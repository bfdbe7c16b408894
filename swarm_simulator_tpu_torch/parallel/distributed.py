"""torch.distributed glue for the cross-device joint solve.

The port's counterpart of the JAX package's ``parallel/distributed.py``
(``initialize``): where JAX runs one program over a device mesh and
couples the devices with ``psum`` / ``pmax`` / ``all_gather`` /
``ppermute``, the port runs one process per rank of a ``torch.distributed``
group and couples them with the helpers below.

* ``init_group`` joins a group through a ``FileStore`` (no network):
  ``nccl`` for ranks on CUDA cards (rank r on card r mod the card count),
  ``gloo`` for ranks on the CPU.  A tensor on the other kind of device is
  refused by every helper; nothing is moved between devices.
* ``run_ranks`` spawns the ranks (``torch.multiprocessing``, spawn
  context), each joining the group of the backend the caller names and
  running ``fn``, and returns rank 0's result.  A rank that raises makes
  it raise.  One rank runs in the calling process.
* ``psum``, ``pmax``, ``all_gather_tiled`` are the collectives; the
  point-to-point pairs ``send_next``/``recv_prev`` and
  ``send_prev``/``recv_next`` carry a tensor one rank along the chain as
  batched P2P ops.  On a 1-rank group each helper returns its input (no
  NCCL call sends to its own rank).

``global_mesh``, ``scenario_shard`` and ``stack_across_processes`` of the
JAX module serve the scenario-replicated Jacobi path, which is not ported
yet (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile

import torch
import torch.distributed as dist

#: the device kind each backend's tensors live on
BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}

#: how long a collective waits for the other ranks before it fails (a
#: rank stuck in a long host prep must not time the others out)
TIMEOUT = datetime.timedelta(seconds=600)


def init_group(rank: int, world_size: int, store_path: str,
               backend: str = "nccl") -> None:
    """Join the default process group as ``rank`` of ``world_size``, meeting
    through the file ``store_path`` (every rank gives the same path)."""
    if backend not in BACKEND_DEVICE:
        raise ValueError(f"backend {backend!r}: expected one of "
                         f"{sorted(BACKEND_DEVICE)}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a CUDA card; use "
                               "'gloo' for ranks on the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=TIMEOUT)


def group_device(group=None) -> torch.device:
    """The device this rank's tensors live on: its card under nccl, the
    CPU under gloo."""
    backend = dist.get_backend(group)
    kind = BACKEND_DEVICE.get(backend)
    if kind is None:
        raise ValueError(f"process group backend {backend!r} is not one of "
                         f"{sorted(BACKEND_DEVICE)}")
    if kind == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _check(t: torch.Tensor, group) -> None:
    want = BACKEND_DEVICE.get(dist.get_backend(group))
    if t.device.type != want:
        raise ValueError(f"a {dist.get_backend(group)} group carries {want} "
                         f"tensors; got one on {t.device}")


def psum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``t`` over the ranks (all_reduce SUM, in place)."""
    _check(t, group)
    dist.all_reduce(t, dist.ReduceOp.SUM, group=group)
    return t


def pmax(t: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise maximum of ``t`` over the ranks (all_reduce MAX, in
    place)."""
    _check(t, group)
    dist.all_reduce(t, dist.ReduceOp.MAX, group=group)
    return t


def all_gather_tiled(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated on dim 0 in rank order."""
    _check(t, group)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def _p2p(op, t: torch.Tensor, peer: int, group) -> None:
    _check(t, group)
    if group is not None:
        peer = dist.get_global_rank(group, peer)
    for work in dist.batch_isend_irecv([dist.P2POp(op, t, peer, group)]):
        work.wait()


def send_next(t: torch.Tensor, group=None) -> torch.Tensor:
    """Send ``t`` to rank r + 1 (the last rank sends nothing); returns
    ``t``."""
    r = dist.get_rank(group)
    if r + 1 < dist.get_world_size(group):
        _p2p(dist.isend, t.contiguous(), r + 1, group)
    return t


def recv_prev(buf: torch.Tensor, group=None) -> torch.Tensor:
    """Receive into ``buf`` from rank r - 1 (rank 0 keeps ``buf``); returns
    ``buf``."""
    r = dist.get_rank(group)
    if r > 0:
        _p2p(dist.irecv, buf, r - 1, group)
    return buf


def send_prev(t: torch.Tensor, group=None) -> torch.Tensor:
    """Send ``t`` to rank r - 1 (rank 0 sends nothing); returns ``t``."""
    r = dist.get_rank(group)
    if r > 0:
        _p2p(dist.isend, t.contiguous(), r - 1, group)
    return t


def recv_next(buf: torch.Tensor, group=None) -> torch.Tensor:
    """Receive into ``buf`` from rank r + 1 (the last rank keeps ``buf``);
    returns ``buf``."""
    r = dist.get_rank(group)
    if r + 1 < dist.get_world_size(group):
        _p2p(dist.irecv, buf, r + 1, group)
    return buf


def _run_rank(rank: int, fn, world_size: int, store_path: str, backend: str,
              args: tuple):
    init_group(rank, world_size, store_path, backend)
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()


def _spawned_rank(rank: int, fn, world_size: int, store_path: str,
                  backend: str, out_path: str, args: tuple) -> None:
    # the ranks share the host's cores: one intra-op thread each
    torch.set_num_threads(1)
    result = _run_rank(rank, fn, world_size, store_path, backend, args)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(result, f)


def run_ranks(fn, world_size: int, *args, backend: str):
    """Run ``fn(*args)`` on every rank of a fresh ``world_size``-rank group
    and return rank 0's result.  ``backend`` has no default: the caller
    names the card (``"nccl"``) or the CPU (``"gloo"``).  ``fn`` is a
    module-level function (the spawned ranks import it by name) and its
    result must pickle.  With
    ``world_size == 1`` it runs in the calling process under a 1-rank
    group; otherwise each rank is a spawned process, and the first rank
    that raises ends the others and makes this raise."""
    tmp = tempfile.mkdtemp(prefix="sst_ranks_")
    store = os.path.join(tmp, "store")
    out = os.path.join(tmp, "rank0.pkl")
    try:
        if world_size == 1:
            return _run_rank(0, fn, 1, store, backend, args)
        torch.multiprocessing.start_processes(
            _spawned_rank, args=(fn, world_size, store, backend, out, args),
            nprocs=world_size, join=True, start_method="spawn")
        with open(out, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
