"""The block-tridiagonal (Thomas) KKT solve and its chunked sweeps.

Three wrappers of the hand-written CUDA kernels in ``csrc/thomas.cu``,
one library:

  thomas_solve       (K2)  one x = K(rho_r)^-1 b on float32 or bf16
                           pivots; replaces the JAX package's Pallas TPU
                           kernel ``ops/pallas_thomas.py::_kernel``
                           (``thomas_solve_pallas``) in both of its
                           inventory dtypes
  thomas_chunk_fwd   (K3a) the forward sweep over one knot chunk of the
                           cross-device pipeline (qp/nullspace_shard);
                           replaces ``_chunk_fwd_kernel``
  thomas_chunk_bwd   (K3b) the back substitution over one chunk; replaces
                           ``_chunk_bwd_kernel``

For CUDA float32 tensors (K2: pivots float32 or bf16) a wrapper launches
its kernel once or raises; it takes its plain twin (``*_reference``) only
for tensors on the CPU.  The twins define what the kernels compute and are
what the CPU tests run.

Layouts (Mi interior knots, L knots of a chunk, B3 = 3 * agents,
bs = B3 * phi), contiguous:

  dinv  [R, Mi, bs, bs]  flat pivot inverses of every rung, row
                         (agent*3 + axis)*phi + derivative order; not
                         assumed symmetric (the products are Dinv @ v);
                         a chunk's slab is [R, L, bs, bs]
  ho    [Mi-1, phi, phi] off-diagonal blocks: K[k, k+1] = I_B3 (x) ho[k]
  kin   [L, phi, phi]    per chunk knot j: the block coupling the previous
                         knot into j (zero at the chain's first knot and
                         on pad knots)
  kout  [L, phi, phi]    the block coupling knot j into the next (zero
                         from the chain's last real knot on)
  b     [Mi, bs] / [L, bs]  right-hand side, knot-major
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build


def ko_t(H: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(I_B3 (x) H)^T applied to each [bs] row of v [..., bs]."""
    phi = H.shape[-1]
    return torch.einsum("ai,xa->xi", H, v.reshape(-1, phi)).reshape(v.shape)


def ko(H: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(I_B3 (x) H) applied to each [bs] row of v [..., bs]."""
    phi = H.shape[-1]
    return torch.einsum("ab,xb->xa", H, v.reshape(-1, phi)).reshape(v.shape)


def thomas_solve_reference(dinv: torch.Tensor, ho: torch.Tensor,
                           b: torch.Tensor, rho_idx: int) -> torch.Tensor:
    """Plain torch twin of K2: the Thomas sweeps over knots with the stored
    pivot inverses of rung ``rho_idx``; the off-diagonal blocks I_B3 (x) Ho
    are applied through the Kronecker structure.  Returns x [Mi, bs] in the
    dtype of b.  Pivots of another dtype (the bf16 inventory) are widened
    to b's dtype block by block, before each product, as the kernels do."""
    if b.is_cuda:
        thomas_solve_reference.cuda_calls += 1
    Mi = b.shape[0]
    rung = dinv[rho_idx]

    def Dinv(k):
        return rung[k].to(b.dtype)

    y = [b[0]]
    for k in range(1, Mi):
        y.append(b[k] - ko_t(ho[k - 1], Dinv(k - 1) @ y[k - 1]))
    x = [None] * Mi
    x[Mi - 1] = Dinv(Mi - 1) @ y[Mi - 1]
    for k in range(Mi - 2, -1, -1):
        x[k] = Dinv(k) @ (y[k] - ko(ho[k], x[k + 1]))
    return torch.stack(x)


thomas_solve_reference.cuda_calls = 0


def thomas_chunk_fwd_reference(dinv: torch.Tensor, kin: torch.Tensor,
                               b: torch.Tensor, t_in: torch.Tensor,
                               rho_idx: int) -> torch.Tensor:
    """Plain torch twin of K3a: for j = 0..L-1,
    y_j = b_j - (I (x) kin_j)^T T_{j-1} with T_{-1} = t_in, and
    T_j = Dinv_j y_j.  Returns T [L, bs] (the carry out is T[L-1]) in the
    dtype of the operands."""
    if b.is_cuda:
        thomas_chunk_fwd_reference.cuda_calls += 1
    Dinv = dinv[rho_idx]
    T, t = [], t_in
    for j in range(b.shape[0]):
        t = Dinv[j] @ (b[j] - ko_t(kin[j], t))
        T.append(t)
    return torch.stack(T)


thomas_chunk_fwd_reference.cuda_calls = 0


def thomas_chunk_bwd_reference(dinv: torch.Tensor, kout: torch.Tensor,
                               T: torch.Tensor, x_in: torch.Tensor,
                               rho_idx: int) -> torch.Tensor:
    """Plain torch twin of K3b: for j = L-1..0,
    x_j = T_j - Dinv_j (I (x) kout_j) x_{j+1} with x_L = x_in.  Returns
    x [L, bs] (the carry out is x[0]) in the dtype of the operands."""
    if T.is_cuda:
        thomas_chunk_bwd_reference.cuda_calls += 1
    Dinv = dinv[rho_idx]
    L = T.shape[0]
    x, xn = [None] * L, x_in
    for j in range(L - 1, -1, -1):
        xn = T[j] - Dinv[j] @ ko(kout[j], xn)
        x[j] = xn
    return torch.stack(x)


thomas_chunk_bwd_reference.cuda_calls = 0

#: a float32 kernel against a float64 twin on the same inputs, for every
#: kernel of the port: its worst error over the rungs (each relative to
#: the result's own scale) is at most TWIN_GAP_FACTOR times the float32
#: twin's worst error, plus TWIN_GAP_FLOOR.  The rung systems have
#: condition numbers up to ~1/rho_min, so float32 round-off alone moves a
#: result by up to ~1e-3 of its scale, and by a factor that varies from
#: rung to rung between two float32 implementations (which is why the
#: worst over the rungs is compared, not each rung)
TWIN_GAP_FACTOR = 3.0
TWIN_GAP_FLOOR = 1e-5


def rel_error(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max |x - ref| relative to the reference's own scale max |ref|."""
    ref = ref.double()
    return (float((x.double() - ref).abs().max())
            / max(float(ref.abs().max()), 1e-30))


def twin_gap_use(kernel_vs_f64, f32_vs_f64) -> float:
    """The share of the tolerance a kernel uses: its worst error against
    the float64 twin over the rungs, over TWIN_GAP_FACTOR times the
    float32 twin's worst error plus TWIN_GAP_FLOOR (1 = at the limit).
    Arguments: one error per rung each."""
    return max(kernel_vs_f64) / (TWIN_GAP_FACTOR * max(f32_vs_f64)
                                 + TWIN_GAP_FLOOR)


#: shared memory one block may use on an H100 (227 KB)
SMEM_PER_BLOCK = 232448
#: the largest ring tile (bytes) when a block's rows of a stage do not
#: fit two whole slots
TILE_BYTES = 48 * 1024
#: ring slots at most, and the bytes their mbarriers take
#: (csrc/chain_ring.cuh: kMaxSlots, kBarBytes)
MAX_SLOTS = 8
BAR_BYTES = 128


class RingPlan(NamedTuple):
    """How the chain kernels K1, K2, K3a and K3b stream their pivot rows
    (csrc/chain_ring.cuh): each chain block owns ``groups`` row groups of
    every knot, read through a ring of ``slots`` shared-memory slots of
    ``slot_bytes``, tiles of ``tile_rows`` rows."""
    groups: int
    tile_rows: int
    slots: int
    slot_bytes: int
    smem: int       # dynamic shared memory of a block, bytes


def slot_bytes(tile_rows: int, bs: int, itemsize: int) -> int:
    """One ring slot: the tile rounded up to 16 bytes, plus 16 for a span
    that starts inside a 16-byte line (chain_ring.cuh's slot_bytes)."""
    return -(-tile_rows * bs * itemsize // 16) * 16 + 16


def ring_plan(bs: int, phi: int, itemsize: int, hist_knots: int = 0,
              sms: int = 132, resident_knots: int = 0) -> RingPlan:
    """The ring plan of a chain over [bs, bs] pivot blocks of ``itemsize``
    bytes (4 float32, 2 bf16), row groups of ``phi`` rows, on a card of
    ``sms`` multiprocessors.  The row groups spread over as many chain
    blocks as the card has SMs (one block each): fewer rows a block make
    a shorter dot in each stage (at 64 agents) and more SMs pull the
    stream (at 256), which outweighs the wider vector exchange
    (PERF.md).
    A block keeps its rows of ``hist_knots`` knots in shared memory
    beside the ring (K2's forward rows y_k, P4's T_k; K1, K3a and K3b keep
    none), and T1's P4 its pivot rows of ``resident_knots`` knots
    (csrc/thomas_chain.cuh).
    Whole stages go in a slot when two of them fit, else tiles of at most
    TILE_BYTES; as many slots as the rest of the block's shared memory
    holds, up to MAX_SLOTS."""
    if phi < 1 or bs % phi:
        raise ValueError(f"rows of {bs} do not split into groups of {phi}")
    B3 = bs // phi
    groups = -(-B3 // sms)
    rows = groups * phi
    fixed = (BAR_BYTES + 4 * (bs + rows + hist_knots * rows)
             + resident_knots * rows * bs * itemsize)
    room = SMEM_PER_BLOCK - fixed
    if room >= 2 * slot_bytes(rows, bs, itemsize):
        tile_rows = rows
    else:
        tile_rows = max(1, min(rows, TILE_BYTES // (bs * itemsize)))
    slot = slot_bytes(tile_rows, bs, itemsize)
    slots = min(MAX_SLOTS, room // slot)
    if slots < 2:
        raise ValueError(f"pivot rows of {bs} x {itemsize} bytes leave no "
                         f"room for a two-slot ring in {SMEM_PER_BLOCK} "
                         "bytes of shared memory")
    return RingPlan(groups=groups, tile_rows=tile_rows, slots=slots,
                    slot_bytes=slot, smem=fixed + slots * slot)


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.thomas_solve, lib.thomas_solve_bf16):
        fn.restype = ci
        fn.argtypes = [vp] * 5 + [ci] * 7 + [vp]
    for fn in (lib.thomas_chunk_fwd, lib.thomas_chunk_bwd):
        fn.restype = ci
        fn.argtypes = [vp] * 6 + [ci] * 7 + [vp]
    lib.thomas_error_string.restype = ctypes.c_char_p
    lib.thomas_error_string.argtypes = [ci]


def _cuda_operands(fname: str, rho_idx: int, dinv: torch.Tensor, phi: int,
                   named: tuple, pivot_dtypes=(torch.float32,)
                   ) -> torch.Tensor:
    """Check a kernel's operands (CUDA, float32 — dinv one of
    ``pivot_dtypes`` —, the expected shapes, contiguous; ``named`` holds
    (name, tensor, shape) triples, dinv's among them) and return the rung's
    pivots dinv[rho_idx]."""
    R, bs = dinv.shape[0], dinv.shape[-1]
    if phi < 1 or bs % phi:
        raise ValueError(f"{fname}: blocks of {bs} rows do not split into "
                         f"groups of phi = {phi}")
    if not 0 <= rho_idx < R:
        raise ValueError(f"{fname}: rung {rho_idx} outside [0, {R})")
    for name, t, shape in named:
        if t.device.type != "cuda":
            raise ValueError(f"{fname}: {name} is on {t.device}, expected a "
                             "CUDA tensor")
        allowed = pivot_dtypes if t is dinv else (torch.float32,)
        if t.dtype not in allowed:
            raise ValueError(f"{fname}: {name} has dtype {t.dtype}, "
                             f"expected {' or '.join(map(str, allowed))}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fname}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fname}: {name} is not contiguous")
    piv = dinv[rho_idx]
    # the kernels read a row 16 bytes at a time when its length allows
    if bs % (16 // dinv.element_size()) == 0 and piv.data_ptr() % 16:
        raise ValueError(f"{fname}: dinv is not 16-byte aligned")
    return piv


def _launch(fname: str, *args) -> None:
    """Call the library's ``fname`` with tensor, int and stream arguments
    on the current stream of the first tensor's device; raise on a CUDA
    error."""
    lib = _build.load("thomas", _declare)
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    cargs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
             else a for a in args]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, fname)(*cargs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fname}: CUDA error {err} "
                           f"({lib.thomas_error_string(err).decode()})")


def thomas_solve(dinv: torch.Tensor, ho: torch.Tensor, b: torch.Tensor,
                 rho_idx: int) -> torch.Tensor:
    """x [Mi, bs] = K(ladder[rho_idx])^-1 b.  CUDA tensors launch K2 once:
    on float32 pivots (counted in ``launches``) or bf16 pivots (the
    preconditioner inventory, counted in ``launches_bf16``; ho and b stay
    float32).  CPU tensors run the plain twin; anything else raises."""
    if b.device.type == "cpu":
        return thomas_solve_reference(dinv, ho, b, rho_idx)
    R, Mi, bs = dinv.shape[0], dinv.shape[1], dinv.shape[-1]
    phi = ho.shape[-1]
    piv = _cuda_operands("thomas_solve", rho_idx, dinv, phi, (
        ("dinv", dinv, (R, Mi, bs, bs)), ("ho", ho, (Mi - 1, phi, phi)),
        ("b", b, (Mi, bs))), pivot_dtypes=(torch.float32, torch.bfloat16))
    plan = ring_plan(bs, phi, dinv.element_size(), hist_knots=Mi,
                     sms=sm_count(b.device))
    x = torch.empty_like(b)
    # the chain's vector entries, 64 bits each (csrc/chain_ring.cuh)
    vbuf = torch.empty((2, bs), dtype=torch.int64, device=b.device)
    bf16 = dinv.dtype == torch.bfloat16
    _launch("thomas_solve_bf16" if bf16 else "thomas_solve", piv, ho, b,
            vbuf, x, bs // phi, Mi, phi, plan.groups, plan.tile_rows,
            plan.slots, plan.smem)
    if bf16:
        thomas_solve.launches_bf16 += 1
    else:
        thomas_solve.launches += 1
    # the scratch may be released while the launch is in flight: the
    # caching allocator reuses its blocks only in stream order
    return x


thomas_solve.launches = 0
thomas_solve.launches_bf16 = 0


def chunk_plan(bs: int, phi: int, sms: int = 132) -> RingPlan:
    """The ring plan of K3a and K3b: float32 rows, none kept for a back
    sweep."""
    return ring_plan(bs, phi, 4, hist_knots=0, sms=sms)


def _chunk_sweep(fname: str, dinv, kc, v, carry, rho_idx: int):
    """Launch K3a or K3b (``fname``) on one chunk; returns its [L, bs]."""
    R, L, bs = dinv.shape[0], dinv.shape[1], dinv.shape[-1]
    phi = kc.shape[-1]
    names = (("kin", "b", "t_in") if fname == "thomas_chunk_fwd"
             else ("kout", "T", "x_in"))
    piv = _cuda_operands(fname, rho_idx, dinv, phi, (
        ("dinv", dinv, (R, L, bs, bs)), (names[0], kc, (L, phi, phi)),
        (names[1], v, (L, bs)), (names[2], carry, (bs,))))
    plan = chunk_plan(bs, phi, sm_count(v.device))
    out = torch.empty_like(v)
    # the chain's vector entries, 64 bits each, as K2's
    vbuf = torch.empty((2, bs), dtype=torch.int64, device=v.device)
    _launch(fname, piv, kc, v, carry, vbuf, out, bs // phi, L, phi,
            plan.groups, plan.tile_rows, plan.slots, plan.smem)
    return out


def thomas_chunk_fwd(dinv: torch.Tensor, kin: torch.Tensor, b: torch.Tensor,
                     t_in: torch.Tensor, rho_idx: int) -> torch.Tensor:
    """T [L, bs] of one chunk's forward sweep (see
    thomas_chunk_fwd_reference).  CUDA float32 tensors launch K3a once;
    CPU tensors run the plain twin; anything else raises."""
    if b.device.type == "cpu":
        return thomas_chunk_fwd_reference(dinv, kin, b, t_in, rho_idx)
    T = _chunk_sweep("thomas_chunk_fwd", dinv, kin, b, t_in, rho_idx)
    thomas_chunk_fwd.launches += 1
    return T


thomas_chunk_fwd.launches = 0


def thomas_chunk_bwd(dinv: torch.Tensor, kout: torch.Tensor, T: torch.Tensor,
                     x_in: torch.Tensor, rho_idx: int) -> torch.Tensor:
    """x [L, bs] of one chunk's back substitution (see
    thomas_chunk_bwd_reference).  CUDA float32 tensors launch K3b once;
    CPU tensors run the plain twin; anything else raises."""
    if T.device.type == "cpu":
        return thomas_chunk_bwd_reference(dinv, kout, T, x_in, rho_idx)
    x = _chunk_sweep("thomas_chunk_bwd", dinv, kout, T, x_in, rho_idx)
    thomas_chunk_bwd.launches += 1
    return x


thomas_chunk_bwd.launches = 0
