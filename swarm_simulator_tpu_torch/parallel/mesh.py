"""The Gauss-Seidel sweep of sequential batch planning on one device.

The JAX module also places stacked problems on a (scenario, batch) device
mesh and runs the Jacobi sweeps there; the port has only the sweep that
the planning path runs (``seqbatch.solve_trajectories``'s default mode).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.device import pin_ieee_fp32
from ..qp import admm, assemble


def gauss_seidel_sweep(stacked: assemble.QPData, dummy: torch.Tensor,
                       settings: admm.ADMMSettings,
                       rounds: int = 1, kkt_chunk: int = 4):
    """The reference's sequential batch planning with the dummy control
    points kept on the device: each batch refreshes its coupling rhs from
    the current dummy, solves, and writes its solution back — exactly the
    Gauss-Seidel semantics of rbp_planner.hpp:140-204, with no host round
    trip between batches.

    stacked: the batch QPs on one device, a leading batch axis on every
    leaf (seqbatch._stack_qpdata); dummy [N, M, n+1, 3] on that device.
    The KKT operators are built ``kkt_chunk`` batches at a time.  Padded
    agents (id >= N) are solved but never written back.
    Returns (dummy [N, M, n+1, 3], SolveInfo of the last round, [L]).
    """
    N, M, npp, _ = dummy.shape
    if dummy.is_cuda:
        pin_ieee_fp32()
    sdatas, scals, ops = admm._prepare_stack(stacked, settings, kkt_chunk)
    # one spare row takes the padded agents' writes (the JAX package's
    # mode="drop" scatter)
    ext = torch.cat([dummy, dummy.new_zeros((1,) + dummy.shape[1:])])
    dummy = ext[:N]
    L = stacked.lb.shape[0]
    for _ in range(rounds):
        infos = []
        for i in range(L):
            def pick(tree):
                return admm._tree_map(lambda a: a[i], tree)

            data_l, sd, scal, op = (pick(stacked), pick(sdatas),
                                    pick(scals), pick(ops))
            d = assemble.refresh_from_dummy(data_l, dummy)
            if scal is not None:
                rhs = torch.where(
                    d.pair_mask[:, None] > 0, d.pair_rhs * scal.pair_row,
                    torch.full((), -assemble.BIG, dtype=d.pair_rhs.dtype,
                               device=d.pair_rhs.device))
                sd = dataclasses.replace(sd, pair_rhs=rhs,
                                         x0=d.x0 / scal.d)
            else:
                sd = dataclasses.replace(sd, pair_rhs=d.pair_rhs, x0=d.x0)
            x, info = admm._iterate(
                *(admm._tree_map(lambda a: a[None], t)
                  for t in (d, sd, scal, op)), settings)
            B = x.shape[1]
            ctrl = x[0].permute(0, 2, 1).reshape(B, M, npp, 3)
            ext[data_l.agents.long().clamp(max=N)] = ctrl.to(ext.dtype)
            infos.append(info)
    return dummy, admm._tree_map(lambda *v: torch.cat(v), *infos)
