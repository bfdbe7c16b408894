"""Shared ADMM pieces that the knot-state solver (qp/nullspace) uses.

Only the solver-independent types of the JAX package's qp/admm.py: the
per-solve info record and the pair-constraint operator.  The
sequential-batch OSQP splitting itself (``Param.solver="admm"``) is not
ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SolveInfo(NamedTuple):
    iters: int
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    obj: torch.Tensor


class PairOp(NamedTuple):
    """Pair-constraint operator: signed agent selection S = C_j - C_i
    [P, B] (one-hot rows, weighted by the pair mask) plus the
    per-control-point normals [P, 3, D] (masked)."""
    n_d: torch.Tensor  # [P, 3, D]
    S: torch.Tensor  # [P, B]


def _pair_op(data) -> PairOp:
    P, M, _ = data.pair_n.shape
    npp = data.lb.shape[-1] // M
    B = data.lb.shape[0]
    dt = data.lb.dtype
    n_d = torch.repeat_interleave(data.pair_n, npp, dim=1)  # [P, D, 3]
    n_d = n_d.permute(0, 2, 1) * data.pair_mask[:, None, None]
    cj = (data.pair_bj >= 0).to(dt) * data.pair_mask
    ci = (data.pair_bi >= 0).to(dt) * data.pair_mask
    rows = torch.arange(P, device=data.lb.device)
    S = torch.zeros((P, B), dtype=dt, device=data.lb.device)
    S.index_put_((rows, data.pair_bj.long().clamp(min=0)), cj,
                 accumulate=True)
    S.index_put_((rows, data.pair_bi.long().clamp(min=0)), -ci,
                 accumulate=True)
    return PairOp(n_d=n_d.contiguous(), S=S)
