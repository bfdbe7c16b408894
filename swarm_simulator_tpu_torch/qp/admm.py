"""Shared ADMM pieces that the knot-state solver (qp/nullspace) uses.

Only the solver-independent pieces of the JAX package's qp/admm.py: the
per-solve info record, the pair-constraint operator and the pair
coupling that the device prep factors in.  The sequential-batch OSQP
splitting itself (``Param.solver="admm"``) is not ported yet.
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
    """Pair-constraint operator: the per-control-point normals [P, 3, D]
    (masked), each pair's two agents with their signed weights, and the
    signed agent selection S = C_j - C_i [P, B] (one-hot rows weighted by
    the pair mask) that A^T's pair part contracts with.  A x gathers by
    the agent indices instead of multiplying S."""
    n_d: torch.Tensor  # [P, 3, D]
    S: torch.Tensor  # [P, B]
    bi: torch.Tensor  # [P] int64 agent of the pair's i side (-1 -> 0)
    bj: torch.Tensor  # [P] int64 agent of the pair's j side (-1 -> 0)
    ci: torch.Tensor  # [P] weight of the i side (0 where bi = -1)
    cj: torch.Tensor  # [P] weight of the j side (0 where bj = -1)


def _pair_sides(data):
    """(bi, bj, ci, cj): each pair's agent indices clamped to >= 0 and
    their weights, the pair mask folded in; a one-sided pair (index -1)
    keeps weight 0 on its absent side."""
    dt = data.lb.dtype
    ci = (data.pair_bi >= 0).to(dt) * data.pair_mask
    cj = (data.pair_bj >= 0).to(dt) * data.pair_mask
    return (data.pair_bi.long().clamp(min=0), data.pair_bj.long().clamp(min=0),
            ci, cj)


def _selection(data) -> torch.Tensor:
    """Signed agent selection S [P, B]: S[p, bj] = c_j, S[p, bi] = -c_i,
    the pair mask folded in (one-sided pairs keep one entry)."""
    P = data.pair_n.shape[0]
    B = data.lb.shape[0]
    bi, bj, ci, cj = _pair_sides(data)
    rows = torch.arange(P, device=data.lb.device)
    S = torch.zeros((P, B), dtype=data.lb.dtype, device=data.lb.device)
    S.index_put_((rows, bj), cj, accumulate=True)
    S.index_put_((rows, bi), -ci, accumulate=True)
    return S


def _pair_op(data) -> PairOp:
    P, M, _ = data.pair_n.shape
    npp = data.lb.shape[-1] // M
    n_d = torch.repeat_interleave(data.pair_n, npp, dim=1)  # [P, D, 3]
    n_d = n_d.permute(0, 2, 1) * data.pair_mask[:, None, None]
    bi, bj, ci, cj = _pair_sides(data)
    return PairOp(n_d=n_d.contiguous(), S=_selection(data), bi=bi, bj=bj,
                  ci=ci, cj=cj)


def _build_coupling(data) -> torch.Tensor:
    """Pair-constraint normal-equation coupling C [M, B3, B3], row index
    agent*3 + axis: C_m = sum_p (S_p (x) n_pm)(S_p (x) n_pm)^T, the A^T A
    of segment m's pair rows.  Contracted as U[m, p, (b, k)] =
    S[p, b] n[p, m, k] and one batched U_m^T U_m, so no [P, B, M, 3, B]
    intermediate (3.6 GB in float32 at 64 agents) is ever formed."""
    M = data.pair_n.shape[1]
    B = data.lb.shape[0]
    S = _selection(data)
    U = torch.einsum("pb,pmk->mpbk", S, data.pair_n).reshape(M, -1, 3 * B)
    return U.transpose(1, 2) @ U
