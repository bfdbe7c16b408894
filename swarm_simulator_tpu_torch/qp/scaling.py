"""Structure-preserving Ruiz equilibration for the trajectory QP.

float32 cannot Cholesky-factor the raw KKT system: the jerk cost carries
dt^(1-2*phi) ~ 1e3-scale entries and the continuity rows carry
n!/(n-phi)! * dt^-phi factors up to 60 (squared via A^T rho A), giving
condition numbers beyond f32's ~1e7 range.  Modified Ruiz scaling (as in
OSQP) fixes this — and with two structural choices the scaled problem has
*exactly* the same block structure as the original, so the solver's
matvecs don't change at all:

  * variable scaling d[D] is shared across agents and axes (the problem is
    homogeneous in (b, k): same Q, same Aeq, meter-scale boxes), so
    Qseg_bar = c * diag(d_m) Qseg diag(d_m) stays [M, n+1, n+1] and
    Aeq_bar stays [Re, D];
  * box rows are scaled by e_box = 1/d, keeping the box block an identity;
    pair rows by 1/(d * max_k |n|), which folds entirely into pair_n and
    pair_rhs.

Unscaling: x = d * x_bar.  Every leaf of a QPData of torch tensors may
carry leading batch axes (a stack of problems, each scaled on its own).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .assemble import QPData

_MIN_SCALE = 1e-4
_MAX_SCALE = 1e4


@dataclass(frozen=True)
class Scaling:
    c: torch.Tensor  # [...] cost scaling
    d: torch.Tensor  # [..., D] variable scaling (shared over agents/axes)
    e_eq: torch.Tensor  # [..., Re] equality row scaling
    pair_row: torch.Tensor  # [..., P, D] pair row scaling = 1/(d * max|n|)


def _dense_P_template(Qseg: torch.Tensor) -> torch.Tensor:
    """|blockdiag(Qseg)| as [..., D, D] magnitudes for norm computation."""
    *lead, M, npp, _ = Qseg.shape
    P = Qseg.new_zeros((*lead, M, npp, M, npp))
    # the (m, :, m, :) blocks: the diagonal over the two segment axes
    P.diagonal(dim1=-4, dim2=-2).copy_(Qseg.abs().movedim(-3, -1))
    return P.reshape(*lead, M * npp, M * npp)


def equilibrate(data: QPData, iters: int = 10) -> tuple[QPData, Scaling]:
    dt = data.lb.dtype
    M, npp = data.Qseg.shape[-3:-1]
    D = M * npp
    lead = data.Qseg.shape[:-3]

    P_abs = _dense_P_template(data.Qseg)
    A_abs = data.Aeq.abs()

    d = P_abs.new_ones((*lead, D))
    e_eq = P_abs.new_ones((*lead, data.Aeq.shape[-2]))
    c = P_abs.new_ones(lead)

    def clipped_inv_sqrt(v):
        return 1.0 / v.clamp(_MIN_SCALE, _MAX_SCALE).sqrt()

    def colP():
        return (c[..., None, None] * d[..., :, None] * P_abs
                * d[..., None, :]).amax(-2)

    for _ in range(iters):
        # column infinity norms of the scaled [P; Aeq; I] stack (the box
        # rows' e_box * d == 1 by construction)
        col_eq = (e_eq[..., :, None] * A_abs * d[..., None, :]).amax(-2)
        col = torch.maximum(torch.maximum(colP(), col_eq),
                            torch.ones((), dtype=dt, device=d.device))
        d = d * clipped_inv_sqrt(col)

        row_eq = (e_eq[..., :, None] * A_abs * d[..., None, :]).amax(-1)
        e_eq = e_eq * clipped_inv_sqrt(row_eq)

        # cost scaling (OSQP: 1/mean of P column norms; q == 0 here)
        gamma = 1.0 / colP().mean(-1).clamp(_MIN_SCALE, _MAX_SCALE)
        c = c * gamma

    # pair rows: entries n[p, m(d), k] * d[d]; normalize row inf-norm to 1
    n_max = data.pair_n.abs().amax(-1)  # [..., P, M]
    n_max_d = n_max.repeat_interleave(npp, dim=-1)  # [..., P, D]
    pair_row = 1.0 / (n_max_d * d[..., None, :]).clamp(min=1e-8)

    dm = d.reshape(*lead, M, npp)
    dB = d[..., None, None, :]  # over the [B, 3] axes of [..., B, 3, D]
    sdata = replace(
        data,
        Qseg=(c[..., None, None, None] * dm[..., :, :, None] * data.Qseg
              * dm[..., :, None, :]),
        Aeq=e_eq[..., :, None] * data.Aeq * d[..., None, :],
        deq=data.deq * e_eq[..., None, None, :],
        lb=data.lb / dB,
        ub=data.ub / dB,
        pair_n=data.pair_n / n_max[..., None].clamp(min=1e-8),
        pair_rhs=torch.where(data.pair_mask[..., None] > 0,
                             data.pair_rhs * pair_row,
                             torch.full((), -1e8, dtype=dt,
                                        device=d.device)),
        x0=data.x0 / dB,
    )
    return sdata, Scaling(c=c, d=d, e_eq=e_eq, pair_row=pair_row)
