"""Generic dense-matrix ADMM QP solver.

  minimize 0.5 x^T Q x + q^T x   s.t.  l <= A x <= u

Used by the SCP planner (whose constraint matrices are naturally dense,
scp_planner.hpp:202-292).  The OSQP-style splitting of qp/admm.py with
dense Ruiz equilibration: one Cholesky, then each iteration is two
matrix-vector products with A and one with K^-1 (torch.matmul: the JAX
package reaches no Pallas kernel here either).

The JAX package tests convergence after every iteration inside one
compiled while_loop.  The port runs ``_SYNC_EVERY`` iterations between
host syncs with the same per-iteration test: the iteration at which the
test first holds freezes the state, so the result and the iteration count
are those of a per-iteration loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..core.device import pin_ieee_fp32, resolve_device

# iterations between host syncs (the result does not depend on it)
_SYNC_EVERY = 25


@dataclass(frozen=True)
class DenseSettings:
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6
    alpha: float = 1.6
    max_iter: int = 2000
    eps_abs: float = 1e-5
    eps_rel: float = 1e-5
    scaling_iters: int = 10


class DenseInfo(NamedTuple):
    iters: int
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    obj: torch.Tensor


def _equilibrate(Q, q, A, l, u, iters):
    """Modified Ruiz scaling (d [n], e [m], c) of the dense QP."""
    m, n = A.shape
    d = Q.new_ones(n)
    e = Q.new_ones(m)
    c = Q.new_ones(())
    lo, hi = 1e-4, 1e4

    def isqrt(v):
        return 1.0 / torch.sqrt(torch.clamp(v, lo, hi))

    absQ, absA = Q.abs(), A.abs()
    for _ in range(iters):
        colQ = torch.amax(c * d[:, None] * absQ * d[None, :], dim=0)
        colA = torch.amax(e[:, None] * absA * d[None, :], dim=0)
        d = d * isqrt(torch.maximum(colQ, colA))
        rowA = torch.amax(e[:, None] * absA * d[None, :], dim=1)
        e = e * isqrt(rowA)
        colQ = torch.amax(c * d[:, None] * absQ * d[None, :], dim=0)
        qn = torch.amax(torch.abs(c * d * q))
        c = c / torch.clamp(torch.maximum(colQ.mean(), qn), lo, hi)
    return d, e, c


def solve_dense(Q, q, A, l, u, settings: DenseSettings = DenseSettings(),
                is_eq=None, x0=None, device=None):
    """Solve one dense QP on ``device`` (None = the card; raises without
    one: pass ``device="cpu"`` for the CPU).  Operands are arrays or
    tensors, moved there in Q's dtype; q None = 0; is_eq: bool[m] marks
    rows given the boosted rho (None: rows with l == u).  Returns (x,
    DenseInfo)."""
    device = resolve_device(device)
    if device.type == "cuda":
        pin_ieee_fp32()
    Q = torch.as_tensor(Q, device=device)

    def put(v):
        return None if v is None else torch.as_tensor(v, dtype=Q.dtype,
                                                      device=device)

    with torch.no_grad():
        return _solve_dense(
            Q, put(q), put(A), put(l), put(u), settings,
            None if is_eq is None else torch.as_tensor(is_eq, device=device),
            put(x0))


def _solve_dense(Q, q, A, l, u, s: DenseSettings, is_eq, x0):
    m, n = A.shape
    dt = Q.dtype
    if q is None:
        q = Q.new_zeros(n)
    if is_eq is None:
        is_eq = l == u
    rho = torch.where(is_eq, s.rho * s.rho_eq_scale, s.rho).to(dt)

    d, e, c = _equilibrate(Q, q, A, l, u, s.scaling_iters)
    Qs = c * d[:, None] * Q * d[None, :]
    qs = c * d * q
    As = e[:, None] * A * d[None, :]
    ls = e * l
    us = e * u

    K = Qs + s.sigma * torch.eye(n, dtype=dt, device=Q.device) \
        + (As.T * rho) @ As
    Kinv = torch.cholesky_inverse(torch.linalg.cholesky(K))

    x = Q.new_zeros(n) if x0 is None else x0 / d
    z = torch.clamp(As @ x, ls, us)
    y = Q.new_zeros(m)

    def step(x, z, y):
        rhs = s.sigma * x - qs + As.T @ (rho * z - y)
        x_t = Kinv @ rhs
        ax_t = As @ x_t
        x_new = s.alpha * x_t + (1 - s.alpha) * x
        v = s.alpha * ax_t + (1 - s.alpha) * z + y / rho
        z_new = torch.clamp(v, ls, us)
        y_new = rho * (v - z_new)

        # unscaled residuals
        xu = d * x_new
        yu = e * y_new / c
        zu = z_new / e
        ax = A @ xu
        px = Q @ xu + q
        aty = A.T @ yu
        r_prim = torch.amax(torch.abs(ax - zu))
        r_dual = torch.amax(torch.abs(px + aty))
        eps_p = s.eps_abs + s.eps_rel * torch.maximum(
            torch.amax(torch.abs(ax)), torch.amax(torch.abs(zu)))
        eps_d = s.eps_abs + s.eps_rel * torch.maximum(
            torch.amax(torch.abs(px)), torch.amax(torch.abs(aty)))
        return x_new, z_new, y_new, (r_prim <= eps_p) & (r_dual <= eps_d)

    # active: the loop condition of the JAX package's while_loop, read on
    # the device each iteration; a stopped loop keeps its state and count
    it = torch.zeros((), dtype=torch.long, device=Q.device)
    active = torch.ones((), dtype=torch.bool, device=Q.device)
    n_run = 0
    while n_run < s.max_iter and bool(active):
        for _ in range(min(_SYNC_EVERY, s.max_iter - n_run)):
            x_n, z_n, y_n, done = step(x, z, y)
            x = torch.where(active, x_n, x)
            z = torch.where(active, z_n, z)
            y = torch.where(active, y_n, y)
            it = it + active
            active = active & ~done
        n_run += _SYNC_EVERY

    xu = d * x
    yu = e * y / c
    zu = z / e
    r_prim = torch.amax(torch.abs(A @ xu - zu))
    r_dual = torch.amax(torch.abs(Q @ xu + q + A.T @ yu))
    obj = 0.5 * xu @ Q @ xu + q @ xu
    return xu, DenseInfo(iters=int(it), r_prim=r_prim, r_dual=r_dual,
                         obj=obj)
