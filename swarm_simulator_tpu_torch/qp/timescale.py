"""Post-solve time scaling to restore dynamic feasibility.

Vectorized form of RBPPlanner::timeScale (rbp_planner.hpp:209-266): find
the velocity/acceleration extrema of every segment polynomial, grow a
global time_scale by factors of 1.1 until every axis obeys max_vel/max_acc,
then rescale coefficients and knot times.

Extrema are found from *all* real roots of the relevant derivative
polynomial (batched companion-matrix eigenvalues).  Note: the reference's
roots_derivative (rbp_planner.hpp:746-752) inspects only the first ``i``
eigenvalues — we deliberately check every root, which can only make the
result more conservative (never less safe).
"""
from __future__ import annotations

import numpy as np

SCALE_UPDATE_RATE = 1.1


def _derivative_coeffs(coef: np.ndarray, r: int, n: int) -> np.ndarray:
    """r-th derivative coefficients, descending powers.

    coef [..., n+1] with column j = coefficient of t^(n-j).
    Returns [..., n+1-r] with column j = coefficient of t^(n-r-j).
    """
    j = np.arange(n + 1)
    powers = n - j  # power of each column
    fall = np.ones(n + 1)
    for k in range(r):
        fall = fall * np.maximum(powers - k, 0)
    der = coef * fall
    return der[..., : n + 1 - r] if r > 0 else der


def _real_roots_batched(c: np.ndarray) -> np.ndarray:
    """Real roots of polynomials c[..., K+1] (descending powers), NaN-padded.

    Batched companion-matrix eigenvalues: polynomials are grouped by
    effective degree (position of the first nonzero leading coefficient)
    and each group is one batched np.linalg.eigvals call — no per-segment
    host loop (the reference's roots_derivative, rbp_planner.hpp:727-754,
    eigensolves one 4x4 at a time; at 256 agents x 16 scenarios that is
    ~10^5 host eigensolves per timescale pass).
    """
    *batch, K1 = c.shape
    K = K1 - 1
    flat = c.reshape(-1, K1)
    n_poly = flat.shape[0]
    roots = np.full((n_poly, K), np.nan)

    nonzero = np.abs(flat) > 0
    first_nz = np.where(nonzero.any(axis=1), np.argmax(nonzero, axis=1), K1)
    for lead in range(0, K):  # effective degree K - lead >= 1
        deg = K - lead
        sel = np.nonzero(first_nz == lead)[0]
        if len(sel) == 0:
            continue
        p = flat[sel, lead:]                       # [g, deg+1]
        monic = p[:, 1:] / p[:, :1]                # [g, deg]
        if deg == 1:
            roots[sel, 0] = -monic[:, 0]
            continue
        comp = np.zeros((len(sel), deg, deg))
        comp[:, 0, :] = -monic
        idx = np.arange(deg - 1)
        comp[:, idx + 1, idx] = 1.0
        ev = np.linalg.eigvals(comp)               # [g, deg] complex
        real = np.abs(ev.imag) == 0
        order = np.argsort(~real, axis=1)          # real roots first
        ev_sorted = np.take_along_axis(ev, order, axis=1)
        real_sorted = np.take_along_axis(real, order, axis=1)
        vals = np.where(real_sorted, ev_sorted.real, np.nan)
        roots[sel, :deg] = vals
    return roots.reshape(*batch, K)


def _max_abs_poly(c: np.ndarray, ts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """max_t |poly(t)| over candidate times ts [..., C] (NaN = skip).

    Returns (max values, argmax times)."""
    K = c.shape[-1] - 1
    powers = np.arange(K, -1, -1)
    tval = np.where(np.isnan(ts), 0.0, ts)[..., None]  # [..., C, 1]
    vals = np.abs(np.sum(c[..., None, :] * tval ** powers, axis=-1))
    vals = np.where(np.isnan(ts), -np.inf, vals)
    imax = np.argmax(vals, axis=-1)
    vmax = np.take_along_axis(vals, imax[..., None], axis=-1)[..., 0]
    tmax = np.take_along_axis(np.where(np.isnan(ts), 0.0, ts), imax[..., None],
                              axis=-1)[..., 0]
    return vmax, tmax


def _required_scale(ratio: np.ndarray) -> np.ndarray:
    """Smallest 1.1^k >= ratio (the reference grows by 1.1 steps,
    rbp_planner.hpp:782-791; we compute the exact requirement instead of
    re-evaluating at the unscaled extremum time, which under-scales for
    interior maxima — t -> t/s divides velocity by exactly s and
    acceleration by exactly s^2)."""
    ratio = np.maximum(ratio, 1.0)
    k = np.ceil(np.log(ratio) / np.log(SCALE_UPDATE_RATE) - 1e-12)
    return SCALE_UPDATE_RATE ** k


def compute_time_scale(coef: np.ndarray, T: np.ndarray, max_vel: np.ndarray,
                       max_acc: np.ndarray, n: int, phi: int) -> float:
    """Global time-scale factor >= 1 (timeScale, rbp_planner.hpp:209-235)."""
    if phi != 3 or n != 5:
        return 1.0
    N, M, _, _ = coef.shape
    dt = np.diff(np.asarray(T))  # [M]
    c = np.asarray(coef).transpose(0, 3, 1, 2)  # [N, 3, M, n+1]

    vel = _derivative_coeffs(c, 1, n)  # [N,3,M,5]
    acc = _derivative_coeffs(c, 2, n)  # [N,3,M,4]
    jerk = _derivative_coeffs(c, 3, n)  # [N,3,M,3]

    dt_b = np.broadcast_to(dt, c.shape[:-1])

    # velocity extrema: roots of acceleration + interval ends
    r_acc = _real_roots_batched(acc)
    cand_v = np.concatenate(
        [r_acc, np.zeros_like(dt_b)[..., None], dt_b[..., None]], axis=-1)
    cand_v = np.where((cand_v >= 0) & (cand_v <= dt_b[..., None]), cand_v, np.nan)
    cand_v[..., -2] = 0.0  # t=0 always valid
    cand_v[..., -1] = dt_b
    vmax, _ = _max_abs_poly(vel, cand_v)
    lim_v = np.broadcast_to(np.asarray(max_vel)[:, :, None], vmax.shape)
    s_vel = _required_scale(vmax / lim_v)

    # acceleration extrema: roots of jerk + interval ends
    r_jerk = _real_roots_batched(jerk)
    cand_a = np.concatenate(
        [r_jerk, np.zeros_like(dt_b)[..., None], dt_b[..., None]], axis=-1)
    cand_a = np.where((cand_a >= 0) & (cand_a <= dt_b[..., None]), cand_a, np.nan)
    cand_a[..., -2] = 0.0
    cand_a[..., -1] = dt_b
    amax, _ = _max_abs_poly(acc, cand_a)
    lim_a = np.broadcast_to(np.asarray(max_acc)[:, :, None], amax.shape)
    s_acc = _required_scale(np.sqrt(amax / lim_a))

    return float(max(1.0, s_vel.max(), s_acc.max()))


def apply_time_scale(coef: np.ndarray, T: np.ndarray, scale: float,
                     n: int) -> tuple[np.ndarray, np.ndarray]:
    """Rescale coefficients and knot times by ``scale``
    (rbp_planner.hpp:236-265)."""
    if scale == 1.0:
        return coef, T
    j = np.arange(n + 1)
    factors = (1.0 / scale) ** (n - j)  # column j holds t^(n-j)
    return coef * factors[None, None, :, None], np.asarray(T) * scale
