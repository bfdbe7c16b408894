"""Bernstein-polynomial machinery for piecewise trajectory optimization.

The reference (swarm_planner/include/rbp_planner.hpp:327-405) hard-codes the
degree-5 matrices ``Q_base`` (jerk-cost Gram matrix), ``basis`` (Bernstein ->
power conversion) and the endpoint-derivative matrices ``A_0`` / ``A_T``.
Here every matrix is derived in closed form for arbitrary degree ``n`` and
derivative order ``phi``; a unit test pins the n=5, phi=3 case to the
reference's hard-coded values.

Conventions (matching the reference):
  * A segment trajectory is p(t) = sum_i c_i B_i^n(t / dt), t in [0, dt].
  * Power coefficients are stored in *descending* order: row j of a power
    coefficient vector multiplies t^(n-j)  (rbp_planner.hpp:695-700).
  * ``bernstein_power_matrix(n)[i, j]`` is the coefficient of s^(n-j) in
    B_i^n(s), so power = (basis @ time_matrix(1/dt)).T @ ctrl.
"""
from __future__ import annotations

import functools
import math

import numpy as np

__all__ = [
    "bernstein_power_matrix",
    "endpoint_derivative_matrices",
    "derivative_cost_matrix",
    "time_matrix",
    "bernstein_to_power",
]


@functools.lru_cache(maxsize=None)
def bernstein_power_matrix(n: int) -> np.ndarray:
    """Matrix B with B[i, j] = coefficient of s^(n-j) in B_i^n(s).

    B_i^n(s) = C(n,i) s^i (1-s)^(n-i)
             = sum_{m=i}^{n} C(n,i) C(n-i, m-i) (-1)^(m-i) s^m.
    With column j holding the s^(n-j) coefficient (descending powers).
    """
    B = np.zeros((n + 1, n + 1), dtype=np.float64)
    for i in range(n + 1):
        for m in range(i, n + 1):  # m = power of s
            coeff = math.comb(n, i) * math.comb(n - i, m - i) * (-1) ** (m - i)
            B[i, n - m] = coeff
    return B


@functools.lru_cache(maxsize=None)
def endpoint_derivative_matrices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(A_0, A_T) with row r giving the r-th derivative at s=0 / s=1.

    d^r/ds^r p(s)|_{s=0} = n!/(n-r)! * sum_k (-1)^(r-k) C(r,k) c_k
    d^r/ds^r p(s)|_{s=1} = n!/(n-r)! * sum_k (-1)^k     C(r,k) c_{n-k}

    The falling-factorial prefactor n!/(n-r)! is *not* included (the
    reference applies it separately as the running product ``nn``,
    rbp_planner.hpp:380-398); rows hold only the signed binomials.
    """
    A0 = np.zeros((n + 1, n + 1), dtype=np.float64)
    AT = np.zeros((n + 1, n + 1), dtype=np.float64)
    for r in range(n + 1):
        for k in range(r + 1):
            A0[r, k] = (-1) ** (r - k) * math.comb(r, k)
            AT[r, n - k] = (-1) ** k * math.comb(r, k)
    return A0, AT


@functools.lru_cache(maxsize=None)
def derivative_cost_matrix(n: int, phi: int) -> np.ndarray:
    """Gram matrix Q with Q[i, j] = integral_0^1 B_i^{(phi)}(s) B_j^{(phi)}(s) ds.

    Matches the reference's hard-coded ``Q_base`` for n=5, phi=3
    (rbp_planner.hpp:330-335).  The per-segment cost in real time is
    ctrl^T (Q * dt^(1-2*phi)) ctrl  (rbp_planner.hpp:349-351).
    """
    basis = bernstein_power_matrix(n)  # rows: power coeffs (descending)
    # Differentiate each Bernstein polynomial phi times in power space.
    # Descending storage: column j is s^(n-j); derivative of s^m is m s^(m-1).
    der = basis.copy()
    for _ in range(phi):
        new = np.zeros_like(der)
        for j in range(n + 1):
            m = n - j  # power of this column
            if m > 0:
                new[:, j + 1] = der[:, j] * m  # s^m -> m s^(m-1) = column j+1
        der = new
    # Q[i, j] = sum_{a,b} der[i, a] der[j, b] / (power_a + power_b + 1)
    powers = np.arange(n, -1, -1, dtype=np.float64)
    denom = powers[:, None] + powers[None, :] + 1.0
    Q = np.einsum("ia,jb,ab->ij", der, der, 1.0 / denom)
    return Q


def time_matrix(t: float | np.ndarray, n: int) -> np.ndarray:
    """diag(t^(n-i)) for i = 0..n (rbp_planner.hpp:695-700).

    Supports a batched ``t`` of shape [...] -> [..., n+1, n+1].
    """
    t = np.asarray(t, dtype=np.float64)
    powers = np.arange(n, -1, -1, dtype=np.float64)
    diag = t[..., None] ** powers
    out = np.zeros(t.shape + (n + 1, n + 1), dtype=np.float64)
    idx = np.arange(n + 1)
    out[..., idx, idx] = diag
    return out


def bernstein_to_power(ctrl: np.ndarray, dt: np.ndarray, n: int) -> np.ndarray:
    """Convert control points to descending-power coefficients per segment.

    ctrl: [..., M, n+1, K] control points, dt: [..., M] segment durations.
    Returns [..., M, n+1, K] with row j the coefficient of t^(n-j), t local
    to the segment.  Mirrors the conversion loop rbp_planner.hpp:167-196.
    """
    basis = bernstein_power_matrix(n)
    tm = time_matrix(1.0 / np.asarray(dt, dtype=np.float64), n)  # [..., M, n+1, n+1]
    conv = basis @ tm  # [..., M, n+1, n+1]
    # power[j] = sum_i ctrl[i] * conv[i, j]
    return np.einsum("...ij,...ik->...jk", conv, ctrl)
