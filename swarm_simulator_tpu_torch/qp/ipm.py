"""Trusted float64 interior-point QP solver (host CPU, numpy/scipy).

The port's copy of the JAX package's host oracle, the same arithmetic in
the same order.  Two jobs the first-order device solver cannot do for
itself:

1. **Parity oracle**: a Mehrotra predictor-corrector barrier method (the
   algorithm class CPLEX's barrier optimizer runs on these QPs, solveQP,
   rbp_planner.hpp:111-206) run in float64 to mu ~ 1e-10.  Its answers
   are *verified*, not trusted: `kkt_residuals` independently checks
   stationarity, primal feasibility and complementary slackness of the
   returned triple.

2. **The gate's objective yardstick**: eval/gate.ipm_best_response_batch0
   solves one agent batch's best-response QP with it (everyone else fixed
   at the solution being graded); the box rescue
   (qp/joint.rescue_box_batches) re-solves stalled batches with it.

Problem (one batch QP, qp/assemble.QPData, unscaled):

    min  1/2 x' Q x
    s.t. Aeq x = deq          per (agent, axis)          [E]
         lb <= x <= ub        per control point           [box]
         n_p . (x_j - x_i) >= rhs_p   per pair/ctrl-pt    [pair]

flattened to x in R^nx, nx = B*3*D, index (b, k, d) -> (b*3+k)*D + d.
Box + pair rows form one inequality block C x >= c.  Newton steps solve

    [Q + C' (lam/s) C] dx - E' dy = r1 ;  E dx = r2

by dense Cholesky of H = Q + C'WC and a Schur complement on E (E has
full row rank: independent endpoint/continuity rows).  All constraint
matrices are scipy.sparse; H assembly is sparse-times-sparse + dense Q
block-diagonal.

The public functions take a QPData whose leaves are numpy arrays or torch
tensors on any device: they move to host float64 at entry
(assemble.host_f64).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp

from .assemble import BIG, QPData, host_f64


@dataclass
class IPMResult:
    x: np.ndarray          # [B, 3, D] primal solution
    y: np.ndarray          # equality multipliers [ne]
    lam: np.ndarray        # inequality multipliers [mi] (>= 0)
    s: np.ndarray          # slacks [mi] (>= 0)
    iters: int
    mu: float
    r_dual: float
    r_eq: float
    r_ineq: float


def _dense_blocks(data: QPData):
    """numpy f64 views of the structured problem."""
    g = lambda a: np.asarray(a, dtype=np.float64)
    Qseg = g(data.Qseg)
    Aeq = g(data.Aeq)
    deq = g(data.deq)
    lb = g(data.lb)
    ub = g(data.ub)
    pair_n = g(data.pair_n)
    pair_rhs = g(data.pair_rhs)
    mask = np.asarray(data.pair_mask) > 0
    bi = np.asarray(data.pair_bi)
    bj = np.asarray(data.pair_bj)
    x0 = g(data.x0)
    return Qseg, Aeq, deq, lb, ub, pair_n, pair_rhs, mask, bi, bj, x0


def build_flat(data: QPData):
    """Flatten one QPData into (Q dense, E, d, C, c, x0) with C x >= c.

    Returns Q as a dense [nx, nx] (block-diagonal of the per-segment cost
    blocks), E and C as CSR.  Pair rows against fixed agents keep only the
    in-batch side (the fixed side is already folded into pair_rhs by
    qp/assemble.assemble_batch / refresh_from_dummy).
    """
    data = host_f64(data)
    Qseg, Aeq, deq, lb, ub, pair_n, pair_rhs, mask, bi, bj, x0 = \
        _dense_blocks(data)
    B, K3, D = lb.shape
    M, npp, _ = Qseg.shape
    Re = Aeq.shape[0]
    nx = B * K3 * D

    Q = np.zeros((nx, nx))
    Qbase = sla.block_diag(*[Qseg[m] for m in range(M)])  # [D, D]
    for bk in range(B * K3):
        Q[bk * D:(bk + 1) * D, bk * D:(bk + 1) * D] = Qbase

    E = sp.kron(sp.eye(B * K3), sp.csr_matrix(Aeq), format="csr")
    d = deq.reshape(-1)

    # inequalities: x >= lb, -x >= -ub, pair rows
    eye = sp.eye(nx, format="csr")
    C_parts = [eye, -eye]
    c_parts = [lb.reshape(-1), -ub.reshape(-1)]

    keep = np.nonzero(mask & (pair_rhs.min(axis=1) > -BIG / 2))[0]
    Pk = len(keep)
    if Pk:
        n_pd = np.repeat(pair_n[keep], npp, axis=1)       # [Pk, D, 3]
        row_id = np.broadcast_to(
            np.arange(Pk * D)[:, None], (Pk * D, 3)).reshape(Pk, D, 3)
        d_id = np.broadcast_to(np.arange(D)[None, :, None], (Pk, D, 3))
        k_id = np.broadcast_to(np.arange(3)[None, None, :], (Pk, D, 3))
        rows, cols, vals = [], [], []
        for side, b_of in ((+1.0, bj[keep]), (-1.0, bi[keep])):
            inb = b_of >= 0                                # [Pk]
            if not inb.any():
                continue
            col = (b_of[:, None, None] * 3 + k_id) * D + d_id
            sel = np.broadcast_to(inb[:, None, None], (Pk, D, 3))
            rows.append(row_id[sel])
            cols.append(col[sel])
            vals.append(side * n_pd[sel])
        Cp = sp.csr_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(Pk * D, nx))
        C_parts.append(Cp)
        c_parts.append(pair_rhs[keep].reshape(-1))
    C = sp.vstack(C_parts, format="csr")
    c = np.concatenate(c_parts)
    return Q, E, d, C, c, x0.reshape(-1)


def kkt_residuals(Q, E, d, C, c, x, y, lam, s):
    """Independent optimality check of a primal-dual triple.

    Returns (r_dual, r_eq, r_ineq, comp): stationarity
    ||Qx - E'y - C'lam||_inf, equality violation, inequality violation
    (positive part of c - Cx), and complementarity max |lam_i s_i|.
    """
    r_dual = np.abs(Q @ x - E.T @ y - C.T @ lam).max()
    r_eq = np.abs(E @ x - d).max() if d.size else 0.0
    r_ineq = np.maximum(c - C @ x, 0.0).max()
    comp = np.abs(lam * (C @ x - c)).max()
    return float(r_dual), float(r_eq), float(r_ineq), float(comp)


def solve_ipm(data: QPData, tol: float = 1e-9, max_iter: int = 60,
              verbose: bool = False) -> IPMResult:
    """Mehrotra predictor-corrector on one batch QP, float64."""
    data = host_f64(data)
    Q, E, d, C, c, x0 = build_flat(data)
    nx = Q.shape[0]
    ne = E.shape[0]
    mi = C.shape[0]

    x = x0.copy()
    y = np.zeros(ne)
    s = np.maximum(C @ x - c, 1.0)
    lam = np.ones(mi)
    ET = sp.csr_matrix(E.T)
    CT = sp.csr_matrix(C.T)
    E_d = np.asarray(E.todense())

    scale = max(1.0, np.abs(Q).max(), np.abs(c[np.abs(c) < BIG / 2]).max())

    it = 0
    mu = float(s @ lam / mi)
    for it in range(1, max_iter + 1):
        r_d = Q @ x - ET @ y - CT @ lam          # dual residual
        r_p = E @ x - d                          # equality residual
        r_c = C @ x - s - c                      # inequality residual

        conv = (np.abs(r_d).max() < tol * scale
                and np.abs(r_p).max() < tol * scale
                and np.abs(r_c).max() < tol * scale and mu < tol * scale)
        if conv:
            break

        W = lam / s                              # [mi]
        H = Q + (CT.multiply(W) @ C).toarray()
        # primal/dual regularization (standard in production barrier codes:
        # H is PSD but spans ~16 orders of magnitude at planner scale and
        # Cholesky pivots can round negative); escalate until it factors
        delta = 1e-11 * scale
        while True:
            try:
                cho = sla.cho_factor(H + delta * np.eye(nx), lower=True,
                                     check_finite=False)
                HiET = sla.cho_solve(cho, E_d.T, check_finite=False)
                S_schur = E_d @ HiET
                cho_s = sla.cho_factor(
                    S_schur + delta * np.eye(ne), lower=True,
                    check_finite=False)
                break
            except np.linalg.LinAlgError:
                delta *= 100.0
                if delta > 1e3 * scale:
                    raise

        def newton(rd, rp, rc, rsl):
            # eliminate dlam, ds:
            #   dlam = W (C dx + rc') + rsl / s, rc' = -rc, etc.
            # solve [H, -E'; E, 0] (dx, dy) = (g1, g2)
            g1 = -rd + CT @ (W * (-rc) + rsl / s)
            g2 = -rp
            # dx = Hinv (g1 + E' dy);  E dx = g2
            Hi_g1 = sla.cho_solve(cho, g1, check_finite=False)
            dy = sla.cho_solve(cho_s, E_d @ Hi_g1 - g2,
                               check_finite=False)
            dx = Hi_g1 - HiET @ dy
            dlam = rsl / s - W * (C @ dx + rc)
            ds = (rsl - s * dlam) / lam
            return dx, -dy, dlam, ds

        # predictor (affine scaling, sigma = 0)
        rsl_aff = -lam * s
        dx_a, dy_a, dlam_a, ds_a = newton(r_d, r_p, r_c, rsl_aff)

        def max_step(v, dv):
            m = dv < 0
            return 1.0 if not m.any() else min(1.0, (-v[m] / dv[m]).min())

        a_p = max_step(s, ds_a)
        a_d = max_step(lam, dlam_a)
        mu_aff = float((s + a_p * ds_a) @ (lam + a_d * dlam_a) / mi)
        sigma = (mu_aff / mu) ** 3 if mu > 0 else 0.0

        # corrector
        rsl = -lam * s - ds_a * dlam_a + sigma * mu
        dx, dy, dlam, ds = newton(r_d, r_p, r_c, rsl)

        eta = 0.995 if mu > 1e-8 * scale else 0.9999
        a_p = eta * max_step(s, ds)
        a_d = eta * max_step(lam, dlam)
        x += a_p * dx
        s += a_p * ds
        y += a_d * dy
        lam += a_d * dlam
        mu = float(s @ lam / mi)
        if verbose:
            print(f"  ipm it={it} mu={mu:.2e} rd={np.abs(r_d).max():.2e} "
                  f"rp={np.abs(r_p).max():.2e} a=({a_p:.2f},{a_d:.2f})")

    B, K3, D = np.asarray(data.lb).shape
    r_d = float(np.abs(Q @ x - ET @ y - CT @ lam).max())
    r_p = float(np.abs(E @ x - d).max()) if ne else 0.0
    r_c = float(np.maximum(c - C @ x, 0.0).max())
    return IPMResult(x=x.reshape(B, K3, D), y=y, lam=lam, s=s, iters=it,
                     mu=mu, r_dual=r_d, r_eq=r_p, r_ineq=r_c)


def _knot_maps_np(dt: np.ndarray, n: int, phi: int):
    """numpy f64 form of nullspace.knot_maps: [M, phi, phi] maps between a
    segment's first/last phi control points and its knot states, and
    their inverses (L, R, F0, FT)."""
    from ..core import bernstein

    A0, AT = bernstein.endpoint_derivative_matrices(n)
    dt = np.asarray(dt, np.float64)
    M = dt.shape[0]
    fall = []
    nn = 1.0
    for j in range(phi):
        fall.append(nn)
        nn *= (n - j)
    fall = np.asarray(fall)
    scale = fall[None, :] * dt[:, None] ** (-np.arange(phi))
    F0 = scale[:, :, None] * np.asarray(A0[:phi, :phi], np.float64)[None]
    FT = scale[:, :, None] * np.asarray(AT[:phi, n + 1 - phi:],
                                        np.float64)[None]
    L = np.linalg.inv(F0)
    R = np.linalg.inv(FT)
    return L, R, F0, FT


def _reduced_problem(data: QPData):
    """Eliminate the equalities exactly (knot-state parametrization
    x = x_pin + N w, the same closed form qp/nullspace.py uses, rebuilt
    here in numpy f64): returns (H, g, Cw csr, cw, Nfull csr, x_pin_flat,
    const) with the reduced program  min 1/2 w'Hw + g'w  s.t. Cw w >= cw.
    """
    Qseg, Aeq, deq, lb, ub, pair_n, pair_rhs, mask, bi, bj, x0 = \
        _dense_blocks(data)
    B, K3, D = lb.shape
    M, npp, _ = Qseg.shape
    phi = Aeq.shape[0] // (M + 1)
    if npp != 2 * phi:
        raise ValueError("reduced IPM needs n+1 == 2*phi")
    dt = np.asarray(data.dt, np.float64)
    L, R, F0, FT = _knot_maps_np(dt, npp - 1, phi)
    Mi = M - 1
    nw = Mi * phi

    # N (per agent/axis): control point (m, i<phi) <- knot m; (m, i>=phi)
    # <- knot m+1 (interior knots only)
    N = np.zeros((M, npp, Mi, phi))
    if Mi:
        for m in range(1, M):
            N[m, :phi, m - 1, :] = L[m]
            N[m - 1, phi:, m - 1, :] = R[m - 1]
    N = N.reshape(D, nw)

    # pinned-endpoint particular solution from deq
    s_all = np.zeros((B, K3, M + 1, phi))
    s_all[:, :, 0, :] = deq[:, :, :phi]
    s_all[:, :, M, :] = deq[:, :, phi:2 * phi]
    left = np.einsum("mij,bkmj->bkmi", L, s_all[:, :, :M])
    right = np.einsum("mij,bkmj->bkmi", R, s_all[:, :, 1:])
    x_pin = np.concatenate([left, right], axis=-1).reshape(B, K3, D)

    Q, E, d, C, c, x0f = build_flat(data)
    Nfull = sp.kron(sp.eye(B * K3), sp.csr_matrix(N), format="csr")
    x_pin_f = x_pin.reshape(-1)

    Qbase = Q[:D, :D]
    H_a = N.T @ (Qbase @ N)
    H = np.asarray(sla.block_diag(*([H_a] * (B * K3))))
    g = (Nfull.T @ (Q @ x_pin_f))
    Cw = (C @ Nfull).tocsr()
    cw = c - C @ x_pin_f
    const = 0.5 * x_pin_f @ (Q @ x_pin_f)
    return H, g, Cw, cw, Nfull, x_pin_f, const


def solve_ipm_reduced(data: QPData, tol: float = 1e-9, max_iter: int = 60,
                      verbose: bool = False) -> IPMResult:
    """Mehrotra predictor-corrector on the equality-eliminated program —
    the same barrier algorithm as solve_ipm, minus the per-iteration
    equality Schur complement (the knot-state elimination is exact, see
    qp/nullspace.py).  ~30-60x faster at batch scale; the returned triple
    is still verified in the ORIGINAL full space (verify_optimal works
    unchanged: equality duals are recovered by least squares at the end).
    """
    data = host_f64(data)
    H, g, Cw, cw, Nfull, x_pin_f, const = _reduced_problem(data)
    nwt = H.shape[0]
    mi = Cw.shape[0]
    CwT = sp.csr_matrix(Cw.T)

    w = np.zeros(nwt)
    s = np.maximum(Cw @ w - cw, 1.0)
    lam = np.ones(mi)
    scale = max(1.0, np.abs(H).max(),
                np.abs(cw[np.abs(cw) < BIG / 2]).max())

    it = 0
    mu = float(s @ lam / mi)
    for it in range(1, max_iter + 1):
        r_d = H @ w + g - CwT @ lam
        r_c = Cw @ w - s - cw
        conv = (np.abs(r_d).max() < tol * scale
                and np.abs(r_c).max() < tol * scale and mu < tol * scale)
        if conv:
            break

        W = lam / s
        Hn = H + (CwT.multiply(W) @ Cw).toarray()
        delta = 1e-11 * scale
        while True:
            try:
                cho = sla.cho_factor(Hn + delta * np.eye(nwt), lower=True,
                                     check_finite=False)
                break
            except np.linalg.LinAlgError:
                delta *= 100.0
                if delta > 1e3 * scale:
                    raise

        def newton(rd, rc, rsl):
            g1 = -rd + CwT @ (W * (-rc) + rsl / s)
            dw = sla.cho_solve(cho, g1, check_finite=False)
            dlam = rsl / s - W * (Cw @ dw + rc)
            ds = (rsl - s * dlam) / lam
            return dw, dlam, ds

        rsl_aff = -lam * s
        dw_a, dlam_a, ds_a = newton(r_d, r_c, rsl_aff)

        def max_step(v, dv):
            m = dv < 0
            return 1.0 if not m.any() else min(1.0, (-v[m] / dv[m]).min())

        a_p = max_step(s, ds_a)
        a_d = max_step(lam, dlam_a)
        mu_aff = float((s + a_p * ds_a) @ (lam + a_d * dlam_a) / mi)
        sigma = (mu_aff / mu) ** 3 if mu > 0 else 0.0

        rsl = -lam * s - ds_a * dlam_a + sigma * mu
        dw, dlam, ds = newton(r_d, r_c, rsl)

        eta = 0.995 if mu > 1e-8 * scale else 0.9999
        a_p = eta * max_step(s, ds)
        a_d = eta * max_step(lam, dlam)
        w += a_p * dw
        s += a_p * ds
        lam += a_d * dlam
        mu = float(s @ lam / mi)
        if verbose:
            print(f"  ipm-r it={it} mu={mu:.2e} "
                  f"rd={np.abs(r_d).max():.2e}")

    # back to full space + recover equality multipliers:
    #   E' y = Q x - C' lam  (least squares via the normal equations;
    #   E has full row rank)
    x = x_pin_f + Nfull @ w
    Q, E, d, C, c, _ = build_flat(data)
    rhs = Q @ x - C.T @ lam
    EET = (E @ E.T).toarray()
    y = sla.cho_solve(sla.cho_factor(EET, lower=True, check_finite=False),
                      E @ rhs, check_finite=False)

    B, K3, D = np.asarray(data.lb).shape
    r_d = float(np.abs(Q @ x - E.T @ y - C.T @ lam).max())
    r_p = float(np.abs(E @ x - d).max()) if d.size else 0.0
    r_c = float(np.maximum(c - C @ x, 0.0).max())
    # slacks in full space for verify_optimal's complementarity check
    s_full = C @ x - c
    return IPMResult(x=x.reshape(B, K3, D), y=y, lam=lam, s=s_full,
                     iters=it, mu=mu, r_dual=r_d, r_eq=r_p, r_ineq=r_c)


def verify_optimal(data: QPData, res: IPMResult, tol: float = 1e-6) -> dict:
    """Re-check the returned triple against the KKT conditions (built
    independently of the solve loop's internal state).  Returns the
    residual dict; raises AssertionError if any exceeds tol * scale."""
    data = host_f64(data)
    Q, E, d, C, c, _ = build_flat(data)
    r_dual, r_eq, r_ineq, comp = kkt_residuals(
        Q, E, d, C, c, res.x.reshape(-1), res.y, res.lam, res.s)
    scale = max(1.0, float(np.abs(res.x).max()))
    out = {"r_dual": r_dual, "r_eq": r_eq, "r_ineq": r_ineq, "comp": comp}
    for k, v in out.items():
        if not v < tol * scale:
            raise AssertionError(
                f"KKT {k}={v:.3e} exceeds {tol * scale:.1e}")
    return out
