"""The plans' quadratic programs as the benchmark defines them, and a
plain solver for them.

One program a group of agents of one map and one Jacobi round (the
upstream's RBPPlanner, rbp_planner.hpp:100-206, 351-688): the control
points x[b, k, d] of degree-n Bernstein segments (d = m (n+1) + i),

  minimise    sum over agents, axes, segments of ctrl' Q_base dt^(1-2 phi) ctrl
  subject to  start and goal states and C^(phi-1) continuity at the knots,
              each control point inside its segment's box,
              n . (x_j - x_i) >= r_i + r_j for each pair with a member in
              the group, at every control point of every segment; a pair's
              member outside the group is held at its dummy control points.

The solver eliminates the equalities with an orthonormal null-space basis
(the continuity and end states then hold to the rounding of the basis)
and runs Mehrotra's predictor-corrector interior-point method on the
inequalities: each Newton system over all the group's agents and axes
formed densely and factored by Cholesky.  It shares nothing with the
program's solvers (first-order splitting on the card), so a plan that
agrees with it is a solution of the stated program, not of the
program's own arithmetic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def bernstein_power(n: int) -> np.ndarray:
    """B[i, j]: the coefficient of s^(n-j) in the Bernstein polynomial
    B_i^n(s)."""
    B = np.zeros((n + 1, n + 1))
    for i in range(n + 1):
        for m in range(i, n + 1):
            B[i, n - m] = math.comb(n, i) * math.comb(n - i, m - i) \
                * (-1) ** (m - i)
    return B


def jerk_gram(n: int, phi: int) -> np.ndarray:
    """Q[i, j] = integral over [0, 1] of the phi-th derivatives of B_i^n and
    B_j^n."""
    der = bernstein_power(n)
    for _ in range(phi):
        new = np.zeros_like(der)
        for j in range(n):
            new[:, j + 1] = der[:, j] * (n - j)
        der = new
    pw = np.arange(n, -1, -1, dtype=np.float64)
    return np.einsum("ia,jb,ab->ij", der, der,
                     1.0 / (pw[:, None] + pw[None, :] + 1.0))


def equality_rows(T: np.ndarray, n: int, phi: int) -> np.ndarray:
    """[(M + 1) phi, M (n+1)]: the derivatives 0..phi-1 at the start and
    at the goal, then their jumps at each interior knot, on one axis of
    one agent's control points."""
    M, npp = len(T) - 1, n + 1
    dt = np.diff(T)

    def rows(r: int, at_end: bool) -> np.ndarray:
        # r-th derivative in time of a segment at s = 0 or s = 1
        w = np.zeros(npp)
        for k in range(r + 1):
            sign = (-1) ** k if at_end else (-1) ** (r - k)
            w[(n - k) if at_end else k] = sign * math.comb(r, k)
        return w * math.perm(n, r)

    A = np.zeros(((M + 1) * phi, M * npp))
    for r in range(phi):
        A[r, :npp] = rows(r, False) / dt[0] ** r
        A[phi + r, (M - 1) * npp:] = rows(r, True) / dt[-1] ** r
        for m in range(1, M):
            row = 2 * phi + phi * (m - 1) + r
            A[row, (m - 1) * npp:m * npp] = rows(r, True) / dt[m - 1] ** r
            A[row, m * npp:(m + 1) * npp] = -rows(r, False) / dt[m] ** r
    return A


def dummy_points(paths: np.ndarray, n: int, M: int) -> np.ndarray:
    """The upstream's build_dummy (rbp_planner.hpp:513-549): a segment's
    first half of control points at its start waypoint, the rest at its end
    waypoint.  [N, L, 3] -> [N, M, n+1, 3]."""
    N, L, _ = paths.shape
    half = (n + 1) // 2
    i0 = np.minimum(np.arange(M), L - 1)
    i1 = np.minimum(np.arange(M) + 1, L - 1)
    out = np.zeros((N, M, n + 1, 3))
    out[:, :, :half] = paths[:, i0, None, :]
    out[:, :, half:] = paths[:, i1, None, :]
    return out


def groups(N: int, size: int | None) -> list[np.ndarray]:
    """The upstream's setBatch: contiguous groups (None: one of all)."""
    size = N if size is None else size
    return [np.arange(s, min(s + size, N)) for s in range(0, N, size)]


@dataclass
class Problem:
    """One group's program, float64 tensors on one device."""
    agents: np.ndarray   # [B] global ids
    lb: torch.Tensor     # [A, D] (A = 3 B, a = 3 b + axis)
    ub: torch.Tensor
    deq: torch.Tensor    # [A, Re]
    sel: torch.Tensor    # [P, B] +1 on the j member, -1 on the i member
    nd: torch.Tensor     # [P, 3, D] each control point's plane normal
    rhs: torch.Tensor    # [P, D]


def build(T, seg_boxes, pair_idx, normals, start, goal, radius, group,
          dummy, n: int, phi: int, device) -> Problem:
    """The program of agents ``group`` against ``dummy`` [N, M, n+1, 3]."""
    npp, M = n + 1, len(T) - 1
    D, B = M * npp, len(group)
    f = dict(dtype=torch.float64, device=device)
    bx = np.repeat(seg_boxes[group], npp, axis=1)          # [B, D, 6]
    lb = bx[..., 0:3].transpose(0, 2, 1).reshape(3 * B, D)
    ub = bx[..., 3:6].transpose(0, 2, 1).reshape(3 * B, D)
    deq = np.zeros((B, 3, (M + 1) * phi))
    for r in range(min(phi, 3)):
        deq[:, :, r] = start[group, 3 * r:3 * r + 3]
        deq[:, :, phi + r] = goal[group, 3 * r:3 * r + 3]
    local = np.full(len(radius), -1)
    local[group] = np.arange(B)
    li, lj = local[pair_idx[:, 0]], local[pair_idx[:, 1]]
    keep = np.nonzero((li >= 0) | (lj >= 0))[0]
    li, lj = li[keep], lj[keep]
    P = len(keep)
    nrm = np.repeat(normals[keep], npp, axis=1)             # [P, D, 3]
    rhs = np.broadcast_to((radius[pair_idx[keep, 0]]
                           + radius[pair_idx[keep, 1]])[:, None],
                          (P, D)).copy()
    dm = dummy.reshape(dummy.shape[0], D, 3)
    fj, fi = lj < 0, li < 0
    rhs[fj] -= np.einsum("pdk,pdk->pd", nrm[fj], dm[pair_idx[keep, 1][fj]])
    rhs[fi] += np.einsum("pdk,pdk->pd", nrm[fi], dm[pair_idx[keep, 0][fi]])
    sel = np.zeros((P, B))
    sel[lj >= 0, lj[lj >= 0]] = 1.0
    sel[li >= 0, li[li >= 0]] = -1.0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), **f)  # noqa: E731
    return Problem(group, t(lb), t(ub), t(deq.reshape(3 * B, -1)), t(sel),
                   t(nrm.transpose(0, 2, 1)), t(rhs))


def pair_rows(sel: torch.Tensor, nd: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """[A, D] -> [P, D]: n . (x_j - x_i) at every control point (a
    Problem's ``sel`` and ``nd``)."""
    B, D = sel.shape[1], x.shape[-1]
    rel = sel @ x.reshape(B, 3 * D)
    return (rel.reshape(-1, 3, D) * nd).sum(-2)


class Solver:
    """Mehrotra's interior-point method on one group's program, in the null
    space of its equalities:

        min 1/2 z' P z + q' z   s.t.  C z - s = c,  s >= 0

    with x = xp + N z, C z = (N z, -N z, pair rows of N z) and c the
    bounds less their value at xp.  ``dtype`` is the precision of every
    vector and of the Newton matrix's operands; the Cholesky factorisation
    takes float32 where ``dtype`` is narrower, as no narrower one exists."""

    def __init__(self, pb: Problem, T, n: int, phi: int,
                 dtype=torch.float64):
        dev = pb.lb.device
        f64 = dict(dtype=torch.float64, device=dev)
        npp, M = n + 1, len(T) - 1
        dt = np.diff(np.asarray(T, np.float64))
        Qb = jerk_gram(n, phi)
        Q = np.zeros((M * npp, M * npp))
        for m in range(M):
            Q[m * npp:(m + 1) * npp, m * npp:(m + 1) * npp] = \
                Qb * dt[m] ** (1 - 2 * phi)
        Aeq = equality_rows(np.asarray(T, np.float64), n, phi)
        U, S, Vt = np.linalg.svd(Aeq)
        r = int((S > S[0] * 1e-12).sum())
        self.Qblk = torch.as_tensor(Q, **f64)
        N = torch.as_tensor(Vt[r:].T, **f64)                   # [D, F]
        pinv = Vt[:r].T @ np.diag(1.0 / S[:r]) @ U[:, :r].T    # [D, Re]
        self.xp = pb.deq @ torch.as_tensor(pinv.T, **f64)      # [A, D]
        Pr = 2 * N.T @ self.Qblk @ N
        q = 2 * (self.xp @ self.Qblk @ N)
        # the objective scaled to a unit gradient at xp, so that the
        # tolerance on the duality measure is relative
        scale = max(float(q.abs().max()), 1e-300)
        self.pb, self.dtype, self.N64 = pb, dtype, N
        c = lambda a: a.to(dtype)  # noqa: E731
        self.N, self.P = c(N), c(Pr / scale)
        self.q = c(q / scale)                                   # [A, F]
        self.c_lo = c(pb.lb - self.xp)
        self.c_hi = c(self.xp - pb.ub)
        self.c_pair = c(pb.rhs - pair_rows(pb.sel, pb.nd, self.xp))
        self.sel, self.nd = c(pb.sel), c(pb.nd)
        A, D = self.xp.shape
        self.A_, self.D_, self.F_ = A, D, N.shape[1]
        self.NN = c((N[:, :, None] * N[:, None, :]).reshape(D, -1))

    def _pair_t(self, v):
        w = (self.nd * v[:, None, :]).reshape(v.shape[0], -1)
        return (self.sel.T @ w).reshape(self.A_, self.D_)

    def _C(self, z):
        x = z @ self.N.T
        return x, -x, pair_rows(self.sel, self.nd, x)

    def _Ct(self, lo, hi, pr):
        return (lo - hi + self._pair_t(pr)) @ self.N

    def _newton(self, w_lo, w_hi, w_pr):
        """The Cholesky factor of P (x) I + C' W C."""
        A, F, D = self.A_, self.F_, self.D_
        P_, B = self.sel.shape
        lin = torch.float64 if self.dtype == torch.float64 else torch.float32
        V = (self.sel[:, :, None, None] * self.nd[:, None]).reshape(P_, A, D)
        Vw = V * w_pr[:, None, :]
        G = torch.bmm(Vw.permute(2, 1, 0), V.permute(2, 0, 1))  # [D, A, A]
        H = (self.NN.T @ G.reshape(D, A * A)).to(lin)
        H = H.reshape(F, F, A, A).permute(2, 0, 3, 1).reshape(A * F, A * F)
        box = torch.einsum("df,ad,dg->afg", self.N, w_lo + w_hi,
                           self.N).to(lin)
        H.view(A, F, A, F).diagonal(0, 0, 2).add_(
            (box + self.P.to(lin)).permute(1, 2, 0))
        return torch.linalg.cholesky(H)

    def solve(self, max_iter: int = 80, tol: float = 1e-13):
        """Returns (x [A, D] float64, information)."""
        A, F = self.A_, self.F_
        z = torch.zeros(A, F, dtype=self.dtype, device=self.q.device)
        cs = (self.c_lo, self.c_hi, self.c_pair)
        m = sum(v.numel() for v in cs)
        s = [torch.ones_like(v) for v in cs]
        lam = [torch.ones_like(v) for v in cs]
        best, best_merit, info, best_state = z, float("inf"), {}, None
        for it in range(1, max_iter + 1):
            Cz = self._C(z)
            r_d = z @ self.P + self.q - self._Ct(*lam)
            r_p = [a - si - ci for a, si, ci in zip(Cz, s, cs)]
            mu = sum(float((si * li).sum()) for si, li in zip(s, lam)) / m
            rp = max(float(v.abs().max()) for v in r_p)
            rd = float(r_d.abs().max())
            merit = max(mu, rp, rd)
            if not math.isfinite(merit) or merit > 10 * best_merit:
                break
            if merit < best_merit:
                best, best_merit, best_state = z, merit, (z, s, lam)
                info = {"iters": it - 1, "mu": mu, "r_prim": rp,
                        "r_dual": rd}
            if merit < tol:
                break
            w = [li / si for li, si in zip(lam, s)]
            try:
                L = self._newton(*w)
            except torch.linalg.LinAlgError:
                break
            lin = L.dtype

            def step(r_c):
                rhs = -r_d - self._Ct(*[(rc + li * rpi) / si for rc, li, rpi,
                                        si in zip(r_c, lam, r_p, s)])
                dz = torch.zeros_like(rhs)
                for _ in range(3):
                    # iterative refinement against the unfactored matrix
                    res = rhs - dz @ self.P - self._Ct(*[
                        wi * cd for wi, cd in zip(w, self._C(dz))])
                    dz = dz + torch.cholesky_solve(
                        res.reshape(-1, 1).to(lin), L).reshape(A, F).to(
                            self.dtype)
                Cd = self._C(dz)
                ds = [cd + rpi for cd, rpi in zip(Cd, r_p)]
                dl = [-(rc + li * dsi) / si for rc, li, dsi, si in
                      zip(r_c, lam, ds, s)]
                return dz, ds, dl

            def longest(v, dv):
                neg = dv < 0
                if not bool(neg.any()):
                    return 1.0
                return min(1.0, float((-v[neg] / dv[neg]).min()))

            dz, ds, dl = step([si * li for si, li in zip(s, lam)])
            a = min([longest(si, d) for si, d in zip(s, ds)]
                    + [longest(li, d) for li, d in zip(lam, dl)])
            mu_aff = sum(float(((si + a * dsi) * (li + a * dli)).sum())
                         for si, dsi, li, dli in zip(s, ds, lam, dl)) / m
            sig = min(1.0, (mu_aff / mu) ** 3)
            r_c = [si * li + dsi * dli - sig * mu for si, li, dsi, dli in
                   zip(s, lam, ds, dl)]
            dz, ds, dl = step(r_c)
            a = 0.99 * min([longest(si, d) for si, d in zip(s, ds)]
                           + [longest(li, d) for li, d in zip(lam, dl)])
            z = z + a * dz
            s = [si + a * d for si, d in zip(s, ds)]
            lam = [li + a * d for li, d in zip(lam, dl)]
        if self.dtype == torch.float64 and best_state is not None:
            z_pol = self._polish(*best_state)
            if z_pol is not None:
                best = z_pol
                info["polished"] = True
        if self.dtype == torch.float64:
            x = self.xp + best @ self.N64.T
        else:
            x = (self.xp.to(self.dtype) + best @ self.N.T).to(torch.float64)
        return x, info

    def _rows(self, kind: int, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` of one block of C as dense [n, A, F] (kind 0: lower
        box bounds, 1: upper, 2: pair rows)."""
        A, F, D = self.A_, self.F_, self.D_
        out = torch.zeros(len(idx), A, F, dtype=self.N.dtype,
                          device=self.N.device)
        r = torch.arange(len(idx), device=idx.device)
        if kind < 2:
            a, d = idx // D, idx % D
            out[r, a] = self.N[d] * (1.0 if kind == 0 else -1.0)
            return out
        p, d = idx // D, idx % D
        B = self.sel.shape[1]
        coef = self.sel[p][:, :, None] * self.nd[p, :, d][:, None, :]
        out.view(len(idx), B, 3, F).add_(coef[..., None]
                                         * self.N[d][:, None, None, :])
        return out

    def _polish(self, z, s, lam, tol: float = 1e-9):
        """The exact optimum on the active set that the interior point
        method points at (the constraints whose multiplier passes their
        slack): the equality-constrained program solved through its Schur
        complement, kept only where every multiplier is non-negative and
        every other constraint holds."""
        act = [torch.nonzero((li > si).reshape(-1)).reshape(-1)
               for si, li in zip(s, lam)]
        if sum(len(a) for a in act) == 0:
            return None
        C = torch.cat([self._rows(k, a) for k, a in enumerate(act)])
        c = torch.cat([ci.reshape(-1)[a] for ci, a in
                       zip((self.c_lo, self.c_hi, self.c_pair), act)])
        n, A, F = C.shape[0], self.A_, self.F_
        Pinv = torch.linalg.inv(self.P)
        CP = torch.einsum("naf,fg->nag", C, Pinv).reshape(n, -1)
        Cf = C.reshape(n, -1)
        S = CP @ Cf.T
        rhs = c + CP @ self.q.reshape(-1)
        lam_a = torch.linalg.lstsq(S, rhs[:, None]).solution[:, 0]
        z_p = ((lam_a @ Cf).reshape(A, F) - self.q) @ Pinv
        if float(lam_a.min()) < -tol * max(float(lam_a.abs().max()), 1.0):
            return None
        if float((S @ lam_a - rhs).abs().max()) > tol:
            return None
        Cz = self._C(z_p)
        worst = max(float((ci - v).max()) for v, ci in
                    zip(Cz, (self.c_lo, self.c_hi, self.c_pair)))
        return z_p if worst <= tol else None
