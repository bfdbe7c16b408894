"""Batched OSQP-style ADMM solver for the Bernstein trajectory QP.

Replaces the reference's per-batch CPLEX solves (solveQP,
rbp_planner.hpp:111-206) with a first-order operator-splitting method:

  x+ = K^-1 (sigma x - q + A^T (rho.z - y))        (dense matmul or PCG)
  z+ = clip(alpha Ax+ + (1-alpha) z + y/rho, l, u)
  y+ = y + rho (alpha Ax+ + (1-alpha) z - z+)

where K = P + sigma I + A^T diag(rho) A is formed once per problem from the
structured blocks and inverted with a single Cholesky (dense mode), after
which every ADMM iteration is one matmul plus elementwise work; or kept as
the structured operator I (x) base + pair coupling and solved by Jacobi-
preconditioned CG (cg mode).  A and A^T are never materialized: they are
einsums and gathers over the equality/box/pair blocks (qp/assemble.py).

Problems are stacked on a leading axis (``solve_qp_batched``): the loop
runs until every problem has stopped, and a problem that has stopped keeps
its state (and its iteration count) while the others go on, as the JAX
package's batched while_loop does.  The knot-state solver (qp/nullspace)
shares the pair operator and coupling below.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.device import pin_ieee_fp32, resolve_device
from .assemble import BIG, QPData

#: the dtype in which the dense KKT inverse is computed, kept and applied,
#: whatever the problem's dtype.  The JAX package keeps it in the
#: problem's dtype; in float32 the rounding of the K^-1 rhs product then
#: sets a floor under every residual of a solve that runs to its iteration
#: cap: on the 64-agent forest's 4-agent batches the knot continuity sits
#: at 8e-4 to 3e-3 (the JAX package's plan on a CPU, the port's on a CPU
#: and on an H100), across tests/test_pipeline.py's 1e-3, and the plan
#: 0.3-0.75 m from the float64 one.  Kept and applied in float64, the
#: inverse holds the continuity under 2e-4 and the plan within 6 mm of
#: the float64 one (PERF.md).  A stacked float64 inverse takes 8 bytes an
#: entry.
KINV_DTYPE = torch.float64


@dataclass(frozen=True)
class ADMMSettings:
    rho: float = 0.1
    rho_eq_scale: float = 1e3  # equality rows get rho * this (OSQP-style)
    sigma: float = 1e-6
    alpha: float = 1.6
    max_iter: int = 2000
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    # separate absolute dual tolerance: this problem class (singular jerk
    # Hessian) converges fast in the primal and slowly in the dual; the
    # acceptance metrics (collisions, continuity, boxes) are all primal.
    # None -> use eps_abs.
    eps_dual_abs: float | None = None
    scaling: bool = True  # Ruiz equilibration (required for float32)
    # KKT linear-system strategy:
    #   "dense": explicit inverse, one [nx, nx] matmul per iteration —
    #            best for small batches, memory O(nx^2)
    #   "cg":    exploit K = I_{3B} (x) base + pointwise pair coupling
    #            (base is IDENTICAL for every agent and axis — Qseg, Aeq
    #            and the Ruiz scaling are all shared), preconditioned CG
    #            with base^-1 — memory O(D^2 + D*(3B)^2)
    kkt_solver: str = "dense"
    cg_iters: int = 12
    check_every: int = 25  # residual/termination check interval
    # adaptive rho fixes the slow dual convergence of this problem class
    # (singular jerk Hessian); rho excursions are clamped to keep the f32
    # preconditioner well-conditioned
    adaptive_rho: bool = False
    rho_min: float = 1e-2
    rho_max: float = 1e1


class Constr(NamedTuple):
    """A value per constraint row, grouped by block."""
    eq: torch.Tensor  # [..., B, 3, Re]
    box: torch.Tensor  # [..., B, 3, D]
    pair: torch.Tensor  # [..., P, D]


class SolveInfo(NamedTuple):
    iters: object  # int, or a tensor of one count per stacked problem
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    obj: torch.Tensor


class PairOp(NamedTuple):
    """Pair-constraint operator: the per-control-point normals [..., P, 3,
    D] (masked), each pair's two agents with their signed weights, and the
    signed agent selection S = C_j - C_i [..., P, B] (one-hot rows
    weighted by the pair mask).  The batch QPs' A and A^T multiply S (a
    few agents a batch); the knot-state solver's A x gathers by the agent
    indices instead (qp/nullspace._A_x)."""
    n_d: torch.Tensor  # [..., P, 3, D]
    S: torch.Tensor  # [..., P, B]
    bi: torch.Tensor  # [..., P] int64 agent of the pair's i side (-1 -> 0)
    bj: torch.Tensor  # [..., P] int64 agent of the pair's j side (-1 -> 0)
    ci: torch.Tensor  # [..., P] weight of the i side (0 where bi = -1)
    cj: torch.Tensor  # [..., P] weight of the j side (0 where bj = -1)


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
    """Signed agent selection S [..., P, B]: S[p, bj] = c_j, S[p, bi] =
    -c_i, the pair mask folded in (one-sided pairs keep one entry)."""
    B = data.lb.shape[-3]
    bi, bj, ci, cj = _pair_sides(data)
    S = data.lb.new_zeros((*bi.shape, B))
    S.scatter_add_(-1, bj[..., None], cj[..., None])
    S.scatter_add_(-1, bi[..., None], -ci[..., None])
    return S


def _pair_op(data) -> PairOp:
    M = data.pair_n.shape[-2]
    npp = data.lb.shape[-1] // M
    n_d = data.pair_n.repeat_interleave(npp, dim=-2)  # [..., P, D, 3]
    n_d = n_d.transpose(-1, -2) * data.pair_mask[..., None, None]
    bi, bj, ci, cj = _pair_sides(data)
    return PairOp(n_d=n_d.contiguous(), S=_selection(data), bi=bi, bj=bj,
                  ci=ci, cj=cj)


def _build_coupling(data) -> torch.Tensor:
    """Pair-constraint normal-equation coupling C [..., M, B3, B3], row
    index agent*3 + axis: C_m = sum_p (S_p (x) n_pm)(S_p (x) n_pm)^T, the
    A^T A of segment m's pair rows (rho NOT applied).  Contracted as
    U[m, p, (b, k)] = S[p, b] n[p, m, k] and one batched U_m^T U_m, so no
    [P, B, M, 3, B] intermediate (3.6 GB in float32 at 64 agents) is ever
    formed."""
    P, M = data.pair_n.shape[-3:-1]
    B = data.lb.shape[-3]
    S = _selection(data)
    U = torch.einsum("...pb,...pmk->...mpbk", S, data.pair_n)
    U = U.reshape(*U.shape[:-4], M, P, 3 * B)
    return U.transpose(-1, -2) @ U


def _bmm_view(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``a`` as [problems, rows, cols] (leading axes, if any, flattened)."""
    return a.reshape(-1, rows, cols)


def A_matvec(data: QPData, x: torch.Tensor, pop: PairOp) -> Constr:
    """A x for x [..., B, 3, D]: the equality rows Aeq x, the box rows x,
    the pair rows sum_k n_d[p, k, d] (S x)[p, k, d]."""
    *lead, B, K3, D = x.shape
    Re = data.Aeq.shape[-2]
    P = pop.n_d.shape[-3]
    eq = torch.bmm(_bmm_view(x, B * K3, D),
                   _bmm_view(data.Aeq, Re, D).transpose(1, 2))
    xs = torch.bmm(_bmm_view(pop.S, P, B), _bmm_view(x, B, K3 * D))
    pair = (xs.view(*pop.n_d.shape) * pop.n_d).sum(-2)
    return Constr(eq=eq.view(*lead, B, K3, Re), box=x, pair=pair)


def AT_matvec(data: QPData, y: Constr, pop: PairOp) -> torch.Tensor:
    """A^T y: Aeq^T y_eq + y_box + S^T (n_d y_pair)."""
    *lead, B, K3, D = y.box.shape
    Re = data.Aeq.shape[-2]
    P = pop.n_d.shape[-3]
    out = torch.baddbmm(_bmm_view(y.box, B * K3, D),
                        _bmm_view(y.eq, B * K3, Re),
                        _bmm_view(data.Aeq, Re, D))
    contrib = pop.n_d * y.pair[..., :, None, :]  # [..., P, 3, D]
    out = torch.baddbmm(out.view(-1, B, K3 * D),
                        _bmm_view(pop.S, P, B).transpose(1, 2),
                        _bmm_view(contrib, P, K3 * D))
    return out.view(y.box.shape)


def P_matvec(data: QPData, x: torch.Tensor) -> torch.Tensor:
    M, npp = data.Qseg.shape[-3:-1]
    xs = x.reshape(*x.shape[:-1], M, npp)
    return torch.einsum("...mij,...bkmj->...bkmi", data.Qseg,
                        xs).reshape(x.shape)


def _bounds(data: QPData) -> tuple[Constr, Constr]:
    l = Constr(eq=data.deq, box=data.lb, pair=data.pair_rhs)
    u = Constr(eq=data.deq, box=data.ub,
               pair=torch.full_like(data.pair_rhs, BIG))
    return l, u


def _rho_vec(data: QPData, s: ADMMSettings) -> Constr:
    return Constr(
        eq=torch.full_like(data.deq, s.rho * s.rho_eq_scale),
        box=torch.full_like(data.lb, s.rho),
        pair=torch.full_like(data.pair_rhs, s.rho),
    )


class KKTOperator(NamedTuple):
    """Either a dense inverse or the (base, coupling) structured operator.

    cg mode splits rho out so adaptive-rho updates only rebuild the tiny
    [D, D] preconditioner: base(rho) = base0 + rho * base1, and the pair
    coupling is stored unscaled (multiplied by rho at matvec time)."""
    Kinv: torch.Tensor | None  # [..., nx, nx] (dense mode; KINV_DTYPE)
    base0: torch.Tensor | None  # [..., D, D] blockdiag(Qseg) + sigma I
    base1: torch.Tensor | None  # [..., D, D] I + rho_eq_scale Aeq^T Aeq
    coupling: torch.Tensor | None  # [..., M, B3, B3] (cg, rho NOT applied)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _build_base_parts(data: QPData, s: ADMMSettings):
    """base(rho) = base0 + rho * base1, the per-(agent, axis) KKT block
    [D, D] — identical for every agent and axis."""
    *lead, M, npp, _ = data.Qseg.shape
    D = M * npp
    base0 = data.Qseg.new_zeros((*lead, M, npp, M, npp))
    base0.diagonal(dim1=-4, dim2=-2).copy_(data.Qseg.movedim(-3, -1))
    base0 = base0.reshape(*lead, D, D) + s.sigma * _eye(D, data.Qseg)
    base1 = (_eye(D, data.Qseg)
             + s.rho_eq_scale * data.Aeq.transpose(-1, -2) @ data.Aeq)
    return base0, base1


def build_kkt_operator(data: QPData, s: ADMMSettings) -> KKTOperator:
    """The KKT operator of ``data`` (scaled): the dense inverse (Cholesky
    of K, then cho_solve(K, I)) in KINV_DTYPE, or the cg parts (base0,
    base1, the unscaled coupling) in the problem's dtype, as the JAX
    package builds them."""
    *lead, M, npp, _ = data.Qseg.shape
    D = M * npp
    B3 = 3 * data.lb.shape[-3]

    if s.kkt_solver == "cg":
        base0, base1 = _build_base_parts(data, s)
        return KKTOperator(Kinv=None, base0=base0, base1=base1,
                           coupling=_build_coupling(data))

    data = _tree_map(
        lambda a: a.to(KINV_DTYPE) if a.is_floating_point() else a, data)
    base0, base1 = _build_base_parts(data, s)
    coupling = _build_coupling(data)
    # K[a, d, b, e] = delta_ab base[d, e] + delta_de rho coupling_d[d, a, b]
    base = base0 + s.rho * base1
    K = base.new_zeros((*lead, B3, D, B3, D))
    K.diagonal(dim1=-4, dim2=-2).copy_(base[..., None])
    coupling_d = (s.rho * coupling).repeat_interleave(npp, dim=-3)
    K.diagonal(dim1=-3, dim2=-1).add_(coupling_d.movedim(-3, -1))
    nx = B3 * D
    K = K.reshape(*lead, nx, nx)
    chol = torch.linalg.cholesky_ex(K).L
    Kinv = torch.cholesky_solve(_eye(nx, K).expand_as(K), chol)
    return KKTOperator(Kinv=Kinv, base0=None, base1=None, coupling=None)


def _spd_inv(A: torch.Tensor) -> torch.Tensor:
    """The inverse of symmetric positive definite matrices [..., n, n]
    (the KKT blocks base(rho)), through their Cholesky factors, in
    ``A``'s dtype."""
    return torch.cholesky_inverse(torch.linalg.cholesky_ex(A).L)


def _per_problem(v: torch.Tensor) -> torch.Tensor:
    """Per-problem values [L] shaped to broadcast over [L, B, 3, D]."""
    return v[:, None, None, None]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-problem inner product of [L, B, 3, D] blocks."""
    L = a.shape[0]
    return torch.bmm(a.reshape(L, 1, -1), b.reshape(L, -1, 1)).view(L)


def _kkt_matvec(op: KKTOperator, base: torch.Tensor,
                coupling_rho: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K(rho) @ x for the structured operator; x [L, B, 3, D], base [L, D,
    D], coupling_rho [L, M, B3, B3] (the coupling times each problem's
    rho)."""
    L, B, K3, D = x.shape
    M = coupling_rho.shape[1]
    out = torch.bmm(x.view(L, B * K3, D), base.transpose(1, 2))
    xm = x.view(L, B * K3, M, D // M).transpose(1, 2)  # [L, M, B3, npp]
    coup = torch.matmul(coupling_rho, xm)
    out.view(L, B * K3, M, D // M).add_(coup.transpose(1, 2))
    return out.view(x.shape)


def kkt_solve(op: KKTOperator, base: torch.Tensor | None,
              base_inv: torch.Tensor | None, coupling_rho, rhs: torch.Tensor,
              x0: torch.Tensor, s: ADMMSettings) -> torch.Tensor:
    """Solve K x = rhs for a stack of problems (rhs [L, B, 3, D]): dense
    inverse matmul (in the inverse's dtype), or preconditioned CG
    warm-started from the previous ADMM x-solution."""
    L = rhs.shape[0]
    if op.Kinv is not None:
        return torch.bmm(op.Kinv, rhs.reshape(L, -1, 1).to(op.Kinv.dtype)
                         ).to(rhs.dtype).view(rhs.shape)

    def precond(r):
        return torch.bmm(r.view(L, -1, r.shape[-1]),
                         base_inv.transpose(1, 2)).view(r.shape)

    def ratio(num, den):
        """num / den, num where den == 0 (JAX: num / where(den != 0, den,
        1))."""
        return _per_problem(torch.where(den != 0, num / den, num))

    x = x0
    r = rhs - _kkt_matvec(op, base, coupling_rho, x)
    z = precond(r)
    p = z
    rz = _dot(r, z)
    for _ in range(s.cg_iters):
        Kp = _kkt_matvec(op, base, coupling_rho, p)
        alpha = ratio(rz, _dot(p, Kp))
        x = torch.addcmul(x, alpha, p)
        r = torch.addcmul(r, alpha, Kp, value=-1)
        z = precond(r)
        rz_new = _dot(r, z)
        p = torch.addcmul(z, ratio(rz_new, rz), p)
        rz = rz_new
    return x


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of matching dataclasses / (named)
    tuples; None leaves stay None."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(t0):
        return dataclasses.replace(t0, **{
            f.name: _tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)})
    parts = [_tree_map(fn, *xs) for xs in zip(*trees)]
    return type(t0)(*parts) if hasattr(t0, "_fields") else tuple(parts)


def _prepare(data: QPData, s: ADMMSettings):
    """Per-problem setup: equilibration + the KKT operator (in dense mode
    the inverse: the memory- and FLOP-heavy phase)."""
    from .scaling import equilibrate

    if s.scaling:
        sdata, scal = equilibrate(data)
    else:
        sdata, scal = data, None
    return sdata, scal, build_kkt_operator(sdata, s)


def _prepare_stack(data: QPData, s: ADMMSettings, kkt_chunk: int):
    """``_prepare`` of a stack of problems, ``kkt_chunk`` problems at a
    time, so that the temporaries of the Cholesky and of cho_solve(K, I)
    (O(nx^2) per problem) never exist for the whole stack at once."""
    L = data.lb.shape[0]
    parts = [_prepare(_tree_map(lambda a: a[i:i + kkt_chunk], data), s)
             for i in range(0, L, kkt_chunk)]
    return _tree_map(lambda *xs: torch.cat(xs), *parts)


def _iterate(orig: QPData, data: QPData, scal, op: KKTOperator,
             s: ADMMSettings, init=None, return_state: bool = False):
    """Run the ADMM loop on a stack of L problems (a leading axis on every
    leaf of ``orig``, ``data``, ``scal`` and ``op``).

    init: optional (x [L, B, 3, D], z [L, rows], y [L, rows]) in the
    solver's scaled space, the state a previous call returned with
    return_state=True (z is re-clipped to this call's bounds).  The
    equilibration depends only on the problem's structure, not on its
    coupling rhs, so the state carries verbatim across Jacobi rounds.

    Every ``check_every`` iterations the residuals decide, per problem,
    whether it is done; the loop runs while any problem is not done and
    below ``max_iter``, and a problem that has stopped keeps its state and
    its count, so its result does not depend on what it was stacked with.
    One host sync per check.  The iterations keep z and y as one flat
    vector [L, rows] a problem (eq, box, pair rows end to end), so that
    each of their elementwise updates is one operation."""
    L = data.lb.shape[0]
    dt = data.lb.dtype
    dev = data.lb.device

    pop = _pair_op(data)
    pop_orig = _pair_op(orig)
    l, u = _bounds(data)
    sizes = [t[0].numel() for t in l]

    def flat(c: Constr) -> torch.Tensor:
        return torch.cat([t.reshape(L, -1) for t in c], 1)

    def unflat(v: torch.Tensor) -> Constr:
        return Constr(*(part.view(t.shape) for part, t in
                        zip(v.split(sizes, 1), l)))

    lf, uf = flat(l), flat(u)
    # each row's rho as a multiple of rho_s: equality rows rho_eq_scale
    rho_unit = flat(Constr(torch.full_like(l.eq, s.rho_eq_scale),
                           torch.ones_like(l.box), torch.ones_like(l.pair)))

    def unscale_x(xb):
        return xb * scal.d[:, None, None] if scal is not None else xb

    def unscale_y(yb: Constr) -> Constr:
        if scal is None:
            return yb
        c = _per_problem(scal.c)
        return Constr(eq=yb.eq * scal.e_eq[:, None, None] / c,
                      box=yb.box / (scal.d[:, None, None] * c),
                      pair=yb.pair * scal.pair_row / c[..., 0])

    def unscale_z(zb: Constr) -> Constr:
        if scal is None:
            return zb
        return Constr(eq=zb.eq / scal.e_eq[:, None, None],
                      box=zb.box * scal.d[:, None, None],
                      pair=zb.pair / scal.pair_row)

    def tmax(leaves) -> torch.Tensor:
        vals = [v.abs().flatten(1).amax(1) for v in leaves
                if v[0].numel() > 0]
        return (torch.stack(vals).amax(0) if vals
                else torch.zeros(L, dtype=dt, device=dev))

    adaptive = s.adaptive_rho and s.kkt_solver == "cg"
    rho0 = torch.full((L,), s.rho, dtype=dt, device=dev)
    if adaptive:
        # adaptive mode quantizes rho to a precomputed ladder of
        # preconditioners, so the loop holds no matrix inversion
        ladder = torch.as_tensor(
            np.logspace(np.log10(s.rho_min), np.log10(s.rho_max), 7),
            dtype=dt, device=dev)
        bases = op.base0[:, None] + ladder[:, None, None] * op.base1[:, None]
        base_invs = _spd_inv(bases)  # [L, R, D, D]
        rows = torch.arange(L, device=dev)

        def select(idx):
            return ladder[idx], bases[rows, idx], base_invs[rows, idx]

        rho_idx = torch.argmin((ladder.log() - rho0[:1].log()).abs())
        rho_idx = rho_idx.expand(L).clone()
    else:
        rho_idx = torch.zeros(L, dtype=torch.long, device=dev)
        if op.Kinv is None:
            base = op.base0 + rho0[:, None, None] * op.base1
            base_fixed = (base, _spd_inv(base))
        else:
            base_fixed = (None, None)

    def admm_step(x, z, y, x_t_prev, rho, base, base_inv, coupling_rho):
        rhs = torch.add(AT_matvec(data, unflat(rho * z - y), pop), x,
                        alpha=s.sigma)
        x_t = kkt_solve(op, base, base_inv, coupling_rho, rhs, x_t_prev, s)
        ax_t = flat(A_matvec(data, x_t, pop))
        x_new = torch.add(s.alpha * x_t, x, alpha=1 - s.alpha)
        v = torch.add(s.alpha * ax_t, z, alpha=1 - s.alpha).addcdiv_(y, rho)
        z_new = torch.clamp(v, lf, uf)
        return x_new, z_new, (v - z_new).mul_(rho), x_t

    def residuals(x, z, y):
        """Unscaled residuals + scaled tolerances (OSQP sec. 3.4 + 5.1)."""
        xu = unscale_x(x)
        yu = unscale_y(unflat(y))
        zu = unscale_z(unflat(z))
        ax = A_matvec(orig, xu, pop_orig)
        px = P_matvec(orig, xu)
        aty = AT_matvec(orig, yu, pop_orig)
        r_prim = tmax([a_ - zz for a_, zz in zip(ax, zu)])
        r_dual = tmax([px + aty])
        n_prim = torch.maximum(tmax(ax), tmax(zu))
        n_dual = torch.maximum(tmax([px]), tmax([aty]))
        return r_prim, r_dual, n_prim, n_dual

    def keep(active, new, old):
        a = active.reshape(-1, *([1] * (old.dim() - 1)))
        return torch.where(a, new, old)

    if init is None:
        x = data.x0.contiguous()
        z = torch.clamp(flat(A_matvec(data, x, pop)), lf, uf)
        y = torch.zeros_like(z)
    else:
        x, z, y = init
        z = torch.clamp(z, lf, uf)
    x_t = x
    it = torch.zeros(L, dtype=torch.long, device=dev)
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    eps_dual_abs = s.eps_abs if s.eps_dual_abs is None else s.eps_dual_abs
    while True:
        active = (it < s.max_iter) & ~done
        any_active, all_active = torch.stack(
            [active.any(), active.all()]).tolist()
        if not any_active:
            break
        if adaptive:
            rho_s, base, base_inv = select(rho_idx)
        else:
            rho_s = rho0
            base, base_inv = base_fixed
        rho = rho_s[:, None] * rho_unit
        coupling_rho = (None if op.coupling is None else
                        rho_s[:, None, None, None] * op.coupling)
        state = (x, z, y, x_t)
        for _ in range(s.check_every):
            state = admm_step(*state, rho, base, base_inv, coupling_rho)

        r_prim, r_dual, n_prim, n_dual = residuals(*state[:3])
        eps_prim = s.eps_abs + s.eps_rel * n_prim
        eps_dual = eps_dual_abs + s.eps_rel * n_dual
        done_new = (r_prim <= eps_prim) & (r_dual <= eps_dual)
        rho_idx_new = rho_idx
        if adaptive:
            # OSQP adaptive rho: balance normalized residuals, but only
            # jump when the imbalance exceeds 5x — continuous updates keep
            # perturbing the fixed point and stall convergence
            tiny = 1e-10
            ratio = torch.sqrt(
                (r_prim / n_prim.clamp(min=tiny))
                / (r_dual / n_dual.clamp(min=tiny)).clamp(min=tiny))
            rho_cand = (rho_s * ratio).clamp(s.rho_min, s.rho_max)
            change = (rho_cand > 5.0 * rho_s) | (rho_cand < rho_s / 5.0)
            cand_idx = torch.argmin(
                (ladder.log()[None] - rho_cand.log()[:, None]).abs(), dim=1)
            rho_idx_new = torch.where(done_new | ~change, rho_idx, cand_idx)

        if all_active:
            x, z, y, x_t = state
            done, rho_idx = done_new, rho_idx_new
        else:
            # a stopped problem keeps its state (the batched while_loop)
            x, z, y, x_t = (keep(active, n, o)
                            for n, o in zip(state, (x, z, y, x_t)))
            done = torch.where(active, done_new, done)
            rho_idx = torch.where(active, rho_idx_new, rho_idx)
        it = it + s.check_every * active

    r_prim, r_dual, _, _ = residuals(x, z, y)
    xu = unscale_x(x)
    obj = 0.5 * _dot(xu, P_matvec(orig, xu))
    info = SolveInfo(iters=it, r_prim=r_prim, r_dual=r_dual, obj=obj)
    if return_state:
        return xu, info, (x, z, y)
    return xu, info


def _on_device(data: QPData, device) -> QPData:
    """``data`` on the resolved ``device`` (None = the card), float32
    products pinned to IEEE there."""
    device = resolve_device(device)
    if device.type == "cuda":
        pin_ieee_fp32()
    return data.to(device)


def solve_qp(data: QPData, settings: ADMMSettings = ADMMSettings(),
             device=None):
    """Solve one QP on ``device`` (None = the card; raises without one:
    pass ``device="cpu"`` for the CPU).  Returns (x [B, 3, D], SolveInfo)
    with int iters and scalar tensors."""
    one = _tree_map(lambda a: a[None], _on_device(data, device))
    x, info = _iterate(one, *_prepare(one, settings), settings)
    return x[0], SolveInfo(int(info.iters[0]), info.r_prim[0],
                           info.r_dual[0], info.obj[0])


def solve_qp_batched(data: QPData, settings: ADMMSettings = ADMMSettings(),
                     kkt_chunk: int = 4, device=None):
    """Solve a stack of QPs: every QPData leaf has a leading batch axis.

    The KKT operators are built ``kkt_chunk`` problems at a time (the
    cho_solve(K, I) behind a dense inverse allocates O(nx^2) temporaries
    per problem); the ADMM iterations then run on the whole stack.
    Returns (x [L, B, 3, D], SolveInfo of [L] tensors)."""
    data = _on_device(data, device)
    return _iterate(data, *_prepare_stack(data, settings, kkt_chunk),
                    settings)
