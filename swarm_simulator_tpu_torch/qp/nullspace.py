"""Knot-state (equality-eliminated) ADMM — the production trajectory solver.

PyTorch port of the schedule path of the JAX package's qp/nullspace.py.
For the canonical n + 1 == 2*phi case (n=5, phi=3) every Bernstein control
point is an affine function of exactly one knot state (the derivative
values at a knot):

    c[m, 0:phi]  = L[m] @ s[m]        (segment start)
    c[m, phi: ]  = R[m] @ s[m+1]      (segment end)

so the continuity and endpoint equalities hold by construction and the
free variables are the interior knot states w (x = x_pin + N w).  The
reduced KKT matrix is block-tridiagonal over knots with [3B phi]^2
blocks; the host prep (prepare_ns_np) factors it in float64 once per rho
rung, or the device prep (prepare_ns) in the data's dtype on its device,
and the ADMM loop only applies the stored pivot inverses.

What is ported: NSSettings/NSOp, the knot maps, the host-f64 and the
device banded preps (flat pivots), the host refresh of a replan's
endpoint leaves (refresh_ns_op_np), the constraint applies and bounds,
the banded Thomas solve (make_kinv_apply over ops/thomas), and the phased
schedule loop (solve_ns_schedule).  A chunk of check_every iterations runs
one of two ways, both reaching a hand-written CUDA kernel for CUDA
tensors and a plain twin otherwise:
  kkt_refine == 0  one ops/nsfused chunk (the fused kernel);
  kkt_refine >= 1  check_every torch ADMM steps whose w-update is a PCG
                   against the FRESH operator (K_fresh), preconditioned by
                   the rung inventory: 2 + kkt_refine ops/thomas solves
                   per step.
The loop is a Python loop; the termination test after each chunk is one
host sync.

The bf16 preconditioner (NSSettings.precond_dtype="bfloat16"): both
preps round the rung inventory to bf16 (K2 reads it, widening each pivot
at the multiply); legal only with kkt_refine >= 1, where the PCG against
the float32 K_fresh absorbs the ~8-bit mantissa.  The fused chunk (K1)
refuses such an inventory.

Not ported yet: the dense KKT mode and Anderson acceleration.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import bernstein
from ..ops import nsfused, thomas
from .admm import PairOp, SolveInfo, _build_coupling, _pair_op
from .assemble import BIG, KNOT_FACE_GUARD, QPData


@dataclass(frozen=True)
class NSSettings:
    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    max_iter: int = 1500
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    eps_dual_abs: float | None = None
    check_every: int = 50
    # rho ladder (adaptive): quantized rungs of precomputed KKT pivot
    # inverses, RELATIVE to the cost-normalized problem (see
    # _host_prep_ctx_np c_s)
    adaptive_rho: bool = True
    rho_min: float = 1e-3
    rho_max: float = 1e1
    n_rungs: int = 7
    adapt_threshold: float = 5.0
    # fence which rungs a phase may visit without re-preparing the op
    rho_lo: float | None = None
    rho_hi: float | None = None
    # "smooth": w = 0 (the equality-pinned minimum-jerk trajectory);
    # "x0": project data.x0 onto the knot states
    warm_start: str = "smooth"
    # constraint tightening (meters): keeps the TRUE constraints
    # satisfied while the first-order solve's violation stays below it
    tighten: float = 0.0
    # preconditioned-CG steps on each w-update against the FRESH KKT
    # operator (matrix-free from the problem data), with the rung
    # inventory as preconditioner: 0 trusts the inventory (exact when it
    # was prepared in float64 for this data); replans on a device-prepped
    # or stale inventory run 1
    kkt_refine: int = 0
    # storage dtype of the rung inventory: "bfloat16" halves the pivot
    # stream of every Thomas solve (K2 reads bf16 pivots); legal ONLY as a
    # preconditioner, with kkt_refine >= 1 (checked at prep)
    precond_dtype: str = "float32"


class NSConstr(NamedTuple):
    box: torch.Tensor   # [B, 3, D]
    pair: torch.Tensor  # [P, D]


class NSOp(NamedTuple):
    """Static per-problem pieces.  Host prep returns numpy leaves;
    ``to(device)`` moves them (one bulk transfer of the pivot inventory)."""
    N: object        # [D, nw] knot-state -> control-point map
    x_pin: object    # [B, 3, D] contribution of the pinned endpoints
    g: object        # [B, 3, nw] linear cost term c_s N^T Q x_pin
    F0: object       # [M, phi, phi] ctrl -> knot state (left)
    FT: object       # [M, phi, phi] ctrl -> knot state (right)
    c_s: object      # scalar cost normalization
    ladder: object   # [R] rho rungs
    Dinvs: object    # [R, Mi, bs, bs] pivot-block inverses (flat)
    # off-diagonal blocks are I_B3 (x) Ho with Ho [phi, phi] per knot
    Kos: object      # [Mi-1, phi, phi]

    def to(self, device) -> "NSOp":
        return NSOp(*(v.to(device) if isinstance(v, torch.Tensor)
                      else torch.as_tensor(np.asarray(v), device=device)
                      for v in self))


def check_precond(s: NSSettings) -> None:
    """The conditions of NSSettings.precond_dtype: "float32" or
    "bfloat16", and bf16 pivots only as a preconditioner (kkt_refine >= 1:
    the refine chunks solve through ops/thomas, whose K2 reads them)."""
    if s.precond_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"precond_dtype {s.precond_dtype!r}: expected "
                         "'float32' or 'bfloat16'")
    if s.precond_dtype == "bfloat16" and s.kkt_refine < 1:
        raise ValueError(
            "precond_dtype='bfloat16' is only a PRECONDITIONER: it requires "
            "kkt_refine >= 1 (fresh-operator PCG absorbs the ~8-bit "
            "mantissa)")


def pin_ieee_fp32() -> None:
    """Full-precision float32 products: the rung inverses have condition
    numbers near 1/rho_min, and TF32's ~10-bit mantissa wrecks them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def knot_maps(dt: np.ndarray, n: int, phi: int):
    """(L, R, F0, FT) in host float64: per-segment affine maps between the
    phi boundary control points and the knot state (derivative orders
    0..phi-1).  F0[m][j, i] = fall(n, j) dt_m^-j A0[j, i] (rows of
    build_aeq), L = F0^-1; likewise FT/R at the segment end.  Requires
    n+1 == 2*phi."""
    A0, AT = bernstein.endpoint_derivative_matrices(n)
    dt = np.asarray(dt, np.float64)
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


def _build_N(L: np.ndarray, R: np.ndarray, n: int, phi: int) -> np.ndarray:
    """Dense map N [D, (M-1)*phi]: x = x_pin + N @ w (shared per agent/axis).

    Control point (m, i<phi) belongs to knot m (interior index m-1);
    (m, i>=phi) to knot m+1 (interior index m)."""
    M = L.shape[0]
    npp = n + 1
    Mi = M - 1
    N = np.zeros((M, npp, Mi, phi))
    for m in range(1, M):
        N[m, :phi, m - 1, :] = L[m]
        N[m - 1, phi:, m - 1, :] = R[m - 1]
    return N.reshape(M * npp, Mi * phi)


def _x_pin_np(deq: np.ndarray, L: np.ndarray, R: np.ndarray,
              phi: int) -> np.ndarray:
    """Pinned-endpoint trajectory [B, 3, D] in host float64: the interior
    knot states 0, the first and last knot states from deq."""
    B = deq.shape[0]
    M = L.shape[0]
    s_all = np.zeros((B, 3, M + 1, phi))
    s_all[:, :, 0, :] = deq[:, :, :phi]
    s_all[:, :, M, :] = deq[:, :, phi:2 * phi]
    left = np.einsum("mij,bkmj->bkmi", L, s_all[:, :, :M])
    right = np.einsum("mij,bkmj->bkmi", R, s_all[:, :, 1:])
    return np.concatenate([left, right], axis=-1).reshape(B, 3, -1)


def _apply_Qseg(Qseg: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """blockdiag(Qseg) @ v along the last (D) axis."""
    M, npp, _ = Qseg.shape
    shape = v.shape
    vs = v.reshape(shape[:-1] + (M, npp))
    out = torch.einsum("mij,...mj->...mi", Qseg, vs)
    return out.reshape(shape)


def _inv_spd_np(S):
    """Inverse of a symmetric positive-definite matrix via Cholesky
    (LAPACK potrf+potri), falling back to LU if the factorization fails.
    The result is EXACTLY symmetric (potri fills one triangle, mirrored)."""
    from scipy.linalg.lapack import dpotrf, dpotri

    c, info = dpotrf(S, lower=1, overwrite_a=0)
    if info != 0:
        x = np.linalg.inv(S)
        return 0.5 * (x + x.T)
    x, info = dpotri(c, lower=1, overwrite_c=1)
    if info != 0:
        x = np.linalg.inv(S)
        return 0.5 * (x + x.T)
    return x + np.tril(x, -1).T


class _blas_single_threaded:
    """Pin BLAS pools to one thread for the scope (no-op without
    threadpoolctl): the prep runs one rung per worker thread, and BLAS's
    own threading at [576, 576] block sizes only adds contention."""

    def __enter__(self):
        try:
            from threadpoolctl import threadpool_limits
        except ImportError:
            self._ctx = None
        else:
            self._ctx = threadpool_limits(limits=1)
        return self

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
        return False


def _banded_kd_builder_np(Qseg, L, R, C, c_s, sigma):
    """Host builder of the banded KKT's [bs, bs] diagonal blocks:
    returns (make_Kd(k, rho), Ho [Mi-1, phi, phi], bs).  Kd is formed per
    (rung, knot) as one transient."""
    M, npp, _ = Qseg.shape
    phi = npp // 2
    B3 = C.shape[-1]
    WL = np.einsum("mia,mib->mab", L, L)
    WR = np.einsum("mia,mib->mab", R, R)
    Q00 = np.einsum("mia,mij,mjb->mab", L, Qseg[:, :phi, :phi], L)
    Q11 = np.einsum("mia,mij,mjb->mab", R, Qseg[:, phi:, phi:], R)
    Q01 = np.einsum("mia,mij,mjb->mab", L, Qseg[:, :phi, phi:], R)
    Hd = c_s * (Q00[1:M] + Q11[0:M - 1])
    NtN_k = WL[1:M] + WR[0:M - 1]
    Ho = c_s * Q01[1:M - 1]
    bs = B3 * phi
    sigI = sigma * np.eye(phi)
    Hds = Hd + sigI                     # [Mi, phi, phi]
    C1, C0 = C[1:M], C[0:M - 1]         # [Mi, B3, B3]
    WL1, WR0 = WL[1:M], WR[0:M - 1]     # [Mi, phi, phi]
    diag_idx = np.arange(B3)

    def make_Kd(k, rho):
        K4 = C1[k][:, None, :, None] * (rho * WL1[k])[None, :, None, :]
        K4 += C0[k][:, None, :, None] * (rho * WR0[k])[None, :, None, :]
        K4[diag_idx, :, diag_idx, :] += Hds[k] + rho * NtN_k[k]
        return K4.reshape(bs, bs)

    return make_Kd, Ho, bs


def _host_prep_ctx_np(data: QPData, s: NSSettings) -> dict:
    """Host-f64 front of the banded prep: knot maps, null-space map N,
    pinned trajectory, cost normalization, rho ladder, and the pair
    coupling C.  ``data`` holds host numpy leaves."""
    from concurrent.futures import ThreadPoolExecutor
    import os

    if data.dt is None:
        raise ValueError("QPData.dt required for the knot-state solver")
    Qseg = np.asarray(data.Qseg, np.float64)
    M, npp, _ = Qseg.shape
    n = npp - 1
    phi = np.asarray(data.Aeq).shape[0] // (M + 1)
    if npp != 2 * phi:
        raise ValueError("knot-state formulation needs n+1 == 2*phi")
    D = M * npp
    lb = np.asarray(data.lb)
    B = lb.shape[0]
    B3 = 3 * B
    dt_ = lb.dtype

    L, R, F0, FT = knot_maps(np.asarray(data.dt), n, phi)
    Mi = M - 1
    nw = Mi * phi
    N = _build_N(L, R, n, phi)

    x_pin = _x_pin_np(np.asarray(data.deq, np.float64), L, R, phi)

    def apply_Q(v):
        vs = v.reshape(v.shape[:-1] + (M, npp))
        return np.einsum("mij,...mj->...mi", Qseg, vs).reshape(v.shape)

    H_raw = N.T @ apply_Q(N.T).T
    c_s = 1.0 / np.clip(np.mean(np.max(np.abs(H_raw), axis=0)), 1e-12, None)
    g = c_s * np.einsum("da,bkd->bka", N, apply_Q(x_pin))

    if s.adaptive_rho:
        ladder = np.logspace(np.log10(s.rho_min), np.log10(s.rho_max),
                             s.n_rungs)
    else:
        ladder = np.asarray([s.rho], np.float64)

    n_workers = min(4, os.cpu_count() or 1)

    # pair coupling [M, B3, B3]: C_m = A_m^T A_m, accumulated from the
    # four 3x3 agent-block contributions of each pair
    pm = np.asarray(data.pair_mask, np.float64)
    bi = np.asarray(data.pair_bi)
    bj = np.asarray(data.pair_bj)
    pn = np.asarray(data.pair_n, np.float64)        # [P, M, 3]
    wj = (bj >= 0) * pm
    wi = -((bi >= 0) * pm)
    ji = np.clip(bj, 0, None)
    ii = np.clip(bi, 0, None)
    wjj, wii, wij = wj * wj, wi * wi, wi * wj
    C = np.zeros((M, B3, B3))

    def fill_C(m):
        Gp = pn[:, m, :, None] * pn[:, m, None, :]    # [P, 3, 3]
        C4 = np.zeros((B, B, 3, 3))
        np.add.at(C4, (ji, ji), wjj[:, None, None] * Gp)
        np.add.at(C4, (ii, ii), wii[:, None, None] * Gp)
        Gij = wij[:, None, None] * Gp
        np.add.at(C4, (ii, ji), Gij)
        np.add.at(C4, (ji, ii), Gij)
        C[m] = C4.transpose(0, 2, 1, 3).reshape(B3, B3)

    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        list(ex.map(fill_C, range(M)))

    return dict(Qseg=Qseg, M=M, npp=npp, phi=phi, D=D, B=B, B3=B3,
                dt_=dt_, L=L, R=R, F0=F0, FT=FT, Mi=Mi, nw=nw, N=N,
                x_pin=x_pin, c_s=c_s, g=g, ladder=ladder, C=C,
                n_workers=n_workers)


def prepare_ns_np(data: QPData, s: NSSettings) -> NSOp:
    """Host float64 banded-KKT prep; leaves cast once to the problem dtype.

    The rung pivot inverses are the one prep quantity whose float32
    computation measurably degrades solution quality, so the Schur chain
    runs in float64 and each block is rounded once.  Pivots stay FLAT
    [R, Mi, bs, bs], row index (agent*3 + axis)*phi + derivative order.
    With s.precond_dtype="bfloat16" the pivots are rounded once more, from
    the problem dtype to bf16 (round to nearest even, as the JAX package's
    two casts do), into a CPU torch tensor (numpy has no bf16)."""
    from concurrent.futures import ThreadPoolExecutor

    check_precond(s)
    ctx = _host_prep_ctx_np(data, s)
    Qseg, phi = ctx["Qseg"], ctx["phi"]
    B3, dt_, Mi = ctx["B3"], ctx["dt_"], ctx["Mi"]
    L, R, F0, FT = ctx["L"], ctx["R"], ctx["F0"], ctx["FT"]
    N, x_pin, c_s, g = ctx["N"], ctx["x_pin"], ctx["c_s"], ctx["g"]
    ladder, C, n_workers = ctx["ladder"], ctx["C"], ctx["n_workers"]

    make_Kd, Ho, bs = _banded_kd_builder_np(Qseg, L, R, C, c_s, s.sigma)
    Dinvs = np.zeros((len(ladder), Mi, bs, bs), dtype=dt_)

    def fill_rung(r):
        rho = ladder[r]
        Dprev = _inv_spd_np(make_Kd(0, rho))
        Dinvs[r, 0] = Dprev
        for k in range(1, Mi):
            # sandwich (I (x) Ho)^T Dprev (I (x) Ho) as [B3, B3]-batched
            # phi x phi matmuls
            D4 = Dprev.reshape(B3, phi, B3, phi).transpose(0, 2, 1, 3)
            s4 = Ho[k - 1].T @ D4 @ Ho[k - 1]
            sand = s4.transpose(0, 2, 1, 3).reshape(bs, bs)
            Dprev = _inv_spd_np(make_Kd(k, rho) - sand)
            Dinvs[r, k] = Dprev

    # one worker per rung (mild oversubscription of the BLAS-pinned
    # chains beats a straggler round)
    rung_workers = (len(ladder) if len(ladder) <= n_workers + 2
                    else n_workers)
    with _blas_single_threaded():
        with ThreadPoolExecutor(max_workers=rung_workers) as ex:
            list(ex.map(fill_rung, range(len(ladder))))

    def cast(v):
        return np.asarray(v).astype(dt_, copy=False)

    if s.precond_dtype == "bfloat16":
        Dinvs = torch.from_numpy(Dinvs).to(torch.bfloat16)
    return NSOp(N=cast(N), x_pin=cast(x_pin), g=cast(g), F0=cast(F0),
                FT=cast(FT), c_s=cast(c_s), ladder=cast(ladder),
                Dinvs=Dinvs, Kos=cast(Ho))


def refresh_ns_op_np(op: NSOp, data: QPData) -> NSOp:
    """Host refresh of the endpoint-dependent leaves (x_pin, g) for a
    replan that keeps the time grid (same M and dt, checked through F0)
    and reuses the prepared rung inventory (replan_prep="stale").

    The inventory embeds the previous corridors' pair coupling, so the
    solve on fresh data with it is an inexact-metric ADMM: the projections
    and duals use the fresh normals and bounds, only the w-update metric
    is stale (kkt_refine absorbs part of that).  ``op`` and ``data`` hold
    host numpy leaves; milliseconds of work."""
    if data.dt is None:
        raise ValueError("QPData.dt required for the knot-state solver")
    Qseg = np.asarray(data.Qseg, np.float64)
    M, npp, _ = Qseg.shape
    n = npp - 1
    phi = np.asarray(data.Aeq).shape[0] // (M + 1)
    lb = np.asarray(data.lb)
    B = lb.shape[0]
    dt_ = lb.dtype

    L, R, F0, _ = knot_maps(np.asarray(data.dt), n, phi)
    if (np.asarray(op.F0).shape != F0.shape
            or not np.allclose(np.asarray(op.F0, np.float64), F0,
                               rtol=1e-5, atol=1e-8)):
        raise ValueError(
            "refresh_ns_op_np: time grid changed (F0 mismatch); the rung "
            "inventory is tied to dt and M, re-run prepare_ns_np")
    if np.asarray(op.x_pin).shape[0] != B:
        raise ValueError("refresh_ns_op_np: agent count changed")

    N = _build_N(L, R, n, phi)
    x_pin = _x_pin_np(np.asarray(data.deq, np.float64), L, R, phi)
    Qx = np.einsum("mij,bkmj->bkmi", Qseg,
                   x_pin.reshape(B, 3, M, npp)).reshape(B, 3, M * npp)
    c_s = float(np.asarray(op.c_s, np.float64))
    g = c_s * np.einsum("da,bkd->bka", N, Qx)
    return op._replace(x_pin=x_pin.astype(dt_), g=g.astype(dt_))


def prepare_ns(data: QPData, s: NSSettings) -> NSOp:
    """Device-side banded prep: every NSOp leaf in the data's dtype on the
    data's device (``data`` holds tensors).  The rung inventory is the
    Schur chain over knots, Kd per knot, the (I (x) Ho)^T Dinv (I (x) Ho)
    sandwich, and an LU inverse plus one Newton step X (2I - S X), with
    the rungs batched.  Only the small time-grid maps (knot_maps, N,
    x_pin) are built on the host in float64, as the host prep builds
    them.  Pins IEEE float32 products: under TF32 the low-rho rung
    inverses come out orders of magnitude wrong.  The Newton step leaves
    the pivots close to, not exactly, symmetric.  With
    s.precond_dtype="bfloat16" the chain still runs in the data's dtype;
    each knot's pivots are rounded to bf16 as they are stored, once the
    next knot has used them (the same bits as one cast at the end, without
    a full-precision inventory beside the bf16 one).  On a card torch
    takes MAGMA's batched LU for the inverses; at 256 agents ([5, 2304,
    2304] per knot) MAGMA prints a size warning to stdout at every call."""
    check_precond(s)
    pin_ieee_fp32()
    with torch.no_grad():
        return _prepare_ns_impl(data, s)


def _prepare_ns_impl(data: QPData, s: NSSettings) -> NSOp:
    if data.dt is None:
        raise ValueError("QPData.dt required for the knot-state solver")
    Qseg = data.Qseg
    M, npp, _ = Qseg.shape
    n = npp - 1
    phi = data.Aeq.shape[0] // (M + 1)
    if npp != 2 * phi:
        raise ValueError(f"knot-state formulation needs n+1 == 2*phi "
                         f"(got n={n}, phi={phi})")
    B = data.lb.shape[0]
    B3 = 3 * B
    bs = B3 * phi
    Mi = M - 1
    dt_ = data.lb.dtype
    kw = dict(dtype=dt_, device=data.lb.device)

    def host64(t):
        return t.detach().to("cpu", torch.float64).numpy()

    L, R, F0, FT = knot_maps(host64(data.dt), n, phi)
    N = _build_N(L, R, n, phi)                              # [D, nw]
    x_pin = _x_pin_np(host64(data.deq), L, R, phi)
    L, R, F0, FT, N, x_pin = (torch.as_tensor(a, **kw)
                              for a in (L, R, F0, FT, N, x_pin))

    H_raw = N.T @ _apply_Qseg(Qseg, N.T).T
    c_s = 1.0 / torch.clamp(H_raw.abs().amax(dim=0).mean(), min=1e-12)
    g = c_s * torch.einsum("da,bkd->bka", N, _apply_Qseg(Qseg, x_pin))

    if s.adaptive_rho:
        ladder = np.logspace(np.log10(s.rho_min), np.log10(s.rho_max),
                             s.n_rungs)
    else:
        ladder = np.asarray([s.rho], np.float64)
    ladder = torch.as_tensor(ladder, **kw)
    C = _build_coupling(data)                               # [M, B3, B3]

    # Kd[k] = I_B3 (x) (Hd_k + sigma I + rho NtN_k)
    #         + rho (C_{k+1} (x) WL_{k+1} + C_k (x) WR_k)
    WL = torch.einsum("mia,mib->mab", L, L)
    WR = torch.einsum("mia,mib->mab", R, R)
    Q00 = torch.einsum("mia,mij,mjb->mab", L, Qseg[:, :phi, :phi], L)
    Q11 = torch.einsum("mia,mij,mjb->mab", R, Qseg[:, phi:, phi:], R)
    Q01 = torch.einsum("mia,mij,mjb->mab", L, Qseg[:, :phi, phi:], R)
    Hd_s = c_s * (Q00[1:M] + Q11[0:M - 1]) + s.sigma * torch.eye(phi, **kw)
    NtN_k = WL[1:M] + WR[0:M - 1]
    Ho = c_s * Q01[1:M - 1]                                 # [Mi-1, phi, phi]
    eye = torch.eye(B3, **kw)
    rho = ladder[:, None, None]                             # [R, 1, 1]

    def kron(Cb, Wb):     # [.., B3, B3] x [.., phi, phi] -> [.., bs, bs]
        out = torch.einsum("...ij,...ab->...iajb", Cb, Wb)
        return out.reshape(out.shape[:-4] + (bs, bs))

    def kd_knot(k):       # [R, bs, bs]
        return (kron(eye, Hd_s[k] + rho * NtN_k[k])
                + rho * (kron(C[k + 1], WL[k + 1]) + kron(C[k], WR[k])))

    def ko_sandwich(Dinv, Ho_k):      # (I (x) Ho)^T Dinv (I (x) Ho)
        Dr = Dinv.reshape(-1, B3, phi, B3, phi)
        out = torch.einsum("ai,rxayb,bj->rxiyj", Ho_k, Dr, Ho_k)
        return out.reshape(-1, bs, bs)

    I2 = 2.0 * torch.eye(bs, **kw)

    def inv_refined(S):
        X = torch.linalg.inv(S)
        return X @ (I2 - S @ X)

    store = torch.bfloat16 if s.precond_dtype == "bfloat16" else dt_
    Dinvs = torch.empty((len(ladder), Mi, bs, bs), dtype=store,
                        device=data.lb.device)
    prev = inv_refined(kd_knot(0))
    Dinvs[:, 0] = prev
    for k in range(1, Mi):
        prev = inv_refined(kd_knot(k) - ko_sandwich(prev, Ho[k - 1]))
        Dinvs[:, k] = prev
    del prev
    # contiguous leaves, as NSOp.to gives the host prep's: the kernels
    # take their operands as they are and refuse strided views
    return NSOp(*(v.contiguous() for v in (N, x_pin, g, F0, FT, c_s,
                                           ladder, Dinvs, Ho)))


def make_kinv_apply(op: NSOp, B: int, K3: int, M: int, phi: int,
                    solve=None):
    """KKT-system solver ``(rho_idx, rhs [B, K3, nw]) -> [B, K3, nw]``:
    the block-tridiagonal Thomas solve over knots with the stored pivot
    inverses, through ``solve`` (default ops/thomas.thomas_solve, looked
    up at each call: the kernel for CUDA tensors, the plain twin on the
    CPU)."""
    Mi = M - 1
    bs = B * K3 * phi
    if op.Dinvs.shape[-1] != bs:
        raise ValueError(f"pivot inventory has blocks of "
                         f"{op.Dinvs.shape[-1]}, expected {bs}")

    def kinv_apply(rho_idx, rhs):
        b = rhs.reshape(B, K3, Mi, phi).permute(2, 0, 1, 3).reshape(Mi, bs)
        x = (solve or thomas.thomas_solve)(op.Dinvs, op.Kos, b.contiguous(),
                                           int(rho_idx))
        x = x.reshape(Mi, B, K3, phi).permute(1, 2, 0, 3)
        return x.reshape(rhs.shape)

    return kinv_apply


def _x_of(op: NSOp, w: torch.Tensor) -> torch.Tensor:
    """x [B, 3, D] from interior knot states w [B, 3, nw]."""
    return op.x_pin + torch.einsum("da,bka->bkd", op.N, w)


def _w_from_x(op: NSOp, x: torch.Tensor, phi: int) -> torch.Tensor:
    """Project a control-point trajectory onto knot states (average of the
    left/right derivative readings; exact if x is continuity-feasible)."""
    B, K3, D = x.shape
    M = op.F0.shape[0]
    npp = D // M
    c = x.reshape(B, K3, M, npp)
    s_right = torch.einsum("mij,bkmj->bkmi", op.F0, c[..., :phi])  # knot m
    s_left = torch.einsum("mij,bkmj->bkmi", op.FT, c[..., phi:])   # knot m+1
    s_int = 0.5 * (s_left[:, :, :M - 1] + s_right[:, :, 1:])
    return s_int.reshape(B, K3, (M - 1) * phi)


def _A_x(x: torch.Tensor, pop: PairOp) -> NSConstr:
    """A x: the box rows are x itself; pair row p at control point d is
    sum_k n_d[p, k, d] (c_j x[b_j, k, d] - c_i x[b_i, k, d]), a gather of
    each pair's two agents and a multiply-and-sum over the three axes.
    The dense selection S is not multiplied here: its two-nonzero rows
    made the einsum form read ~90x the bytes this needs (torch lowered
    its product with the normals to one GEMV per pair on the card)."""
    def side(b, c):
        return x.index_select(0, b).mul_(pop.n_d).sum(1).mul_(c[:, None])

    return NSConstr(box=x, pair=side(pop.bj, pop.cj).sub_(side(pop.bi,
                                                               pop.ci)))


def _AT_pair(pair: torch.Tensor, pop: PairOp) -> torch.Tensor:
    """The pair rows' part of A^T y."""
    return torch.einsum("pb,pkd->bkd", pop.S, pop.n_d * pair[:, None, :])


def _AT_x(y: NSConstr, pop: PairOp) -> torch.Tensor:
    return y.box + _AT_pair(y.pair, pop)


class ConstrOp(NamedTuple):
    """x -> A x and y -> A^T y of the constraint rows, as the ADMM steps,
    the PCG and the residuals apply them."""
    A_x: Callable
    AT_x: Callable


def constr_op(pop: PairOp, pair_sum=None) -> ConstrOp:
    """A and A^T of the box rows and the pair rows of ``pop``.  A sharded
    solve holds a share of the pair rows on each rank: ``pair_sum`` (its
    all_reduce) sums their A^T y part over the ranks, and the box term,
    which every rank holds whole, is added once, outside it."""
    def AT_x(y):
        part = _AT_pair(y.pair, pop)
        return y.box + (part if pair_sum is None else pair_sum(part))

    return ConstrOp(lambda x: _A_x(x, pop), AT_x)


def _clip(v: NSConstr, l: NSConstr, u: NSConstr) -> NSConstr:
    return NSConstr(*(torch.minimum(torch.maximum(a, lo), hi)
                      for a, lo, hi in zip(v, l, u)))


def _bounds(data: QPData, tighten: float = 0.0) -> tuple[NSConstr, NSConstr]:
    dt_ = data.lb.dtype
    t = torch.tensor(tighten, dtype=dt_, device=data.lb.device)
    pair_l = torch.where(data.pair_rhs > -BIG / 2, data.pair_rhs + t,
                         data.pair_rhs)
    lb, ub = data.lb, data.ub
    # knot-face pre-relaxation (see assemble.KNOT_FACE_GUARD): thin
    # duplicated knot rows are relaxed by g = min(t, guard) on both sides
    # so the tightened constraint recovers the true intersection exactly
    M = data.Qseg.shape[-3]
    if M > 1 and float(tighten) > 0.0:
        g = torch.minimum(t, torch.tensor(KNOT_FACE_GUARD, dtype=dt_,
                                          device=t.device))
        sh = lb.shape[:-1] + (M, lb.shape[-1] // M)
        lbv, ubv = lb.reshape(sh).clone(), ub.reshape(sh).clone()
        ilo = torch.maximum(lbv[..., :-1, -1], lbv[..., 1:, 0])
        ihi = torch.minimum(ubv[..., :-1, -1], ubv[..., 1:, 0])
        thin = (ihi - ilo) < 2 * KNOT_FACE_GUARD
        lo_last = torch.where(thin, ilo - g, lbv[..., :-1, -1])
        lo_first = torch.where(thin, ilo - g, lbv[..., 1:, 0])
        hi_last = torch.where(thin, ihi + g, ubv[..., :-1, -1])
        hi_first = torch.where(thin, ihi + g, ubv[..., 1:, 0])
        lbv[..., :-1, -1] = lo_last
        lbv[..., 1:, 0] = lo_first
        ubv[..., :-1, -1] = hi_last
        ubv[..., 1:, 0] = hi_first
        lb, ub = lbv.reshape(lb.shape), ubv.reshape(ub.shape)
    # per-row clamp: never tighten a box row beyond its own midpoint
    # (degenerate one-cell slots keep width 0 instead of inverting)
    t_box = torch.minimum(t, 0.5 * (ub - lb))
    l = NSConstr(box=lb + t_box, pair=pair_l)
    u = NSConstr(box=ub - t_box,
                 pair=torch.full_like(data.pair_rhs, BIG))
    return l, u


def _cold_state(data: QPData, op: NSOp, s: NSSettings):
    """(pair operator, tightened bounds l and u, cold state (w, z, y)):
    w by ``s.warm_start``, z = clip(A x), y = 0."""
    B, K3, _ = data.lb.shape
    phi = op.F0.shape[1]
    pop = _pair_op(data)
    l, u = _bounds(data, s.tighten)
    if s.warm_start == "x0":
        w = _w_from_x(op, data.x0, phi)
    else:
        w = torch.zeros((B, K3, op.N.shape[1]), dtype=data.lb.dtype,
                        device=data.lb.device)
    z = _clip(_A_x(_x_of(op, w), pop), l, u)
    y = NSConstr(*(torch.zeros_like(v) for v in z))
    return pop, l, u, (w, z, y)


def cold_chunk_inputs(data: QPData, op: NSOp, s: NSSettings):
    """(fused-chunk operands, cold state (w, z, y)): the operands every
    chunk of a solve shares (ops/nsfused.build_operands of the pair
    operator and the tightened bounds) and the state the schedule loop
    starts from without ``init``."""
    pop, l, u, cold = _cold_state(data, op, s)
    return nsfused.build_operands(data, op, pop, l, u), cold


def admm_steps(op: NSOp, cop: ConstrOp, l: NSConstr, u: NSConstr,
               rho_idx: int, sigma: float, alpha: float, w, z, y,
               n_inner: int, solve_w):
    """``n_inner`` knot-state ADMM iterations at rung ``rho_idx`` in plain
    torch; ``cop`` applies the constraint rows, ``solve_w(rhs_w, rho)`` is
    the w-update (the KKT solve).  Returns the new (w, z, y)."""
    rho = op.ladder[rho_idx]
    for _ in range(n_inner):
        rhs_x = NSConstr(*(rho * zz - yy for zz, yy in zip(z, y)))
        rhs_w = sigma * w - op.g + torch.einsum(
            "da,bkd->bka", op.N, cop.AT_x(rhs_x))
        w_t = solve_w(rhs_w, rho)
        ax_t = cop.A_x(_x_of(op, w_t))
        w = alpha * w_t + (1 - alpha) * w
        v = NSConstr(*(alpha * a + (1 - alpha) * zz + yy / rho
                       for a, zz, yy in zip(ax_t, z, y)))
        z_new = _clip(v, l, u)
        y = NSConstr(*(rho * (vv - zz) for vv, zz in zip(v, z_new)))
        z = z_new
    return w, z, y


def pcg_w_update(data: QPData, op: NSOp, cop: ConstrOp, s: NSSettings,
                 kinv_apply, rho_idx: int):
    """The kkt_refine w-update ``(rhs_w, rho) -> w_t``: the inventory solve
    of rhs_w, then ``s.kkt_refine`` preconditioned-CG steps on
    K_fresh w = rhs_w, where K_fresh(rho) v = sigma v + N^T (c_s Q
    + rho A^T A) N v is built from the current data (its pair normals and
    bounds) and the rung inventory is the preconditioner.  The ``tiny``
    guards keep an exactly converged step (residual 0) from 0/0."""
    tiny = 1e-30

    def K_fresh(v, rho):
        x_v = torch.einsum("da,bka->bkd", op.N, v)
        qx = op.c_s * _apply_Qseg(data.Qseg, x_v)
        aax = cop.AT_x(cop.A_x(x_v))
        return s.sigma * v + torch.einsum("da,bkd->bka", op.N,
                                          qx + rho * aax)

    def w_update(rhs_w, rho):
        w_t = kinv_apply(rho_idx, rhs_w)
        r_c = rhs_w - K_fresh(w_t, rho)
        z_c = kinv_apply(rho_idx, r_c)
        p_c = z_c
        rz = torch.sum(r_c * z_c)
        for _ in range(s.kkt_refine):
            Kp = K_fresh(p_c, rho)
            a_c = rz / torch.clamp(torch.sum(p_c * Kp), min=tiny)
            w_t = w_t + a_c * p_c
            r_c = r_c - a_c * Kp
            z_c = kinv_apply(rho_idx, r_c)
            rz_new = torch.sum(r_c * z_c)
            p_c = z_c + (rz_new / torch.clamp(rz, min=tiny)) * p_c
            rz = rz_new
        return w_t

    return w_update


def _iterate_ns(data: QPData, op: NSOp, s: NSSettings, schedule,
                init=None, return_state: bool = False):
    """Phased ADMM loop in knot-state coordinates on one device.

    schedule: (max_iters [K], idx_lo [K], idx_hi [K]) host ints — K fenced
    phases run back to back, each a loop of check_every chunks that stops
    at its budget or when the residuals converge.  init: (w, z, y,
    rho_idx) from a previous call with return_state=True."""
    # every chunk reaches a kernel's wrapper, which routes by the tensors'
    # device (the kernel on CUDA, the plain twin on the CPU): refine
    # chunks solve through ops/thomas, the others are one ops/nsfused chunk
    if s.kkt_refine:
        pop, l, u, cold = _cold_state(data, op, s)
        cop = constr_op(pop)
        B, K3, _ = data.lb.shape
        kinv_apply = make_kinv_apply(op, B, K3, op.F0.shape[0],
                                     op.F0.shape[1])

        def chunk(w, z, y, rho_idx):
            return admm_steps(op, cop, l, u, rho_idx, s.sigma, s.alpha,
                              w, z, y, s.check_every,
                              pcg_w_update(data, op, cop, s, kinv_apply,
                                           rho_idx))
    else:
        ops_f, cold = cold_chunk_inputs(data, op, s)
        cop, l, u = constr_op(ops_f.pop), ops_f.l, ops_f.u

        def chunk(w, z, y, rho_idx):
            return nsfused.nsfused_chunk(ops_f, rho_idx, s.sigma, s.alpha,
                                         w, z, y, n_inner=s.check_every)

    x, info, state = phased_loop(data, op, s, schedule, chunk, cop, l, u,
                                 cold, init)
    if return_state:
        return x, info, state
    return x, info


def phased_loop(data: QPData, op: NSOp, s: NSSettings, schedule, chunk,
                cop: ConstrOp, l: NSConstr, u: NSConstr, cold, init=None,
                pair_max=None):
    """The phased schedule loop that the single-device and the sharded
    solves share: ``chunk(w, z, y, rho_idx)`` runs check_every ADMM
    iterations, then one host sync reads the residuals and the rung walk
    (on the host, in the problem dtype) picks the next rung.  Starts from
    ``init`` (w, z, y, rho_idx), or without it from ``cold`` (w, z, y) at
    the rung nearest s.rho.  ``pair_max`` maps the pair parts' maxima [k] to
    their maxima over all ranks (a sharded solve's all_reduce MAX; None on
    one device).  Returns (x, SolveInfo, (w, z, y, rho_idx)), iterations
    totalled over the phases."""
    dt_ = data.lb.dtype
    dev = data.lb.device
    npf = {torch.float32: np.float32, torch.float64: np.float64}[dt_]
    eps_abs = torch.tensor(s.eps_abs, dtype=dt_, device=dev)
    eps_dual = torch.tensor(
        s.eps_abs if s.eps_dual_abs is None else s.eps_dual_abs,
        dtype=dt_, device=dev)
    eps_rel = torch.tensor(s.eps_rel, dtype=dt_, device=dev)

    # the rung walk runs on the host in the problem dtype
    ladder_h = op.ladder.detach().cpu().numpy()
    lad_log = np.log(ladder_h)

    def nearest_rung(rho) -> int:
        return int(np.argmin(np.abs(lad_log - np.log(npf(rho)))))

    if init is None:
        w, z, y = cold
        rho_idx = nearest_rung(s.rho)
    else:
        w, z, y, rho_idx = init
        z = _clip(z, l, u)

    zero = torch.zeros((), dtype=dt_, device=dev)

    def cmax(parts):
        # max |.| of each NSConstr: the box part whole, the pair parts
        # through one pair_max call
        def m(v):
            return v.abs().max() if v.numel() > 0 else zero
        pair = torch.stack([m(c.pair) for c in parts])
        if pair_max is not None:
            pair = pair_max(pair)
        return [torch.maximum(m(c.box), p) for c, p in zip(parts, pair)]

    def residuals(w, z, y):
        x = _x_of(op, w)
        ax = cop.A_x(x)
        # duals live in the cost-normalized problem: judge stationarity
        # in ORIGINAL units, (c_s Qx + A^T y) / c_s
        px = _apply_Qseg(data.Qseg, x)
        aty = cop.AT_x(y) / op.c_s
        grad_w = torch.einsum("da,bkd->bka", op.N, px + aty)
        r_prim, n_ax, n_z = cmax(
            [NSConstr(*(a - b for a, b in zip(ax, z))), ax, z])
        r_dual = grad_w.abs().max()
        n_prim = torch.maximum(n_ax, n_z)
        n_dual = torch.maximum(
            torch.einsum("da,bkd->bka", op.N, px).abs().max(),
            torch.einsum("da,bkd->bka", op.N, aty).abs().max())
        return r_prim, r_dual, n_prim, n_dual

    def rho_update(rho_idx, done, r_prim, r_dual, n_prim, n_dual, lo, hi):
        if not s.adaptive_rho or done:
            return rho_idx
        tiny = npf(1e-10)
        rho_s = ladder_h[rho_idx]
        ratio = np.sqrt((r_prim / max(n_prim, tiny))
                        / max(r_dual / max(n_dual, tiny), tiny))
        cand = np.clip(rho_s * ratio, npf(s.rho_min), npf(s.rho_max))
        thr = npf(s.adapt_threshold)
        if not (cand > thr * rho_s or cand < rho_s / thr):
            return rho_idx
        return int(np.clip(np.argmin(np.abs(lad_log - np.log(cand))),
                           lo, hi))

    def run_phase(w, z, y, rho_idx, lo, hi, max_it):
        it, done = 0, False
        while it < max_it and not done:
            w, z, y = chunk(w, z, y, rho_idx)
            r_prim, r_dual, n_prim, n_dual = residuals(w, z, y)
            ok = ((r_prim <= eps_abs + eps_rel * n_prim)
                  & (r_dual <= eps_dual + eps_rel * n_dual))
            # the one host sync per chunk
            vals = torch.stack([r_prim, r_dual, n_prim, n_dual,
                                ok.to(dt_)]).cpu().numpy()
            done = bool(vals[4])
            rho_idx = rho_update(rho_idx, done, *vals[:4], lo, hi)
            it += s.check_every
        return w, z, y, rho_idx, it

    total = 0
    for max_it, lo, hi in zip(*schedule):
        rho_idx = int(np.clip(rho_idx, lo, hi))
        w, z, y, rho_idx, it = run_phase(w, z, y, rho_idx, int(lo),
                                         int(hi), int(max_it))
        total += it

    r_prim, r_dual, _, _ = residuals(w, z, y)
    x = _x_of(op, w)
    obj = 0.5 * torch.sum(x * _apply_Qseg(data.Qseg, x))
    info = SolveInfo(iters=total, r_prim=r_prim, r_dual=r_dual, obj=obj)
    return x, info, (w, z, y, rho_idx)


def schedule_arrays(phases: tuple[NSSettings, ...]):
    """(s_base, max_iters [K], idx_lo [K], idx_hi [K]) for a phase tuple
    whose members differ ONLY in max_iter / rho_lo / rho_hi (the
    production shape: feasibility -> polish -> restore), or None if the
    tuple is not schedule-compatible.  Fence indices come from the ladder
    definition in the settings."""
    s0 = phases[0]

    def neutral(p):
        return dataclasses.replace(p, max_iter=0, rho_lo=None, rho_hi=None)

    if any(neutral(p) != neutral(s0) for p in phases[1:]):
        return None
    if s0.adaptive_rho:
        ladder = np.logspace(np.log10(s0.rho_min), np.log10(s0.rho_max),
                             s0.n_rungs)
    else:
        ladder = np.asarray([s0.rho])
    llog = np.log(ladder)

    def fence(r, default):
        if r is None:
            return default
        return int(np.argmin(np.abs(llog - np.log(r))))

    it_k = np.asarray([p.max_iter for p in phases], np.int32)
    lo_k = np.asarray([fence(p.rho_lo, 0) for p in phases], np.int32)
    hi_k = np.asarray([fence(p.rho_hi, len(ladder) - 1)
                       for p in phases], np.int32)
    return neutral(s0), it_k, lo_k, hi_k


def solve_ns_schedule(data: QPData, op: NSOp, s_base: NSSettings,
                      it_k, lo_k, hi_k, init=None,
                      return_state: bool = False):
    """Phased solve with per-phase budgets/fences; SolveInfo.iters is the
    total across phases.  ``data`` and ``op`` hold tensors on one device."""
    pin_ieee_fp32()
    with torch.no_grad():
        return _iterate_ns(data, op, s_base, (it_k, lo_k, hi_k), init=init,
                           return_state=return_state)
