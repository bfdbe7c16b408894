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
device preps in both KKT modes (banded: flat pivots; dense: one K(rho)^-1
a rung), the host refresh of a replan's endpoint leaves
(refresh_ns_op_np), the constraint applies and bounds, the KKT solves
(make_kinv_apply: the banded Thomas solve over ops/thomas, or the dense
inverse's matvec), the phased schedule loop (solve_ns_schedule) and the
per-phase loop of any other phase tuple (solve_ns_phases), and the
one-problem and stacked solves (solve_single_ns, solve_ns,
solve_ns_batched).  A chunk of check_every iterations runs one of three
ways:
  banded, kkt_refine == 0  one ops/nsfused chunk (the fused kernel K1 for
                   CUDA tensors, its plain twin on the CPU);
  kkt_refine >= 1  check_every torch ADMM steps whose w-update is a PCG
                   against the FRESH operator (K_fresh), preconditioned by
                   the rung inventory: 2 + kkt_refine KKT solves per step
                   (ops/thomas's kernel K2 in banded mode);
  dense            check_every torch ADMM steps, each w-update one matvec
                   with the rung's K(rho)^-1 (no kernel: the JAX package
                   reaches none in this mode either).
The loop is a Python loop; the termination test after each chunk is one
host sync.

The bf16 preconditioner (NSSettings.precond_dtype="bfloat16"): both
preps round the rung inventory to bf16 (K2 reads it, widening each pivot
at the multiply); legal only with kkt_refine >= 1, where the PCG against
the float32 K_fresh absorbs the ~8-bit mantissa.  The fused chunk (K1)
refuses such an inventory.

Not ported yet: Anderson acceleration (NSSettings.aa_depth > 0 raises).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import bernstein
from ..core.device import pin_ieee_fp32, resolve_device
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
    # KKT linear-system strategy:
    #   "dense":  K(rho)^-1 materialized per rung [3B nw, 3B nw], one
    #             matvec a w-update; right for small agent batches
    #   "banded": block-tridiagonal Thomas factorization over knots
    #             ([3B phi]^2 pivot blocks, memory O(M (3B phi)^2)); right
    #             for JOINT solves (the 64-agent joint KKT would be a
    #             20160^2 dense inverse, 1.6 GB a rung in float32)
    kkt_mode: str = "dense"
    # Anderson acceleration depth of the JAX package (chunk-level AA-II);
    # 0 = off.  Not ported: any other value raises
    aa_depth: int = 0


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
    # banded mode (None in dense mode):
    Dinvs: object    # [R, Mi, bs, bs] pivot-block inverses (flat)
    # off-diagonal blocks are I_B3 (x) Ho with Ho [phi, phi] per knot
    Kos: object      # [Mi-1, phi, phi]
    # dense mode (None in banded mode):
    Kinvs: object = None  # [R, 3B nw, 3B nw] KKT inverse per rung

    def to(self, device) -> "NSOp":
        return NSOp(*(None if v is None
                      else v.to(device) if isinstance(v, torch.Tensor)
                      else torch.as_tensor(np.asarray(v), device=device)
                      for v in self))


def check_precond(s: NSSettings) -> None:
    """The conditions of NSSettings.kkt_mode ("dense" or "banded") and
    precond_dtype: "float32" or "bfloat16", and bf16 pivots only as a
    preconditioner (kkt_refine >= 1: the refine chunks solve through
    ops/thomas, whose K2 reads them; a dense inventory stays in the
    problem's dtype)."""
    if s.kkt_mode not in ("dense", "banded"):
        raise ValueError(f"kkt_mode {s.kkt_mode!r}: expected 'dense' or "
                         "'banded'")
    if s.precond_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"precond_dtype {s.precond_dtype!r}: expected "
                         "'float32' or 'bfloat16'")
    if s.precond_dtype == "bfloat16" and s.kkt_refine < 1:
        raise ValueError(
            "precond_dtype='bfloat16' is only a PRECONDITIONER: it requires "
            "kkt_refine >= 1 (fresh-operator PCG absorbs the ~8-bit "
            "mantissa)")


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
                n_workers=n_workers, H_raw=H_raw)


def _dense_kinvs_np(ctx: dict, s: NSSettings) -> np.ndarray:
    """The dense mode's rung inventory in host float64: K(rho) = K0 + rho
    K1 [nx, nx], nx = 3B nw, with K0 = I_3B (x) (c_s N^T Q N + sigma I)
    and K1 = I_3B (x) N^T N + the knot-block pair coupling sandwich, each
    rung inverted through its Cholesky factor (one rung per thread)."""
    from concurrent.futures import ThreadPoolExecutor

    N, C, ladder = ctx["N"], ctx["C"], ctx["ladder"]
    M, npp, nw, B3 = ctx["M"], ctx["npp"], ctx["nw"], ctx["B3"]
    H = ctx["c_s"] * ctx["H_raw"] + s.sigma * np.eye(nw)
    K0 = np.einsum("ab,de->adbe", np.eye(B3), H)
    K1 = np.einsum("ab,de->adbe", np.eye(B3), N.T @ N)
    # the pair normals are constant per segment, so the coupling
    # contracts over (segment, control point)
    Nm = N.reshape(M, npp, nw)
    W = np.einsum("mda,mdb->mab", Nm, Nm)
    K1 = K1 + np.einsum("mab,mij->iajb", W, C)
    nx = B3 * nw
    Ks = (K0.reshape(nx, nx)[None]
          + ladder[:, None, None] * K1.reshape(nx, nx)[None])
    Kinvs = np.empty_like(Ks)

    def fill_kinv(r):
        Kinvs[r] = _inv_spd_np(Ks[r])

    with _blas_single_threaded():
        with ThreadPoolExecutor(max_workers=ctx["n_workers"]) as ex:
            list(ex.map(fill_kinv, range(len(ladder))))
    return Kinvs


def prepare_ns_np(data: QPData, s: NSSettings) -> NSOp:
    """Host float64 KKT prep; leaves cast once to the problem dtype.

    The rung inverses are the one prep quantity whose float32 computation
    measurably degrades solution quality, so they are computed in float64
    and each rounded once: in banded mode the Schur chain's pivots, FLAT
    [R, Mi, bs, bs], row index (agent*3 + axis)*phi + derivative order; in
    dense mode one K(rho)^-1 a rung (_dense_kinvs_np).  With
    s.precond_dtype="bfloat16" the banded pivots are rounded once more,
    from the problem dtype to bf16 (round to nearest even, as the JAX
    package's two casts do), into a CPU torch tensor (numpy has no
    bf16)."""
    from concurrent.futures import ThreadPoolExecutor

    check_precond(s)
    ctx = _host_prep_ctx_np(data, s)
    Qseg, phi = ctx["Qseg"], ctx["phi"]
    B3, dt_, Mi = ctx["B3"], ctx["dt_"], ctx["Mi"]
    L, R, F0, FT = ctx["L"], ctx["R"], ctx["F0"], ctx["FT"]
    N, x_pin, c_s, g = ctx["N"], ctx["x_pin"], ctx["c_s"], ctx["g"]
    ladder, C, n_workers = ctx["ladder"], ctx["C"], ctx["n_workers"]

    def cast(v):
        return np.asarray(v).astype(dt_, copy=False)

    if s.kkt_mode == "dense":
        return NSOp(N=cast(N), x_pin=cast(x_pin), g=cast(g), F0=cast(F0),
                    FT=cast(FT), c_s=cast(c_s), ladder=cast(ladder),
                    Dinvs=None, Kos=None,
                    Kinvs=cast(_dense_kinvs_np(ctx, s)))

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
    """Device-side prep: every NSOp leaf in the data's dtype on the data's
    device (``data`` holds tensors).  The banded rung inventory is the
    Schur chain over knots, Kd per knot, the (I (x) Ho)^T Dinv (I (x) Ho)
    sandwich, and an LU inverse plus one Newton step X (2I - S X), with
    the rungs batched; the dense one is K(rho)^-1 of each rung (the
    operator of _dense_kinvs_np), an LU inverse plus the same Newton
    step.  Only the small time-grid maps (knot_maps, N,
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
    if s.kkt_mode == "dense":
        Kinvs = _dense_kinvs(N, H_raw, c_s, C, ladder, s.sigma, M, npp, B3)
        return NSOp(*(v.contiguous() for v in (N, x_pin, g, F0, FT, c_s,
                                               ladder)),
                    Dinvs=None, Kos=None, Kinvs=Kinvs.contiguous())

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


def _dense_kinvs(N, H_raw, c_s, C, ladder, sigma, M, npp, B3):
    """[R, nx, nx] K(rho)^-1 of each rung in the dtype and on the device
    of its operands (the device twin of _dense_kinvs_np)."""
    kw = dict(dtype=N.dtype, device=N.device)
    nw = N.shape[1]
    eye = torch.eye(B3, **kw)
    K0 = torch.einsum("ab,de->adbe", eye,
                      c_s * H_raw + sigma * torch.eye(nw, **kw))
    K1 = torch.einsum("ab,de->adbe", eye, N.T @ N)
    Nm = N.reshape(M, npp, nw)
    W = torch.einsum("mda,mdb->mab", Nm, Nm)
    K1 = K1 + torch.einsum("mab,mij->iajb", W, C)
    nx = B3 * nw
    Ks = (K0.reshape(nx, nx)[None]
          + ladder[:, None, None] * K1.reshape(nx, nx)[None])
    X = torch.linalg.inv(Ks)
    return X @ (2.0 * torch.eye(nx, **kw) - Ks @ X)


def make_kinv_apply(op: NSOp, B: int, K3: int, M: int, phi: int,
                    solve=None):
    """KKT-system solver ``(rho_idx, rhs [B, K3, nw]) -> [B, K3, nw]``:
    in dense mode one matvec with the rung's stored K(rho)^-1; in banded
    mode the block-tridiagonal Thomas solve over knots with the stored
    pivot inverses, through ``solve`` (default ops/thomas.thomas_solve,
    looked up at each call: the kernel for CUDA tensors, the plain twin
    on the CPU)."""
    if op.Kinvs is not None:
        def kinv_apply_dense(rho_idx, rhs):
            return (op.Kinvs[int(rho_idx)] @ rhs.reshape(-1)
                    ).reshape(rhs.shape)
        return kinv_apply_dense

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


def plain_chunk(data: QPData, op: NSOp, cop: ConstrOp, l: NSConstr,
                u: NSConstr, s: NSSettings, kinv_apply):
    """``chunk(w, z, y, rho_idx)``: check_every ADMM iterations in plain
    torch whose w-update is ``kinv_apply`` (the dense inverse's matvec,
    or a KKT solve that reaches ops/thomas), refined by s.kkt_refine PCG
    steps against the fresh operator when s.kkt_refine >= 1."""
    def chunk(w, z, y, rho_idx):
        if s.kkt_refine:
            solve_w = pcg_w_update(data, op, cop, s, kinv_apply, rho_idx)
        else:
            def solve_w(rhs_w, rho):
                return kinv_apply(rho_idx, rhs_w)
        return admm_steps(op, cop, l, u, rho_idx, s.sigma, s.alpha, w, z, y,
                          s.check_every, solve_w)

    return chunk


def phase_schedule(ladder, s: NSSettings):
    """The one-phase schedule ([max_iter], [idx_lo], [idx_hi]) of ``s``:
    its rho fences as the nearest rungs of the operator's ``ladder`` in
    the problem dtype (the JAX package's per-phase loop fences the same
    way)."""
    lad = ladder.detach().cpu().numpy()
    llog = np.log(lad)

    def fence(r, default):
        if r is None:
            return default
        return int(np.argmin(np.abs(llog - np.log(lad.dtype.type(r)))))

    return ([s.max_iter], [fence(s.rho_lo, 0)],
            [fence(s.rho_hi, len(lad) - 1)])


def _iterate_ns(data: QPData, op: NSOp, s: NSSettings, init=None,
                return_state: bool = False, schedule=None):
    """ADMM loop in knot-state coordinates on one device.

    schedule: (max_iters [K], idx_lo [K], idx_hi [K]) host ints — K fenced
    phases run back to back, each a loop of check_every chunks that stops
    at its budget or when the residuals converge; None runs the one phase
    of ``s`` (its max_iter and rho_lo/rho_hi fences, phase_schedule).
    init: (w, z, y, rho_idx) from a previous call with return_state=True
    (z is re-clipped to this call's bounds)."""
    if s.aa_depth:
        raise NotImplementedError(
            "NSSettings.aa_depth > 0 (Anderson acceleration) is not ported "
            "(ROADMAP queue 1, item 4)")
    if schedule is None:
        schedule = phase_schedule(op.ladder, s)
    # every banded chunk reaches a kernel's wrapper, which routes by the
    # tensors' device (the kernel on CUDA, the plain twin on the CPU):
    # refine chunks solve through ops/thomas, the others are one
    # ops/nsfused chunk; dense chunks are plain torch
    if s.kkt_refine or op.Kinvs is not None:
        pop, l, u, cold = _cold_state(data, op, s)
        cop = constr_op(pop)
        B, K3, _ = data.lb.shape
        chunk = plain_chunk(data, op, cop, l, u, s, make_kinv_apply(
            op, B, K3, op.F0.shape[0], op.F0.shape[1]))
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
    if s0.aa_depth:
        return None

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


def run_phases(phases: tuple[NSSettings, ...], ladder, iterate, init=None):
    """The phased solve that the single-device and the sharded solves
    share: ``iterate(s, schedule, init) -> (x, info, state)`` runs one
    settings object over a schedule.  A schedule-compatible tuple
    (schedule_arrays) runs as one schedule of its base settings; any other
    runs phase by phase, each phase with its own settings (tighten,
    kkt_refine, ...) and its fences on ``ladder``, carrying the state (w,
    z, y, rho_idx).  Returns (x, SolveInfo, state), iterations totalled
    over the phases."""
    sched = schedule_arrays(tuple(phases))
    if sched is not None:
        s0, it_k, lo_k, hi_k = sched
        return iterate(s0, (it_k, lo_k, hi_k), init)
    state, total = init, 0
    for s in phases:
        x, info, state = iterate(s, phase_schedule(ladder, s), state)
        total += info.iters
    return x, info._replace(iters=total), state


def solve_ns_schedule(data: QPData, op: NSOp, s_base: NSSettings,
                      it_k, lo_k, hi_k, init=None,
                      return_state: bool = False):
    """Phased solve with per-phase budgets/fences; SolveInfo.iters is the
    total across phases.  ``data`` and ``op`` hold tensors on one device."""
    pin_ieee_fp32()
    with torch.no_grad():
        return _iterate_ns(data, op, s_base, init=init,
                           return_state=return_state,
                           schedule=(it_k, lo_k, hi_k))


def _on(device, data: QPData) -> QPData:
    """``data`` on the resolved ``device`` (None = the card, raising
    without one), float32 products pinned to IEEE."""
    pin_ieee_fp32()
    return data.to(resolve_device(device))


def solve_ns_phases(data: QPData, phases: tuple[NSSettings, ...],
                    return_state: bool = False, op: NSOp | None = None,
                    init=None, device=None):
    """Phased rho schedule sharing ONE prepared op: the rung inventory
    comes from phases[0] (prepare_ns on the device when ``op`` is None);
    the phases run through run_phases (one schedule when they differ only
    in max_iter / rho_lo / rho_hi, else phase by phase), carrying the full
    ADMM state.  init: a (w, z, y, rho_idx) state from an earlier call
    with return_state=True (the state-warm replan).

    ``data`` (host numpy or tensors) and ``op`` move to ``device`` (None =
    the card; raises without one: pass ``device="cpu"`` for the CPU).
    Returns (x [B, 3, D], SolveInfo[, state]); SolveInfo.iters is the
    total over the phases."""
    data = _on(device, data)
    with torch.no_grad():
        op = (prepare_ns(data, phases[0]) if op is None
              else op.to(data.lb.device))

        def iterate(s, schedule, st):
            return _iterate_ns(data, op, s, init=st, return_state=True,
                               schedule=schedule)

        x, info, state = run_phases(phases, op.ladder, iterate, init)
    if return_state:
        return x, info, state
    return x, info


def solve_single_ns(data: QPData, s: NSSettings, device=None):
    """Prepare (prepare_ns, in the data's dtype) and solve one batch QP on
    ``device`` (None = the card; ``device="cpu"`` for the CPU): (x [B, 3,
    D], SolveInfo)."""
    data = _on(device, data)
    with torch.no_grad():
        return _iterate_ns(data, prepare_ns(data, s), s)


def solve_ns(data: QPData, settings: NSSettings = NSSettings(),
             device=None) -> torch.Tensor:
    """Solve one batch QP in knot-state coordinates on ``device`` (None =
    the card).  Returns x [B, 3, D] (as the JAX package's solve_ns);
    continuity and the endpoint equalities hold to machine precision by
    construction."""
    return solve_single_ns(data, settings, device)[0]


def solve_ns_batched(data: QPData, settings: NSSettings = NSSettings(),
                     device=None):
    """Solve a stack of batch QPs (a leading axis on every leaf) on
    ``device`` (None = the card), one problem at a time: each is prepared
    and iterated alone, so its result does not depend on the stack.
    Returns (x [L, B, 3, D], SolveInfo of [L] tensors)."""
    from .admm import _tree_map

    data = _on(device, data)
    return stack_solves([solve_single_ns(_tree_map(lambda a: a[i], data),
                                         settings, data.lb.device)
                         for i in range(data.lb.shape[0])])


def stack_solves(outs):
    """Stack per-problem solves ((x, SolveInfo, ...) each) along a new
    leading axis: (x [L, ...], SolveInfo of [L] tensors)."""
    x = torch.stack([o[0] for o in outs])
    return x, SolveInfo(*(torch.stack([torch.as_tensor(
        getattr(o[1], f), device=x.device) for o in outs])
        for f in SolveInfo._fields))
