"""Cross-device decomposition of ONE joint knot-state ADMM solve.

PyTorch port of the JAX package's qp/nullspace_shard.py on
``torch.distributed``: one solve is partitioned over the ranks of a
process group (one process per rank, see parallel/distributed).  The pair
constraints are split over P (dim 0, padded to a multiple of the rank
count with inactive rows): A x is row-local, A^T y needs one ``psum`` per
apply, and the pair residuals one ``pmax``.  Everything else (w, the box
parts of z and y, x_pin, N, g, Qseg, bounds) is held whole on every rank.
The KKT solve is split one of three ways:

``mode="chunk"`` (default): the pivot inventory's KNOT axis is split into
n contiguous chunks of L knots (zero-padded to n*L knots; pad knots have
Dinv = 0 and b = 0 and carry exact zeros).  The forward sweep flows rank
to rank: rank r receives the [bs] carry from rank r-1 (zeros on rank 0),
runs its chunk through kernel K3a (ops/thomas.thomas_chunk_fwd) and sends
T[L-1] on; the back substitution flows back through kernel K3b
(thomas_chunk_bwd) with x[0] as the carry; one tiled ``all_gather``
assembles the solution.  Per KKT apply: 2(n-1) point-to-point messages of
[bs] floats and one all_gather, constant in the knot count.  The chain
stays sequential: sharding buys pivot memory per rank, not speed.

``mode="blockrow"``: each rank holds bs/n ROWS of every pivot inverse;
every knot's matvec is reassembled with a tiled all_gather, 2*Mi - 1 per
apply.  Needs bs % n == 0.  Plain torch.

``mode="spike"``: SPIKE substructuring (``prepare_spike_np``): each rank
solves its interior chunk with no incoming carry, one all_gather of the
chunks' tip rows feeds a small separator Schur chain solved on every
rank, a local correction solve and one all_gather of the chunks finish
the apply.  Needs uniform segment durations and Mi >= 2n, and runs on the
rank count it was prepared for.  The two chunk solves are
ops/thomas.thomas_solve on the rank's interior chain (kernel K2 on the
card); the separator chain is plain torch.

The schedule and per-phase loops, the ADMM step and the kkt_refine PCG
are qp/nullspace's (``run_phases``, ``phased_loop``, ``plain_chunk``),
given the sharded constraint applies and KKT solve.  Sums are re-associated by the
collectives, so results match a one-device solve to reduction round-off,
not bitwise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import thomas
from ..parallel import distributed as pd
from .assemble import BIG, QPData
from .nullspace import (NSOp, NSSettings, _cold_state, constr_op,
                        phased_loop, pin_ieee_fp32, plain_chunk, run_phases)

MODES = ("chunk", "blockrow", "spike")

#: the QPData leaves split over the ranks (dim 0 is the pair axis)
PAIR_LEAVES = ("pair_bi", "pair_bj", "pair_n", "pair_rhs", "pair_mask",
               "pair_qi", "pair_qj", "pair_rsum")


class SpikeOp(NamedTuple):
    """A SPIKE-prepared operator (``prepare_spike_np``); the chunk length
    Lq and the chunk count n are Dloc's dims."""
    base: NSOp      # shared leaves (N, x_pin, g, ..., Kos); Dinvs None
    Dloc: object    # [R, n, Lq, bs, bs] per-chunk interior chains
    Ssch: object    # [R, n-1, bs, bs] separator Schur pivots
    Soff: object    # [R, max(n-2, 1), bs, bs] S_{j, j+1} blocks


class ShardOp(NamedTuple):
    """One rank's share of a sharded solve's operator, on its device
    (``place``)."""
    base: NSOp      # leaves held whole; Dinvs is this rank's part: chunk
                    # [R, L, bs, bs] knot slab, blockrow [R, Mi, bs/n, bs]
                    # row slab, spike None
    mode: str
    n: int          # the rank count it was placed for
    Mi: int         # interior knots of the whole chain
    kin: object = None    # chunk: [L, phi, phi] couplings into its knots
    kout: object = None   # chunk: [L, phi, phi] couplings out of them
    Dloc: object = None   # spike: [R, Lq, bs, bs] its interior chain
    Ssch: object = None   # spike: [R, n-1, bs, bs]
    Soff: object = None   # spike: [R, max(n-2, 1), bs, bs]


def pad_pairs(data: QPData, mult: int) -> QPData:
    """Pad the pair axis to a multiple of ``mult`` with INACTIVE rows
    (mask 0, zero normals, -BIG rhs: the bounds clamp to (-BIG, BIG), the
    constraint never binds and its dual stays 0).  Host numpy; returns
    ``data`` itself when the pair axis already divides."""
    Pq = np.asarray(data.pair_n).shape[0]
    Pp = -(-Pq // mult) * mult
    if Pp == Pq:
        return data
    pad = Pp - Pq

    def padi(a, val):
        a = np.asarray(a)
        return np.concatenate(
            [a, np.full((pad,) + a.shape[1:], val, a.dtype)], axis=0)

    fill = dict(pair_bi=-1, pair_bj=-1, pair_n=0.0, pair_rhs=-BIG,
                pair_mask=0.0, pair_qi=-1, pair_qj=-1, pair_rsum=0.0)
    return dataclasses.replace(data, **{k: padi(getattr(data, k), v)
                                        for k, v in fill.items()})


def pad_knots(op: NSOp, mult: int) -> NSOp:
    """Zero-block pad the pivot inventory's KNOT axis to a multiple of
    ``mult`` (chunk mode).  Zero pivot blocks and zero rhs rows carry
    exact zeros through both sweeps, so the padded chain solves the
    original system with x = 0 on the pad knots.  Host numpy or tensors;
    returns ``op`` itself when the knot axis already divides."""
    d = op.Dinvs
    Mi = d.shape[1]
    Mp = -(-Mi // mult) * mult
    if Mp == Mi:
        return op
    shape = (d.shape[0], Mp) + tuple(d.shape[2:])
    out = (torch.zeros(shape, dtype=d.dtype, device=d.device)
           if isinstance(d, torch.Tensor) else np.zeros(shape, d.dtype))
    out[:, :Mi] = d
    return op._replace(Dinvs=out)


def chunk_couplings(kos, n_knots: int):
    """(kin, kout) [n_knots, phi, phi] of a chain of Mi = len(kos) + 1
    knots zero-padded to ``n_knots``: kin[k] couples knot k-1 into k
    (zero at knot 0 and on pads), kout[k] couples k into k+1 (zero from
    the last real knot on).  Rank r's chunk takes rows r*L .. r*L+L-1."""
    kos = torch.as_tensor(kos)
    z = kos.new_zeros((n_knots - kos.shape[0],) + tuple(kos.shape[1:]))
    return torch.cat([z[:1], kos, z[1:]]), torch.cat([kos, z])


def _check_phases(phases, mode: str):
    """The checks that the sharded solve can run ``phases`` in ``mode``."""
    if mode not in MODES:
        raise ValueError(f"unknown shard mode {mode!r}")
    for p in phases:
        if p.aa_depth:
            raise ValueError("sharded joint solve does not support aa_depth "
                             "phases")
        if p.kkt_refine and mode == "spike":
            # kkt_refine composes mathematically (the preconditioner is
            # just the spike apply) but is untested in this mode
            raise ValueError("mode='spike' does not support kkt_refine "
                             "phases yet")
        if p.kkt_mode != "banded":
            raise ValueError("sharded joint solve requires kkt_mode="
                             "'banded' (knot-chunk / block-row sharding)")


def place(data: QPData, op, group=None, mode: str = "chunk"):
    """This rank's share of a host problem, on the group's device, made
    contiguous ONCE (repeated solves re-slice nothing): (QPData with its
    slice of the pair rows and every other leaf whole, ShardOp).  ``data``
    and ``op`` hold host numpy leaves (or CPU tensors), as assemble and
    prepare_ns_np / prepare_spike_np give them."""
    if mode not in MODES:
        raise ValueError(f"unknown shard mode {mode!r}")
    if getattr(op, "Dinvs", None) is not None and \
            op.Dinvs.dtype == torch.bfloat16:
        raise ValueError("the sharded solve's sweeps (K3a/K3b) read float32 "
                         "pivots; a bf16 inventory (precond_dtype="
                         "'bfloat16') is for the single-device refine solve")
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    dev = pd.group_device(group)

    def put(v):
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        return torch.as_tensor(np.ascontiguousarray(v)).to(dev)

    data = pad_pairs(data, n)
    Pl = np.asarray(data.pair_n).shape[0] // n
    local = dataclasses.replace(data, **{
        k: np.asarray(getattr(data, k))[rank * Pl:(rank + 1) * Pl]
        for k in PAIR_LEAVES}).to(dev)

    if mode == "spike":
        if not isinstance(op, SpikeOp):
            raise ValueError("mode='spike' needs an operator prepared with "
                             "prepare_spike_np(data, s, n)")
        if int(op.Dloc.shape[1]) != n:
            raise ValueError(
                f"SPIKE operator was prepared for {int(op.Dloc.shape[1])} "
                f"chunks, the group has {n} ranks")
        base = op.base._replace(Dinvs=None)
        Mi = int(np.asarray(base.Kos).shape[0]) + 1
        return local, ShardOp(
            base=NSOp(*(None if v is None else put(v) for v in base)),
            mode=mode, n=n, Mi=Mi, Dloc=put(np.asarray(op.Dloc)[:, rank]),
            Ssch=put(op.Ssch), Soff=put(op.Soff))

    if isinstance(op, SpikeOp):
        raise ValueError(f"mode={mode!r} needs a banded operator "
                         "(prepare_ns_np), not a SPIKE one")
    dinv = np.asarray(op.Dinvs)
    if dinv.ndim != 4:
        raise ValueError("op must be prepared in the FLAT banded layout "
                         "[R, Mi, bs, bs]")
    R, Mi, bs = dinv.shape[0], dinv.shape[1], dinv.shape[-1]
    B, K3 = np.asarray(data.lb).shape[:2]
    phi = np.asarray(op.F0).shape[1]
    if bs != B * K3 * phi:
        raise ValueError(f"pivot blocks of {bs} rows, expected "
                         f"{B * K3 * phi} (an unpadded operator)")
    others = {k: None if getattr(op, k) is None else put(getattr(op, k))
              for k in NSOp._fields if k != "Dinvs"}
    if mode == "blockrow":
        if bs % n:
            raise ValueError(f"pivot block size {bs} must divide over {n} "
                             "ranks (pad agents, change the rank count, or "
                             "use mode='chunk')")
        rows = bs // n
        return local, ShardOp(
            base=NSOp(Dinvs=put(dinv[:, :, rank * rows:(rank + 1) * rows]),
                      **others), mode=mode, n=n, Mi=Mi)

    # chunk: this rank's knot slab and the couplings in and out of it
    dpad = np.asarray(pad_knots(op._replace(Dinvs=dinv), n).Dinvs)
    L = dpad.shape[1] // n
    kin, kout = chunk_couplings(np.asarray(op.Kos), n * L)
    sl = slice(rank * L, (rank + 1) * L)
    return local, ShardOp(
        base=NSOp(Dinvs=put(dpad[:, sl]), **others), mode=mode, n=n, Mi=Mi,
        kin=put(kin[sl]), kout=put(kout[sl]))


def _kinv_apply(sop: ShardOp, B: int, K3: int, phi: int, group):
    """The sharded KKT solve ``(rho_idx, rhs [B, K3, nw]) -> [B, K3, nw]``
    of ``sop.mode``; the result is the same on every rank."""
    op = sop.base
    Mi, n = sop.Mi, sop.n
    rank = dist.get_rank(group)
    bs = B * K3 * phi
    dt_, dev = op.x_pin.dtype, op.x_pin.device

    def rows(rhs):
        return rhs.reshape(B, K3, Mi, phi).permute(2, 0, 1, 3).reshape(Mi,
                                                                      bs)

    def state(x, shape):
        return x.reshape(Mi, B, K3, phi).permute(1, 2, 0, 3).reshape(shape)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt_, device=dev)

    if sop.mode == "chunk":
        L = op.Dinvs.shape[1]
        lo, hi = rank * L, min((rank + 1) * L, Mi)   # its real knots

        def apply_chunk(rho_idx, rhs):
            b = rows(rhs)
            b_loc = zeros(L, bs)
            if hi > lo:
                b_loc[:hi - lo] = b[lo:hi]
            t_in = pd.recv_prev(zeros(bs), group)
            T = thomas.thomas_chunk_fwd(op.Dinvs, sop.kin, b_loc, t_in,
                                        rho_idx)
            pd.send_next(T[L - 1], group)
            x_in = pd.recv_next(zeros(bs), group)
            x = thomas.thomas_chunk_bwd(op.Dinvs, sop.kout, T, x_in, rho_idx)
            pd.send_prev(x[0], group)
            return state(pd.all_gather_tiled(x, group)[:Mi], rhs.shape)

        return apply_chunk

    if sop.mode == "blockrow":
        Ho = op.Kos

        def apply_blockrow(rho_idx, rhs):
            # each rank computes its bs/n rows of Dinv @ v; one tiled
            # all_gather per knot reassembles the block vector
            Dinv = op.Dinvs[rho_idx]                  # [Mi, bs/n, bs]
            b = rows(rhs)

            def gather(v):
                return pd.all_gather_tiled(v, group)

            y = [b[0]]
            for k in range(1, Mi):
                y.append(b[k] - thomas.ko_t(Ho[k - 1],
                                            gather(Dinv[k - 1] @ y[k - 1])))
            x = [None] * Mi
            x[Mi - 1] = gather(Dinv[Mi - 1] @ y[Mi - 1])
            for k in range(Mi - 2, -1, -1):
                x[k] = gather(Dinv[k] @ (y[k] - thomas.ko(Ho[k], x[k + 1])))
            return state(torch.stack(x), rhs.shape)

        return apply_blockrow

    Lq = sop.Dloc.shape[1]
    Ho0 = op.Kos[0]
    # the interior chain's off-diagonal blocks, uniform (SPIKE's guard)
    Ho_loc = Ho0.expand(Lq - 1, *Ho0.shape).contiguous()
    Mp = n * Lq + (n - 1)
    sep_rows = torch.arange(n - 1, device=dev) * (Lq + 1) + Lq
    chunk_rows = (torch.arange(n, device=dev)[:, None] * (Lq + 1)
                  + torch.arange(Lq, device=dev)[None, :]).reshape(-1)

    def apply_spike(rho_idx, rhs):
        # two local chunk solves and a separator chain held on every rank:
        # one all_gather of the tips, one of the chunks, no rank waits on
        # another's chain
        Ss = sop.Ssch[rho_idx]                        # [n-1, bs, bs]
        So = sop.Soff[rho_idx]                        # [max(n-2, 1), bs, bs]
        b_full = zeros(Mp, bs)
        b_full[:Mi] = rows(rhs)
        b_loc = b_full[rank * (Lq + 1):rank * (Lq + 1) + Lq]
        b_sep = b_full[sep_rows]

        def local_solve(bl):
            # this rank's interior chain [R, Lq, bs, bs]: one Thomas solve
            return thomas.thomas_solve(sop.Dloc, Ho_loc, bl.contiguous(),
                                       rho_idx)

        u = local_solve(b_loc)
        tips = pd.all_gather_tiled(torch.stack([u[0], u[-1]])[None], group)
        uF, uL = tips[:, 0], tips[:, 1]               # [n, bs]
        # separator rhs: r_j = b_sep_j - Lo uL_j - Up uF_{j+1}
        r_sep = b_sep - thomas.ko_t(Ho0, uL[:n - 1]) - thomas.ko(Ho0, uF[1:])
        y_s = [r_sep[0]]
        for j in range(1, n - 1):
            y_s.append(r_sep[j] - So[j - 1].T @ (Ss[j - 1] @ y_s[j - 1]))
        x_sep = [None] * (n - 1)
        x_sep[n - 2] = Ss[n - 2] @ y_s[n - 2]
        for j in range(n - 3, -1, -1):
            x_sep[j] = Ss[j] @ (y_s[j] - So[j] @ x_sep[j + 1])
        x_sep = torch.stack(x_sep)
        # correction solve: boundary rhs from the separator values
        corr = zeros(Lq, bs)
        if rank > 0:
            corr[0] += thomas.ko_t(Ho0, x_sep[rank - 1])
        if rank < n - 1:
            corr[Lq - 1] += thomas.ko(Ho0, x_sep[rank])
        x_loc = u - local_solve(corr)
        x_full = zeros(Mp, bs)
        x_full[chunk_rows] = pd.all_gather_tiled(x_loc, group)
        x_full[sep_rows] = x_sep
        return state(x_full[:Mi], rhs.shape)

    return apply_spike


def _iterate_ns_sharded(data: QPData, sop: ShardOp, s: NSSettings, schedule,
                        group, init=None):
    """The phased knot-state ADMM on this rank's share: qp/nullspace's
    loop, ADMM step and PCG with the sharded constraint applies (one psum
    per A^T y, one pmax per residual check) and the sharded KKT solve.
    Returns (x, SolveInfo, state) from ``init`` (or the cold state)."""
    op = sop.base
    B, K3, _ = data.lb.shape
    pop, l, u, cold = _cold_state(data, op, s)
    cop = constr_op(pop, pair_sum=lambda t: pd.psum(t, group))
    chunk = plain_chunk(data, op, cop, l, u, s,
                        _kinv_apply(sop, B, K3, op.F0.shape[1], group))
    return phased_loop(data, op, s, schedule, chunk, cop, l, u, cold, init,
                       pair_max=lambda t: pd.pmax(t, group))


def solve_ns_phases_sharded(data: QPData, phases, op, group=None,
                            mode: str = "chunk"):
    """Run the phased knot-state ADMM with ONE problem partitioned over the
    ranks of ``group`` (None = the default group): pair constraints split
    over P, the KKT solve split by ``mode`` (see the module docstring).

    data/op: host leaves as produced by assemble + prepare_ns_np
    (prepare_spike_np for mode="spike"), or this rank's share from
    ``place`` (a ShardOp), which skips the padding and the transfer.
    Phases that differ only in max_iter / rho_lo / rho_hi (the production
    shape) run as one schedule, any other tuple phase by phase
    (nullspace.run_phases).  Returns (x [B, 3, D], SolveInfo) on the
    group's device, the same on every rank; SolveInfo.iters is the total
    over the phases."""
    _check_phases(phases, mode)
    if isinstance(op, ShardOp):
        n = dist.get_world_size(group)
        if op.mode != mode or op.n != n:
            raise ValueError(f"op was placed for mode={op.mode!r} over "
                             f"{op.n} ranks, not {mode!r} over {n}")
    else:
        data, op = place(data, op, group, mode)
    if mode == "spike" and op.n < 2:
        raise ValueError("mode='spike' needs at least 2 ranks")
    pin_ieee_fp32()

    def iterate(s, schedule, init):
        return _iterate_ns_sharded(data, op, s, schedule, group, init)

    with torch.no_grad():
        x, info, _ = run_phases(phases, op.base.ladder, iterate)
    return x, info


def rank_solve(data: QPData, phases, op, mode: str = "chunk"):
    """Rank worker for parallel.distributed.run_ranks: place the host
    problem on this rank's device, run solve_ns_phases_sharded on the
    default group, and return (x [B, 3, D] as float64 numpy, iterations,
    r_prim, objective, host seconds of the solve ending in a device
    sync)."""
    _check_phases(phases, mode)
    d, o = place(data, op, None, mode)
    dev = pd.group_device()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    x, info = solve_ns_phases_sharded(d, phases, o, None, mode)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    return (x.double().cpu().numpy(), int(info.iters), float(info.r_prim),
            float(info.obj), secs)


def rank_solve_many(cases):
    """Rank worker: ``rank_solve(*case)`` for each case, in order."""
    return [rank_solve(*c) for c in cases]


# ======================================================================
# SPIKE substructuring: a PARALLEL decomposition of the banded Thomas
# solve, against the chunk pipeline's sequential rank-to-rank chain.
#
# The knot axis is split into n interior chunks SEPARATED by single
# separator knots.  Each rank owns one chunk and solves it with no
# incoming carry; the n-1 separator unknowns satisfy a small
# block-tridiagonal Schur system whose per-rung factorization is
# precomputed at prep, like the main pivot inventory.  Per apply: a local
# interior solve, one all_gather of 2 [bs] tip rows per rank, the
# separator chain (n-1 small steps, on every rank), a local correction
# solve, one all_gather of the chunks: about twice the chunk pipeline's
# block applies for n-way parallelism of the chain.
# ======================================================================


def prepare_spike_np(data: QPData, s: NSSettings, n: int) -> SpikeOp:
    """Host-f64 SPIKE prep: per-chunk interior Schur chains and the
    separator Schur system's own chain, per rung.  Requires uniform
    segment durations (constant off-diagonal Ho) and Mi >= 2n.  Total
    pivot memory equals the plain inventory (the chunks repartition it);
    the separator chain adds (n-1)/Mi more."""
    from concurrent.futures import ThreadPoolExecutor

    from .nullspace import (_banded_kd_builder_np, _blas_single_threaded,
                            _host_prep_ctx_np, _inv_spd_np)

    ctx = _host_prep_ctx_np(data, s)
    Qseg, B3, dt_ = ctx["Qseg"], ctx["B3"], ctx["dt_"]
    Mi, ladder, C, c_s = ctx["Mi"], ctx["ladder"], ctx["C"], ctx["c_s"]
    make_Kd, Ho, bs = _banded_kd_builder_np(Qseg, ctx["L"], ctx["R"],
                                            C, c_s, s.sigma)
    if Mi > 1 and not np.allclose(Ho, Ho[:1], atol=1e-12):
        raise ValueError("SPIKE substructuring requires uniform segment "
                         "durations (constant off-diagonal Ho)")
    if Mi < 2 * n:
        raise ValueError(f"SPIKE needs Mi >= 2n (Mi={Mi}, n={n})")
    Up = np.kron(np.eye(B3), Ho[0])           # [bs, bs]; Lo = Up.T
    Lq = -(-(Mi - (n - 1)) // n)

    def gpos(c, i):
        return c * (Lq + 1) + i

    def sep_pos(j):
        return j * (Lq + 1) + Lq

    R_ = len(ladder)
    Dloc = np.zeros((R_, n, Lq, bs, bs), dtype=dt_)
    Ssch = np.zeros((R_, n - 1, bs, bs), dtype=dt_)
    Soff = np.zeros((R_, max(n - 2, 1), bs, bs), dtype=dt_)

    def fill_rung(r):
        rho = ladder[r]
        corners = []                 # per chunk: (VF, WF, WL)
        for c in range(n):
            # interior chain (restarted Schur recursion; pad knots stay 0)
            Dc = []
            prev = None
            for i in range(Lq):
                g = gpos(c, i)
                if g >= Mi:
                    break
                Kd = make_Kd(g, rho)
                if prev is not None:
                    Kd = Kd - Up.T @ prev @ Up
                prev = _inv_spd_np(Kd)
                Dc.append(prev)
                Dloc[r, c, i] = prev
            if not Dc:
                corners.append((np.zeros((bs, bs)),) * 3)
                continue
            # corner blocks of A_c^-1 by block solves with E_first /
            # E_last right-hand sides: VF = (A^-1)_FF, WF = (A^-1)_FL,
            # WL = (A^-1)_LL
            X = Dc[-1]
            WL = X
            for i in range(len(Dc) - 2, -1, -1):
                X = Dc[i] @ (-(Up @ X))
            WF = X
            Ys = [np.eye(bs)]
            for i in range(1, len(Dc)):
                Ys.append(-(Up.T @ (Dc[i - 1] @ Ys[-1])))
            X = Dc[-1] @ Ys[-1]
            for i in range(len(Dc) - 2, -1, -1):
                X = Dc[i] @ (Ys[i] - Up @ X)
            corners.append((X, WF, WL))

        # separator Schur system (block tridiagonal over j)
        Sdiag = []
        for j in range(n - 1):
            p = sep_pos(j)
            if p >= Mi:
                Sdiag.append(None)
                continue
            VF_r = corners[j + 1][0]
            WL_l = corners[j][2]
            Sdiag.append(make_Kd(p, rho) - Up.T @ WL_l @ Up
                         - Up @ VF_r @ Up.T)
            if j < n - 2:
                Soff[r, j] = -(Up @ corners[j + 1][1] @ Up)
        prev = None
        for j in range(n - 1):
            if Sdiag[j] is None:
                continue
            Sjj = Sdiag[j]
            if prev is not None:
                So = Soff[r, j - 1].astype(np.float64)
                Sjj = Sjj - So.T @ prev @ So
            prev = _inv_spd_np(Sjj)
            Ssch[r, j] = prev

    with _blas_single_threaded():
        workers = min(R_, max(1, ctx["n_workers"]))
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(fill_rung, range(R_)))

    def cast(v):
        return np.asarray(v).astype(dt_, copy=False)

    base = NSOp(N=cast(ctx["N"]), x_pin=cast(ctx["x_pin"]), g=cast(ctx["g"]),
                F0=cast(ctx["F0"]), FT=cast(ctx["FT"]), c_s=cast(c_s),
                ladder=cast(ladder), Dinvs=None, Kos=cast(Ho))
    return SpikeOp(base=base, Dloc=Dloc, Ssch=Ssch, Soff=Soff)
