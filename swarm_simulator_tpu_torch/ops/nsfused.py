"""The fused knot-state ADMM chunk: ``n_inner`` iterations in one launch.

``nsfused_chunk`` is the wrapper of the hand-written CUDA kernel in
``csrc/nsfused.cu`` (replacing the JAX package's Pallas TPU kernel
``ops/pallas_nsfused.py::_kernel``).  For CUDA tensors it launches the
kernel or raises; it takes the plain twin ``nsfused_chunk_reference`` only
for tensors on the CPU.  The twin is the ADMM step of qp/nullspace written
in plain torch with the banded Thomas solve (nullspace.make_kinv_apply
over the plain Thomas twin thomas.thomas_solve_reference);
it defines what the kernel computes and is what the CPU tests run.

Kernel layouts (B agents, B3 = 3B, M segments, Mi = M-1 interior knots,
bs = B3*phi, D = M*(n+1), P pairs), all float32 and contiguous:

  dinv   [R, Mi, bs, bs]  flat pivot inverses, row (agent*3+axis)*phi + f
  w      [Mi, bs]         knot-state rows (knot-major)
  box    [B3, D]          x_pin, bounds, z/y box parts
  pair   [P, D]           pair lower bounds, z/y pair parts
  pnm    [P, M, 3]        masked pair normals
  CSR    per agent: the pairs it belongs to and the signed mask weight
         (+c_j where it is the pair's j, -c_i where it is the pair's i),
         so A^T is a deterministic gather (no atomics)

The kernel library is built with nvcc on first use into the package's
git-ignored ``build/`` directory (ops/_build) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build, thomas
from .thomas import TWIN_GAP_FACTOR, TWIN_GAP_FLOOR  # noqa: F401


class FusedOperands(NamedTuple):
    """Static per-problem operands of one solve (built once per solve)."""
    # solver-layout inputs of the plain twin
    data: object
    op: object
    pop: object
    l: object
    u: object
    # kernel-layout float32 operands
    dinv: torch.Tensor    # [R, Mi, bs, bs]
    ho: torch.Tensor      # [Mi-1, phi, phi]
    lmap: torch.Tensor    # [M, phi, phi]  L = F0^-1 per segment
    rmap: torch.Tensor    # [M, phi, phi]  R = FT^-1 per segment
    xpin: torch.Tensor    # [B3, D]
    g: torch.Tensor       # [Mi, bs]
    lb: torch.Tensor      # [B3, D]
    ub: torch.Tensor      # [B3, D]
    pl: torch.Tensor      # [P, D]
    pnm: torch.Tensor     # [P, M, 3]
    pi: torch.Tensor      # [P] int32 (clamped agent index of qi)
    pj: torch.Tensor      # [P] int32
    ci: torch.Tensor      # [P] float32 mask weight of the i side
    cj: torch.Tensor      # [P] float32 mask weight of the j side
    aptr: torch.Tensor    # [B+1] int32 CSR row pointers
    apair: torch.Tensor   # [nnz] int32 pair index
    acoef: torch.Tensor   # [nnz] float32 signed weight
    ladder: np.ndarray    # [R] float32 host copy of the rho rungs
    dims: dict


def rows_from_state(v: torch.Tensor, Mi: int, phi: int) -> torch.Tensor:
    """[B, K3, nw] knot states -> knot-major rows [Mi, B*K3*phi]."""
    B, K3, _ = v.shape
    return (v.reshape(B * K3, Mi, phi).permute(1, 0, 2)
            .reshape(Mi, B * K3 * phi))


def state_from_rows(r: torch.Tensor, B: int, K3: int, phi: int) -> torch.Tensor:
    """Inverse of rows_from_state."""
    Mi = r.shape[0]
    return (r.reshape(Mi, B * K3, phi).permute(1, 0, 2)
            .reshape(B, K3, Mi * phi))


def pair_csr(pair_bi: np.ndarray, pair_bj: np.ndarray,
             pair_mask: np.ndarray, B: int):
    """Per-agent pair lists of the signed selection S[p, b] =
    c_j [b == bj] - c_i [b == bi]: (row pointers [B+1], pair index,
    weight), pairs in ascending order within each agent."""
    bi = np.asarray(pair_bi).astype(np.int64)
    bj = np.asarray(pair_bj).astype(np.int64)
    pm = np.asarray(pair_mask, np.float64)
    p = np.arange(len(bi))
    agent = np.concatenate([bj[bj >= 0], bi[bi >= 0]])
    pair = np.concatenate([p[bj >= 0], p[bi >= 0]])
    coef = np.concatenate([pm[bj >= 0], -pm[bi >= 0]])
    order = np.lexsort((pair, agent))
    ptr = np.zeros(B + 1, np.int64)
    np.add.at(ptr, agent + 1, 1)
    return (np.cumsum(ptr).astype(np.int32), pair[order].astype(np.int32),
            coef[order].astype(np.float32))


def refuse_bf16(dinv) -> None:
    """A bf16 inventory (NSSettings.precond_dtype="bfloat16") is a
    preconditioner for the kkt_refine >= 1 solve through ops/thomas, never
    the operator of a refine-0 solve (K1's chunk or the K2 route)."""
    if isinstance(dinv, torch.Tensor) and dinv.dtype == torch.bfloat16:
        raise ValueError(
            "bf16 pivot inventory (precond_dtype='bfloat16') requires "
            "kkt_refine >= 1 (the Thomas solve, K2): a refine-0 solve (the "
            "fused chunk K1, or the K2 route) would widen it back to "
            "float32 and solve with the rounded pivots as its exact "
            "operator")


def build_operands(data, op, pop, l, u) -> FusedOperands:
    """Kernel operands from the solver's data, operator, pair operator and
    (tightened) bounds — all tensors on one device.  Refuses a bf16 pivot
    inventory (refuse_bf16)."""
    refuse_bf16(op.Dinvs)
    B, K3, D = data.lb.shape
    M = data.Qseg.shape[0]
    npp = D // M
    Mi = M - 1
    phi = op.F0.shape[1]
    P = data.pair_n.shape[0]
    dev = data.lb.device
    f32 = torch.float32

    def t32(a):
        return torch.as_tensor(a).to(device=dev, dtype=f32).contiguous()

    F0 = op.F0.detach().cpu().double().numpy()
    FT = op.FT.detach().cpu().double().numpy()
    aptr, apair, acoef = pair_csr(data.pair_bi.cpu().numpy(),
                                  data.pair_bj.cpu().numpy(),
                                  data.pair_mask.cpu().numpy(), B)
    mask = data.pair_mask
    dims = dict(B=B, K3=K3, D=D, M=M, npp=npp, Mi=Mi, phi=phi, P=P,
                B3=B * K3, bs=B * K3 * phi, R=op.Dinvs.shape[0])
    return FusedOperands(
        data=data, op=op, pop=pop, l=l, u=u,
        dinv=t32(op.Dinvs), ho=t32(op.Kos),
        lmap=t32(np.linalg.inv(F0)), rmap=t32(np.linalg.inv(FT)),
        xpin=t32(op.x_pin.reshape(B * K3, D)),
        g=t32(rows_from_state(op.g, Mi, phi)),
        lb=t32(l.box.reshape(B * K3, D)), ub=t32(u.box.reshape(B * K3, D)),
        pl=t32(l.pair), pnm=t32(data.pair_n * mask[:, None, None]),
        pi=pop.bi.to(device=dev, dtype=torch.int32).contiguous(),
        pj=pop.bj.to(device=dev, dtype=torch.int32).contiguous(),
        ci=t32(pop.ci), cj=t32(pop.cj),
        aptr=torch.as_tensor(aptr, device=dev),
        apair=torch.as_tensor(apair, device=dev),
        acoef=torch.as_tensor(acoef, device=dev),
        ladder=op.ladder.detach().cpu().numpy().astype(np.float32),
        dims=dims)


class CardLimits(NamedTuple):
    """What K1's launch needs to know of a card."""
    sms: int          # multiprocessors (the cooperative grid: one block each)
    smem_optin: int   # dynamic shared memory a block may opt in to, bytes


#: an H100 SXM's limits (132 SMs, 227 KB of shared memory a block)
H100 = CardLimits(sms=132, smem_optin=thomas.SMEM_PER_BLOCK)

#: csrc/nsfused.cu: kMaxPhi, the knot-state width its registers hold
MAX_PHI = 4
#: the kernel indexes the [Mi, bs] rows, the [B3, D] box and the [P, D]
#: pair arrays and the agents' pair lists with 32-bit ints
INDEX_LIMIT = 2 ** 31


def card_limits(device) -> CardLimits:
    """The limits of the CUDA card ``device``."""
    p = torch.cuda.get_device_properties(device)
    return CardLimits(sms=p.multi_processor_count,
                      smem_optin=p.shared_memory_per_block_optin)


def unfit_reasons(B: int, M: int, P: int, limits: CardLimits,
                  phi: int = 3) -> list[str]:
    """The rules of csrc/nsfused.cu that a problem of B agents, M segments
    and P pairs breaks on a card of ``limits`` (empty: K1 runs it).  The
    kernel's own limits, not the TPU kernel's (its 256-lane group and
    8-sublane rules are Mosaic's): the knot-state width, at least one
    interior knot, the ring plan of the chain (thomas.ring_plan: a
    two-slot ring beside the block's rows) within the block's opt-in
    shared memory, a cooperative grid of one block per SM that holds the
    chain's blocks, and 32-bit element indices."""
    reasons = []
    if not 1 <= phi <= MAX_PHI:
        reasons.append(f"phi {phi} outside [1, {MAX_PHI}]")
    if M < 2:
        reasons.append(f"M = {M}: no interior knot")
    if reasons:
        return reasons
    B3, Mi, D = 3 * B, M - 1, M * 2 * phi
    bs = B3 * phi
    try:
        plan = thomas.ring_plan(bs, phi, 4, sms=limits.sms)
    except ValueError as e:
        return [f"ring plan: {e}"]
    if plan.smem > limits.smem_optin:
        reasons.append(f"ring plan needs {plan.smem} bytes of shared memory "
                       f"a block, the card allows {limits.smem_optin}")
    if -(-B3 // plan.groups) > limits.sms:
        reasons.append(f"{-(-B3 // plan.groups)} chain blocks on "
                       f"{limits.sms} SMs")
    for name, n in (("Mi * bs", Mi * bs), ("B3 * D", B3 * D),
                    ("P * D", P * D), ("pair-list entries", 2 * P)):
        if n >= INDEX_LIMIT:
            reasons.append(f"{name} = {n} elements overflow 32-bit indices")
    return reasons


def fits(B: int, M: int, P: int, device, phi: int = 3) -> bool:
    """Whether K1 runs a problem of B agents, M segments and P pairs on
    ``device`` (a CUDA device, or CardLimits such as H100) —
    unfit_reasons is empty."""
    limits = device if isinstance(device, CardLimits) else card_limits(device)
    return not unfit_reasons(B, M, P, limits, phi)


def nsfused_chunk_reference(ops: FusedOperands, rho_idx: int, sigma: float,
                            alpha: float, w, z, y, n_inner: int):
    """Plain torch twin: ``n_inner`` knot-state ADMM iterations
    (qp/nullspace's admm step with the banded Thomas solve) in the dtype
    of the state.  Returns the new (w, z, y)."""
    from ..qp import nullspace as ns

    if w.is_cuda:
        nsfused_chunk_reference.cuda_calls += 1
    d = ops.dims
    kinv_apply = ns.make_kinv_apply(ops.op, d["B"], d["K3"], d["M"],
                                    d["phi"],
                                    solve=thomas.thomas_solve_reference)
    return ns.admm_steps(ops.op, ns.constr_op(ops.pop), ops.l, ops.u,
                         rho_idx, sigma, alpha, w, z, y, n_inner,
                         lambda rhs_w, rho: kinv_apply(rho_idx, rhs_w))


nsfused_chunk_reference.cuda_calls = 0

#: the parts of a chunk's state (w, z, y) that the kernel is judged on
STATE_PARTS = ("w", "z_box", "z_pair", "y_box", "y_pair")


def state_errors(a, b) -> list[float]:
    """max |a - b| of two chunk results (w, z, y), per part of
    STATE_PARTS, each relative to that part's own scale max |b| (the duals
    y are orders of magnitude below the primal state, so one shared scale
    would hide an error in them)."""
    return [thomas.rel_error(x, ref)
            for x, ref in zip((a[0], *a[1], *a[2]), (b[0], *b[1], *b[2]))]


def twin_gap_use(kernel_vs_f64, f32_vs_f64) -> dict[str, float]:
    """Per state part, the share of its tolerance the kernel uses
    (thomas.twin_gap_use's rule on each part).  Arguments: one
    state_errors list per rung."""
    return {name: thomas.twin_gap_use([k[i] for k in kernel_vs_f64],
                                      [t[i] for t in f32_vs_f64])
            for i, name in enumerate(STATE_PARTS)}


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nsfused_chunk.restype = ci
    lib.nsfused_chunk.argtypes = [vp] * 32 + [ci] * 9 + [cf] * 3 + [vp]
    lib.nsfused_error_string.restype = ctypes.c_char_p
    lib.nsfused_error_string.argtypes = [ci]


def _check(name: str, t: torch.Tensor, shape: tuple, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"nsfused_chunk: {name} is on {t.device}, "
                         "expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"nsfused_chunk: {name} has dtype {t.dtype}, "
                         f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"nsfused_chunk: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"nsfused_chunk: {name} is not contiguous")


def nsfused_chunk(ops: FusedOperands, rho_idx: int, sigma: float,
                  alpha: float, w, z, y, n_inner: int):
    """``n_inner`` knot-state ADMM iterations at rung ``rho_idx``.

    w [B, 3, nw], z/y NSConstr(box [B, 3, D], pair [P, D]).  CUDA float32
    tensors launch the fused kernel once; CPU tensors run the plain twin;
    anything else raises.  Returns the new (w, z, y)."""
    refuse_bf16(ops.op.Dinvs)
    if w.device.type == "cpu":
        return nsfused_chunk_reference(ops, rho_idx, sigma, alpha, w, z, y,
                                       n_inner)
    from ..qp.nullspace import NSConstr

    d = ops.dims
    B, K3, D, M, P = d["B"], d["K3"], d["D"], d["M"], d["P"]
    Mi, phi, B3, bs, R = d["Mi"], d["phi"], d["B3"], d["bs"], d["R"]
    if K3 != 3 or d["npp"] != 2 * phi:
        raise ValueError(f"nsfused_chunk: unsupported dims {d}")
    if not 0 <= rho_idx < R:
        raise ValueError(f"nsfused_chunk: rung {rho_idx} outside [0, {R})")
    w_rows = rows_from_state(w, Mi, phi).contiguous()
    zb = z.box.reshape(B3, D).contiguous()
    yb = y.box.reshape(B3, D).contiguous()
    zp = z.pair.contiguous()
    yp = y.pair.contiguous()
    for name, t, shape in (
            ("w", w_rows, (Mi, bs)), ("z.box", zb, (B3, D)),
            ("y.box", yb, (B3, D)), ("z.pair", zp, (P, D)),
            ("y.pair", yp, (P, D)), ("dinv", ops.dinv, (R, Mi, bs, bs)),
            ("ho", ops.ho, (Mi - 1, phi, phi)),
            ("lmap", ops.lmap, (M, phi, phi)),
            ("rmap", ops.rmap, (M, phi, phi)),
            ("xpin", ops.xpin, (B3, D)), ("g", ops.g, (Mi, bs)),
            ("lb", ops.lb, (B3, D)), ("ub", ops.ub, (B3, D)),
            ("pl", ops.pl, (P, D)), ("pnm", ops.pnm, (P, M, 3)),
            ("ci", ops.ci, (P,)), ("cj", ops.cj, (P,))):
        _check(name, t, shape)
    nnz = ops.apair.shape[0]
    for name, t, shape in (("pi", ops.pi, (P,)), ("pj", ops.pj, (P,)),
                           ("aptr", ops.aptr, (B + 1,)),
                           ("apair", ops.apair, (nnz,))):
        _check(name, t, shape, torch.int32)
    _check("acoef", ops.acoef, (nnz,))
    unfit = unfit_reasons(B, M, P, card_limits(w.device), phi)
    if unfit:
        raise ValueError("nsfused_chunk: the problem does not fit the "
                         "kernel (" + "; ".join(unfit) + "); route it "
                         "through qp/joint.select_kkt_path")

    lib = _build.load("nsfused", _declare)
    w_o = torch.empty_like(w_rows)
    zb_o, yb_o = torch.empty_like(zb), torch.empty_like(yb)
    zp_o, yp_o = torch.empty_like(zp), torch.empty_like(yp)
    rhs = torch.empty_like(w_rows)
    t_rows = torch.empty_like(w_rows)
    at = torch.empty_like(zb)
    xt = torch.empty_like(zb)
    plan = thomas.ring_plan(bs, phi, 4, sms=thomas.sm_count(w.device))
    # the chain's vector entries, 64 bits each (csrc/chain_ring.cuh)
    vbuf = torch.empty((2, bs), dtype=torch.int64, device=w.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = lib.nsfused_chunk(
        ptr(ops.dinv[rho_idx]), ptr(ops.ho), ptr(ops.lmap), ptr(ops.rmap),
        ptr(ops.xpin), ptr(ops.g), ptr(ops.lb), ptr(ops.ub), ptr(ops.pl),
        ptr(ops.pnm), ptr(ops.pi), ptr(ops.pj), ptr(ops.ci), ptr(ops.cj),
        ptr(ops.aptr), ptr(ops.apair), ptr(ops.acoef),
        ptr(w_rows), ptr(zb), ptr(zp), ptr(yb), ptr(yp),
        ptr(w_o), ptr(zb_o), ptr(zp_o), ptr(yb_o), ptr(yp_o),
        ptr(rhs), ptr(t_rows), ptr(at), ptr(xt), ptr(vbuf),
        B, M, phi, P, int(n_inner), plan.groups, plan.tile_rows,
        plan.slots, plan.smem,
        float(ops.ladder[rho_idx]), float(sigma), float(alpha),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"nsfused_chunk: CUDA error {err} "
            f"({lib.nsfused_error_string(err).decode()})")
    nsfused_chunk.launches += 1
    # the scratch tensors may be released while the launch is in flight:
    # the caching allocator reuses their blocks only in stream order
    return (state_from_rows(w_o, B, K3, phi),
            NSConstr(box=zb_o.reshape(B, K3, D), pair=zp_o),
            NSConstr(box=yb_o.reshape(B, K3, D), pair=yp_o))


nsfused_chunk.launches = 0


# ---- the stack axis: one launch of K1's stacked form for many problems ----

class StackOperands(NamedTuple):
    """The FusedOperands of a stack of problems of one shape, stacked once
    per solve for the stacked kernel (csrc/nsfused_stack.cu).  An entry's
    pair list has its own length (padded pairs carry no list entries), so
    the lists are concatenated and ``aoff`` holds each entry's offset."""
    entries: tuple        # the entries' FusedOperands (the plain twin's)
    dinv: torch.Tensor    # [L, R, rung] each rung flat, padded to `rung`
    ho: torch.Tensor      # [L, Mi-1, phi, phi]
    lmap: torch.Tensor    # [L, M, phi, phi]
    rmap: torch.Tensor    # [L, M, phi, phi]
    xpin: torch.Tensor    # [L, B3, D]
    g: torch.Tensor       # [L, Mi, bs]
    lb: torch.Tensor      # [L, B3, D]
    ub: torch.Tensor      # [L, B3, D]
    pl: torch.Tensor      # [L, P, D]
    pnm: torch.Tensor     # [L, P, M, 3]
    pi: torch.Tensor      # [L, P] int32
    pj: torch.Tensor      # [L, P] int32
    ci: torch.Tensor      # [L, P]
    cj: torch.Tensor      # [L, P]
    aptr: torch.Tensor    # [L, B+1] int32, within the entry's own list
    aoff: torch.Tensor    # [L] int32 the entry's first list entry
    apair: torch.Tensor   # [nnz of all entries] int32
    acoef: torch.Tensor   # [nnz of all entries] float32
    ladders: np.ndarray   # [L, R] float32 host copy of each entry's rungs
    dims: dict            # the entries' common dims, and "rung"


#: nsfused_stack and its twin take and return the stack's state as tensors
#: with a leading entry axis (tools/chain_bench tells checkouts apart by it)
STACK_STATE_AXIS = True

#: csrc/nsfused_stack.cu: bytes before the rung in shared memory (its
#: mbarrier, 16-byte padded)
STACK_BAR_BYTES = 16
#: csrc/nsfused_stack.cu: threads a block, the largest (portable) cluster,
#: the most ways an agent's pair list is split in the A^T gather, the
#: chain's threads a row
STACK_THREADS = 1024
STACK_MAX_CLUSTER = 8
STACK_MAX_SPLIT = 8
STACK_ROW_SPLIT = 4
#: csrc/nsfused_stack.cu: the chain block's threads that widen the next
#: stage's rows (the chain's team runs in the others)
STACK_STAGERS = 256


def rung_floats(M: int, B: int, phi: int = 3) -> int:
    """Floats of one flat rung [Mi, bs, bs] padded to a multiple of 4, so
    that every rung of a stacked inventory starts on 16 bytes (one bulk
    copy moves it whole)."""
    bs = 3 * B * phi
    return -(-(M - 1) * bs * bs // 4) * 4


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def stack_team_rows(phi: int = 3) -> int:
    """Rows a warp of the stacked kernel's chain team holds: whole
    agent-axis triples (phi rows each) at STACK_ROW_SPLIT lanes a row."""
    return 32 // STACK_ROW_SPLIT // phi * phi


def stack_smem_bytes(B: int, M: int, phi: int = 3) -> int:
    """Shared memory of the stacked kernel's chain block: its barrier, the
    active rung (float32), the right-hand sides and the Thomas rows ([Mi,
    bs] each), the chain's vector [2, bs] (double-buffered), Ho, and two
    slots of a stage's rows widened (float64)."""
    bs, Mi = 3 * B * phi, M - 1
    o = _up16(STACK_BAR_BYTES + 4 * rung_floats(M, B, phi))
    o = _up16(o + 8 * Mi * bs)
    o = _up16(o + 8 * Mi * bs)
    o = _up16(o + 2 * 8 * bs)
    o = _up16(o + 8 * (Mi - 1) * phi * phi)
    return _up16(o + 2 * 8 * bs * bs)


def stack_partner_knots(M: int, cluster: int) -> int:
    """Knots a partner block of the stacked kernel owns in clusters of
    ``cluster`` blocks (the last one the rest)."""
    return -(-(M - 1) // (cluster - 1))


def stack_partner_bytes(B: int, M: int, P: int, cluster: int,
                        phi: int = 3) -> int:
    """Shared memory of a partner block of the stacked kernel in clusters
    of ``cluster`` blocks (csrc/nsfused_stack.cu's layout), for its run of
    kq knots and the at most dmax = kq (2 phi) + 2 phi columns they map:
    x_t of every row at the columns (aliased by the gather's partial sums),
    z_box and y_box there, w and w_t of the knots, the pair rows' values
    (float64); x_pin and the box bounds at the columns, the pair rows'
    lower bounds, g of the knots, the L and R maps, the pairs' agents and
    mask weights, the agents' pair lists (32-bit), and the pair normals
    of the kq + 1 segments the columns touch."""
    B3, npp = 3 * B, 2 * phi
    bs, D = B3 * phi, M * npp
    kq = stack_partner_knots(M, cluster)
    dmax = min(kq * npp + 2 * phi, D)
    split = min(STACK_MAX_SPLIT, max(1, STACK_THREADS // (B * kq * npp)))
    o = _up16(8 * max(B3 * dmax, B3 * split * kq * npp))
    for n in (8 * B3 * dmax, 8 * B3 * dmax, 8 * kq * bs, 8 * kq * bs,
              8 * P * dmax, 4 * B3 * dmax, 4 * B3 * dmax, 4 * B3 * dmax,
              4 * P * dmax, 4 * kq * bs, 4 * M * phi * phi,
              4 * M * phi * phi, 8 * P, 8 * P, 4 * (B + 1), 8 * P, 8 * P,
              12 * P * (kq + 1)):
        o = _up16(o + n)
    return o


class StackPlan(NamedTuple):
    """How csrc/nsfused_stack.cu runs an entry: a cluster of ``cluster``
    blocks (the chain block and cluster - 1 partners, each a run of
    stack_partner_knots knots) and each block's dynamic shared memory
    (``smem``, the larger of the chain block's and a partner's)."""
    cluster: int
    smem: int


#: the fewest partners the plan gives an entry
STACK_MIN_PARTNERS = 4


def stack_plan(B: int, M: int, P: int, limits=None,
               phi: int = 3) -> StackPlan | None:
    """The cluster plan of an entry of B agents, M segments and P pairs
    within ``limits`` (CardLimits; None: no limit): the fewest partners,
    from STACK_MIN_PARTNERS (fewer where M has fewer interior knots) to
    STACK_MAX_CLUSTER - 1, whose shared memory holds their knots' columns
    of the state, each partner at least one knot; None when no cluster
    holds the entry (the chain block's rung does not fit, or a partner's
    columns at 7 partners).  It depends on the shapes and the card alone,
    never on the stack."""
    optin = float("inf") if limits is None else limits.smem_optin
    chain = stack_smem_bytes(B, M, phi)
    if chain > optin or M < 2:
        return None
    Mi = M - 1
    for q in range(min(STACK_MIN_PARTNERS, Mi), STACK_MAX_CLUSTER):
        kq = stack_partner_knots(M, q + 1)
        if (q - 1) * kq >= Mi:  # a partner without a knot
            continue
        part = stack_partner_bytes(B, M, P, q + 1, phi)
        if part <= optin:
            return StackPlan(q + 1, max(chain, part))
    return None


def stack_fits(B: int, M: int, P: int, limits, phi: int = 3) -> bool:
    """Whether the stacked kernel holds an entry of B agents, M segments
    and P pairs on a card of ``limits`` (CardLimits, or a CUDA device):
    the knot-state width, an interior knot, a cluster plan (stack_plan:
    the chain block's rung and vectors, and a partner's columns of the
    state, within a block's opt-in shared memory), the chain's team
    within a block, and 32-bit indices within an entry.  At M = 36 on an
    H100 groups of 4 fit (bs 36: a 181,440-byte rung) and groups of 8 do
    not (bs 72: 725,760 bytes)."""
    if not isinstance(limits, CardLimits):
        limits = card_limits(limits)
    if not (1 <= phi <= MAX_PHI and M >= 2):
        return False
    bs, D = 3 * B * phi, M * 2 * phi
    return (stack_plan(B, M, P, limits, phi) is not None
            and 32 * -(-bs // stack_team_rows(phi))
            <= STACK_THREADS - STACK_STAGERS
            and max((M - 1) * bs * bs, 3 * B * D, P * D, 3 * P * M, 2 * P)
            < INDEX_LIMIT)


def stack_operands(entries) -> StackOperands:
    """Stack the FusedOperands of problems of one shape (ValueError
    otherwise) for nsfused_stack."""
    entries = tuple(entries)
    d = entries[0].dims
    for e in entries[1:]:
        if e.dims != d:
            raise ValueError(f"stack_operands: an entry of dims {e.dims} "
                             f"in a stack of {d}")
    rung = rung_floats(d["M"], d["B"], d["phi"])
    flat = d["Mi"] * d["bs"] ** 2
    dinv = entries[0].dinv.new_zeros((len(entries), d["R"], rung))
    for i, e in enumerate(entries):
        dinv[i, :, :flat] = e.dinv.reshape(d["R"], flat)
    nnz = [int(e.apair.shape[0]) for e in entries]
    dev = dinv.device

    def stk(name):
        return torch.stack([getattr(e, name) for e in entries]).contiguous()

    return StackOperands(
        entries=entries, dinv=dinv,
        **{k: stk(k) for k in ("ho", "lmap", "rmap", "xpin", "g", "lb",
                               "ub", "pl", "pnm", "pi", "pj", "ci", "cj",
                               "aptr")},
        aoff=torch.as_tensor(np.cumsum([0] + nnz[:-1]), dtype=torch.int32,
                             device=dev),
        apair=torch.cat([e.apair for e in entries]),
        acoef=torch.cat([e.acoef for e in entries]),
        ladders=np.stack([e.ladder for e in entries]),
        dims=dict(d, rung=rung))


def nsfused_stack_reference(ops: StackOperands, active, rho_idx, sigma: float,
                            alpha: float, w, z, y, n_inner: int):
    """Plain twin of nsfused_stack: nsfused_chunk_reference on each active
    entry's rows with its own rung; the other entries' rows are passed
    through."""
    from ..qp.nullspace import NSConstr

    if w.is_cuda:
        nsfused_stack_reference.cuda_calls += 1
    w, zb, zp, yb, yp = (t.clone() for t in (w, *z, *y))
    for i in active:
        w[i], (zb[i], zp[i]), (yb[i], yp[i]) = nsfused_chunk_reference(
            ops.entries[i], rho_idx[i], sigma, alpha, w[i],
            NSConstr(zb[i], zp[i]), NSConstr(yb[i], yp[i]), n_inner)
    return w, NSConstr(zb, zp), NSConstr(yb, yp)


nsfused_stack_reference.cuda_calls = 0


def _declare_stack(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nsfused_stack.restype = ci
    lib.nsfused_stack.argtypes = ([vp] * 26 + [ci] * 9
                                  + [ctypes.c_double] * 2 + [vp])
    lib.nsfused_stack_smem.restype = ctypes.c_longlong
    lib.nsfused_stack_smem.argtypes = [ci] * 6
    lib.nsfused_stack_error_string.restype = ctypes.c_char_p
    lib.nsfused_stack_error_string.argtypes = [ci]


def nsfused_stack(ops: StackOperands, active, rho_idx, sigma: float,
                  alpha: float, w, z, y, n_inner: int, *, _lib=None,
                  _state=None):
    """``n_inner`` knot-state ADMM iterations of each ``active`` entry of a
    stack, each at its own rung ``rho_idx[i]`` (one rung an entry of the
    stack); the other entries are frozen.

    w, z, y: the stack's state with a leading entry axis (w [L, B, 3, nw],
    z/y NSConstr(box [L, B, 3, D], pair [L, P, D])).  CUDA float32 tensors
    launch the stacked kernel once (a cluster of blocks an active entry,
    stack_plan; the active entries' rows gathered and widened to float64
    for the chunk and rounded back to float32 after it,
    csrc/nsfused_stack.cu says why); CPU tensors run the plain twin;
    anything else raises.
    Returns new tensors (w, z, y), the frozen entries' rows passed
    through bit for bit.  ``_lib`` and ``_state`` (a variant library of
    ``stack_variant`` and its state dtype) are for the measuring tools: a
    launch through them is not counted."""
    active = [int(i) for i in active]
    if not active:
        raise ValueError("nsfused_stack: no active entry")
    refuse_bf16(ops.entries[0].op.Dinvs)
    if w.device.type == "cpu":
        return nsfused_stack_reference(ops, active, rho_idx, sigma, alpha,
                                       w, z, y, n_inner)
    from ..qp.nullspace import NSConstr

    d = ops.dims
    B, K3, D, M, P = d["B"], d["K3"], d["D"], d["M"], d["P"]
    Mi, phi, B3, bs, R = d["Mi"], d["phi"], d["B3"], d["bs"], d["R"]
    L, n = len(ops.entries), len(active)
    if K3 != 3 or d["npp"] != 2 * phi:
        raise ValueError(f"nsfused_stack: unsupported dims {d}")
    for i in active:
        if not 0 <= i < L:
            raise ValueError(f"nsfused_stack: entry {i} outside [0, {L})")
        if not 0 <= rho_idx[i] < R:
            raise ValueError(f"nsfused_stack: entry {i}'s rung "
                             f"{rho_idx[i]} outside [0, {R})")
    dev = w.device
    # a block's entry, rung and rho (its float32 bits), one copy from
    # pinned memory, so the host does not wait for the stream here
    rho = np.asarray([ops.ladders[i][rho_idx[i]] for i in active],
                     np.float32)
    blk = torch.from_numpy(np.concatenate([
        np.asarray(active, np.int32),
        np.asarray([rho_idx[i] for i in active], np.int32),
        rho.view(np.int32)]))
    if dev.type == "cuda":
        blk = blk.pin_memory()
    blk = blk.to(dev, non_blocking=True)
    idx = blk[:n].long()
    # the active rows; [n, B, K3, nw] -> knot-major rows [n, Mi, bs]
    # (rows_from_state)
    w_rows = (w.index_select(0, idx).reshape(n, B3, Mi, phi)
              .permute(0, 2, 1, 3).reshape(n, Mi, bs).contiguous())
    zb, yb = (t.box.index_select(0, idx).reshape(n, B3, D) for t in (z, y))
    zp, yp = (t.pair.index_select(0, idx) for t in (z, y))
    named = [("w", w_rows, (n, Mi, bs)), ("z.box", zb, (n, B3, D)),
             ("y.box", yb, (n, B3, D)), ("z.pair", zp, (n, P, D)),
             ("y.pair", yp, (n, P, D)),
             ("dinv", ops.dinv, (L, R, d["rung"])),
             ("ho", ops.ho, (L, Mi - 1, phi, phi)),
             ("lmap", ops.lmap, (L, M, phi, phi)),
             ("rmap", ops.rmap, (L, M, phi, phi)),
             ("xpin", ops.xpin, (L, B3, D)), ("g", ops.g, (L, Mi, bs)),
             ("lb", ops.lb, (L, B3, D)), ("ub", ops.ub, (L, B3, D)),
             ("pl", ops.pl, (L, P, D)), ("pnm", ops.pnm, (L, P, M, 3)),
             ("ci", ops.ci, (L, P)), ("cj", ops.cj, (L, P)),
             ("acoef", ops.acoef, (ops.apair.shape[0],))]
    _build.check_operands("nsfused_stack", named)
    _build.check_operands("nsfused_stack", (
        ("pi", ops.pi, (L, P)), ("pj", ops.pj, (L, P)),
        ("aptr", ops.aptr, (L, B + 1)), ("aoff", ops.aoff, (L,)),
        ("apair", ops.apair, (ops.acoef.shape[0],))), torch.int32)
    limits = card_limits(dev)
    if not stack_fits(B, M, P, limits, phi):
        raise ValueError(f"nsfused_stack: an entry of {B} agents, M = {M}, "
                         f"{P} pairs does not fit a cluster of the card; "
                         "route the stack by qp/nullspace.stack_route")
    plan = stack_plan(B, M, P, limits, phi)
    # the chunk's state in float64, in place (csrc/nsfused_stack.cu)
    wide = torch.float64 if _state is None else _state
    w_rows, zb, yb, zp, yp = (t.to(wide) for t in (w_rows, zb, yb, zp, yp))
    lib = _lib or _build.load("nsfused_stack", _declare_stack)
    smem = lib.nsfused_stack_smem(B, M, phi, P, d["rung"], plan.cluster)
    if _lib is None and smem != plan.smem:
        raise RuntimeError(f"nsfused_stack: the kernel lays out {smem} bytes "
                           f"a block, stack_plan {plan.smem}")
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    err = lib.nsfused_stack(
        ptr(ops.dinv), ptr(ops.ho), ptr(ops.lmap), ptr(ops.rmap),
        ptr(ops.xpin), ptr(ops.g), ptr(ops.lb), ptr(ops.ub), ptr(ops.pl),
        ptr(ops.pnm), ptr(ops.pi), ptr(ops.pj), ptr(ops.ci), ptr(ops.cj),
        ptr(ops.aptr), ptr(ops.aoff), ptr(ops.apair), ptr(ops.acoef),
        ptr(blk), ptr(blk[n:]), ptr(blk[2 * n:]),
        ptr(w_rows), ptr(zb), ptr(zp), ptr(yb), ptr(yp),
        B, M, phi, P, int(n_inner), n, R, d["rung"], plan.cluster,
        float(sigma), float(alpha),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check_error("nsfused_stack", err, lib.nsfused_stack_error_string)
    if _lib is None:
        nsfused_stack.launches += 1
    # rounded back to float32; knot-major rows back to [n, B, K3, nw]
    # (state_from_rows); scattered into copies of the stack's state
    f32 = torch.float32
    w_new = (w_rows.to(f32).reshape(n, Mi, B3, phi).permute(0, 2, 1, 3)
             .reshape(n, B, K3, Mi * phi))

    def put(t, rows):
        return t.index_copy(0, idx, rows.to(f32).reshape((n,) + t.shape[1:]))

    return (put(w, w_new), NSConstr(put(z.box, zb), put(z.pair, zp)),
            NSConstr(put(y.box, yb), put(y.pair, yp)))


nsfused_stack.launches = 0


def stack_variant(tag: str) -> ctypes.CDLL:
    """The library of csrc/nsfused_stack.cu built with ``-D<TAG>``
    (``stack_profile`` or ``stack_state_f32``), for nsfused_stack's
    ``_lib`` in the measuring tools."""
    def declare(lib):
        _declare_stack(lib)
        lib.nsfused_stack_stamps.restype = ctypes.c_int
        lib.nsfused_stack_stamps.argtypes = [ctypes.c_void_p]
        lib.nsfused_stack_phases.restype = ctypes.c_char_p
        lib.nsfused_stack_phases.argtypes = []
    return _build.load(f"nsfused_stack@{tag}", declare)


def stack_stamps(lib: ctypes.CDLL) -> tuple[list[str], np.ndarray]:
    """The phase names of a ``stack_profile`` library and [blocks, phases
    + 1] clock64 cycles of its last launch: each phase summed over the
    chunk's iterations in each of the first 128 blocks, then the block's
    total."""
    names = lib.nsfused_stack_phases().decode().split(",")
    out = np.zeros((128, 16), np.int64)
    err = lib.nsfused_stack_stamps(out.ctypes.data)
    _build.check_error("nsfused_stack_stamps", err,
                       lib.nsfused_stack_error_string)
    return names, np.concatenate([out[:, :len(names)], out[:, -1:]], 1)
