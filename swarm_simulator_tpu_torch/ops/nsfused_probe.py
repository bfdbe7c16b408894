"""T1, the fused-chunk probes: the pieces of the fused ADMM chunk (K1) on
their own, at the 64-agent tile form (Mi = 35 knots, phi = 3, B3 = 192).

Wrappers of the hand-written CUDA kernels in ``csrc/nsfused_probe.cu``,
which replace the four Pallas TPU kernels of the JAX package's
``tools/pallas_debug/nsfused_probe.py``:

  p1_reshape_combine     (P1, :67)  out[3i + j] = x[6i + j] + 2 x[6i + 3 + j]
                                    of x [216, 192]
  p2_tile_apply          (P2, :106) out[g, c] = sum_f sum_b
                                    D6[r, 3, f, g, b, c] y[f, b]
  p3_split_pair_product  (P3, :156) x [216, 192] @ s [192, 2048] through
                                    three bf16 parts of x, float32 sums,
                                    one block per 64 x 64 tile of out
  p4_resident_thomas     (P4, :231) ``inner`` iterations of the tile-form
                                    forward and backward Thomas sweeps:
                                    p4_relayout (the rung into K2's flat
                                    row order), then p4_chain (the
                                    iterations in one launch of K2's chain
                                    template with P4's back substitution)

Each launches its kernel for CUDA float32 tensors or raises, runs its plain
version (``*_reference``) for CPU tensors, and counts its launches.
``launch_floor`` launches an empty kernel (the floor a launch-bound probe
is timed against; no plain version).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from . import thomas

MI, PHI, B3 = 35, 3, 192
MP, PL = 216, 2048    # pair rows, padded pair lanes
INNER = 50


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nsfused_probe_p1.restype = ci
    lib.nsfused_probe_p1.argtypes = [vp] * 3
    lib.nsfused_probe_p2.restype = ci
    lib.nsfused_probe_p2.argtypes = [vp] * 3 + [ci] * 2 + [vp]
    lib.nsfused_probe_floor.restype = ci
    lib.nsfused_probe_floor.argtypes = [ci] * 3 + [vp]
    lib.nsfused_probe_p3.restype = ci
    lib.nsfused_probe_p3.argtypes = [vp] * 3 + [ci] * 3 + [vp]
    lib.nsfused_probe_p4_relayout.restype = ci
    lib.nsfused_probe_p4_relayout.argtypes = [vp] * 2 + [ci] + [vp]
    lib.nsfused_probe_p4.restype = ci
    lib.nsfused_probe_p4.argtypes = [vp] * 5 + [ci] * 7 + [vp]
    lib.nsfused_probe_error_string.restype = ctypes.c_char_p
    lib.nsfused_probe_error_string.argtypes = [ci]


def _launch(fname: str, *args, device=None) -> None:
    """Call ``fname`` of the library on the current stream of ``device``
    (default: the first tensor's); tensors go as pointers, ints as they
    are."""
    lib = _build.load("nsfused_probe", _declare)
    dev = device or next(a for a in args
                         if isinstance(a, torch.Tensor)).device
    with torch.cuda.device(dev):
        cargs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
                 else a for a in args]
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check_error(fname, getattr(lib, fname)(
            *cargs, ctypes.c_void_p(stream)), lib.nsfused_probe_error_string)


def _rung_ok(fname: str, d6: torch.Tensor, rho_idx: int, knots: int) -> None:
    R = d6.shape[0]
    _build.check_operands(fname, (("d6", d6, (R, knots, PHI, PHI, B3, B3)),))
    if not 0 <= rho_idx < R:
        raise ValueError(f"{fname}: rung {rho_idx} outside [0, {R})")


# ---- P1 ----

def p1_reshape_combine_reference(x: torch.Tensor) -> torch.Tensor:
    x4 = x.reshape(36, 6, B3)
    return (x4[:, 0:3] + 2.0 * x4[:, 3:6]).reshape(108, B3)


def p1_reshape_combine(x: torch.Tensor) -> torch.Tensor:
    """[108, 192] from x [216, 192] (P1)."""
    if x.device.type == "cpu":
        return p1_reshape_combine_reference(x)
    _build.check_operands("p1_reshape_combine", (("x", x, (MP, B3)),))
    out = torch.empty((108, B3), dtype=torch.float32, device=x.device)
    _launch("nsfused_probe_p1", x, out)
    p1_reshape_combine.launches += 1
    return out


p1_reshape_combine.launches = 0


# ---- P2 ----

def p2_tile_apply_reference(d6: torch.Tensor, y: torch.Tensor,
                            rho_idx: int) -> torch.Tensor:
    """The TPU probe's dapply of knot 3: per output component g, the sum
    over f of the column reductions of D6[r, 3, f, g] against y[f]."""
    D = d6[rho_idx, 3]
    rows = []
    for g in range(PHI):
        acc = torch.zeros(B3, dtype=y.dtype, device=y.device)
        for f in range(PHI):
            acc = acc + (D[f, g] * y[f][:, None]).sum(0)
        rows.append(acc)
    return torch.stack(rows)


#: output columns of one P2 cluster (csrc/nsfused_probe.cu: kP2Cols), the
#: threads sharing a (g, 4 columns) and the rows each takes at most
#: (kP2Lanes, kP2Steps), and the portable cluster size
P2_COLS, P2_LANES, P2_STEPS, P2_MAX_CLUSTER = 16, 8, 12, 8


class P2Plan(NamedTuple):
    """P2's launch: ``tiles`` clusters of ``cluster`` blocks, cluster t
    computing output columns [t * cols, (t + 1) * cols) of every g, block
    rank q of it summing rows [q * rows, (q + 1) * rows) of the phi * B3
    rows (f, b); ``threads`` a block."""
    cols: int
    tiles: int
    cluster: int
    rows: int
    threads: int


def p2_plan(B3: int = B3, phi: int = PHI, sms: int = 132) -> P2Plan:
    """The cluster tiling of P2 on a card of ``sms`` multiprocessors: a
    cluster per P2_COLS columns, as many blocks a cluster (at most
    P2_MAX_CLUSTER) as keep every block on an SM of its own, but no fewer
    than a block's registers need (P2_LANES * P2_STEPS rows at most), the
    rows split evenly over a cluster's blocks (the kernel takes phi = 3
    and B3 = 192).  Raises ValueError where B3 does not split into column
    tiles or the rows do not fit P2_MAX_CLUSTER blocks."""
    if B3 % P2_COLS:
        raise ValueError(f"p2_tile_apply: {B3} columns do not split into "
                         f"tiles of {P2_COLS}")
    tiles = B3 // P2_COLS
    least = -(-phi * B3 // (P2_LANES * P2_STEPS))
    cluster = min(P2_MAX_CLUSTER, max(least, sms // tiles))
    rows = -(-phi * B3 // cluster)
    if rows > P2_LANES * P2_STEPS:
        raise ValueError(f"p2_tile_apply: {rows} rows a block exceed "
                         f"{P2_LANES * P2_STEPS}")
    return P2Plan(cols=P2_COLS, tiles=tiles, cluster=cluster, rows=rows,
                  threads=phi * (P2_COLS // 4) * P2_LANES)


def p2_tile_apply(d6: torch.Tensor, y: torch.Tensor,
                  rho_idx: int) -> torch.Tensor:
    """[3, 192] = knot 3 of rung ``rho_idx`` of d6 [R, 35, 3, 3, 192, 192]
    applied to y [3, 192] (P2: p2_plan's clusters, the partial tiles added
    in the leader's shared memory)."""
    if y.device.type == "cpu":
        return p2_tile_apply_reference(d6, y, rho_idx)
    _rung_ok("p2_tile_apply", d6, rho_idx, d6.shape[1])
    if d6.shape[1] < 4:
        raise ValueError("p2_tile_apply: d6 has no knot 3")
    _build.check_operands("p2_tile_apply", (("y", y, (PHI, B3)),))
    d = d6[rho_idx, 3]
    if d.data_ptr() % 16:
        raise ValueError("p2_tile_apply: d6's knot is not 16-byte aligned")
    plan = p2_plan(sms=thomas.sm_count(y.device))
    out = torch.empty((PHI, B3), dtype=torch.float32, device=y.device)
    _launch("nsfused_probe_p2", d, y, out, plan.cluster, plan.rows)
    p2_tile_apply.launches += 1
    return out


p2_tile_apply.launches = 0


def launch_floor(blocks: int, threads: int, cluster: int,
                 device) -> None:
    """Launch an empty kernel of ``blocks`` blocks of ``threads`` in
    clusters of ``cluster`` on ``device`` (a CUDA device; there is nothing
    to run on the CPU): the floor a launch-bound kernel's time stands on."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"launch_floor: {device} is not a CUDA device")
    _launch("nsfused_probe_floor", blocks, threads, cluster, device=device)
    launch_floor.launches += 1


launch_floor.launches = 0


# ---- P3 ----

def split3(a: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """float32 a as three bf16 parts (the high 16 bits, the high 16 bits of
    the rest, the rest rounded), each returned widened to float32."""
    mask = torch.tensor(-65536, dtype=torch.int32)   # 0xFFFF0000
    a0 = (a.view(torch.int32) & mask.to(a.device)).view(torch.float32)
    r = a - a0
    a1 = (r.view(torch.int32) & mask.to(a.device)).view(torch.float32)
    return tuple(p.to(torch.bfloat16).to(torch.float32)
                 for p in (a0, a1, r - a1))


def p3_split_pair_product_reference(x: torch.Tensor,
                                    s: torch.Tensor) -> torch.Tensor:
    sb = s.to(torch.bfloat16).to(torch.float32)
    x0, x1, x2 = split3(x)
    return x0 @ sb + x1 @ sb + x2 @ sb


#: P3's output tile (rows and columns of out a block computes), the bf16
#: elements a shared-memory row is padded by, and the row length of the
#: out tile staged in shared memory (csrc/nsfused_probe.cu)
P3_TILE, P3_PAD, P3_OUT_LD = 64, 8, 72
#: shared memory one block may use on an H100 (227 KB)
SMEM_PER_BLOCK = 232448


def p3_plan(M: int, K: int, N: int) -> tuple[tuple[int, int], int]:
    """P3's launch for out [M, N] = x [M, K] @ s [K, N]: the grid (column
    tiles, row tiles) of 64 x 64 output tiles and the bytes of dynamic
    shared memory a block takes (csrc/nsfused_probe.cu's p3_smem).
    Raises ValueError on shapes the tiling cannot take: K not a multiple
    of 16, N not a multiple of 64, or K so deep that a block's panels
    exceed 227 KB (K > 208)."""
    if M < 1 or K < 16 or K % 16 or N < P3_TILE or N % P3_TILE:
        raise ValueError(
            f"p3_split_pair_product: [{M}, {K}] @ [{K}, {N}] does not tile: "
            f"K must be a multiple of 16 and N a multiple of {P3_TILE}")
    stage = max(2 * P3_TILE * K * 4, P3_TILE * P3_OUT_LD * 4)
    smem = stage + 2 * (3 * P3_TILE * (K + P3_PAD) + K * (P3_TILE + P3_PAD))
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"p3_split_pair_product: K = {K} needs {smem} bytes "
                         f"of shared memory a block (at most "
                         f"{SMEM_PER_BLOCK})")
    return (N // P3_TILE, -(-M // P3_TILE)), smem


def p3_split_pair_product(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ s [K, N] through three bf16 parts of x on the tensor cores
    (P3; s exact in bf16).  The kernel's tiling needs K a multiple of 16
    (at most 208) and N a multiple of 64 (p3_plan); other shapes raise."""
    if x.device.type == "cpu":
        return p3_split_pair_product_reference(x, s)
    M, K = x.shape
    N = s.shape[-1]
    _build.check_operands("p3_split_pair_product", (("x", x, (M, K)),
                                                    ("s", s, (K, N))))
    p3_plan(M, K, N)
    if x.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError("p3_split_pair_product: x and s must be 16-byte "
                         "aligned")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    _launch("nsfused_probe_p3", x, s, out, M, K, N)
    p3_split_pair_product.launches += 1
    return out


p3_split_pair_product.launches = 0


# ---- P4 ----

def p4_resident_thomas_reference(d6: torch.Tensor, ho: torch.Tensor,
                                 b: torch.Tensor, rho_idx: int = 0,
                                 inner: int = INNER) -> torch.Tensor:
    """The TPU probe's ``inner`` iterations (each recomputes the same x
    from b) of the tile-form sweeps: x [Mi, 3, 192]."""
    D = d6[rho_idx]
    Mi = b.shape[0]

    def dapply(k, v):   # out[g, c] = sum_f sum_b D[k, f, g, b, c] v[f, b]
        return torch.einsum("fgbc,fb->gc", D[k], v)

    def hoT(t):
        return torch.stack([sum(ho[f, g] * t[f] for f in range(PHI))
                            for g in range(PHI)])

    def ho_(t):
        return torch.stack([sum(ho[f, g] * t[g] for g in range(PHI))
                            for f in range(PHI)])

    x = torch.empty_like(b)
    for _ in range(inner):
        y, t = [b[0] + 0.0], [None] * Mi
        for k in range(1, Mi):
            t[k - 1] = dapply(k - 1, y[k - 1])
            y.append(b[k] - hoT(t[k - 1]))
        x[Mi - 1] = dapply(Mi - 1, y[Mi - 1])
        for k in range(Mi - 2, -1, -1):
            x[k] = t[k] - dapply(k, ho_(x[k + 1]))
    return x


def p4_relayout_reference(d6: torch.Tensor, rho_idx: int) -> torch.Tensor:
    """Rung ``rho_idx`` of d6 [R, Mi, 3, 3, 192, 192] as flat [576, 576]
    blocks in K2's row order: m[k, 3c + g, 3b + f] = d6[r, k, f, g, b, c],
    so that the tile-form apply D(k) v is m[k] @ v in the order 3b + f."""
    Mi = d6.shape[1]
    return d6[rho_idx].permute(0, 4, 2, 3, 1).reshape(Mi, PHI * B3,
                                                      PHI * B3)


def p4_relayout(d6: torch.Tensor, rho_idx: int) -> torch.Tensor:
    """m [Mi, 576, 576] (p4_relayout_reference) from d6 [R, Mi, 3, 3, 192,
    192]: a tiled transpose through shared memory on the card."""
    if d6.device.type == "cpu":
        return p4_relayout_reference(d6, rho_idx)
    Mi = d6.shape[1]
    _rung_ok("p4_relayout", d6, rho_idx, Mi)
    m = torch.empty((Mi, PHI * B3, PHI * B3), dtype=torch.float32,
                    device=d6.device)
    _launch("nsfused_probe_p4_relayout", d6[rho_idx], m, Mi)
    p4_relayout.launches += 1
    return m


p4_relayout.launches = 0


def p4_chain_reference(m: torch.Tensor, ho: torch.Tensor, bf: torch.Tensor,
                       inner: int = INNER) -> torch.Tensor:
    """The chain kernel's plain twin on the flat layout: ``inner`` times
    (each recomputes the same x from bf [Mi, 576], rows 3c + g) the
    forward sweep t_k = m_k y_k, y_{k+1} = bf_{k+1} - (I (x) ho)^T t_k
    (y_0 = bf_0) and the back substitution x_{Mi-1} = t_{Mi-1},
    x_k = t_k - m_k (I (x) ho) x_{k+1}.  Returns x [Mi, 576]."""
    Mi = bf.shape[0]
    x = torch.empty_like(bf)
    for _ in range(inner):
        y, t = bf[0], [None] * Mi
        for k in range(Mi - 1):
            t[k] = m[k] @ y
            y = bf[k + 1] - thomas.ko_t(ho, t[k])
        x[Mi - 1] = m[Mi - 1] @ y
        for k in range(Mi - 2, -1, -1):
            x[k] = t[k] - m[k] @ thomas.ko(ho, x[k + 1])
    return x


def p4_plan(resident: int, Mi: int = MI,
            sms: int = 132) -> thomas.RingPlan:
    """The chain's ring plan with each block's rows of the last
    ``resident`` knots kept in shared memory: K2's plan (ops/thomas.
    ring_plan, its T rows of Mi knots kept), slots as many as the bytes
    left allow.  Raises ValueError where fewer than two slots are left."""
    if not 0 <= resident <= Mi:
        raise ValueError(f"p4_plan: {resident} resident knots of {Mi}")
    return thomas.ring_plan(PHI * B3, PHI, 4, hist_knots=Mi, sms=sms,
                            resident_knots=resident)


def p4_max_resident(Mi: int = MI, sms: int = 132) -> int:
    """The most knots p4_plan can keep resident beside a two-slot ring."""
    h = 0
    while h < Mi:
        try:
            p4_plan(h + 1, Mi, sms)
        except ValueError:
            break
        h += 1
    return h


def p4_stage_split(resident: int, Mi: int = MI) -> tuple[list, list]:
    """The stages of one period of the chain (2 Mi - 1: the forward sweep
    over knots 0..Mi-1, the back over Mi-2..0) as the kernel splits them
    (csrc/thomas_chain.cuh): (the stages the ring streams, in its order;
    the stages that read the rows held in shared memory).  The held ones
    are those of the last ``resident`` knots, stages Mi - resident ..
    Mi + resident - 2; streamed stage q is stage q, or q + 2 resident - 1
    from Mi - resident on (RowRing's skipped range)."""
    nstage = 2 * Mi - 1
    skip0, nskip = Mi - resident, max(0, 2 * resident - 1)
    streamed = [q + (nskip if q >= skip0 else 0)
                for q in range(nstage - nskip)]
    return streamed, list(range(skip0, skip0 + nskip))


def p4_chain(m: torch.Tensor, ho: torch.Tensor, b: torch.Tensor,
             inner: int = INNER, resident: int | None = None
             ) -> torch.Tensor:
    """x [Mi, 3, 192] after ``inner`` iterations of both sweeps over the
    re-laid rung m [Mi, 576, 576] (p4_relayout) with ho [3, 3], from
    b [Mi, 3, 192]: one launch of the chain (counted in
    p4_resident_thomas.launches), each block keeping its rows of the last
    ``resident`` knots in shared memory (p4_plan; None: as many as fit,
    p4_max_resident, which tools/chain_bench --p4 measured faster than
    none, PERF.md); CPU tensors run p4_chain_reference."""
    Mi, n = b.shape[0], PHI * B3
    bf = b.transpose(1, 2).reshape(Mi, n)    # rows 3c + g
    if b.device.type == "cpu":
        xf = p4_chain_reference(m, ho, bf, inner)
    else:
        _build.check_operands("p4_chain", (("m", m, (Mi, n, n)),
                                           ("ho", ho, (PHI, PHI)),
                                           ("b", b, (Mi, PHI, B3))))
        if inner < 1:
            raise ValueError(f"p4_chain: inner = {inner} < 1")
        sms = thomas.sm_count(b.device)
        if resident is None:
            resident = p4_max_resident(Mi, sms)
        plan = p4_plan(resident, Mi, sms)
        xf = torch.empty((Mi, n), dtype=torch.float32, device=b.device)
        # the chain's vector entries, 64 bits each, over the three buffers
        # of a periodic chain (csrc/thomas_chain.cuh)
        vbuf = torch.empty((3, n), dtype=torch.int64, device=b.device)
        _launch("nsfused_probe_p4", m, ho, bf.contiguous(), vbuf, xf, Mi,
                inner, plan.groups, plan.tile_rows, plan.slots, resident,
                plan.smem)
        p4_resident_thomas.launches += 1
    return xf.reshape(Mi, B3, PHI).transpose(1, 2).contiguous()


def p4_resident_thomas(d6: torch.Tensor, ho: torch.Tensor, b: torch.Tensor,
                       rho_idx: int = 0, inner: int = INNER) -> torch.Tensor:
    """x [Mi, 3, 192] after ``inner`` iterations of both sweeps over rung
    ``rho_idx`` of d6 [R, Mi, 3, 3, 192, 192] with ho [3, 3] (P4): the
    re-layout, then the chain with as many knots resident as fit."""
    if b.device.type == "cpu":
        return p4_resident_thomas_reference(d6, ho, b, rho_idx, inner)
    Mi = b.shape[0]
    _rung_ok("p4_resident_thomas", d6, rho_idx, Mi)
    _build.check_operands("p4_resident_thomas", (("ho", ho, (PHI, PHI)),
                                                 ("b", b, (Mi, PHI, B3))))
    if inner < 1:
        raise ValueError(f"p4_resident_thomas: inner = {inner} < 1")
    return p4_chain(p4_relayout(d6, rho_idx), ho, b, inner)


p4_resident_thomas.launches = 0
