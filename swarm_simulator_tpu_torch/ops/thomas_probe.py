"""T3, the staged Thomas probe: the block-tridiagonal solve with a dense
coupling koM, cut into stages.

The wrapper of the hand-written CUDA kernel in ``csrc/thomas_probe.cu``,
which replaces the Pallas TPU kernels of the JAX package's
``tools/pallas_debug/thomas_probe.py`` (``k_dma``, ``k_mv``, ``k_fwd`` and
the ``thomas_solve_pallas`` run it probes as ``full``).  Over the pivot
blocks D_k = dinv[rho_idx, k] [bs, bs], with koM [bs, bs] and b [Mi, bs]:

  dma   out[k] = D_k[0, :]
  mv    out[k] = D_k b_k
  fwd   y_0 = b_0, y_k = b_k - koM^T (D_{k-1} y_{k-1}); out = y
  full  fwd, then x_{Mi-1} = D_{Mi-1} y_{Mi-1},
        x_k = D_k^T (y_k - koM x_{k+1}); out = x

(``full`` equals the TPU kernel's solve on symmetric pivots, which the
probe gives it.)  For CUDA tensors the wrapper launches the kernel once on
the chain of K2 (``csrc/chain_ring.cuh``: one block per SM, each streaming
its rows of every knot through a TMA ring; ``probe_plan`` sizes it) or
raises; for CPU tensors it runs the plain version
``thomas_probe_reference``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .thomas import (BAR_BYTES, MAX_SLOTS, SMEM_PER_BLOCK, TILE_BYTES,
                     slot_bytes, sm_count)

STAGES = ("dma", "mv", "fwd", "full")


def stages_of(stage: str, Mi: int) -> int:
    """The chain stages one launch runs (full: both sweeps, as K2's
    2 Mi - 1)."""
    return 2 * Mi - 1 if stage == "full" else Mi


def thomas_probe_reference(dinv: torch.Tensor, koM: torch.Tensor,
                           b: torch.Tensor, stage: str,
                           rho_idx: int) -> torch.Tensor:
    """The plain version of ``stage`` on rung ``rho_idx``: out [Mi, bs] in
    b's dtype."""
    D = dinv[rho_idx].to(b.dtype)
    Mi = b.shape[0]
    if stage == "dma":
        return D[:, 0, :].clone()
    if stage == "mv":
        return torch.stack([D[k] @ b[k] for k in range(Mi)])
    if stage not in ("fwd", "full"):
        raise ValueError(f"thomas_probe: unknown stage {stage!r}")
    y = [b[0]]
    for k in range(1, Mi):
        y.append(b[k] - (D[k - 1] @ y[k - 1]) @ koM)
    if stage == "fwd":
        return torch.stack(y)
    x = [None] * Mi
    x[Mi - 1] = D[Mi - 1] @ y[Mi - 1]
    for k in range(Mi - 2, -1, -1):
        x[k] = (y[k] - koM @ x[k + 1]) @ D[k]
    return torch.stack(x)


#: rows a block may own when its coupling rows are read through L2
#: (csrc/thomas_probe.cu: kMaxRows, one register sum a row), and the
#: floats of the warps' sums they meet in (kWarps * kMaxRows)
MAX_L2_ROWS = 32
RED_FLOATS = 8 * MAX_L2_ROWS


class ProbePlan(NamedTuple):
    """How T3 streams its pivot rows (csrc/thomas_probe.cu on
    csrc/chain_ring.cuh): ``blocks`` blocks, one per SM at most, each
    owning ``rows`` rows, read through a ring of ``slots`` slots of
    ``slot_bytes``, tiles of ``tile_rows`` rows.  The rows are those of
    every knot (the chain's spans: fwd and full, dma and mv when asked) or
    a flat span of the rung's Mi * bs rows (dma and mv).  fwd and full
    hold the block's coupling rows (koM^T, and koM for full) in shared
    memory when ``resident``, else read them through L2."""
    rows: int
    blocks: int
    tile_rows: int
    slots: int
    slot_bytes: int
    resident: bool
    smem: int       # dynamic shared memory of a block, bytes


def probe_plan(bs: int, Mi: int, stage: str, sms: int = 132,
               knot_spans: bool = False) -> ProbePlan:
    """The ring plan of ``stage`` over [bs, bs] float32 pivot blocks, Mi
    knots, on a card of ``sms`` multiprocessors (bs % 4 == 0: whole
    16-byte rows).  dma and mv split the rung's Mi * bs rows into flat
    spans, one a block: their knots do not depend on each other, and an
    SM's bulk copies land one after another, so that a knot's span of a
    few rows (11.5 KB at bs 576) would cost a copy's latency each (PERF.md);
    with ``knot_spans`` they take the chain's spans instead, ceil(bs / sms)
    rows of every knot, as fwd and full do.  A flat span streams through
    two slots of as many rows as fit (the larger an SM's copies, the
    faster its stream: PERF.md), the chain's spans in whole spans or tiles
    of at most TILE_BYTES.  Beside the ring (layout_floats): mv's b rows,
    the chain's vector and sums, full's forward rows and partial sums.
    The coupling rows are resident when a two-slot ring of two-row tiles
    still fits beside them (a ring of one-row tiles reads slower than the
    coupling through L2).  As many slots as fit, up to MAX_SLOTS."""
    if stage not in STAGES:
        raise ValueError(f"thomas_probe: unknown stage {stage!r}")
    if bs < 4 or bs % 4:
        raise ValueError(f"thomas_probe: bs = {bs} is not a multiple of 4 "
                         "(rows are copied and read 16 bytes at a time)")
    flat = stage in ("dma", "mv") and not knot_spans
    nrow = Mi * bs if flat else bs
    rows = -(-nrow // sms)
    blocks = -(-nrow // rows)
    base = BAR_BYTES + 4 * layout_floats(stage, bs, Mi, rows, blocks, 0,
                                         False, flat)
    per_slot = 4 * bs if stage == "mv" and not flat else 0   # b rows
    coupling = 4 * rows * bs * {"fwd": 1, "full": 2}.get(stage, 0)
    resident = coupling > 0 and base + coupling + 2 * (
        slot_bytes(min(rows, 2), bs, 4) + per_slot) <= SMEM_PER_BLOCK
    if coupling and not resident and rows > MAX_L2_ROWS:
        raise ValueError(f"thomas_probe: {rows} rows a block exceed the "
                         f"{MAX_L2_ROWS} whose coupling rows it reads "
                         "through L2")
    room = SMEM_PER_BLOCK - base - (coupling if resident else 0)
    fit = (room // 2 - per_slot - 16) // (bs * 4)   # rows of two slots
    if fit >= rows:
        tile_rows = rows
    elif flat:   # two slots of as many rows as fit, balanced
        tile_rows = -(-rows // -(-rows // max(1, fit)))
    else:
        tile_rows = max(1, min(TILE_BYTES // (bs * 4), fit))
    slot = slot_bytes(tile_rows, bs, 4)
    slots = min(MAX_SLOTS, room // (slot + per_slot))
    if slots < 2:
        raise ValueError(f"thomas_probe: rows of {bs} floats leave no room "
                         f"for a two-slot ring in {SMEM_PER_BLOCK} bytes")
    return ring_variant(ProbePlan(rows, blocks, tile_rows, slots, slot,
                                  resident, 0), bs, Mi, stage, knot_spans)


def ring_variant(plan: ProbePlan, bs: int, Mi: int, stage: str,
                 knot_spans: bool = False, **change) -> ProbePlan:
    """``plan`` with the fields in ``change`` (tile_rows, slots, resident)
    replaced and its slot bytes and shared memory recomputed as the kernel
    carves them (csrc/thomas_probe.cu: probe_floats): a study's variant;
    the kernel refuses one past 227 KB."""
    p = plan._replace(**change)
    flat = stage in ("dma", "mv") and not knot_spans
    slot = slot_bytes(p.tile_rows, bs, 4)
    return p._replace(slot_bytes=slot, smem=BAR_BYTES + p.slots * slot
                      + 4 * layout_floats(stage, bs, Mi, p.rows, p.blocks,
                                          p.slots, p.resident, flat))


def layout_floats(stage: str, bs: int, Mi: int, rows: int, blocks: int,
                  slots: int, resident: bool, flat: bool) -> int:
    """Floats of a block's shared memory beside the ring, as the kernel
    carves them (csrc/thomas_probe.cu: probe_floats): mv's b rows (one a
    slot, or those its flat span touches); the chain's vector, the
    coupling rows when resident, the warps' sums and the block's results;
    full's partial sums, all blocks' of its rows, and its forward rows."""
    coup = rows * bs if resident else 0
    return {"dma": 0,
            "mv": (span_knots(rows, bs, Mi) if flat else slots) * bs,
            "fwd": bs + coup + RED_FLOATS + rows,
            "full": 2 * bs + 2 * coup + RED_FLOATS + rows + blocks * rows
            + Mi * rows}[stage]


def span_knots(rows: int, bs: int, Mi: int) -> int:
    """The knots a flat span of ``rows`` rows may touch (their b rows sit
    in shared memory for mv; csrc/thomas_probe.cu's span_knots)."""
    return min(Mi, (rows + bs - 2) // bs + 1)


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.thomas_probe_grid.restype = ci
    lib.thomas_probe_grid.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    lib.thomas_probe.restype = ci
    lib.thomas_probe.argtypes = [vp] * 7 + [ci] * 9 + [vp]
    lib.thomas_probe_error_string.restype = ctypes.c_char_p
    lib.thomas_probe_error_string.argtypes = [ci]


def thomas_probe_grid(bs: int, Mi: int, stage: str, device: torch.device,
                      knot_spans: bool = False,
                      plan: ProbePlan | None = None
                      ) -> tuple[ProbePlan, int]:
    """(the plan, by default probe_plan's, and the blocks T3 launches for
    it on ``device``): the kernel's library refuses a plan whose blocks
    cannot all co-reside."""
    plan = plan or probe_plan(bs, Mi, stage, sm_count(device), knot_spans)
    flat = stage in ("dma", "mv") and not knot_spans
    lib = _build.load("thomas_probe", _declare)
    g = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check_error("thomas_probe_grid", lib.thomas_probe_grid(
            Mi * bs if flat else bs, plan.rows, plan.smem, ctypes.byref(g)),
            lib.thomas_probe_error_string)
    return plan, g.value


def thomas_probe(dinv: torch.Tensor, koM: torch.Tensor, b: torch.Tensor,
                 stage: str, rho_idx: int, knot_spans: bool = False,
                 plan: ProbePlan | None = None) -> torch.Tensor:
    """out [Mi, bs] of ``stage`` (see the module) on rung ``rho_idx`` of
    dinv [R, Mi, bs, bs].  CUDA float32 tensors launch T3 once (dma and mv
    on flat spans of the rung, or on the chain's spans with
    ``knot_spans``: the same result, the stream of a chain stage), on
    ``plan`` when given (a study's variant of probe_plan's: its rows,
    tiles, slots and residency; the kernel refuses one that does not fit
    its layout); CPU tensors run the plain version; anything else
    raises."""
    if b.device.type == "cpu":
        return thomas_probe_reference(dinv, koM, b, stage, rho_idx)
    if stage not in STAGES:
        raise ValueError(f"thomas_probe: unknown stage {stage!r}")
    Mi, bs = b.shape
    R = dinv.shape[0]
    _build.check_operands("thomas_probe", (
        ("dinv", dinv, (R, Mi, bs, bs)), ("koM", koM, (bs, bs)),
        ("b", b, (Mi, bs))))
    if not 0 <= rho_idx < R:
        raise ValueError(f"thomas_probe: rung {rho_idx} outside [0, {R})")
    rung = dinv[rho_idx]
    # TMA copies and 16-byte loads: every row on a 16-byte boundary
    if any(t.data_ptr() % 16 for t in (rung, koM, b)):
        raise ValueError("thomas_probe: dinv, koM or b is not 16-byte "
                         "aligned")
    dev = b.device
    plan, grid = thomas_probe_grid(bs, Mi, stage, dev, knot_spans, plan)
    lib = _build.load("thomas_probe", _declare)
    with torch.cuda.device(dev):
        chained = stage in ("fwd", "full")
        koMT = koM.T.contiguous() if chained else koM
        # the chain's tagged entries (csrc/chain_ring.cuh), 64 bits each
        vbuf = (torch.empty(6 * bs + (2 * grid * bs if stage == "full"
                                      else 0), dtype=torch.int64, device=dev)
                if chained else None)
        sink = (torch.empty(grid * 256, dtype=torch.float32, device=dev)
                if stage == "dma" else None)
        out = torch.empty_like(b)
        ptr = ctypes.c_void_p
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check_error("thomas_probe", lib.thomas_probe(
            *(ptr(None if a is None else a.data_ptr())
              for a in (rung, koM, koMT, b, vbuf, out, sink)),
            bs, Mi, STAGES.index(stage), plan.rows, plan.tile_rows,
            plan.slots, int(plan.resident), int(knot_spans), plan.smem,
            ptr(stream)),
            lib.thomas_probe_error_string)
    thomas_probe.launches += 1
    return out


thomas_probe.launches = 0
