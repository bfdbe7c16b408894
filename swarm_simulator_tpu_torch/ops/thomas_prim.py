"""T2, the chain-primitive bench: REPS x Mi steps of one primitive of the
Thomas chain, one mode per launch.

The wrapper of the hand-written CUDA kernel in ``csrc/thomas_prim.cu``,
which replaces the Pallas TPU kernel of the JAX package's
``tools/pallas_debug/thomas_prim_bench.py`` (``kern``).  Each step reads
pivot block A = dinv[rho_idx, k] [bs, bs] and updates a state acc [bs, bs]
(vrow = acc row 0, vcol = acc column 0):

  dma      row 0 += A[0, :]
  mv_sub   row 0  = vcol^T A
  mv_lane  col 0  = A vrow
  mv_mxu   row 0  = bf16(vrow) @ bf16(A), float32 accumulation
  trans    acc    = 0.5 acc + A^T
  fwd      t = A vrow; row 0 = b_k - t^T koM + 1e-30 t^T A
  dmag     steps over Mi // nbuf groups of nbuf blocks, row 0 += row 0 of
           the group's first block
  dmaq     as dma, each block copied as nbuf parts

``mode@N`` gives the ring N slots (dmag and dmaq: N blocks a group or N
parts a copy).  The output [Mi, bs] is zero but for row 0, acc's row 0
at the end.  acc starts at zeros or at ``acc0``: the TPU kernel reads its
accumulator uninitialised, so its result is defined only once the start
is.  For CUDA tensors the wrapper launches the kernel on one block
(``grid="one"``, the TPU probe's single core) or on the chain ring
(``grid="ring"``, one block per SM, rows split by row group as
ops/thomas.ring_plan splits them, no barrier between steps; see
``prim_plan``), or raises; for CPU tensors it runs the plain version
``thomas_prim_reference``.  dmag's group lands in its slot as one 3-D
tensor-map copy (faster than or equal to nbuf 1-D bulk copies on one
barrier at every width on an H100, PERF.md).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

MODES = ("dma", "mv_sub", "mv_lane", "mv_mxu", "trans", "fwd", "dmag",
         "dmaq")
GRIDS = ("one", "ring")
#: bytes of one ring slot (whole rows, at least one) with up to 4 slots;
#: the ring's slots share 160 KB beyond that
TILE_BYTES = 40 * 1024
RING_BYTES = 160 * 1024
SMEM_LIMIT = 232448
#: bytes of the mbarriers at the front of shared memory (up to 64), and
#: the alignment of a ring slot (csrc/thomas_prim.cu: kBarBytes, kSlotAlign)
BAR_BYTES = 512
SLOT_ALIGN = 128


def parse_mode(spec: str) -> tuple[str, int]:
    """"mode" or "mode@N" -> (mode, nbuf); nbuf defaults to 2."""
    mode, _, nb = spec.partition("@")
    if mode not in MODES:
        raise ValueError(f"thomas_prim: unknown mode {mode!r} (one of "
                         f"{', '.join(MODES)})")
    nbuf = int(nb) if nb else 2
    if not 1 <= nbuf <= 8:
        raise ValueError(f"thomas_prim: {nbuf} slots outside [1, 8]")
    return mode, nbuf


def thomas_prim_reference(dinv: torch.Tensor, koM: torch.Tensor,
                          b: torch.Tensor, mode: str, nbuf: int = 2,
                          reps: int = 20, acc0: torch.Tensor | None = None,
                          rho_idx: int = 0) -> torch.Tensor:
    """The plain version: the REPS x Mi-step recurrence of ``mode`` on
    rung ``rho_idx`` of ``dinv`` [R, Mi, bs, bs], in b's dtype; returns
    out [Mi, bs]."""
    Mi, bs = b.shape
    acc = (torch.zeros((bs, bs), dtype=b.dtype, device=b.device)
           if acc0 is None else acc0.to(b.dtype).clone())
    rung = dinv[rho_idx].to(b.dtype)
    for _ in range(reps):
        if mode == "dmag":
            for g in range(Mi // nbuf):
                acc[0] = acc[0] + rung[g * nbuf, 0]
            continue
        for k in range(Mi):
            A = rung[k]
            if mode in ("dma", "dmaq"):
                acc[0] = acc[0] + A[0]
            elif mode == "mv_sub":
                acc[0] = acc[:, 0] @ A
            elif mode == "mv_lane":
                acc[:, 0] = A @ acc[0]
            elif mode == "mv_mxu":
                acc[0] = (acc[0].to(torch.bfloat16).to(b.dtype)
                          @ A.to(torch.bfloat16).to(b.dtype))
            elif mode == "trans":
                acc = acc * 0.5 + A.T
            elif mode == "fwd":
                t = A @ acc[0]
                acc[0] = b[k] - t @ koM + (t @ A) * 1e-30
            else:
                raise ValueError(f"thomas_prim: unknown mode {mode!r}")
    out = torch.zeros_like(b)
    out[0] = acc[0]
    return out


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.thomas_prim.restype = ci
    lib.thomas_prim.argtypes = [vp] * 5 + [ci] * 10 + [vp]
    lib.thomas_prim_error_string.restype = ctypes.c_char_p
    lib.thomas_prim_error_string.argtypes = [ci]


class PrimPlan(NamedTuple):
    """How T2 streams the rung (csrc/thomas_prim.cu): ``blocks`` blocks,
    block c owning rows [c * rows, (c + 1) * rows) of every pivot block,
    read through a ring of ``slots`` slots of ``slot_bytes`` (tiles of
    ``tile_rows`` rows; dmag's slot holds its group's nbuf tiles back to
    back)."""
    blocks: int
    rows: int
    tile_rows: int
    slots: int
    slot_bytes: int
    smem: int       # dynamic shared memory of a block, bytes


def row_group(bs: int) -> int:
    """The rows the ring grid keeps together: the chain's row groups of
    phi = 3 (an agent axis's derivative orders) where bs splits into them,
    as at 64 and 256 agents (576, 2304), else single rows (the probe's own
    bs 640)."""
    return 3 if bs % 3 == 0 else 1


def prim_plan(bs: int, mode: str, nbuf: int, grid: str,
              sms: int = 132) -> PrimPlan:
    """T2's plan on ``grid``: "one" one block of all bs rows; "ring" the
    row groups spread over as many blocks as the card has SMs, one each,
    as ops/thomas.ring_plan spreads the chain's.  The ring has ``nbuf``
    slots (dmag and dmaq 2), each a tile of whole rows (dmag: of each of
    its nbuf pivot blocks) of at most min(TILE_BYTES, RING_BYTES / slots)
    bytes, at least one row; beside it the block keeps the state row, its
    partial row, a tile's row products, and where the mode reads them the
    partial rows it gathers from every block (mv_sub, mv_mxu, fwd) and its
    rows of b (fwd) (csrc/thomas_prim.cu carves the same)."""
    if grid not in GRIDS:
        raise ValueError(f"thomas_prim: grid {grid!r} is not one of {GRIDS}")
    if grid == "one":
        rows = bs
    else:
        g = row_group(bs)
        rows = -(-(bs // g) // sms) * g
    blocks = -(-bs // rows)
    slots = 2 if mode in ("dmag", "dmaq") else nbuf
    grp = nbuf if mode == "dmag" else 1
    fit = min(TILE_BYTES, RING_BYTES // slots) // (grp * bs * 4)
    tile_rows = max(1, min(rows, fit))
    slot = -(-grp * tile_rows * bs * 4 // SLOT_ALIGN) * SLOT_ALIGN
    gather = blocks * rows if mode in ("mv_sub", "mv_mxu", "fwd") else 0
    smem = (BAR_BYTES + slots * slot + 4 * (
        2 * bs + tile_rows + gather + (rows if mode == "fwd" else 0)))
    if smem > SMEM_LIMIT:
        raise ValueError(f"thomas_prim: bs = {bs} with {slots} slots needs "
                         "more shared memory than a block has")
    return PrimPlan(blocks=blocks, rows=rows, tile_rows=tile_rows,
                    slots=slots, slot_bytes=slot, smem=smem)


def exchange_words(mode: str, steps: int, blocks: int, bs: int) -> int:
    """The 64-bit tagged entries T2 exchanges between blocks in ``steps``
    steps (csrc/thomas_prim.cu lays them out the same; the caller zeroes
    them): mv_sub each step's column-0 partials and the last step's
    partial rows, mv_lane each step's row 0 entry 0, mv_mxu two parities
    of partial rows, fwd those and two parities of the state row; the
    other modes exchange nothing."""
    return {"mv_sub": steps * blocks + blocks * bs, "mv_lane": steps + 1,
            "mv_mxu": 2 * blocks * bs,
            "fwd": 2 * blocks * bs + 2 * bs}.get(mode, 1)


def thomas_prim(dinv: torch.Tensor, koM: torch.Tensor, b: torch.Tensor,
                mode: str, nbuf: int = 2, reps: int = 20,
                acc0: torch.Tensor | None = None, rho_idx: int = 0,
                grid: str = "ring") -> torch.Tensor:
    """out [Mi, bs] of REPS x Mi steps of ``mode`` (see the module).  CUDA
    float32 tensors launch T2 once on ``grid`` ("one" or "ring"); CPU
    tensors run the plain version; anything else raises."""
    if b.device.type == "cpu":
        return thomas_prim_reference(dinv, koM, b, mode, nbuf, reps, acc0,
                                     rho_idx)
    if mode not in MODES:
        raise ValueError(f"thomas_prim: unknown mode {mode!r}")
    if not 1 <= nbuf <= 8 or reps < 0:
        raise ValueError(f"thomas_prim: nbuf {nbuf} outside [1, 8] or reps "
                         f"{reps} < 0")
    Mi, bs = b.shape
    R = dinv.shape[0]
    named = [("dinv", dinv, (R, Mi, bs, bs)), ("koM", koM, (bs, bs)),
             ("b", b, (Mi, bs))]
    if acc0 is not None:
        named.append(("acc0", acc0, (bs, bs)))
    _build.check_operands("thomas_prim", named)
    if bs % 16:
        raise ValueError(f"thomas_prim: bs = {bs} is not a multiple of 16 "
                         "(16-byte bulk copies, tensor-core tiles of 8)")
    if not 0 <= rho_idx < R:
        raise ValueError(f"thomas_prim: rung {rho_idx} outside [0, {R})")
    rung = dinv[rho_idx]
    if rung.data_ptr() % 16:
        raise ValueError("thomas_prim: dinv is not 16-byte aligned")
    dev = b.device
    plan = prim_plan(bs, mode, nbuf, grid,
                     torch.cuda.get_device_properties(dev)
                     .multi_processor_count)
    steps = reps * (Mi // nbuf if mode == "dmag" else Mi)
    lib = _build.load("thomas_prim", _declare)
    with torch.cuda.device(dev):
        acc = (torch.zeros((bs, bs), dtype=torch.float32, device=dev)
               if acc0 is None else acc0.clone())
        xb = torch.zeros(exchange_words(mode, steps, plan.blocks, bs),
                         dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = ctypes.c_void_p
        _build.check_error("thomas_prim", lib.thomas_prim(
            ptr(rung.data_ptr()), ptr(koM.data_ptr()), ptr(b.data_ptr()),
            ptr(acc.data_ptr()), ptr(xb.data_ptr()), bs, Mi, reps,
            MODES.index(mode), nbuf, plan.rows, plan.tile_rows, plan.slots,
            plan.slot_bytes, plan.smem, ptr(stream)),
            lib.thomas_prim_error_string)
        out = torch.zeros_like(b)
        out[0] = acc[0]
    thomas_prim.launches += 1
    return out


thomas_prim.launches = 0
