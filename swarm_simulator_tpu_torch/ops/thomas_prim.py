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
(``grid="one"``, the TPU probe's single core) or on K2's first grid
(``grid="k2"``, ceil(bs / 24) cooperative blocks, a grid sync per step),
or raises; for CPU tensors it runs the plain version
``thomas_prim_reference``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MODES = ("dma", "mv_sub", "mv_lane", "mv_mxu", "trans", "fwd", "dmag",
         "dmaq")
GRIDS = ("one", "k2")
#: bytes of one ring slot (whole rows, at least one) with up to 4 slots;
#: the ring's slots share 160 KB beyond that
TILE_BYTES = 40 * 1024
RING_BYTES = 160 * 1024
SMEM_LIMIT = 232448


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
    lib.thomas_prim_grid.restype = ci
    lib.thomas_prim_grid.argtypes = [ci] * 5 + [ctypes.POINTER(ci)]
    lib.thomas_prim.restype = ci
    lib.thomas_prim.argtypes = [vp] * 5 + [ci] * 7 + [vp]
    lib.thomas_prim_error_string.restype = ctypes.c_char_p
    lib.thomas_prim_error_string.argtypes = [ci]


def tile_rows(bs: int, nslots: int) -> int:
    """Rows of one ring slot."""
    return max(1, min(TILE_BYTES, RING_BYTES // nslots) // (bs * 4))


def blocks_wanted(grid: str, bs: int) -> int:
    """1, or K2's first grid at this width: one warp per row group of 3, eight
    warps a block."""
    return 1 if grid == "one" else -(-bs // 24)


def thomas_prim(dinv: torch.Tensor, koM: torch.Tensor, b: torch.Tensor,
                mode: str, nbuf: int = 2, reps: int = 20,
                acc0: torch.Tensor | None = None, rho_idx: int = 0,
                grid: str = "k2") -> torch.Tensor:
    """out [Mi, bs] of REPS x Mi steps of ``mode`` (see the module).  CUDA
    float32 tensors launch T2 once on ``grid`` ("one" or "k2"); CPU tensors
    run the plain version; anything else raises."""
    if b.device.type == "cpu":
        return thomas_prim_reference(dinv, koM, b, mode, nbuf, reps, acc0,
                                     rho_idx)
    if mode not in MODES:
        raise ValueError(f"thomas_prim: unknown mode {mode!r}")
    if grid not in GRIDS:
        raise ValueError(f"thomas_prim: grid {grid!r} is not one of {GRIDS}")
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
    nslots = 2 if mode in ("dmag", "dmaq") else nbuf
    rows = tile_rows(bs, nslots)
    if 512 + 4 * (nslots * rows * bs + 2 * bs + rows) > SMEM_LIMIT:
        raise ValueError(f"thomas_prim: bs = {bs} with {nslots} slots needs "
                         "more shared memory than a block has")
    lib = _build.load("thomas_prim", _declare)
    code = MODES.index(mode)
    dev = b.device
    with torch.cuda.device(dev):
        g = ctypes.c_int(0)
        _build.check_error("thomas_prim_grid", lib.thomas_prim_grid(
            code, nbuf, bs, rows, blocks_wanted(grid, bs), ctypes.byref(g)),
            lib.thomas_prim_error_string)
        acc = (torch.zeros((bs, bs), dtype=torch.float32, device=dev)
               if acc0 is None else acc0.clone())
        part = torch.empty((2, g.value, bs), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = ctypes.c_void_p
        _build.check_error("thomas_prim", lib.thomas_prim(
            ptr(rung.data_ptr()), ptr(koM.data_ptr()), ptr(b.data_ptr()),
            ptr(acc.data_ptr()), ptr(part.data_ptr()), bs, Mi, reps, code,
            nbuf, rows, g.value, ptr(stream)), lib.thomas_prim_error_string)
        out = torch.zeros_like(b)
        out[0] = acc[0]
    thomas_prim.launches += 1
    return out


thomas_prim.launches = 0
