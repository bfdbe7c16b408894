"""T4, the pivot-stream study: a kernel that only streams one rung of the
Thomas pivot inventory.

The wrapper of the hand-written CUDA kernel in ``csrc/thomas_stream.cu``,
which replaces the Pallas TPU kernel of the JAX package's
``tools/thomas_bw_study.py`` (``make_dma_kernel``): out [bs] float32 is
the sum of every row of every pivot block of rung ``rho_idx``,

    out[c] = sum_k sum_row dinv[rho_idx, k, row, c],

read through a ring of ``slots`` (2 or 4) asynchronous copies, each tile
copied whole or, ``split``, as two halves on separate barriers.  It
measures how fast the card reads the stream that K2's sweeps read (see
``tools/thomas_bw_study.py``).  For CUDA tensors the wrapper launches the
kernel (float32 or bf16 pivots) or raises; for CPU tensors it runs the
plain version ``thomas_stream_reference``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: the variants of the JAX study (tools/thomas_bw_study.py:180-189):
#: name -> (slots, split)
VARIANTS = {"dma2": (2, False), "dma4": (4, False),
            "dma2split": (2, True), "dma4split": (4, True)}

#: bytes of one tile (whole rows, at least one): 4 slots of it and the
#: column accumulator fit in a block's 227 KB of shared memory at
#: 256 agents (a float32 row of bs = 2304 is 9216 bytes: 5 rows a tile)
TILE_BYTES = 48 * 1024


def thomas_stream_reference(dinv: torch.Tensor,
                            rho_idx: int) -> torch.Tensor:
    """The plain version: every row of rung ``rho_idx`` summed, in
    float32 ([bs])."""
    return dinv[rho_idx].float().sum(dim=(0, 1))


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.thomas_stream_grid.restype = ci
    lib.thomas_stream_grid.argtypes = [ci] * 5 + [ctypes.POINTER(ci)]
    lib.thomas_stream.restype = ci
    lib.thomas_stream.argtypes = [vp, cll] + [ci] * 6 + [vp] * 3
    lib.thomas_stream_error_string.restype = ctypes.c_char_p
    lib.thomas_stream_error_string.argtypes = [ci]


def tile_rows(bs: int, element_size: int) -> int:
    """Rows per tile: as many whole rows as fit in TILE_BYTES, at least
    one."""
    return max(1, TILE_BYTES // (bs * element_size))


_grids: dict[tuple, int] = {}


def thomas_stream(dinv: torch.Tensor, rho_idx: int, slots: int = 2,
                  split: bool = False) -> torch.Tensor:
    """out [bs] float32: the sum of every row of rung ``rho_idx`` of
    ``dinv`` [R, Mi, bs, bs] (float32 or bf16).  A CUDA tensor launches T4
    once (``slots`` 2 or 4, ``split`` copies in halves); a CPU tensor runs
    the plain version; anything else raises."""
    if dinv.device.type == "cpu":
        return thomas_stream_reference(dinv, rho_idx)
    if dinv.device.type != "cuda":
        raise ValueError(f"thomas_stream: dinv is on {dinv.device}, "
                         "expected a CUDA tensor")
    if dinv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"thomas_stream: dinv has dtype {dinv.dtype}, "
                         "expected torch.float32 or torch.bfloat16")
    if dinv.dim() != 4 or dinv.shape[-1] != dinv.shape[-2]:
        raise ValueError(f"thomas_stream: dinv has shape "
                         f"{tuple(dinv.shape)}, expected [R, Mi, bs, bs]")
    if not dinv.is_contiguous():
        raise ValueError("thomas_stream: dinv is not contiguous")
    if (slots, split) not in VARIANTS.values():
        raise ValueError(f"thomas_stream: no variant with {slots} slots, "
                         f"split={split}")
    R, Mi, bs = dinv.shape[0], dinv.shape[1], dinv.shape[-1]
    if not 0 <= rho_idx < R:
        raise ValueError(f"thomas_stream: rung {rho_idx} outside [0, {R})")
    elt = dinv.element_size()
    if (bs * elt) % 32:
        raise ValueError(f"thomas_stream: a row of {bs} x {elt} bytes is "
                         "not a multiple of 32 bytes (the bulk copies move "
                         "16-byte units, a split copy half a tile)")
    rung = dinv[rho_idx]
    if rung.data_ptr() % 16:
        raise ValueError("thomas_stream: dinv is not 16-byte aligned")
    lib = _build.load("thomas_stream", _declare)
    rows = tile_rows(bs, elt)
    dev = dinv.device
    key = (dev.index, elt, slots, split, bs, rows)
    with torch.cuda.device(dev):
        grid = _grids.get(key)
        if grid is None:
            g = ctypes.c_int(0)
            _build.check_error("thomas_stream_grid", lib.thomas_stream_grid(
                elt, slots, int(split), bs, rows, ctypes.byref(g)),
                lib.thomas_stream_error_string)
            grid = _grids[key] = g.value
        partial = torch.empty((grid, bs), dtype=torch.float32, device=dev)
        out = torch.empty(bs, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check_error("thomas_stream", lib.thomas_stream(
            ctypes.c_void_p(rung.data_ptr()), Mi * bs, bs, elt, slots,
            int(split), rows, grid, ctypes.c_void_p(partial.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream)),
            lib.thomas_stream_error_string)
    thomas_stream.launches += 1
    return out


thomas_stream.launches = 0
