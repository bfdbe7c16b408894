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
K2's first grid (ceil(bs / 24) cooperative blocks) or raises; for CPU
tensors it runs the plain version ``thomas_probe_reference``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

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


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.thomas_probe_grid.restype = ci
    lib.thomas_probe_grid.argtypes = [ci, ctypes.POINTER(ci)]
    lib.thomas_probe.restype = ci
    lib.thomas_probe.argtypes = [vp] * 8 + [ci] * 4 + [vp]
    lib.thomas_probe_error_string.restype = ctypes.c_char_p
    lib.thomas_probe_error_string.argtypes = [ci]


def thomas_probe(dinv: torch.Tensor, koM: torch.Tensor, b: torch.Tensor,
                 stage: str, rho_idx: int) -> torch.Tensor:
    """out [Mi, bs] of ``stage`` (see the module) on rung ``rho_idx`` of
    dinv [R, Mi, bs, bs].  CUDA float32 tensors launch T3 once; CPU tensors
    run the plain version; anything else raises."""
    if b.device.type == "cpu":
        return thomas_probe_reference(dinv, koM, b, stage, rho_idx)
    if stage not in STAGES:
        raise ValueError(f"thomas_probe: unknown stage {stage!r}")
    Mi, bs = b.shape
    R = dinv.shape[0]
    _build.check_operands("thomas_probe", (
        ("dinv", dinv, (R, Mi, bs, bs)), ("koM", koM, (bs, bs)),
        ("b", b, (Mi, bs))))
    if bs % 4:
        raise ValueError(f"thomas_probe: bs = {bs} is not a multiple of 4 "
                         "(rows are read 16 bytes a lane)")
    if not 0 <= rho_idx < R:
        raise ValueError(f"thomas_probe: rung {rho_idx} outside [0, {R})")
    rung = dinv[rho_idx]
    if rung.data_ptr() % 16:
        raise ValueError("thomas_probe: dinv is not 16-byte aligned")
    lib = _build.load("thomas_probe", _declare)
    dev = b.device
    with torch.cuda.device(dev):
        g = ctypes.c_int(0)
        _build.check_error("thomas_probe_grid",
                           lib.thomas_probe_grid(bs, ctypes.byref(g)),
                           lib.thomas_probe_error_string)
        koMT = koM.T.contiguous()
        y = torch.empty_like(b)
        t = torch.empty(bs, dtype=torch.float32, device=dev)
        sink = torch.empty(g.value * 256, dtype=torch.float32, device=dev)
        out = torch.empty_like(b)
        ptr = ctypes.c_void_p
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check_error("thomas_probe", lib.thomas_probe(
            *(ptr(a.data_ptr()) for a in (rung, koM, koMT, b, y, t, out,
                                          sink)),
            bs, Mi, STAGES.index(stage), g.value, ptr(stream)),
            lib.thomas_probe_error_string)
    thomas_probe.launches += 1
    return out


thomas_probe.launches = 0
