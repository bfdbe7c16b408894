"""The block-tridiagonal (Thomas) KKT solve: one x = K(rho_r)^-1 b.

``thomas_solve`` is the wrapper of the hand-written CUDA kernel in
``csrc/thomas.cu`` (replacing the JAX package's Pallas TPU kernel
``ops/pallas_thomas.py::_kernel``, reached through
``thomas_solve_pallas``).  For CUDA float32 tensors it launches the kernel
or raises; it takes the plain twin ``thomas_solve_reference`` only for
tensors on the CPU.  The twin defines what the kernel computes and is what
the CPU tests run.

Layouts (Mi interior knots, B3 = 3 * agents, bs = B3 * phi), contiguous:

  dinv  [R, Mi, bs, bs]  flat pivot inverses of every rung, row
                         (agent*3 + axis)*phi + derivative order; not
                         assumed symmetric (the products are Dinv @ v)
  ho    [Mi-1, phi, phi] off-diagonal blocks: K[k, k+1] = I_B3 (x) ho[k]
  b     [Mi, bs]         right-hand side, knot-major
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def thomas_solve_reference(dinv: torch.Tensor, ho: torch.Tensor,
                           b: torch.Tensor, rho_idx: int) -> torch.Tensor:
    """Plain torch twin: the Thomas sweeps over knots with the stored pivot
    inverses of rung ``rho_idx``; the off-diagonal blocks I_B3 (x) Ho are
    applied through the Kronecker structure.  Returns x [Mi, bs] in the
    dtype of the operands."""
    if b.is_cuda:
        thomas_solve_reference.cuda_calls += 1
    Mi, bs = b.shape
    phi = ho.shape[-1]
    B3 = bs // phi
    Dinv = dinv[rho_idx]

    def koT(Ho_k, v):     # (I (x) Ho)^T v
        return torch.einsum("ai,xa->xi", Ho_k, v.reshape(B3, phi)).reshape(bs)

    def ko(Ho_k, v):      # (I (x) Ho) v
        return torch.einsum("ab,xb->xa", Ho_k, v.reshape(B3, phi)).reshape(bs)

    y = [b[0]]
    for k in range(1, Mi):
        y.append(b[k] - koT(ho[k - 1], Dinv[k - 1] @ y[k - 1]))
    x = [None] * Mi
    x[Mi - 1] = Dinv[Mi - 1] @ y[Mi - 1]
    for k in range(Mi - 2, -1, -1):
        x[k] = Dinv[k] @ (y[k] - ko(ho[k], x[k + 1]))
    return torch.stack(x)


thomas_solve_reference.cuda_calls = 0

#: a float32 kernel against a float64 twin on the same inputs, for both
#: kernels of the port: its worst error over the rungs (each relative to
#: the result's own scale) is at most TWIN_GAP_FACTOR times the float32
#: twin's worst error, plus TWIN_GAP_FLOOR.  The rung systems have
#: condition numbers up to ~1/rho_min, so float32 round-off alone moves a
#: result by up to ~1e-3 of its scale, and by a factor that varies from
#: rung to rung between two float32 implementations (which is why the
#: worst over the rungs is compared, not each rung)
TWIN_GAP_FACTOR = 3.0
TWIN_GAP_FLOOR = 1e-5


def rel_error(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max |x - ref| relative to the reference's own scale max |ref|."""
    ref = ref.double()
    return (float((x.double() - ref).abs().max())
            / max(float(ref.abs().max()), 1e-30))


def twin_gap_use(kernel_vs_f64, f32_vs_f64) -> float:
    """The share of the tolerance a kernel uses: its worst error against
    the float64 twin over the rungs, over TWIN_GAP_FACTOR times the
    float32 twin's worst error plus TWIN_GAP_FLOOR (1 = at the limit).
    Arguments: one error per rung each."""
    return max(kernel_vs_f64) / (TWIN_GAP_FACTOR * max(f32_vs_f64)
                                 + TWIN_GAP_FLOOR)


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.thomas_solve.restype = ci
    lib.thomas_solve.argtypes = [vp] * 5 + [ci] * 3 + [vp]
    lib.thomas_error_string.restype = ctypes.c_char_p
    lib.thomas_error_string.argtypes = [ci]


def _check(name: str, t: torch.Tensor, shape: tuple):
    if t.device.type != "cuda":
        raise ValueError(f"thomas_solve: {name} is on {t.device}, "
                         "expected a CUDA tensor")
    if t.dtype != torch.float32:
        raise ValueError(f"thomas_solve: {name} has dtype {t.dtype}, "
                         "expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"thomas_solve: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"thomas_solve: {name} is not contiguous")


def thomas_solve(dinv: torch.Tensor, ho: torch.Tensor, b: torch.Tensor,
                 rho_idx: int) -> torch.Tensor:
    """x [Mi, bs] = K(ladder[rho_idx])^-1 b.  CUDA float32 tensors launch
    the kernel once; CPU tensors run the plain twin; anything else
    raises."""
    if b.device.type == "cpu":
        return thomas_solve_reference(dinv, ho, b, rho_idx)
    R, Mi, bs = dinv.shape[0], dinv.shape[1], dinv.shape[-1]
    phi = ho.shape[-1]
    if phi < 1 or bs % phi:
        raise ValueError(f"thomas_solve: blocks of {bs} rows do not split "
                         f"into groups of phi = {phi}")
    if not 0 <= rho_idx < R:
        raise ValueError(f"thomas_solve: rung {rho_idx} outside [0, {R})")
    for name, t, shape in (("dinv", dinv, (R, Mi, bs, bs)),
                           ("ho", ho, (Mi - 1, phi, phi)),
                           ("b", b, (Mi, bs))):
        _check(name, t, shape)
    piv = dinv[rho_idx]
    if bs % 4 == 0 and piv.data_ptr() % 16:
        raise ValueError("thomas_solve: dinv is not 16-byte aligned")
    lib = _build.load("thomas", _declare)
    x = torch.empty_like(b)
    y = torch.empty_like(b)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(b.device).cuda_stream
    err = lib.thomas_solve(ptr(piv), ptr(ho), ptr(b), ptr(y), ptr(x),
                           bs // phi, Mi, phi, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"thomas_solve: CUDA error {err} "
                           f"({lib.thomas_error_string(err).decode()})")
    thomas_solve.launches += 1
    # the scratch y may be released while the launch is in flight: the
    # caching allocator reuses its block only in stream order
    return x


thomas_solve.launches = 0
