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
                                    forward and backward Thomas sweeps

Each launches its kernel for CUDA float32 tensors or raises, runs its plain
version (``*_reference``) for CPU tensors, and counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MI, PHI, B3 = 35, 3, 192
MP, PL = 216, 2048    # pair rows, padded pair lanes
INNER = 50


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nsfused_probe_p1.restype = ci
    lib.nsfused_probe_p1.argtypes = [vp] * 3
    lib.nsfused_probe_p2.restype = ci
    lib.nsfused_probe_p2.argtypes = [vp] * 4
    lib.nsfused_probe_p3.restype = ci
    lib.nsfused_probe_p3.argtypes = [vp] * 3 + [ci] * 3 + [vp]
    lib.nsfused_probe_p4.restype = ci
    lib.nsfused_probe_p4.argtypes = [vp] * 5 + [ci] * 2 + [vp]
    lib.nsfused_probe_error_string.restype = ctypes.c_char_p
    lib.nsfused_probe_error_string.argtypes = [ci]


def _launch(fname: str, *args) -> None:
    """Call ``fname`` of the library on the current stream of the first
    tensor's device; tensors go as pointers, ints as they are."""
    lib = _build.load("nsfused_probe", _declare)
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
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


def p2_tile_apply(d6: torch.Tensor, y: torch.Tensor,
                  rho_idx: int) -> torch.Tensor:
    """[3, 192] = knot 3 of rung ``rho_idx`` of d6 [R, 35, 3, 3, 192, 192]
    applied to y [3, 192] (P2)."""
    if y.device.type == "cpu":
        return p2_tile_apply_reference(d6, y, rho_idx)
    _rung_ok("p2_tile_apply", d6, rho_idx, d6.shape[1])
    if d6.shape[1] < 4:
        raise ValueError("p2_tile_apply: d6 has no knot 3")
    _build.check_operands("p2_tile_apply", (("y", y, (PHI, B3)),))
    out = torch.empty((PHI, B3), dtype=torch.float32, device=y.device)
    _launch("nsfused_probe_p2", d6[rho_idx, 3], y, out)
    p2_tile_apply.launches += 1
    return out


p2_tile_apply.launches = 0


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


def p4_resident_thomas(d6: torch.Tensor, ho: torch.Tensor, b: torch.Tensor,
                       rho_idx: int = 0, inner: int = INNER) -> torch.Tensor:
    """x [Mi, 3, 192] after ``inner`` iterations of both sweeps over rung
    ``rho_idx`` of d6 [R, Mi, 3, 3, 192, 192] with ho [3, 3] (P4)."""
    if b.device.type == "cpu":
        return p4_resident_thomas_reference(d6, ho, b, rho_idx, inner)
    Mi = b.shape[0]
    _rung_ok("p4_resident_thomas", d6, rho_idx, Mi)
    _build.check_operands("p4_resident_thomas", (("ho", ho, (PHI, PHI)),
                                                 ("b", b, (Mi, PHI, B3))))
    if inner < 1:
        raise ValueError(f"p4_resident_thomas: inner = {inner} < 1")
    t = torch.empty_like(b)
    x = torch.empty_like(b)
    _launch("nsfused_probe_p4", d6[rho_idx], ho, b, t, x, Mi, inner)
    p4_resident_thomas.launches += 1
    return x


p4_resident_thomas.launches = 0
