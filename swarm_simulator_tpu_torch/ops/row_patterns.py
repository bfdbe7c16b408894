"""T5, the row-assembly patterns: fourteen small index maps (concat,
reshape, pad, dynamic row writes, broadcast, roll, an update slice,
``.at[].add``).

The wrapper of the hand-written CUDA kernel in ``csrc/row_patterns.cu``,
which replaces the Pallas TPU kernels of the JAX package's
``tools/pallas_debug/mosaic_patterns.py`` (``run`` and its kernels k1 ...
k12).  ``PATTERNS`` names each as the TPU probe does, with its inputs'
and output's shapes and its plain version; ``pattern_inputs`` makes the
probe's fixed ``arange`` inputs.  For CUDA tensors ``row_pattern`` launches
the kernel once or raises; for CPU tensors it runs the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from . import _build


def _rows_written(shape, fill):
    def f(a):
        out = torch.zeros(shape, dtype=a.dtype, device=a.device)
        for k in range(shape[0]):
            fill(out, a, k)
        return out
    return f


def _p6(o, a, k):
    o[k, 256:512] = a[k, :256] * 2.0


def _p6b(o, a, k):
    o[k, 0:192] = a[k, :192] * 2.0


def _p7(o, a, k):
    for f in range(3):
        o[k, f, :] = a[k, :192] * (1.0 + f)


def _p11(a):
    x = torch.zeros((8, 768), dtype=a.dtype, device=a.device)
    x[:, 256:512] = a
    return x


def _p12(a):
    x = torch.zeros((8, 3, 192), dtype=a.dtype, device=a.device)
    x[1:8, 1, :] += a[:7, :192]
    return x


def _scaled(factors):
    """out[:, f, :] = factors[f] * x for x [n, l]: one torch.mul of x
    against the factors on a new middle axis (the factors made once per
    device, at the first call)."""
    made = {}

    def mul(x):
        w = made.get(x.device)
        if w is None:
            w = made[x.device] = torch.tensor(
                factors, dtype=x.dtype, device=x.device).reshape(1, -1, 1)
        return torch.mul(x.unsqueeze(1), w)
    return mul


_BY_12, _BY_123, _BY_012 = (_scaled((1.0, 2.0)), _scaled((1.0, 2.0, 3.0)),
                            _scaled((0.0, 1.0, 2.0)))


class Pattern(NamedTuple):
    inputs: tuple            # the shapes of its inputs
    out: tuple               # the shape of its output
    plain: Callable          # the plain version
    #: the one PyTorch call that computes it; none for P6 and P6b, which
    #: scale and then place (two calls)
    library: Callable | None


PATTERNS = {
    "P1 lane concat 3x[8,256] -> [8,768]": Pattern(
        ((8, 256),) * 3, (8, 768), lambda a, b, c: torch.cat([a, b, c], 1),
        lambda a, b, c: torch.cat([a, b, c], 1)),
    "P1b lane concat 2x[8,192] -> [8,384]": Pattern(
        ((8, 192),), (8, 384), lambda x: torch.cat([x, x * 2.0], 1),
        lambda x: _BY_12(x).view(8, 384)),
    "P2 sublane concat [1,256]+[7,256]": Pattern(
        ((8, 256),), (8, 256), lambda x: torch.cat([x[:1] * 0.0, x[:7]], 0),
        lambda x: F.pad(x[:7], (0, 0, 1, 0))),
    "P3 mid-dim concat 3x[35,1,192] -> [35,3,192]": Pattern(
        ((35, 192),), (35, 3, 192),
        lambda x: torch.cat([x[:, None], (x * 2.0)[:, None],
                             (x * 3.0)[:, None]], 1), _BY_123),
    "P4 sublane reshape roundtrip [216,192]<->[36,6,192]": Pattern(
        ((216, 192),), (216, 192),
        lambda x: (x.reshape(36, 6, 192) * 2.0).reshape(216, 192),
        lambda x: torch.mul(x, 2.0)),
    "P5 lane pad [8,192] -> [8,256]": Pattern(
        ((8, 192),), (8, 256), lambda x: F.pad(x, (0, 64)),
        lambda x: F.pad(x, (0, 64))),
    "P6 ref write [ds(k,1), 256:512]": Pattern(
        ((8, 256),), (8, 768), _rows_written((8, 768), _p6), None),
    "P6b ref write [ds(k,1), 0:192] into [8,768]": Pattern(
        ((8, 256),), (8, 768), _rows_written((8, 768), _p6b), None),
    "P7 3D ref write [ds(k,1), f, :]": Pattern(
        ((8, 256),), (8, 3, 192), _rows_written((8, 3, 192), _p7),
        lambda a: _BY_123(a[:, :192])),
    "P8 sum(3D*[192,1,1], axis=0) -> [3,192]": Pattern(
        ((192, 3, 192), (192, 1, 1)), (3, 192),
        lambda g, c: torch.sum(g * c, 0),
        lambda g, c: torch.einsum("kfl,k->fl", g, c.view(-1))),
    "P9 broadcast [8,1,192]*[1,3,1]": Pattern(
        ((8, 192),), (8, 3, 192),
        lambda x: x[:, None, :] * torch.arange(
            3, dtype=x.dtype, device=x.device).reshape(1, 3, 1), _BY_012),
    "P10 lane roll by 256 on [8,768]": Pattern(
        ((8, 768),), (8, 768), lambda x: torch.roll(x, 256, 1),
        lambda x: torch.roll(x, 256, 1)),
    "P11 dus on value (expected FAIL)": Pattern(
        ((8, 256),), (8, 768), _p11, lambda a: F.pad(a, (256, 256))),
    "P12 .at[1:8,1,:].add on 3D value": Pattern(
        ((8, 256),), (8, 3, 192), _p12,
        lambda a: F.pad(a[:7, :192].unsqueeze(1), (0, 0, 1, 1, 1, 0))),
}

#: the patterns whose result is a data movement, bit-equal on any device;
#: P8's sum of products is held to a relative tolerance
SUM_PATTERN = "P8 sum(3D*[192,1,1], axis=0) -> [3,192]"


def pattern_inputs(device="cpu") -> dict[str, tuple]:
    """The TPU probe's inputs (mosaic_patterns.py:32-34, 43, 56, 66,
    109-110, 121, 127): float32 aranges, made on ``device``."""
    def ar(*shape):
        n = 1
        for s in shape:
            n *= s
        return torch.arange(n, dtype=torch.float32,
                            device=device).reshape(shape)

    a = ar(8, 256)
    b, c = a + 1.0, a + 2.0
    a192 = a[:, :192].contiguous()
    m3 = ar(35, 192)
    one = {"P1 ": (a, b, c), "P1b": (a192,), "P2 ": (a,), "P3 ": (m3,),
           "P4 ": (ar(216, 192),), "P5 ": (a192,), "P6 ": (a,),
           "P6b": (a,), "P7 ": (a,),
           "P8 ": (ar(192, 3, 192) * 1e-4, ar(192).reshape(192, 1, 1)),
           "P9 ": (m3[:8].contiguous(),), "P10": (a.repeat(1, 3),),
           "P11": (a,), "P12": (a,)}
    return {name: one[name[:3]] for name in PATTERNS}


def row_pattern_reference(name: str, *inputs) -> torch.Tensor:
    return PATTERNS[name].plain(*inputs)


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.row_pattern.restype = ci
    lib.row_pattern.argtypes = [ci] + [vp] * 4 + [ci, vp]
    lib.row_pattern_error_string.restype = ctypes.c_char_p
    lib.row_pattern_error_string.argtypes = [ci]


def row_pattern(name: str, *inputs: torch.Tensor) -> torch.Tensor:
    """The output of pattern ``name`` (a key of PATTERNS) on ``inputs``.
    CUDA float32 tensors launch T5 once; CPU tensors run the plain version;
    anything else raises."""
    pat = PATTERNS[name]
    if len(inputs) != len(pat.inputs):
        raise ValueError(f"row_pattern: {name} takes {len(pat.inputs)} "
                         f"inputs, got {len(inputs)}")
    if inputs[0].device.type == "cpu":
        return row_pattern_reference(name, *inputs)
    _build.check_operands("row_pattern", [
        (f"input {i}", t, s) for i, (t, s) in enumerate(zip(inputs,
                                                            pat.inputs))])
    lib = _build.load("row_patterns", _declare)
    dev = inputs[0].device
    with torch.cuda.device(dev):
        out = torch.empty(pat.out, dtype=torch.float32, device=dev)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in inputs]
        ptrs += [ptrs[0]] * (3 - len(ptrs))
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check_error("row_pattern", lib.row_pattern(
            list(PATTERNS).index(name), *ptrs, ctypes.c_void_p(out.data_ptr()),
            out.numel(), ctypes.c_void_p(stream)),
            lib.row_pattern_error_string)
    row_pattern.launches += 1
    return out


row_pattern.launches = 0
