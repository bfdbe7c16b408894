"""Build the hand-written CUDA kernels of ``csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with nvcc
(``sm_90a``) into its own shared library ``build/lib<name>.so`` in the
package's git-ignored build directory, loaded with ctypes.  A library is
rebuilt when it is missing or older than its source or a shared header
(``csrc/*.cuh``).  Nothing is built
when a module is imported: the first launch builds.

A name ``"<source>@<tag>"`` builds a variant of ``csrc/<source>.cu`` for
the measuring tools, compiled with ``-D<TAG>`` (the tag in upper case)
into its own library ``build/lib<source>_<tag>.so``; no wrapper of the
port loads one.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _compile(name: str, verbose: bool) -> tuple[Path, float, str]:
    base, _, tag = name.partition("@")
    src = CSRC / f"{base}.cu"
    lib = BUILD / f"lib{base}{'_' + tag if tag else ''}.so"
    defines = (f"-D{tag.upper()}",) if tag else ()
    newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
    if lib.exists() and lib.stat().st_mtime >= newest:
        return lib, 0.0, ""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *defines,
           *(("-Xptxas", "-v") if verbose else ()), "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src.name} failed ({res.returncode}):"
                           f"\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, res.stdout + res.stderr


def build(*names: str, verbose: bool = False) -> dict[str, tuple]:
    """Compile each ``csrc/<name>.cu`` into ``build/lib<name>.so`` unless
    the library is newer than its source, one nvcc process per source,
    all started together.  Returns {name: (library path, build seconds,
    compiler output; ptxas statistics with ``verbose``)}."""
    with _lock, ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        futs = {n: ex.submit(_compile, n, verbose) for n in names}
        return {n: f.result() for n, f in futs.items()}


def check_operands(fname: str, named, dtype=None) -> None:
    """Raise ValueError unless every (name, tensor, shape) of ``named`` is
    a contiguous CUDA tensor of that shape and ``dtype`` (None:
    torch.float32)."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    for name, t, shape in named:
        if t.device.type != "cuda":
            raise ValueError(f"{fname}: {name} is on {t.device}, expected a "
                             "CUDA tensor")
        if t.dtype != dtype:
            raise ValueError(f"{fname}: {name} has dtype {t.dtype}, "
                             f"expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fname}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fname}: {name} is not contiguous")


def check_error(fname: str, err: int, describe) -> None:
    """Raise RuntimeError for a non-zero cudaError_t ``err`` returned by a
    library function; ``describe(err)`` is the library's error string."""
    if err != 0:
        raise RuntimeError(f"{fname}: CUDA error {err} "
                           f"({describe(err).decode()})")


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use);
    ``declare(lib)`` sets its functions' argtypes and restype once."""
    lib = _libs.get(name)
    if lib is None:
        path, _, _ = build(name)[name]
        lib = ctypes.CDLL(str(path))
        declare(lib)
        _libs[name] = lib
    return lib
