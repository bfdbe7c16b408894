"""ctypes bindings for the C++ host runtime (ECBS, EDT, SFC expansion).

The source is this package's own ``csrc/swarm_native.cpp``, a byte-equal
copy of the JAX package's host runtime, so both packages run the same
host search code.  The library is built on first use with g++ into this
package's git-ignored ``build/`` directory.  The build writes a temporary
file and renames it into place, so concurrent test workers never load a
half-written library.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "swarm_native.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "build"
_LIB = _BUILD / "libswarm_native.so"
_lock = threading.Lock()
_lib = None


def build_native(force: bool = False) -> Path:
    with _lock:
        if _LIB.exists() and not force and \
                _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
            return _LIB
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
               "-march=native", str(_SRC), "-o", str(tmp)]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
        return _LIB


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build_native()
        lib = ctypes.CDLL(str(_LIB))
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)

        lib.ecbs_solve.restype = ctypes.c_int
        lib.ecbs_solve.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, ctypes.c_int, i32p, i32p, f64p, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_long, ctypes.c_int,
            ctypes.c_double, i32p, i32p, ctypes.c_int,
        ]
        lib.esdf_compute.restype = None
        lib.esdf_compute.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, f32p,
        ]
        lib.sfc_expand_agent.restype = ctypes.c_int
        lib.sfc_expand_agent.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, i64p, f64p, f64p,
            ctypes.c_double, ctypes.c_double,
            f64p, ctypes.c_int, ctypes.c_double,
            f64p, ctypes.c_int,
        ]
        _lib = lib
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def ecbs_search_native(*, dims, obstacles, starts, goals, quad_size,
                       grid_size, w, max_expansions: int = 500_000,
                       max_time: int = 0, timeout_s: float = 60.0):
    """Returns per-agent paths as lists of (t, x, y, z), or None."""
    lib = get_lib()
    n = len(starts)
    obs = np.asarray(sorted(obstacles), dtype=np.int32).reshape(-1, 3)
    st = np.ascontiguousarray(np.asarray(starts, dtype=np.int32))
    gl = np.ascontiguousarray(np.asarray(goals, dtype=np.int32))
    qs = np.ascontiguousarray(np.asarray(quad_size, dtype=np.float64))
    max_path = 4 * (dims[0] * dims[1] * dims[2]) + 200
    out_paths = np.zeros((n, max_path, 3), dtype=np.int32)
    out_lens = np.zeros(n, dtype=np.int32)
    ret = lib.ecbs_solve(
        dims[0], dims[1], dims[2],
        _ptr(obs, ctypes.c_int32), len(obs),
        _ptr(st, ctypes.c_int32), _ptr(gl, ctypes.c_int32),
        _ptr(qs, ctypes.c_double), n,
        float(grid_size), float(w), int(max_expansions), int(max_time),
        float(timeout_s),
        _ptr(out_paths, ctypes.c_int32), _ptr(out_lens, ctypes.c_int32),
        max_path)
    if ret != 0:
        return None
    paths = []
    for i in range(n):
        L = int(out_lens[i])
        paths.append([(t, int(out_paths[i, t, 0]), int(out_paths[i, t, 1]),
                       int(out_paths[i, t, 2])) for t in range(L)])
    return paths


def esdf_native(occ: np.ndarray, res: float, max_dist: float) -> np.ndarray:
    lib = get_lib()
    occ = np.ascontiguousarray(occ, dtype=np.uint8)
    X, Y, Z = occ.shape
    out = np.zeros((X, Y, Z), dtype=np.float32)
    lib.esdf_compute(_ptr(occ, ctypes.c_uint8), X, Y, Z, float(res),
                     float(max_dist), _ptr(out, ctypes.c_float))
    return out


def sfc_expand_native(esdf_arr: np.ndarray, res: float, i0: np.ndarray,
                      world_min, world_max, box_xy_res: float,
                      box_z_res: float, traj: np.ndarray,
                      margin: float, max_boxes: int = 512) -> np.ndarray:
    """One agent's SFC boxes [n_boxes, 6]; raises on invalid trajectory."""
    lib = get_lib()
    esdf_arr = np.ascontiguousarray(esdf_arr, dtype=np.float32)
    X, Y, Z = esdf_arr.shape
    i0 = np.ascontiguousarray(i0, dtype=np.int64)
    wmin = np.ascontiguousarray(world_min, dtype=np.float64)
    wmax = np.ascontiguousarray(world_max, dtype=np.float64)
    traj = np.ascontiguousarray(traj, dtype=np.float64)
    out = np.zeros((max_boxes, 6), dtype=np.float64)
    ret = lib.sfc_expand_agent(
        _ptr(esdf_arr, ctypes.c_float), X, Y, Z, float(res),
        _ptr(i0, ctypes.c_int64), _ptr(wmin, ctypes.c_double),
        _ptr(wmax, ctypes.c_double), float(box_xy_res), float(box_z_res),
        _ptr(traj, ctypes.c_double), len(traj), float(margin),
        _ptr(out, ctypes.c_double), max_boxes)
    if ret == -1:
        raise ValueError("obstacle invades initial trajectory")
    if ret < 0:
        raise RuntimeError(f"sfc_expand_agent failed: {ret}")
    return out[:ret]
