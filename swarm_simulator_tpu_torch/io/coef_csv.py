"""Crazyswarm trajectory CSV read/write (generateCoefCSV format).

Format (rbp_planner.hpp:295-324): header
  duration,x^0..x^7,y^0..y^7,z^0..z^7,yaw^0..yaw^7
one row per segment; coefficients in ASCENDING powers of local time,
zero-padded to degree 7; yaw always zero.

The committed log/coef1..64.csv files are the reference's golden 64-agent
solution and our primary parity artifact (SURVEY.md §4).

A copy of swarm_simulator_tpu/io/coef_csv.py (host code),
so that the PyTorch port never imports the JAX package.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

_HEADER = ("duration," +
           ",".join(f"{a}^{i}" for a in ("x", "y", "z", "yaw")
                    for i in range(8)))


def write_coef_csv(path: str | Path, coef: np.ndarray, T: np.ndarray,
                   n: int) -> None:
    """coef [M, n+1, 3] descending powers -> crazyswarm CSV (n <= 7)."""
    if n > 7:
        raise ValueError("crazyswarm CSV supports degree <= 7")
    M = coef.shape[0]
    dt = np.diff(np.asarray(T))
    with open(path, "w") as f:
        f.write(_HEADER + "\n")
        for m in range(M):
            cells = [_fmt(dt[m])]
            for k in range(3):
                # ascending powers: coef row n-i holds t^i
                for i in range(n + 1):
                    cells.append(_fmt(coef[m, n - i, k]))
                cells.extend(["0"] * (7 - n))
            cells.extend(["0"] * 8)  # yaw
            f.write(",".join(cells) + ",\n")


def _fmt(v: float) -> str:
    # match C++ ostream default: 6 significant digits
    return f"{v:.6g}"


def read_coef_csv(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """CSV -> (coef [M, 8, 3] descending powers of degree 7, durations [M])."""
    rows = []
    durations = []
    with open(path) as f:
        next(f)  # header
        for line in f:
            cells = [c for c in line.strip().split(",") if c != ""]
            if not cells:
                continue
            vals = np.array([float(c) for c in cells])
            durations.append(vals[0])
            rows.append(vals[1:25].reshape(3, 8))  # x,y,z ascending powers
    coef_asc = np.stack(rows)  # [M, 3, 8]
    # -> descending powers [M, 8, 3]: row j = coeff of t^(7-j)
    coef = coef_asc[:, :, ::-1].transpose(0, 2, 1)
    return np.ascontiguousarray(coef), np.asarray(durations)


def write_all(dir_path: str | Path, coef: np.ndarray, T: np.ndarray,
              n: int) -> None:
    """Per-agent files coef{i+1}.csv, i = 0..N-1 (reference naming)."""
    dir_path = Path(dir_path)
    dir_path.mkdir(parents=True, exist_ok=True)
    for qi in range(coef.shape[0]):
        write_coef_csv(dir_path / f"coef{qi + 1}.csv", coef[qi], T, n)
