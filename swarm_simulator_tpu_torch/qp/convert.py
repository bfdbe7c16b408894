"""Solution extraction: control points -> power-basis coefficients."""
from __future__ import annotations

import numpy as np

from ..core import bernstein


def x_to_ctrl(x: np.ndarray, M: int, n: int) -> np.ndarray:
    """Solver layout [B, 3, D] -> control points [B, M, n+1, 3]."""
    B = x.shape[0]
    return np.asarray(x).reshape(B, 3, M, n + 1).transpose(0, 2, 3, 1)


def ctrl_to_coef(ctrl: np.ndarray, T: np.ndarray, n: int) -> np.ndarray:
    """[.., M, n+1, 3] control points -> descending-power coefficients
    (the Bernstein->power translation loop, rbp_planner.hpp:167-196)."""
    dt = np.diff(np.asarray(T, dtype=np.float64))
    return bernstein.bernstein_to_power(np.asarray(ctrl, dtype=np.float64), dt, n)
