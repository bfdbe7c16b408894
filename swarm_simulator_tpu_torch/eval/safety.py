"""Safety and acceptance metrics (float64, on the plan's device).

A ``device`` of None means the card (raising without one), as for every
entry point of the port; pass ``device="cpu"`` for the CPU.

The reference prints two acceptance numbers after every run
(rbp_publisher.hpp:125-126): the global minimum inter-agent ellipsoidal
distance ratio (collision iff < 1, update_safety_margin_ratio :769-798)
and the total flight distance (trajectory_length_sum :685-695).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device


def safety_margin_ratio(pos, radius, *, downwash: float,
                        device=None) -> float:
    """pos [N, S, 3] -> min over time/pairs of downwash-scaled dist ratio."""
    device = resolve_device(device)
    f64 = torch.float64
    pos = torch.as_tensor(pos, dtype=f64, device=device)
    radius = torch.as_tensor(radius, dtype=f64, device=device)
    N = pos.shape[0]
    scale = torch.tensor([1.0, 1.0, 1.0 / downwash], dtype=f64,
                         device=device)
    iu, ju = torch.triu_indices(N, N, offset=1, device=device)
    dist = torch.linalg.vector_norm((pos[ju] - pos[iu]) * scale, dim=-1)
    ratio = dist / (radius[iu] + radius[ju])[:, None]
    return float(ratio.min())


def flight_distance(pos, device=None) -> float:
    """Total path length over all agents from dense samples [N, S, 3]."""
    device = resolve_device(device)
    pos = torch.as_tensor(pos, dtype=torch.float64, device=device)
    return float(torch.linalg.vector_norm(pos[:, 1:] - pos[:, :-1],
                                          dim=-1).sum())


def knot_continuity_error(coef: np.ndarray, T: np.ndarray, n: int,
                          phi: int, device=None) -> float:
    """Max |p^(r)(T_m^-) - p^(r)(T_m^+)| over interior knots, r < phi."""
    from .sample import sample_trajectories

    device = resolve_device(device)
    T = np.asarray(T)
    eps = 1e-6
    sl = sample_trajectories(coef, T, T[1:-1] - eps, n=n, derivatives=phi,
                             device=device)
    sr = sample_trajectories(coef, T, T[1:-1] + eps, n=n, derivatives=phi,
                             device=device)
    return float((sl - sr).abs().max())


def box_containment_error(ctrl: np.ndarray, seg_boxes: np.ndarray) -> float:
    """Max violation of control points vs their segment SFC boxes.

    ctrl [N, M, n+1, 3], seg_boxes [N, M, 6]; <= 0 means all inside."""
    lo = seg_boxes[:, :, None, 0:3] - ctrl
    hi = ctrl - seg_boxes[:, :, None, 3:6]
    return float(np.max(np.maximum(lo, hi)))


def dynamic_limit_violation(vel: np.ndarray, acc: np.ndarray,
                            max_vel: np.ndarray, max_acc: np.ndarray) -> float:
    """Max of |v|-v_max and |a|-a_max per axis; <= 0 means feasible.

    vel/acc [N, S, 3], limits [N, 3]."""
    ev = np.abs(vel) - max_vel[:, None, :]
    ea = np.abs(acc) - max_acc[:, None, :]
    return float(max(ev.max(), ea.max()))
