"""The acceptance gate on solved control points (bench.gate_quality of the
JAX package, without its IPM objective oracle, which is not ported)."""
from __future__ import annotations

import numpy as np

from ..core.device import resolve_device
from ..qp import convert, timescale
from .safety import safety_margin_ratio
from .sample import sample_times, sample_trajectories


def gate_quality(ctrl, plan, mission, param, device=None):
    """(ok, metrics) for control points [N, M, n+1, 3]:
      * collision ratio >= 1 (rbp_publisher.hpp:769-798)
      * C^0 / C^2 knot continuity (< 1e-3 / < 5e-3) and endpoint pins
        (< 1e-4)
      * SFC box containment of every control point (< 1e-3)
      * dynamic limits after time scaling (rbp_planner.hpp:209-266),
        verified by dense sampling of the scaled trajectory
        (<= 1 + 1e-9 of max_vel / max_acc)
    Sampling runs in float64 on ``device`` (None = the card; raises
    without one: pass ``device="cpu"`` for the CPU)."""
    device = resolve_device(device)
    dm = np.asarray(ctrl, dtype=np.float64)
    coef = convert.ctrl_to_coef(dm, plan.T, param.n)
    ts = sample_times(np.asarray(plan.T), 0.1)
    pos = sample_trajectories(coef, np.asarray(plan.T), ts, n=param.n,
                              derivatives=1, device=device)[:, :, 0]
    ratio = safety_margin_ratio(pos, mission.radius,
                                downwash=param.downwash, device=device)

    cont = []
    d = dm.copy()
    deg = param.n
    for _ in range(3):
        cont.append(float(np.abs(d[:, 1:, 0] - d[:, :-1, -1]).max()))
        d = deg * np.diff(d, axis=2)
        deg -= 1
    start_err = float(np.abs(dm[:, 0, 0] - mission.start[:, :3]).max())
    goal_err = float(np.abs(dm[:, -1, -1] - mission.goal[:, :3]).max())
    boxes = plan.seg_boxes
    viol = float(np.maximum(boxes[:, :, None, :3] - dm,
                            dm - boxes[:, :, None, 3:]).max())

    scale = timescale.compute_time_scale(coef, plan.T, mission.max_vel,
                                         mission.max_acc, param.n,
                                         param.phi)
    coef_s, T_s = timescale.apply_time_scale(coef, plan.T, scale, param.n)
    ts_s = sample_times(np.asarray(T_s), 0.1)
    pva = sample_trajectories(coef_s, np.asarray(T_s), ts_s, n=param.n,
                              derivatives=3, device=device).cpu().numpy()
    vel_frac = float((np.abs(pva[:, :, 1]).max(axis=1)
                      / np.asarray(mission.max_vel)).max())
    acc_frac = float((np.abs(pva[:, :, 2]).max(axis=1)
                      / np.asarray(mission.max_acc)).max())

    m = dict(ratio=ratio, cont0=cont[0], cont2=cont[2],
             endpoints=max(start_err, goal_err), box_viol=viol,
             time_scale=scale, vel_frac=vel_frac, acc_frac=acc_frac,
             timescale_supported=(param.n == 5 and param.phi == 3))
    ok = (ratio >= 1.0 and cont[0] < 1e-3 and cont[2] < 5e-3
          and m["endpoints"] < 1e-4 and viol < 1e-3
          and vel_frac <= 1.0 + 1e-9 and acc_frac <= 1.0 + 1e-9)
    return ok, m
