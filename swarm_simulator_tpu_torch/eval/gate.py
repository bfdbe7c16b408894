"""The acceptance gate on solved control points and its objective oracle
(the JAX package's bench.gate_quality, batch0_objective, oracle_batch and
ipm_best_response_batch0).  The oracle is the host float64 IPM
(qp/ipm.py), so the port grades itself without JAX."""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.device import resolve_device
from ..parallel import seqbatch
from ..qp import assemble, convert, ipm, timescale
from .safety import safety_margin_ratio
from .sample import sample_times, sample_trajectories


def gate_quality(ctrl, plan, mission, param, obj_ref=None, obj_b0=None,
                 obj_tol=1.25, device=None):
    """(ok, metrics) for control points [N, M, n+1, 3]:
      * collision ratio >= 1 (rbp_publisher.hpp:769-798)
      * C^0 / C^2 knot continuity (< 1e-3 / < 5e-3) and endpoint pins
        (< 1e-4)
      * SFC box containment of every control point (< 1e-3)
      * dynamic limits after time scaling (rbp_planner.hpp:209-266),
        verified by dense sampling of the scaled trajectory
        (<= 1 + 1e-9 of max_vel / max_acc)
      * with ``obj_ref`` (the jerk objective of the f64 IPM best-response
        optimum of one agent batch, ipm_best_response_batch0): our
        objective for those agents, ``obj_b0`` (batch0_objective), within
        ``obj_tol`` of it.
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

    if obj_ref is not None:
        m["obj_b0"] = obj_b0
        m["obj_ref"] = obj_ref
        ok = ok and obj_b0 <= obj_ref * obj_tol + 1e-9
    return ok, m


def batch0_objective(dm, plan, mission, param, b_idx: int = 0):
    """(jerk objective of agent batch b_idx's control points in ``dm``,
    that batch's host QPData)."""
    batches, _ = seqbatch.make_batches(mission.qn, param)
    agents = batches[b_idx]
    dummy = assemble.build_dummy(plan.init_traj, param.n)
    data0 = assemble.assemble_batch(plan, mission, param, agents, dummy)
    Qseg = np.asarray(data0.Qseg).astype(np.float64)
    c = np.asarray(dm, np.float64)[agents]            # [B, M, n+1, 3]
    return float(np.einsum("bmik,mij,bmjk->", c, Qseg, c) * 0.5), data0


def oracle_batch(seed: int, n_batches: int) -> int:
    """The agent batch the IPM best-response oracle checks for a gate
    seed: a stride co-prime to 16, so gate seeds 0-4 cover five distinct
    batches of the 64-agent forest (0, 7, 14, 5, 12)."""
    return (seed * 7) % n_batches


def ipm_best_response_batch0(plan, mission, param, final_ctrl,
                             b_idx: int = 0, pair_relax: float = 0.0):
    """(objective, seconds of the verified solve): the f64 IPM optimum of
    batch b_idx's best-response QP, its agents free and everyone else
    fixed at ``final_ctrl`` (the pair rhs refreshed from it), by the
    reduced (equality-eliminated) barrier; the optimum is verified by the
    full-space KKT residual check (1e-5), and a solve that fails it is
    retried tighter, never checked looser.  ``pair_relax`` lowers every
    pair rhs: an exactly optimal ``final_ctrl`` can leave pair rows with
    zero slack against the fixed neighbours, and the barrier then has no
    strict interior; the relaxation biases the objective down (margins
    read high)."""
    batches, _ = seqbatch.make_batches(mission.qn, param)
    dummy = np.asarray(final_ctrl, np.float64)
    data0 = assemble.host_f64(assemble.assemble_batch(
        plan, mission, param, batches[b_idx], dummy))
    # barrier slack on zero-width duplicated knot rows; 5e-4 stays under
    # the 1e-3 gate bound
    lb_r, ub_r = assemble.relax_thin_knot_rows(data0.lb, data0.ub, param.n)
    data0 = dataclasses.replace(data0, lb=lb_r, ub=ub_r)
    if pair_relax:
        data0 = dataclasses.replace(data0,
                                    pair_rhs=data0.pair_rhs - pair_relax)
    t0 = time.perf_counter()
    res = ipm.solve_ipm_reduced(data0)
    dt = time.perf_counter() - t0
    try:
        ipm.verify_optimal(data0, res, tol=1e-5)
    except AssertionError:
        # marginal instances can pass the solver's own termination test
        # while the full-space complementarity is still settling: retry
        # tighter; dt is the verified solve's own time
        t0 = time.perf_counter()
        res = ipm.solve_ipm_reduced(data0, tol=1e-12, max_iter=120)
        dt = time.perf_counter() - t0
        ipm.verify_optimal(data0, res, tol=1e-5)
    Q = ipm.build_flat(data0)[0]
    xo = res.x.reshape(-1)
    return float(0.5 * xo @ (Q @ xo)), dt
