"""The comparison that decides ``correct``: every map of a run judged by
what its plan states, and a sample of them worked out again from the
seed.

Every map the window planned is read against the program's own
corridors (``judge_plan``):

  corridor_differ  each break of the search's promises (each path from
                   its start to its goal, a grid cell at most a time
                   step);
  pos_jump_m, vel_jump_mps, acc_jump_mps2
                   the largest jump of position, velocity and
                   acceleration at a knot or against the start and goal
                   states, read from the plan's polynomial coefficients;
  box_viol_m       the farthest a control point lies outside its box;
  pair_viol_m      the most a plane constraint of a pair planned
                   together is broken by;
  jerk_vs_dummy    J(plan) / J(the map's dummy), J the integrated squared
                   jerk of all agents and the dummy the upstream's start
                   of the sweep (a segment's first half of control points
                   at its start waypoint, the rest at its end): a C^2
                   path inside its boxes that stops at every waypoint.  A
                   plan the solve never moved reads 1, and so jumps,
                   boxes and planes cannot tell it from a solved one.

For the maps of the sample (``judge_map``) the benchmark also makes the
world and the mission itself and counts every voxel and every start or
goal value in which the program's differ (``inputs_differ``), works the
corridors out again from the program's initial paths (the upstream's box
growth and pair planes) and counts every segment box or pair plane that
differs (``corridor_differ``), reads the numbers above against its own
corridors, and

  jerk_ratio       J(plan) / J(reference plan), the reference plan the
                   same Jacobi sweep (one group of all agents: the joint
                   program) with each program solved to its optimum in
                   float64 by reference/qp's interior-point method.

The configurations stop the program's solver on its primal residuals and
hold the dual one only loosely (eps_dual_abs 0.5 and 1.5), so a plan is
a feasible point of its program well above its optimum; the ratios are
held below limits that the plans of a sound program stay under and a
plan that never left its dummy does not.  The maps the program did not
plan are counted by the caller (``maps_unplanned``).

A control (``control=``) puts the reference's own plan in the program's
place: reference/qp's interior-point sweep computed in a lower precision
(a dtype), or in float64 with the box rows (``"nobox"``) or the pair
planes (``"nopair"``) relaxed by RELAX metres, a plan that leaves its
corridor.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import corridor, qp, world

#: the numbers a run gives, in the order they are printed; a
#: configuration's ``limits`` name the ones compared with a limit (those
#: its control or a fault separates from the program), the rest are
#: printed beside them
NUMBERS = ("maps_unplanned", "inputs_differ", "corridor_differ",
           "pos_jump_m", "vel_jump_mps", "acc_jump_mps2", "jerk_vs_dummy",
           "box_viol_m", "pair_viol_m", "jerk_ratio")

#: metres by which the ``nobox`` and ``nopair`` controls relax their rows
RELAX = 1.0

#: the controls that relax a kind of row instead of lowering precision
RELAXED = ("nobox", "nopair")


def jumps(coef: np.ndarray, T: np.ndarray, start: np.ndarray,
          goal: np.ndarray, orders: int) -> list[float]:
    """The largest jump of each derivative order 0..orders-1 of the
    piecewise polynomials coef [N, M, n+1, 3] (descending powers in local
    time) at the knots of T and against the start and goal states."""
    npp = coef.shape[2]
    n = npp - 1
    dt = np.diff(np.asarray(T, np.float64))
    out = []
    for r in range(orders):
        # r-th derivative at local time 0 and at dt
        at0 = math.factorial(r) * coef[:, :, n - r, :]
        k = np.arange(n - r + 1)             # column j = k: power n - k
        w = np.array([math.perm(n - j, r) for j in k])
        powers = (n - r - k).astype(np.float64)
        at1 = np.einsum("j,mj,qmjk->qmk", w,
                        dt[:, None] ** powers[None, :], coef[:, :, k, :])
        gap = [np.abs(at1[:, :-1] - at0[:, 1:]).max(initial=0.0),
               np.abs(at0[:, 0] - start[:, 3 * r:3 * r + 3]).max(),
               np.abs(at1[:, -1] - goal[:, 3 * r:3 * r + 3]).max()]
        out.append(float(max(gap)))
    return out


def judge_plan(cfg: dict, got: dict) -> dict:
    """The numbers of one planned map read against the program's own
    corridors (every map of a window).  ``got``: as ``judge_map``'s, with
    a plan."""
    p = cfg["param"]
    m = world.mission(cfg["mission"])
    plan = got["plan"]
    out = dict.fromkeys(NUMBERS, 0.0)
    paths, T = np.asarray(plan["init_traj"]), np.asarray(plan["T"])
    out["corridor_differ"] = float(path_faults(paths, T, m, p))
    if paths.shape[:2] != (m.start.shape[0], len(T)):
        return out
    ctrl, coef = np.asarray(plan["ctrl"]), np.asarray(plan["coef"])
    if not _shaped(ctrl, coef, m, T, p["n"]):
        out["maps_unplanned"] = 1.0
        return out
    out.update(plan_numbers(cfg, m, paths, T, np.asarray(plan["seg_boxes"]),
                            np.asarray(plan["pair_idx"]),
                            np.asarray(plan["pair_normals"]), ctrl, coef))
    return out


def _shaped(ctrl, coef, m, T, n: int) -> bool:
    want = (m.start.shape[0], len(T) - 1, n + 1, 3)
    return ctrl.shape == want and coef.shape == want


def plan_numbers(cfg: dict, m, paths, T, boxes, pairs, normals, ctrl,
                 coef) -> dict:
    """Jumps, box and plane violations and jerk_vs_dummy of the plan
    ``ctrl`` [N, M, n+1, 3] (``coef`` its power coefficients) in the
    corridors ``boxes`` [N, M, 6], ``pairs`` [P, 2], ``normals``
    [P, M, 3]."""
    p = cfg["param"]
    n, phi = p["n"], p["phi"]
    out = {}
    (out["pos_jump_m"], out["vel_jump_mps"],
     out["acc_jump_mps2"]) = jumps(coef, T, m.start, m.goal, min(phi, 3))
    lo, hi = boxes[:, :, None, :3], boxes[:, :, None, 3:]
    out["box_viol_m"] = float(np.maximum(lo - ctrl, ctrl - hi)
                              .clip(min=0).max(initial=0.0))
    # only the pairs planned together: a pair across groups is held
    # against the other group's previous round, which the plan does not
    # carry
    size = p["batch_size"] if p["sequential"] else None
    grp = np.zeros(m.start.shape[0], int)
    for k, g in enumerate(qp.groups(m.start.shape[0], size)):
        grp[g] = k
    i, j = pairs[:, 0], pairs[:, 1]
    both = grp[i] == grp[j]
    if bool(both.any()):
        i, j, nrm = i[both], j[both], normals[both]
        sep = np.einsum("pmk,pmck->pmc", nrm, ctrl[j] - ctrl[i])
        need = (m.radius[i] + m.radius[j])[:, None, None]
        out["pair_viol_m"] = float((need - sep).clip(min=0).max())
    else:
        out["pair_viol_m"] = 0.0
    M = len(T) - 1
    out["jerk_vs_dummy"] = jerk(ctrl, T, n, phi) / jerk(
        qp.dummy_points(paths, n, M), T, n, phi)
    return out


def judge_map(cfg: dict, seed: int, got: dict, device,
              control: str | None = None) -> dict:
    """The numbers of one map of the sample.  ``got``: the program's world
    (occ), mission (start, goal, radius) and plan (init_traj, T,
    seg_boxes, pair_idx, pair_normals, ctrl, coef), or plan None.  With
    ``control`` (a dtype's name, or one of RELAXED) the reference's own
    sweep so computed takes the program's place (the control)."""
    p = cfg["param"]
    lo = [p["world_x_min"], p["world_y_min"], p["world_z_min"]]
    hi = [p["world_x_max"], p["world_y_max"], p["world_z_max"]]
    n, phi = p["n"], p["phi"]
    m = world.mission(cfg["mission"])
    grid = world.forest(m, lo, hi, p["world_resolution"], seed,
                        **cfg["forest"])
    out = dict.fromkeys(NUMBERS, 0.0)
    occ = np.asarray(got["occ"])
    out["inputs_differ"] = float(
        (occ != grid.occ).sum() if occ.shape == grid.occ.shape
        else occ.size + grid.occ.size)
    for key in ("start", "goal", "radius"):
        a, b = np.asarray(got[key]), getattr(m, key)
        out["inputs_differ"] += float((a != b).sum() if a.shape == b.shape
                                      else a.size + b.size)
    plan = got.get("plan")
    if plan is None or plan.get("ctrl") is None:
        out["maps_unplanned"] = 1.0
        return out
    paths, T = np.asarray(plan["init_traj"]), np.asarray(plan["T"])
    box_res = [p["box_xy_res"], p["box_xy_res"], p["box_z_res"]]
    out["corridor_differ"] = float(path_faults(paths, T, m, p))
    if paths.shape[:2] != (m.start.shape[0], len(T)):
        return out
    try:
        boxes = corridor.boxes(grid, paths, T, m.radius, box_res, lo, hi)
    except ValueError:
        # an initial path through an obstacle: no corridor exists
        out["corridor_differ"] += 1.0
        return out
    pairs, normals, _ = corridor.pair_planes(paths, p["downwash"])
    got_boxes = np.asarray(plan["seg_boxes"])
    got_n = np.asarray(plan["pair_normals"])
    got_p = np.asarray(plan["pair_idx"])
    if got_boxes.shape != boxes.shape or got_n.shape != normals.shape \
            or got_p.shape != pairs.shape:
        out["corridor_differ"] += float(boxes.size + normals.size)
        return out
    out["corridor_differ"] += float(
        (np.abs(boxes - got_boxes).max(-1) > 1e-9).sum()
        + (np.abs(normals - got_n).max(-1) > 1e-9).sum()
        + (got_p != pairs).sum())
    size = p["batch_size"] if p["sequential"] else None
    grps = qp.groups(m.start.shape[0], size)
    rounds = max(1, p["iteration"])
    best = sweep(boxes, pairs, normals, paths, T, m, grps, rounds, n, phi,
                 device, torch.float64)
    if control is None:
        ctrl, coef = np.asarray(plan["ctrl"]), np.asarray(plan["coef"])
    else:
        relax = control if control in RELAXED else None
        dtype = torch.float64 if relax else getattr(torch, control)
        ctrl = sweep(boxes, pairs, normals, paths, T, m, grps, rounds, n,
                     phi, device, dtype, relax=relax)
        coef = power_coefficients(ctrl, T, n)
    if not _shaped(ctrl, coef, m, T, n):
        out["maps_unplanned"] = 1.0
        return out
    out.update(plan_numbers(cfg, m, paths, T, boxes, pairs, normals, ctrl,
                            coef))
    out["jerk_ratio"] = jerk(ctrl, T, n, phi) / jerk(best, T, n, phi)
    return out


def path_faults(paths: np.ndarray, T: np.ndarray, m, p: dict) -> int:
    """The initial paths' breaks of what the search promises: each agent
    from its start to its goal, one knot a time step, a step at most one
    grid cell on each axis."""
    if paths.shape[:2] != (m.start.shape[0], len(T)):
        return paths.size
    res = np.array([p["grid_xy_res"], p["grid_xy_res"], p["grid_z_res"]])
    step = np.abs(np.diff(paths, axis=1))
    return int((np.abs(paths[:, 0] - m.start[:, :3]) > 1e-9).any(-1).sum()
               + (np.abs(paths[:, -1] - m.goal[:, :3]) > 1e-9).any(-1).sum()
               + (step > res + 1e-9).any(-1).sum()
               + (np.abs(np.diff(T) - p["time_step"]) > 1e-9).sum())


def jerk(ctrl: np.ndarray, T: np.ndarray, n: int, phi: int) -> float:
    """The integrated squared phi-th derivative of every agent's
    trajectory, control points [N, M, n+1, 3]."""
    dt = np.diff(np.asarray(T, np.float64))
    Q = qp.jerk_gram(n, phi)
    return float(np.einsum("qmik,ij,qmjk,m->", ctrl, Q, ctrl,
                           dt ** (1 - 2 * phi)))


def sweep(boxes, pairs, normals, paths, T, m, grps, rounds: int, n: int,
          phi: int, device, dtype, relax: str | None = None) -> np.ndarray:
    """The reference's plan [N, M, n+1, 3]: the Jacobi sweep of ``grps``
    over ``rounds`` rounds (one group of all agents: the joint program),
    each group's program solved in ``dtype``; ``relax`` "nobox" or
    "nopair" relaxes those rows by RELAX metres."""
    M = len(T) - 1
    dummy = qp.dummy_points(paths, n, M)
    for _ in range(rounds):
        solved = dummy.copy()
        for g in grps:
            pb = qp.build(T, boxes, pairs, normals, m.start, m.goal,
                          m.radius, g, dummy, n, phi, device)
            if relax == "nobox":
                pb.lb, pb.ub = pb.lb - RELAX, pb.ub + RELAX
            elif relax == "nopair":
                pb.rhs = pb.rhs - RELAX
            x, _ = qp.Solver(pb, T, n, phi, dtype=dtype).solve()
            solved[g] = x.reshape(len(g), 3, M, n + 1) \
                .permute(0, 2, 3, 1).cpu().numpy()
        dummy = solved
    return dummy


def power_coefficients(ctrl: np.ndarray, T: np.ndarray, n: int):
    """Control points [N, M, n+1, 3] -> descending power coefficients in
    local time (the upstream's conversion, rbp_planner.hpp:167-196)."""
    dt = np.diff(np.asarray(T, np.float64))
    B = qp.bernstein_power(n)
    scale = (1.0 / dt)[:, None] ** np.arange(n, -1, -1)[None, :]
    conv = B[None] * scale[:, None, :]                       # [M, i, j]
    return np.einsum("mij,qmik->qmjk", conv, ctrl)


def worst(rows: list[dict]) -> dict:
    """Each number's largest value over the maps."""
    return {k: max((r[k] for r in rows), default=0.0) for k in NUMBERS}
