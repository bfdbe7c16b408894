"""Flat-corridor variant (the swarm_traj_planner_rbp_flat entry point).

Mirrors Corridor::update_flat_box (rbp_corridor.hpp:28-33, 400-772):
  * SFC boxes initialize from raw segment endpoints +/- half a box
    resolution (updateFlatObsBox :427-432) instead of snapping;
  * RSFC uses axis-aligned sector planes: per pair, the signed grid
    displacement picks among 6 half-space sectors (+/-x, +/-y, +/-z), and
    a backward greedy min-jump search chooses one sector per interval
    (updateFlatRelBox :496-623); normals come from sec2normVec (:625-648);
  * knot times T are rebuilt from the corridor-change breakpoints
    (updateTs :650-772) — non-uniform segments.

Index/time bookkeeping follows the reference's time_step == 1 semantics
(the reference appends grid *indices* onto the times vector, which only
coincide with times when time_step == 1; we divide the incoming uniform T
by time_step so the behavior is consistent for any time_step).

A copy of swarm_simulator_tpu/corridor/flat.py (host code),
so that the PyTorch port never imports the JAX package.
"""
from __future__ import annotations

import math

import numpy as np

from ..core.types import Mission, Param, PlanResult
from ..world.esdf import ESDF
from .sfc import EPS_F, _point_in_box, expand_box, is_obstacle_in_box

SECTOR_RANGE = (-3, -2, -1, 1, 2, 3)


def sec2norm_vec(sector: int, downwash: float) -> np.ndarray:
    n = np.zeros(3)
    sgn = (sector > 0) - (sector < 0)
    axis = abs(sector) - 1
    n[axis] = sgn / downwash if axis == 2 else sgn
    return n


def flat_obs_boxes(esdf: ESDF, plan: PlanResult, radius: np.ndarray,
                   param: Param, breakpoints: set) -> list:
    """updateFlatObsBox: SFC with half-res-inflated seed boxes; collects
    knot breakpoints (as path indices) into ``breakpoints``."""
    N, L, _ = plan.init_traj.shape
    makespan_idx = len(plan.T) - 1
    sfc_all = []
    for qi in range(N):
        traj = plan.init_traj[qi]
        boxes: list[list] = []
        box_prev = [0.0] * 6
        for s in range(L - 1):
            p0, p1 = traj[s], traj[s + 1]
            if _point_in_box(p1, box_prev):
                continue
            hx, hz = param.box_xy_res / 2.0, param.box_z_res / 2.0
            box = [min(p0[0], p1[0]) - hx, min(p0[1], p1[1]) - hx,
                   min(p0[2], p1[2]) - hz, max(p0[0], p1[0]) + hx,
                   max(p0[1], p1[1]) + hx, max(p0[2], p1[2]) + hz]
            if is_obstacle_in_box(esdf, box, float(radius[qi]), param):
                raise ValueError(
                    f"agent {qi}: obstacle invades initial trajectory")
            box = expand_box(esdf, box, float(radius[qi]), param)
            boxes.append(box)
            box_prev = box

        # time windows (updateFlatObsBox :446-488): break at box_max-1
        box_max = len(boxes)
        box_log = np.zeros((box_max, L), dtype=np.int64)
        for bi in range(box_max):
            for j in range(L):
                if _point_in_box(traj[j], boxes[bi]):
                    box_log[bi, j] = 1 if j == 0 else box_log[bi, j - 1] + 1

        end_times = [-1.0] * box_max
        box_iter = 0
        path_iter = 0
        while path_iter < L:
            if box_iter >= box_max - 1:
                break
            if box_log[box_iter, path_iter] > 0 and \
                    box_log[box_iter + 1, path_iter] > 0:
                count = 1
                while (path_iter + count < L
                       and box_log[box_iter, path_iter + count] > 0
                       and box_log[box_iter + 1, path_iter + count] > 0):
                    count += 1
                obs_index = path_iter + count // 2
                end_times[box_iter] = obs_index * param.time_step
                breakpoints.add(float(obs_index))
                path_iter += count // 2
                box_iter += 1
            path_iter += 1
        end_times[box_max - 1] = makespan_idx * param.time_step
        sfc_all.append([(boxes[bi], end_times[bi]) for bi in range(box_max)])
    return sfc_all


def flat_rel_boxes(plan: PlanResult, mission: Mission, param: Param,
                   breakpoints: set) -> dict:
    """updateFlatRelBox: sector planes + backward greedy min-jump path."""
    N, L, _ = plan.init_traj.shape
    makespan_idx = len(plan.T) - 1
    rsfc: dict = {}
    for qi in range(N):
        for qj in range(qi + 1, N):
            ti, tj = plan.init_traj[qi], plan.init_traj[qj]
            path_max = L
            sector_log = np.zeros((6, path_max), dtype=np.int64)
            for it in range(path_max):
                d = np.round((tj[it] - ti[it]) /
                             np.array([param.grid_xy_res, param.grid_xy_res,
                                       param.grid_z_res]))
                rel = [0,
                       int(d[0] > EPS_F) - int(d[0] < -EPS_F),
                       int(d[1] > EPS_F) - int(d[1] < -EPS_F),
                       int(d[2] > EPS_F) - int(d[2] < -EPS_F)]
                for i, sector in enumerate(SECTOR_RANGE):
                    sgn = 1 if i > 2 else -1
                    if rel[abs(sector)] * sgn > 0:
                        sector_log[i, it] = (1 if it == 0
                                             else sector_log[i, it - 1] + 1)

            entries = []
            it = path_max - 1
            sector_next = int(np.argmax(sector_log[:, it]))
            count_next = int(sector_log[:, it].max())
            entries.append((sec2norm_vec(SECTOR_RANGE[sector_next],
                                         param.downwash),
                            makespan_idx * param.time_step))
            it = it - count_next + 1

            while it > 1:
                col_max = int(sector_log[:, it].max())
                sector_curr = int(np.argmax(sector_log[:, it]))
                if col_max <= 1:
                    # allow a sector jump, but not through the quadrotor
                    it -= 1
                    sector_opp = 6 - 1 - sector_next
                    col_max2 = int(sector_log[:, it].max())
                    sector_curr = int(np.argmax(sector_log[:, it]))
                    if col_max2 <= 0:
                        raise ValueError(
                            f"pair ({qi},{qj}): invalid initial trajectory, "
                            "missing sector link")
                    if sector_curr == sector_opp:
                        if not any(i != sector_opp and
                                   sector_log[i, it] == col_max2
                                   for i in range(6)):
                            raise ValueError(
                                f"pair ({qi},{qj}): invalid path, jumping "
                                "through quadrotor")
                    count = 0
                else:
                    count = 1
                    while (it + count < path_max and
                           sector_log[sector_curr, it + count] > 0):
                        count += 1

                if count == 0:
                    rel_index = it + 0.5
                else:
                    rel_index = math.floor(it + count / 2.0)

                entries.insert(0, (sec2norm_vec(SECTOR_RANGE[sector_curr],
                                                param.downwash),
                                   rel_index * param.time_step))
                breakpoints.add(float(rel_index))
                sector_next = sector_curr
                it = it - int(sector_log[:, it].max()) + 1

            rsfc[(qi, qj)] = entries
    return rsfc


def pair_normals_from_rsfc(rsfc: dict, pair_idx: np.ndarray,
                           T: np.ndarray) -> np.ndarray:
    """[P, M, 3] active plane per segment (build_dlq lookup :485-489)."""
    M = len(T) - 1
    out = np.zeros((len(pair_idx), M, 3))
    for p, (qi, qj) in enumerate(pair_idx):
        entries = rsfc[(int(qi), int(qj))]
        ri = 0
        for m in range(M):
            while ri < len(entries) and entries[ri][1] < T[m + 1]:
                ri += 1
            out[p, m] = entries[min(ri, len(entries) - 1)][0]
    return out


def build_flat_corridors(esdf: ESDF, plan: PlanResult, mission: Mission,
                         param: Param) -> PlanResult:
    """Full update_flat_box: SFC + sector RSFC + rebuilt knot vector."""
    from .times import seg_boxes_from_sfc

    makespan_idx = len(plan.T) - 1
    breakpoints: set = set()
    plan.sfc = flat_obs_boxes(esdf, plan, mission.radius, param, breakpoints)
    plan.rsfc = flat_rel_boxes(plan, mission, param, breakpoints)

    # updateTs (:650-772): uniform indices + corridor breakpoints
    knots = set(float(i) for i in range(makespan_idx + 1))
    knots |= breakpoints
    knots |= {0.0, float(makespan_idx)}
    T = np.array(sorted(knots)) * param.time_step
    plan.T = T

    N = mission.qn
    iu, ju = np.triu_indices(N, k=1)
    plan.pair_idx = np.stack([iu, ju], axis=1).astype(np.int32)
    plan.seg_boxes = seg_boxes_from_sfc(plan.sfc, T)
    plan.pair_normals = pair_normals_from_rsfc(plan.rsfc, plan.pair_idx, T)
    return plan
