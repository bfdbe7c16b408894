"""Safe flight corridors: axis-aligned obstacle-free boxes along each path.

Host-side reference implementation of Corridor::updateObsBox
(rbp_corridor.hpp:149-243): per initial-trajectory segment, initialize an
AABB from the snapped endpoints, then greedily expand it in round-robin
axis order by one box-resolution step at a time, re-checking only the
newly-added slab against the ESDF, until every face hits an obstacle or the
world boundary (expand_box, rbp_corridor.hpp:99-147).  Box end-times come
from overlap windows of consecutive boxes along the path (:195-237).

A C++ twin lives in search/native (used for production sizes); both are
cross-checked in tests.
"""
from __future__ import annotations

import math

import numpy as np

from ..core.types import Param, PlanResult
from ..world.esdf import ESDF

EPS = 1e-9  # SP_EPSILON
EPS_F = 1e-6  # SP_EPSILON_FLOAT


def _sample_coords(lo: float, hi: float, res: float, world_lo: float) -> np.ndarray:
    """Sample positions lo, lo+res, ... <= hi+EPS_F, shifted +EPS_F; the first
    sample is shifted to lo-EPS_F when the box does not touch the world
    boundary (isObstacleInBox, rbp_corridor.hpp:47-63)."""
    count = int(math.floor((hi + EPS_F - lo) / res)) + 1
    xs = lo + np.arange(count) * res + EPS_F
    if lo > world_lo + EPS_F:
        xs[0] = lo - EPS_F
    return xs


def is_obstacle_in_box(esdf: ESDF, box, margin: float, param: Param) -> bool:
    xs = _sample_coords(box[0], box[3], param.box_xy_res, param.world_x_min)
    ys = _sample_coords(box[1], box[4], param.box_xy_res, param.world_y_min)
    zs = _sample_coords(box[2], box[5], param.box_z_res, param.world_z_min)
    pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1).reshape(-1, 3)
    dist = esdf.query(pts)
    return bool(np.any(dist < margin - EPS_F))


def _in_boundary(box, param: Param) -> bool:
    return (box[0] > param.world_x_min - EPS and box[1] > param.world_y_min - EPS
            and box[2] > param.world_z_min - EPS and box[3] < param.world_x_max + EPS
            and box[4] < param.world_y_max + EPS and box[5] < param.world_z_max + EPS)


def _point_in_box(p, box) -> bool:
    return (p[0] > box[0] - EPS and p[1] > box[1] - EPS and p[2] > box[2] - EPS
            and p[0] < box[3] + EPS and p[1] < box[4] + EPS and p[2] < box[5] + EPS)


def expand_box(esdf: ESDF, box: list, margin: float, param: Param) -> list:
    """Greedy round-robin axis expansion (rbp_corridor.hpp:99-147).

    Axis indices 0..2 shrink the min faces, 3..5 grow the max faces; a
    candidate slab that hits an obstacle or the boundary retires its axis.
    """
    axis_cand = [0, 1, 2, 3, 4, 5]
    i = -1
    while axis_cand:
        box_cand = list(box)
        box_update = list(box)
        while (not is_obstacle_in_box(esdf, box_update, margin, param)
               and _in_boundary(box_update, param)):
            i += 1
            if i >= len(axis_cand):
                i = 0
            axis = axis_cand[i]
            box = list(box_cand)
            box_update = list(box_cand)
            if axis < 3:
                box_update[axis + 3] = box_cand[axis]
                res = param.box_z_res if axis == 2 else param.box_xy_res
                box_cand[axis] -= res
                box_update[axis] = box_cand[axis]
            else:
                box_update[axis - 3] = box_cand[axis]
                res = param.box_z_res if axis == 5 else param.box_xy_res
                box_cand[axis] += res
                box_update[axis] = box_cand[axis]
        del axis_cand[i]
        if i > 0:
            i -= 1
        else:
            i = len(axis_cand) - 1
    return box


def _agent_boxes_python(esdf: ESDF, traj: np.ndarray, radius: float,
                        param: Param) -> list[list]:
    L = len(traj)
    boxes: list[list] = []
    box_prev = [0.0] * 6
    for s in range(L - 1):
        p0, p1 = traj[s], traj[s + 1]
        if _point_in_box(p1, box_prev):
            continue
        rxy, rz = param.box_xy_res, param.box_z_res
        box = [
            round(min(p0[0], p1[0]) / rxy) * rxy,
            round(min(p0[1], p1[1]) / rxy) * rxy,
            round(min(p0[2], p1[2]) / rz) * rz,
            round(max(p0[0], p1[0]) / rxy) * rxy,
            round(max(p0[1], p1[1]) / rxy) * rxy,
            round(max(p0[2], p1[2]) / rz) * rz,
        ]
        if is_obstacle_in_box(esdf, box, radius, param):
            raise ValueError(
                f"obstacle invades initial trajectory at segment {s}")
        box = expand_box(esdf, box, radius, param)
        boxes.append(box)
        box_prev = box
    return boxes


def _agent_boxes_native(esdf: ESDF, traj: np.ndarray, radius: float,
                        param: Param) -> list[list]:
    from ..search.native_binding import sfc_expand_native

    boxes = sfc_expand_native(
        esdf.dist, esdf.grid.res, esdf.grid.i0, param.world_min,
        param.world_max, param.box_xy_res, param.box_z_res,
        np.ascontiguousarray(traj), radius)
    return [list(b) for b in boxes]


def update_obs_boxes(esdf: ESDF, plan: PlanResult, radius: np.ndarray,
                     param: Param,
                     backend: str = "auto") -> list[list[tuple[list, float]]]:
    """Per-agent SFC: list of (box[6], end_time) (updateObsBox)."""
    N, L, _ = plan.init_traj.shape
    makespan = float(plan.T[-1])

    expand = _agent_boxes_python
    if backend in ("auto", "native"):
        try:
            from ..search.native_binding import build_native
            build_native()
            expand = _agent_boxes_native
        except Exception:
            if backend == "native":
                raise

    def agent_sfc(qi):
        traj = plan.init_traj[qi]
        try:
            boxes = expand(esdf, traj, float(radius[qi]), param)
        except ValueError as e:
            raise ValueError(f"agent {qi}: {e}") from e

        # --- box time windows (rbp_corridor.hpp:195-237) ---
        box_max = len(boxes)
        path_max = L
        box_log = np.zeros((box_max, path_max), dtype=np.int64)
        for bi in range(box_max):
            for j in range(path_max):
                if _point_in_box(traj[j], boxes[bi]):
                    box_log[bi, j] = 1 if j == 0 else box_log[bi, j - 1] + 1

        end_times = [-1.0] * box_max
        box_iter = 0
        path_iter = 0
        while path_iter < path_max:
            if box_iter == box_max - 1:
                if box_log[box_iter, path_iter] > 0:
                    path_iter += 1
                    continue
                else:
                    box_iter -= 1
            if box_log[box_iter, path_iter] > 0 and box_log[box_iter + 1, path_iter] > 0:
                count = 1
                while (path_iter + count < path_max
                       and box_log[box_iter, path_iter + count] > 0
                       and box_log[box_iter + 1, path_iter + count] > 0):
                    count += 1
                obs_index = path_iter + count // 2
                end_times[box_iter] = float(plan.T[obs_index])
                path_iter = path_iter + count // 2
                box_iter += 1
            elif box_log[box_iter, path_iter] == 0:
                box_iter -= 1
                path_iter -= 1
            path_iter += 1
        end_times[box_max - 1] = makespan
        return [(boxes[bi], end_times[bi]) for bi in range(box_max)]

    # agents are independent and the NATIVE greedy expansion releases
    # the GIL — thread across agents (order kept).  The pure-Python
    # fallback holds the GIL, so threading it would only add contention.
    if expand is _agent_boxes_native:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=4) as ex:
            return list(ex.map(agent_sfc, range(N)))
    return [agent_sfc(qi) for qi in range(N)]
