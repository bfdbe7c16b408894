"""Initial-trajectory planner: grid construction + ECBS adapter.

Mirrors ECBSPlanner (include/ecbs_planner.hpp): the obstacle set is built by
thresholding the ESDF at max_radius + grid_margin over the snapped grid
(:80-109), starts/goals snap to the nearest grid point (:112-136), and the
discrete solution is padded to uniform length makespan+3 with the exact
start prepended and the exact goal appended (:49-70), with uniform knot
times T[i] = i * time_step (:41-43).
"""
from __future__ import annotations

import numpy as np

from ..core.types import GridSpec, Mission, Param, PlanResult
from ..world.esdf import ESDF
from . import ecbs


def build_obstacle_set(esdf: ESDF, grid: GridSpec, mission: Mission,
                       param: Param) -> set[tuple[int, int, int]]:
    r = float(np.max(mission.radius))
    xs = grid.x_min + np.arange(grid.dimx) * grid.xy_res
    ys = grid.y_min + np.arange(grid.dimy) * grid.xy_res
    zs = grid.z_min + np.arange(grid.dimz) * grid.z_res
    pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1).reshape(-1, 3)
    dist = esdf.query(pts)
    if np.any(dist < 0):
        raise ValueError("grid point outside the distance map")
    blocked = dist < r + param.grid_margin
    idx = np.argwhere(blocked.reshape(grid.dimx, grid.dimy, grid.dimz))
    return {tuple(map(int, i)) for i in idx}


def plan_initial_trajectories(
    esdf: ESDF,
    mission: Mission,
    param: Param,
    *,
    backend: str = "auto",
) -> PlanResult:
    """Run ECBS and fill PlanResult.init_traj / .T."""
    grid = GridSpec.from_param(param)
    obstacles = build_obstacle_set(esdf, grid, mission, param)

    starts = grid.world_to_grid(mission.start[:, :3])
    goals = grid.world_to_grid(mission.goal[:, :3])
    for qi in range(mission.qn):
        if tuple(map(int, starts[qi])) in obstacles:
            raise ValueError(f"start of agent {qi} is occluded by obstacle")
        if tuple(map(int, goals[qi])) in obstacles:
            raise ValueError(f"goal of agent {qi} is occluded by obstacle")

    paths = _search(grid, obstacles, starts, goals, mission, param, backend)
    if paths is None:
        raise RuntimeError("ECBS failed to find a solution")

    makespan = max(len(p) - 1 for p in paths)
    M = makespan + 2
    T = np.arange(M + 1, dtype=np.float64) * param.time_step

    N = mission.qn
    init_traj = np.zeros((N, M + 1, 3), dtype=np.float64)
    for qi, path in enumerate(paths):
        pts = [mission.start[qi, :3]]
        for s in path:
            pts.append(grid.grid_to_world(np.array(s[1:], dtype=np.float64)))
        while len(pts) <= makespan + 2:
            pts.append(mission.goal[qi, :3])
        init_traj[qi] = np.stack(pts)

    return PlanResult(init_traj=init_traj, T=T)


def _search(grid: GridSpec, obstacles, starts, goals, mission: Mission,
            param: Param, backend: str):
    start_cells = [tuple(map(int, s)) for s in starts]
    goal_cells = [tuple(map(int, g)) for g in goals]
    if backend in ("auto", "native"):
        try:
            from .native_binding import ecbs_search_native
            return ecbs_search_native(
                dims=(grid.dimx, grid.dimy, grid.dimz), obstacles=obstacles,
                starts=start_cells, goals=goal_cells,
                quad_size=mission.radius, grid_size=param.grid_xy_res,
                w=param.ecbs_w)
        except (ImportError, OSError):
            if backend == "native":
                raise
    env = ecbs.Environment(
        dims=(grid.dimx, grid.dimy, grid.dimz), obstacles=obstacles,
        goals=goal_cells, quad_size=list(mission.radius),
        grid_size=param.grid_xy_res)
    return ecbs.ecbs_search(env, start_cells, w=param.ecbs_w)
