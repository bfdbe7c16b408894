"""Seeded random-forest obstacle generator.

Reproduces the geometry rules of the reference's random_map_generator
(src/random_map_generator.cpp:56-113): square-footprint pillars of width w
snapped to the voxel grid, each voxel column with an independently sampled
height, rejected if their footprint circle overlaps any agent start/goal
disc inflated by ``margin``.  Unlike the reference (which seeds from
random_device, :37-38) generation is fully deterministic given ``seed``.
"""
from __future__ import annotations

import math

import numpy as np

from ..core.types import Mission
from .voxel import OccupancyGrid


def generate_forest(
    mission: Mission,
    *,
    world_min,
    world_max,
    resolution: float = 0.1,
    obs_num: int = 20,
    r_min: float = 0.3,
    r_max: float = 0.3,
    h_min: float = 0.0,
    h_max: float = 2.5,
    margin: float = 0.5,
    seed: int = 0,
    max_tries: int = 100_000,
) -> OccupancyGrid:
    rng = np.random.default_rng(seed)
    world_min = np.asarray(world_min, dtype=np.float64)
    world_max = np.asarray(world_max, dtype=np.float64)
    grid = OccupancyGrid.empty(world_min, world_max, resolution)

    starts = mission.start[:, :2]
    goals = mission.goal[:, :2]
    radii = mission.radius

    pts: list[np.ndarray] = []
    accepted = 0
    tries = 0
    while accepted < obs_num and tries < max_tries:
        tries += 1
        x = rng.uniform(world_min[0], world_max[0])
        y = rng.uniform(world_min[1], world_max[1])
        w = rng.uniform(r_min, r_max)

        d_start = np.hypot(x - starts[:, 0], y - starts[:, 1])
        d_goal = np.hypot(x - goals[:, 0], y - goals[:, 1])
        if np.any(d_start < radii + w + margin) or np.any(d_goal < radii + w + margin):
            continue

        # snap footprint center to the voxel lattice (+res/2 voxel center)
        x = math.floor(x / resolution) * resolution + resolution / 2.0
        y = math.floor(y / resolution) * resolution + resolution / 2.0
        wid = math.ceil(w / resolution)
        r_lo = int(-wid / 2.0)  # C++ double->int truncation toward zero
        for r in range(r_lo, wid + r_lo):
            for s in range(r_lo, wid + r_lo):
                h = rng.uniform(h_min, h_max)  # per-column height (cpp :92)
                hei = math.ceil(h / resolution)
                if hei <= 0:
                    continue
                t = np.arange(hei)
                col = np.empty((hei, 3))
                col[:, 0] = x + (r + 0.5) * resolution + 1e-5
                col[:, 1] = y + (s + 0.5) * resolution + 1e-5
                col[:, 2] = (t + 0.5) * resolution + 1e-5
                pts.append(col)
        accepted += 1

    if accepted < obs_num:
        raise RuntimeError(
            f"forest generation placed only {accepted}/{obs_num} obstacles")
    if pts:
        grid.mark_points(np.concatenate(pts, axis=0))
    return grid
