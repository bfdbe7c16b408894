"""The inputs as the benchmark defines them: missions and seeded forests.

A frozen copy of the rules the program is held to (the upstream's
random_map_generator.cpp:56-113 geometry and its octomap voxelisation,
and the two mission geometries), in numpy, so that the benchmark makes
every map itself from the seed and compares the program's world and
mission with it voxel for voxel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class Mission:
    start: np.ndarray   # [N, 9] position, velocity, acceleration
    goal: np.ndarray    # [N, 9]
    radius: np.ndarray  # [N]


def perimeter_swap(n_agents: int, half: float, z: float,
                   radius: float) -> Mission:
    """Agents evenly spaced on a square's perimeter, each flying to its
    point reflection (missions/mission_64agents_15.json's geometry)."""
    if n_agents % 4:
        raise ValueError("n_agents must be divisible by 4")
    per_edge = n_agents // 4
    t = np.arange(per_edge) * (2 * half / per_edge)
    xy = np.concatenate([
        np.stack([np.full(per_edge, half), -half + t], axis=1),
        np.stack([half - t, np.full(per_edge, half)], axis=1),
        np.stack([np.full(per_edge, -half), half - t], axis=1),
        np.stack([-half + t, np.full(per_edge, -half)], axis=1),
    ])
    start = np.zeros((n_agents, 9))
    goal = np.zeros((n_agents, 9))
    start[:, 0:2], start[:, 2] = xy, z
    goal[:, 0:2], goal[:, 2] = -xy, z
    return Mission(start, goal, np.full(n_agents, float(radius)))


def antipodal_swap(n_agents: int, span: float, z: float,
                   radius: float) -> Mission:
    """Agents on a circle of radius ``span`` flying to their antipodes
    (missions/mission_8agents_*.json's geometry)."""
    ang = np.linspace(0.0, 2 * np.pi, n_agents, endpoint=False)
    start = np.zeros((n_agents, 9))
    start[:, 0], start[:, 1], start[:, 2] = (span * np.cos(ang),
                                             span * np.sin(ang), z)
    goal = np.zeros((n_agents, 9))
    goal[:, :3] = start[:, :3] * np.array([-1.0, -1.0, 1.0])
    return Mission(start, goal, np.full(n_agents, float(radius)))


MISSIONS = {"perimeter_swap": perimeter_swap,
            "antipodal_swap": antipodal_swap}


def mission(spec: dict) -> Mission:
    args = {k: v for k, v in spec.items() if k != "kind"}
    return MISSIONS[spec["kind"]](**args)


@dataclass
class Grid:
    """A dense occupancy grid: voxel i along an axis spans
    [(i0 + i) res, (i0 + i + 1) res) (octomap's keys)."""
    occ: np.ndarray  # [X, Y, Z] bool
    res: float
    i0: np.ndarray   # [3] int64

    @classmethod
    def empty(cls, lo, hi, res: float) -> "Grid":
        lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
        i0 = np.floor(lo / res + 1e-9).astype(np.int64)
        i1 = np.floor(hi / res + 1e-9).astype(np.int64)
        return cls(np.zeros(tuple(i1 - i0 + 1), dtype=bool), res, i0)

    def index(self, pts) -> np.ndarray:
        return (np.floor(np.asarray(pts, np.float64) / self.res)
                .astype(np.int64) - self.i0)


def forest(m: Mission, lo, hi, res: float, seed: int, obs_num: int,
           r_min: float, r_max: float, h_min: float, h_max: float,
           margin: float, max_tries: int = 100_000) -> Grid:
    """Square pillars snapped to the voxel lattice, each voxel column of a
    pillar its own height, a pillar rejected where its footprint circle
    comes within ``margin`` of a start or goal disc."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    grid = Grid.empty(lo, hi, res)
    starts, goals, radii = m.start[:, :2], m.goal[:, :2], m.radius
    pts, accepted, tries = [], 0, 0
    while accepted < obs_num and tries < max_tries:
        tries += 1
        x = rng.uniform(lo[0], hi[0])
        y = rng.uniform(lo[1], hi[1])
        w = rng.uniform(r_min, r_max)
        if (np.any(np.hypot(x - starts[:, 0], y - starts[:, 1])
                   < radii + w + margin)
                or np.any(np.hypot(x - goals[:, 0], y - goals[:, 1])
                          < radii + w + margin)):
            continue
        x = math.floor(x / res) * res + res / 2.0
        y = math.floor(y / res) * res + res / 2.0
        wid = math.ceil(w / res)
        r_lo = int(-wid / 2.0)
        for r in range(r_lo, wid + r_lo):
            for s in range(r_lo, wid + r_lo):
                hei = math.ceil(rng.uniform(h_min, h_max) / res)
                if hei <= 0:
                    continue
                col = np.empty((hei, 3))
                col[:, 0] = x + (r + 0.5) * res + 1e-5
                col[:, 1] = y + (s + 0.5) * res + 1e-5
                col[:, 2] = (np.arange(hei) + 0.5) * res + 1e-5
                pts.append(col)
        accepted += 1
    if accepted < obs_num:
        raise RuntimeError(f"placed {accepted} of {obs_num} obstacles")
    if pts:
        idx = grid.index(np.concatenate(pts))
        ok = np.all((idx >= 0) & (idx < np.array(grid.occ.shape)), axis=-1)
        idx = idx[ok]
        grid.occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    return grid
