"""Mission JSON loader — same schema as the reference (mission.hpp:22-88).

Schema:
  {"quadrotors": {"<name>": {"max_vel": [..], "max_acc": [..], ...}, ...},
   "agents": [{"name": ..., "start": [...], "goal": [...],
               "radius": r, "speed": s}, ...]}

start/goal may have 3..9 entries (pos, vel, acc); missing entries are zero.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..core.types import Mission


def load_mission(path: str | Path) -> Mission:
    with open(path) as f:
        doc = json.load(f)
    return mission_from_dict(doc)


def mission_from_dict(doc: dict) -> Mission:
    agents = doc["agents"]
    quadrotors = doc.get("quadrotors", {})
    qn = len(agents)

    start = np.zeros((qn, 9), dtype=np.float64)
    goal = np.zeros((qn, 9), dtype=np.float64)
    radius = np.zeros(qn, dtype=np.float64)
    speed = np.zeros(qn, dtype=np.float64)
    max_vel = np.zeros((qn, 3), dtype=np.float64)
    max_acc = np.zeros((qn, 3), dtype=np.float64)
    names = []

    for qi, agent in enumerate(agents):
        name = agent["name"]
        names.append(name)
        s = np.asarray(agent["start"], dtype=np.float64)
        g = np.asarray(agent["goal"], dtype=np.float64)
        start[qi, : len(s)] = s
        goal[qi, : len(g)] = g
        radius[qi] = agent["radius"]
        speed[qi] = agent["speed"]
        quad = quadrotors[name]
        mv = np.asarray(quad["max_vel"], dtype=np.float64)
        ma = np.asarray(quad["max_acc"], dtype=np.float64)
        max_vel[qi, : len(mv)] = mv
        max_acc[qi, : len(ma)] = ma

    return Mission(start=start, goal=goal, radius=radius, speed=speed,
                   max_vel=max_vel, max_acc=max_acc, names=names)


def perimeter_swap_mission(n_agents: int = 64, *, half: float = 4.0,
                           z: float = 1.0, radius: float = 0.15,
                           speed: float = 1.0, max_vel: float = 1.7,
                           max_acc: float = 6.2) -> Mission:
    """Agents evenly spaced on a square perimeter, goals point-reflected —
    the canonical demo geometry (missions/mission_64agents_15.json)."""
    if n_agents % 4 != 0:
        raise ValueError("n_agents must be divisible by 4")
    per_edge = n_agents // 4
    step = 2 * half / per_edge
    t = np.arange(per_edge) * step  # half-open edge walk: no corner dups
    xy = np.concatenate([
        np.stack([np.full(per_edge, half), -half + t], axis=1),   # right, up
        np.stack([half - t, np.full(per_edge, half)], axis=1),    # top, left
        np.stack([np.full(per_edge, -half), half - t], axis=1),   # left, down
        np.stack([-half + t, np.full(per_edge, -half)], axis=1),  # bottom
    ])
    start = np.zeros((n_agents, 9))
    goal = np.zeros((n_agents, 9))
    start[:, 0:2] = xy
    start[:, 2] = z
    goal[:, 0:2] = -xy
    goal[:, 2] = z
    return Mission(
        start=start, goal=goal,
        radius=np.full(n_agents, radius), speed=np.full(n_agents, speed),
        max_vel=np.full((n_agents, 3), max_vel),
        max_acc=np.full((n_agents, 3), max_acc),
        names=["default"] * n_agents,
    )


def swap_mission(n_agents: int = 2, *, z: float = 0.5, span: float = 1.0,
                 radius: float = 0.25, speed: float = 1.0,
                 max_vel: float = 1.7, max_acc: float = 6.2) -> Mission:
    """Synthetic antipodal-swap mission (like missions/mission_2agents_25.json):
    agents on a circle of radius ``span`` swap with their antipodes."""
    angles = np.linspace(0.0, 2 * np.pi, n_agents, endpoint=False)
    start = np.zeros((n_agents, 9))
    goal = np.zeros((n_agents, 9))
    start[:, 0] = span * np.cos(angles)
    start[:, 1] = span * np.sin(angles)
    start[:, 2] = z
    goal[:, :3] = start[:, :3] * np.array([-1.0, -1.0, 1.0])
    return Mission(
        start=start, goal=goal,
        radius=np.full(n_agents, radius), speed=np.full(n_agents, speed),
        max_vel=np.full((n_agents, 3), max_vel),
        max_acc=np.full((n_agents, 3), max_acc),
        names=["default"] * n_agents,
    )


def scatter_mission(n_agents: int, *, half: float = 9.5, z: float = 1.0,
                    min_sep: float = 0.9, radius: float = 0.15,
                    speed: float = 1.0, max_vel: float = 1.7,
                    max_acc: float = 6.2, seed: int = 0) -> Mission:
    """Seeded random start/goal scatter at constant altitude — the
    large-swarm workload (conflicts are spatially sparse, unlike the
    all-through-center perimeter swap, so search stays tractable at
    hundreds of agents).  min_sep > grid diagonal/2 keeps snapped cells
    distinct."""
    rng = np.random.default_rng(seed)

    def scatter() -> np.ndarray:
        pts: list[np.ndarray] = []
        while len(pts) < n_agents:
            p = rng.uniform(-half, half, size=2)
            if not pts or np.min(
                    np.linalg.norm(np.asarray(pts) - p, axis=1)) >= min_sep:
                pts.append(p)
        return np.asarray(pts)

    start = np.zeros((n_agents, 9))
    goal = np.zeros((n_agents, 9))
    start[:, :2] = scatter()
    goal[:, :2] = scatter()
    start[:, 2] = goal[:, 2] = z
    return Mission(
        start=start, goal=goal,
        radius=np.full(n_agents, radius), speed=np.full(n_agents, speed),
        max_vel=np.full((n_agents, 3), max_vel),
        max_acc=np.full((n_agents, 3), max_acc),
        names=["default"] * n_agents,
    )
