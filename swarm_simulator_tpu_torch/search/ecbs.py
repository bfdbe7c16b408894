"""Enhanced Conflict-Based Search (ECBS) — host-side discrete MAPF.

Clean-room implementation of bounded-suboptimal ECBS (Barer et al. 2014)
with the reference's extensions (third_party/ecbs/include/environment.hpp):

  * 3-D grid, 6-connected moves + wait, unit costs, time-expanded states
  * continuous-radius conflict checks: two agents conflict when their
    Euclidean separation (in grid units, scaled by the grid resolution) is
    below the sum of their radii — not merely when they share a cell
    (environment.hpp:656-681)
  * low level: focal A* (A*-epsilon) ordered by path conflict counts
  * high level: focal search over constraint-tree nodes within w * best cost

This pure-Python version is the correctness reference; a C++ twin lives in
``search/native`` for production-size problems.  Both are exercised against
each other in tests.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Optional

State = tuple[int, int, int, int]  # (t, x, y, z)
Cell = tuple[int, int, int]

_MOVES = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, 1, 0), (0, -1, 0),
          (0, 0, 1), (0, 0, -1))


def _seg_min_dist_to_origin(ax, ay, az, bx, by, bz) -> float:
    """Minimum distance from the segment a->b to the origin.

    Mirrors Vector::min_dist_to_origin (environment.hpp:69-93): endpoint
    distances always count; the perpendicular foot only when strictly
    interior.
    """
    da = math.sqrt(ax * ax + ay * ay + az * az)
    if (ax, ay, az) == (bx, by, bz):
        return da
    db = math.sqrt(bx * bx + by * by + bz * bz)
    dmin = min(da, db)
    nx, ny, nz = bx - ax, by - ay, bz - az
    nn = math.sqrt(nx * nx + ny * ny + nz * nz)
    nx, ny, nz = nx / nn, ny / nn, nz / nn
    adn = ax * nx + ay * ny + az * nz
    cx, cy, cz = ax - adn * nx, ay - adn * ny, az - adn * nz
    dc = math.sqrt(cx * cx + cy * cy + cz * cz)
    if ((cx - ax) * (cx - bx) + (cy - ay) * (cy - by) + (cz - az) * (cz - bz)) < 0 \
            and dmin > dc:
        dmin = dc
    return dmin


@dataclass
class Conflict:
    time: int
    agent1: int
    agent2: int
    kind: str  # "vertex" | "edge"
    s1: State
    s2: State
    s1b: Optional[State] = None
    s2b: Optional[State] = None


@dataclass
class Constraints:
    vertex: frozenset = frozenset()  # of (t, x, y, z)
    edge: frozenset = frozenset()  # of (t, x1, y1, z1, x2, y2, z2)

    def add_vertex(self, vc) -> "Constraints":
        return Constraints(self.vertex | {vc}, self.edge)

    def add_edge(self, ec) -> "Constraints":
        return Constraints(self.vertex, self.edge | {ec})


class Environment:
    """Shared MAPF environment (environment.hpp Environment class)."""

    def __init__(self, dims: tuple[int, int, int], obstacles: set[Cell],
                 goals: list[Cell], quad_size: list[float], grid_size: float):
        self.dims = dims
        self.obstacles = obstacles
        self.goals = goals
        self.quad_size = list(quad_size)
        self.grid_size = float(grid_size)

    # ---- conflicts ----------------------------------------------------
    def vertex_conflict(self, i: int, j: int, s1: State, s2: State) -> bool:
        rsum = self.quad_size[i] + self.quad_size[j]
        if rsum < self.grid_size:
            return s1[1:] == s2[1:]
        dx, dy, dz = s2[1] - s1[1], s2[2] - s1[2], s2[3] - s1[3]
        return math.sqrt(dx * dx + dy * dy + dz * dz) * self.grid_size < rsum

    def edge_conflict(self, i: int, j: int, s1a: State, s1b: State,
                      s2a: State, s2b: State) -> bool:
        rsum = self.quad_size[i] + self.quad_size[j]
        if rsum < self.grid_size * 0.5:
            return s1a[1:] == s2b[1:] and s1b[1:] == s2a[1:]
        d = _seg_min_dist_to_origin(
            s2a[1] - s1a[1], s2a[2] - s1a[2], s2a[3] - s1a[3],
            s2b[1] - s1b[1], s2b[2] - s1b[2], s2b[3] - s1b[3])
        return d * self.grid_size <= rsum

    @staticmethod
    def _state_at(path: list[State], t: int) -> State:
        return path[t] if t < len(path) else path[-1]

    def first_conflict(self, solution: list[list[State]]) -> Optional[Conflict]:
        max_t = max(len(p) - 1 for p in solution)
        n = len(solution)
        for t in range(max_t):
            for i in range(n):
                s1 = self._state_at(solution[i], t)
                for j in range(i + 1, n):
                    s2 = self._state_at(solution[j], t)
                    if self.vertex_conflict(i, j, s1, s2):
                        return Conflict(t, i, j, "vertex", s1, s2)
            for i in range(n):
                s1a = self._state_at(solution[i], t)
                s1b = self._state_at(solution[i], t + 1)
                for j in range(i + 1, n):
                    s2a = self._state_at(solution[j], t)
                    s2b = self._state_at(solution[j], t + 1)
                    if self.edge_conflict(i, j, s1a, s1b, s2a, s2b):
                        return Conflict(t, i, j, "edge", s1a, s2a, s1b, s2b)
        return None

    def count_conflicts(self, solution: list[list[State]]) -> int:
        """Total conflict count — the high-level focal heuristic."""
        max_t = max(len(p) - 1 for p in solution)
        n = len(solution)
        count = 0
        for t in range(max_t):
            for i in range(n):
                s1 = self._state_at(solution[i], t)
                for j in range(i + 1, n):
                    s2 = self._state_at(solution[j], t)
                    if self.vertex_conflict(i, j, s1, s2):
                        count += 1
            for i in range(n):
                s1a = self._state_at(solution[i], t)
                s1b = self._state_at(solution[i], t + 1)
                for j in range(i + 1, n):
                    s2a = self._state_at(solution[j], t)
                    s2b = self._state_at(solution[j], t + 1)
                    if self.edge_conflict(i, j, s1a, s1b, s2a, s2b):
                        count += 1
        return count

    def constraints_from_conflict(self, c: Conflict) -> dict[int, tuple]:
        """agent -> ("vertex"|"edge", constraint tuple) for both branches."""
        if c.kind == "vertex":
            return {
                c.agent1: ("vertex", (c.time, *c.s1[1:])),
                c.agent2: ("vertex", (c.time, *c.s2[1:])),
            }
        return {
            c.agent1: ("edge", (c.time, *c.s1[1:], *c.s1b[1:])),
            c.agent2: ("edge", (c.time, *c.s2[1:], *c.s2b[1:])),
        }


class _FocalHeap:
    """Open set with a focal sublist: all entries with key f <= bound.

    Entries flow pending -> focal as the bound grows (the incremental focal
    maintenance of a_star_epsilon.hpp:134-155 / ecbs.hpp:170-191).
    """

    def __init__(self):
        self.open: list = []  # (f, tie, item)
        self.pending: list = []  # (f, tie, focal_key, item)
        self.focal: list = []  # (focal_key, tie, item)
        self.bound = -math.inf

    def push(self, f: float, focal_key, tie, item):
        heapq.heappush(self.open, (f, tie, item))
        if f <= self.bound:
            heapq.heappush(self.focal, (focal_key, tie, item))
        else:
            heapq.heappush(self.pending, (f, tie, focal_key, item))

    def raise_bound(self, bound: float):
        self.bound = bound
        while self.pending and self.pending[0][0] <= bound:
            f, tie, focal_key, item = heapq.heappop(self.pending)
            heapq.heappush(self.focal, (focal_key, tie, item))

    def min_f(self, stale) -> Optional[float]:
        while self.open and stale(self.open[0][2]):
            heapq.heappop(self.open)
        return self.open[0][0] if self.open else None

    def pop_focal(self, stale):
        while self.focal and stale(self.focal[0][2]):
            heapq.heappop(self.focal)
        if not self.focal:
            return None
        return heapq.heappop(self.focal)[2]


def low_level_search(
    env: Environment,
    agent: int,
    start_cell: Cell,
    constraints: Constraints,
    solution: list[Optional[list[State]]],
    w: float,
    max_time: int,
) -> Optional[tuple[list[State], int, int]]:
    """Focal A* for one agent.  Returns (path, cost, fmin)."""
    goals = env.goals
    gx, gy, gz = goals[agent]
    dimx, dimy, dimz = env.dims
    others = [(i, p) for i, p in enumerate(solution)
              if i != agent and p]

    last_goal_constraint = -1
    for (t, x, y, z) in constraints.vertex:
        if (x, y, z) == (gx, gy, gz):
            last_goal_constraint = max(last_goal_constraint, t)

    def h(x, y, z) -> int:
        return abs(x - gx) + abs(y - gy) + abs(z - gz)

    def focal_state(s: State) -> int:
        c = 0
        for i, p in others:
            s2 = p[s[0]] if s[0] < len(p) else p[-1]
            if env.vertex_conflict(agent, i, s, s2):
                c += 1
        return c

    def focal_transition(s1a: State, s1b: State) -> int:
        c = 0
        for i, p in others:
            s2a = p[s1a[0]] if s1a[0] < len(p) else p[-1]
            s2b = p[s1b[0]] if s1b[0] < len(p) else p[-1]
            if env.edge_conflict(agent, i, s1a, s1b, s2a, s2b):
                c += 1
        return c

    start: State = (0, *start_cell)
    # g(state) == state.time (unit costs), so a state never improves: first
    # arrival wins and a closed set suffices.
    came_from: dict[State, State] = {}
    closed: set[State] = set()
    in_open: set[State] = {start}
    focal_val: dict[State, int] = {start: focal_state(start)}

    heap = _FocalHeap()
    f0 = h(*start_cell)
    heap.push(f0, (focal_val[start], f0, 0), 0, start)
    counter = 1
    fmin = f0

    def stale(s: State) -> bool:
        return s in closed

    while True:
        cur_min = heap.min_f(stale)
        if cur_min is None:
            return None
        fmin = max(fmin, cur_min)
        heap.raise_bound(w * fmin)
        s = heap.pop_focal(stale)
        if s is None:
            continue
        closed.add(s)
        in_open.discard(s)

        t, x, y, z = s
        if (x, y, z) == (gx, gy, gz) and t > last_goal_constraint:
            path = [s]
            while path[-1] in came_from:
                path.append(came_from[path[-1]])
            path.reverse()
            return path, t, fmin

        if t >= max_time:
            continue
        for dx, dy, dz in _MOVES:
            nx, ny, nz = x + dx, y + dy, z + dz
            ns: State = (t + 1, nx, ny, nz)
            if not (0 <= nx < dimx and 0 <= ny < dimy and 0 <= nz < dimz):
                continue
            if (nx, ny, nz) in env.obstacles:
                continue
            if (t + 1, nx, ny, nz) in constraints.vertex:
                continue
            if (t, x, y, z, nx, ny, nz) in constraints.edge:
                continue
            if ns in closed or ns in in_open:
                continue
            came_from[ns] = s
            in_open.add(ns)
            fv = focal_val[s] + focal_state(ns) + focal_transition(s, ns)
            focal_val[ns] = fv
            nf = (t + 1) + h(nx, ny, nz)
            heap.push(nf, (fv, nf, -(t + 1)), counter, ns)
            counter += 1


@dataclass
class _HLNode:
    solution: list
    constraints: list
    cost: int
    lb: int
    focal_h: int
    node_id: int = 0


def ecbs_search(
    env: Environment,
    start_cells: list[Cell],
    w: float = 1.3,
    max_time: Optional[int] = None,
    max_expansions: int = 200_000,
) -> Optional[list[list[State]]]:
    """High-level focal search over the constraint tree (ecbs.hpp:109-297)."""
    n = len(start_cells)
    if max_time is None:
        dimx, dimy, dimz = env.dims
        max_time = 2 * (dimx * dimy * dimz) + 100

    root_solution: list = [None] * n
    root_constraints = [Constraints() for _ in range(n)]
    cost = 0
    lb = 0
    for i in range(n):
        res = low_level_search(env, i, start_cells[i], root_constraints[i],
                               root_solution, w, max_time)
        if res is None:
            return None
        root_solution[i], ci, fmin = res
        cost += ci
        lb += fmin

    root = _HLNode(root_solution, root_constraints, cost, lb,
                   env.count_conflicts(root_solution))

    heap = _FocalHeap()
    heap.push(root.cost, (root.focal_h, root.cost), 0, root)
    live: set[int] = {0}
    next_id = 1
    expansions = 0

    def stale(node: _HLNode) -> bool:
        return node.node_id not in live

    while expansions < max_expansions:
        best = heap.min_f(stale)
        if best is None:
            return None
        heap.raise_bound(w * best)
        node = heap.pop_focal(stale)
        if node is None:
            continue
        live.discard(node.node_id)
        expansions += 1

        conflict = env.first_conflict(node.solution)
        if conflict is None:
            return node.solution

        for agent, (kind, con) in env.constraints_from_conflict(conflict).items():
            constraints = list(node.constraints)
            constraints[agent] = (constraints[agent].add_vertex(con)
                                  if kind == "vertex"
                                  else constraints[agent].add_edge(con))
            solution = list(node.solution)
            res = low_level_search(env, agent, start_cells[agent],
                                   constraints[agent], solution, w, max_time)
            if res is None:
                next_id += 1
                continue
            path, ci, fmin = res
            new_cost = node.cost - (len(node.solution[agent]) - 1) + ci
            new_lb = node.lb  # updated below with replanned fmin
            # reference tracks per-agent fmin; recompute incrementally
            solution[agent] = path
            child = _HLNode(solution, constraints, new_cost, new_lb,
                            env.count_conflicts(solution), next_id)
            live.add(next_id)
            heap.push(child.cost, (child.focal_h, child.cost), next_id, child)
            next_id += 1

    return None
