"""The corridors as the benchmark defines them, worked out again from the
program's initial paths.

A frozen numpy copy of the upstream's corridor rules: the obstacle-free
boxes of Corridor::updateObsBox (rbp_corridor.hpp:99-243: a box from
each path segment's snapped end points, grown one box step at a time in
round-robin axis order while the newly added slab stays clear, then the
boxes' time windows) and the pair planes of Corridor::updateRelBox
(rbp_corridor.hpp:338-398).  The clearance query is the upstream's
DynamicEDTOctomap test "distance from the voxel that holds the point to
the nearest occupied voxel, centre to centre, below the margin", which
for one margin is a dilation of the occupancy by every voxel offset
shorter than it.
"""
from __future__ import annotations

import math

import numpy as np

from .world import Grid

EPS = 1e-9
EPS_F = 1e-6


class Clearance:
    """``blocked(points)``: True where the voxel holding a point lies
    closer than ``margin`` (less EPS_F) to an occupied voxel, centre to
    centre, or outside the grid (the upstream's distance -1)."""

    def __init__(self, grid: Grid, margin: float):
        self.grid = grid
        occ = grid.occ
        k = int(math.ceil(margin / grid.res)) + 1
        lim = (margin - EPS_F) / grid.res
        near = np.zeros_like(occ)
        X, Y, Z = occ.shape
        for dx in range(-k, k + 1):
            for dy in range(-k, k + 1):
                for dz in range(-k, k + 1):
                    if math.sqrt(dx * dx + dy * dy + dz * dz) >= lim:
                        continue
                    src = occ[max(0, dx):X + min(0, dx),
                              max(0, dy):Y + min(0, dy),
                              max(0, dz):Z + min(0, dz)]
                    near[max(0, -dx):X + min(0, -dx),
                         max(0, -dy):Y + min(0, -dy),
                         max(0, -dz):Z + min(0, -dz)] |= src
        self.near = near

    def blocked(self, axes) -> bool:
        """Whether any point of the lattice ``axes`` (three coordinate
        lists) is blocked."""
        idx = []
        for a, xs in enumerate(axes):
            i = np.floor(xs / self.grid.res).astype(np.int64) - self.grid.i0[a]
            if i.min() < 0 or i.max() >= self.near.shape[a]:
                return True
            idx.append(i)
        return bool(self.near[np.ix_(*idx)].any())


def _samples(lo: float, hi: float, res: float, world_lo: float):
    xs = lo + np.arange(int(math.floor((hi + EPS_F - lo) / res)) + 1) * res \
        + EPS_F
    if lo > world_lo + EPS_F:
        xs[0] = lo - EPS_F
    return xs


def _box_blocked(clear: Clearance, box, res, world_lo) -> bool:
    return clear.blocked([_samples(box[a], box[a + 3], res[a], world_lo[a])
                          for a in range(3)])


def _inside(box, lo, hi) -> bool:
    return all(box[a] > lo[a] - EPS and box[a + 3] < hi[a] + EPS
               for a in range(3))


def _holds(p, box) -> bool:
    return all(box[a] - EPS < p[a] < box[a + 3] + EPS for a in range(3))


def _grow(clear, box, res, lo, hi):
    cand = [0, 1, 2, 3, 4, 5]
    i = -1
    while cand:
        box_cand, box_update = list(box), list(box)
        while (not _box_blocked(clear, box_update, res, lo)
               and _inside(box_update, lo, hi)):
            i += 1
            if i >= len(cand):
                i = 0
            ax = cand[i]
            box, box_update = list(box_cand), list(box_cand)
            if ax < 3:
                box_update[ax + 3] = box_cand[ax]
                box_cand[ax] -= res[ax]
                box_update[ax] = box_cand[ax]
            else:
                box_update[ax - 3] = box_cand[ax]
                box_cand[ax] += res[ax - 3]
                box_update[ax] = box_cand[ax]
        del cand[i]
        i = i - 1 if i > 0 else len(cand) - 1
    return box


def agent_corridor(clear: Clearance, path: np.ndarray, T: np.ndarray,
                   res, lo, hi) -> list:
    """[(box, end time)] along one agent's path."""
    boxes, prev = [], [0.0] * 6
    for s in range(len(path) - 1):
        p0, p1 = path[s], path[s + 1]
        if _holds(p1, prev):
            continue
        box = [round(min(p0[a], p1[a]) / res[a]) * res[a] for a in range(3)] \
            + [round(max(p0[a], p1[a]) / res[a]) * res[a] for a in range(3)]
        if _box_blocked(clear, box, res, lo):
            raise ValueError(f"an obstacle on the initial path, segment {s}")
        box = _grow(clear, box, res, lo, hi)
        boxes.append(box)
        prev = box
    n_box, n_path = len(boxes), len(path)
    log = np.zeros((n_box, n_path), dtype=np.int64)
    for b in range(n_box):
        for j in range(n_path):
            if _holds(path[j], boxes[b]):
                log[b, j] = 1 if j == 0 else log[b, j - 1] + 1
    ends = [-1.0] * n_box
    b = j = 0
    while j < n_path:
        if b == n_box - 1:
            if log[b, j] > 0:
                j += 1
                continue
            b -= 1
        if log[b, j] > 0 and log[b + 1, j] > 0:
            c = 1
            while (j + c < n_path and log[b, j + c] > 0
                   and log[b + 1, j + c] > 0):
                c += 1
            ends[b] = float(T[j + c // 2])
            j += c // 2
            b += 1
        elif log[b, j] == 0:
            b -= 1
            j -= 1
        j += 1
    ends[-1] = float(T[-1])
    return list(zip(boxes, ends))


def segment_boxes(corridors: list, T: np.ndarray) -> np.ndarray:
    """[N, M, 6]: each segment's box, the first whose end time reaches the
    segment's end."""
    M = len(T) - 1
    out = np.zeros((len(corridors), M, 6))
    for q, boxes in enumerate(corridors):
        b = 0
        for m in range(M):
            while b < len(boxes) and boxes[b][1] < T[m + 1]:
                b += 1
            out[q, m] = boxes[min(b, len(boxes) - 1)][0]
    return out


def boxes(grid: Grid, paths: np.ndarray, T: np.ndarray, radius: np.ndarray,
          box_res, lo, hi) -> np.ndarray:
    """Every agent's segment boxes [N, M, 6]."""
    clear: dict[float, Clearance] = {}
    corridors = []
    for q in range(paths.shape[0]):
        r = float(radius[q])
        if r not in clear:
            clear[r] = Clearance(grid, r)
        corridors.append(agent_corridor(clear[r], paths[q], T, box_res,
                                        lo, hi))
    return segment_boxes(corridors, T)


def pair_planes(paths: np.ndarray, downwash: float):
    """(pair index [P, 2] with i < j, normals [P, M, 3], least scaled
    distance [P, M]): for each pair and segment, the point of the
    downwash-scaled relative segment nearest the origin, as a unit
    normal with z divided by the downwash again."""
    N = paths.shape[0]
    iu, ju = np.triu_indices(N, k=1)
    scale = np.array([1.0, 1.0, 1.0 / downwash])
    rel = (paths[ju] - paths[iu]) * scale
    a, b = rel[:, :-1], rel[:, 1:]
    na, nb = np.linalg.norm(a, axis=-1), np.linalg.norm(b, axis=-1)
    m = np.where((nb < na)[..., None], b, a)
    dmin = np.minimum(na, nb)
    seg = b - a
    seg_len = np.linalg.norm(seg, axis=-1, keepdims=True)
    n_hat = seg / np.where(seg_len > 0, seg_len, 1.0)
    c = a - n_hat * np.sum(a * n_hat, axis=-1, keepdims=True)
    nc = np.linalg.norm(c, axis=-1)
    use_c = ((np.sum((c - a) * (c - b), axis=-1) < 0) & (dmin > nc)
             & ~(seg_len[..., 0] < 1e-12))
    m = np.where(use_c[..., None], c, m)
    dmin = np.where(use_c, nc, dmin)
    norm = np.linalg.norm(m, axis=-1, keepdims=True)
    return (np.stack([iu, ju], axis=1),
            m / np.where(norm > 0, norm, 1.0) * scale, dmin)
