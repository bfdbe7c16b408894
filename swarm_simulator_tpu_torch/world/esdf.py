"""Euclidean distance field over the occupancy grid (host, native EDT).

Replaces DynamicEDTOctomap (the only obstacle-query API in the reference —
ecbs_planner.hpp:93, rbp_corridor.hpp:66) with a precomputed dense
distance tensor from the C++ host runtime (search/native_binding).
Distances are voxel-center-to-voxel-center and clamped to ``max_dist``,
matching DynamicEDTOctomap(maxDist=1.0, ...) in
swarm_traj_planner_rbp.cpp:75.

Only the native EDT is ported: if the native library cannot be built the
constructor raises (the device min-plus transform of the JAX package,
``esdf_from_occupancy``, has no port yet).
"""
from __future__ import annotations

import numpy as np

from ..search.native_binding import esdf_native
from .voxel import OccupancyGrid


class ESDF:
    """Host-side wrapper bundling the distance tensor with its voxelization."""

    def __init__(self, grid: OccupancyGrid, max_dist: float = 1.0):
        self.grid = grid
        self.max_dist = float(max_dist)
        self.dist = esdf_native(grid.occ, grid.res, max_dist)

    def query(self, pts: np.ndarray) -> np.ndarray:
        """Distance at world points; -1 outside the map (DynamicEDT semantics)."""
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        idx = self.grid.point_to_index(pts)
        dims = np.array(self.grid.dims)
        ok = np.all((idx >= 0) & (idx < dims), axis=-1)
        idxc = np.clip(idx, 0, dims - 1)
        d = self.dist[idxc[:, 0], idxc[:, 1], idxc[:, 2]].astype(np.float64)
        d[~ok] = -1.0
        return d
