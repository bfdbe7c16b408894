"""Dense occupancy voxel grid — the planner's environment representation.

Replaces the reference's octomap::OcTree + DynamicEDTOctomap pair
(swarm_traj_planner_rbp.cpp:73-83) with a dense [X, Y, Z] tensor whose
voxelization matches octomap's key/coordinate convention: the voxel with
index i along an axis spans [ (i0+i)*res, (i0+i+1)*res ) and has center
(i0 + i + 0.5)*res, where i0 = floor(world_min/res).  DynamicEDTOctomap is
built over the world AABB, so the grid covers floor(min/res)..floor(max/res)
inclusive per axis.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class OccupancyGrid:
    occ: np.ndarray  # [X, Y, Z] bool
    res: float
    i0: np.ndarray  # [3] int voxel index offset = floor(world_min/res)

    @classmethod
    def empty(cls, world_min, world_max, res: float) -> "OccupancyGrid":
        world_min = np.asarray(world_min, dtype=np.float64)
        world_max = np.asarray(world_max, dtype=np.float64)
        i0 = np.floor(world_min / res + 1e-9).astype(np.int64)
        i1 = np.floor(world_max / res + 1e-9).astype(np.int64)
        dims = (i1 - i0 + 1).astype(np.int64)
        return cls(occ=np.zeros(tuple(dims), dtype=bool), res=res, i0=i0)

    @property
    def dims(self) -> tuple[int, int, int]:
        return self.occ.shape

    def point_to_index(self, pts: np.ndarray) -> np.ndarray:
        """Voxel indices containing world points (octomap coordToKey)."""
        pts = np.asarray(pts, dtype=np.float64)
        return (np.floor(pts / self.res).astype(np.int64) - self.i0)

    def index_to_center(self, idx: np.ndarray) -> np.ndarray:
        return (np.asarray(idx, dtype=np.float64) + self.i0 + 0.5) * self.res

    def mark_points(self, pts: np.ndarray) -> None:
        """Occupy the voxels containing ``pts`` (octomap_server voxelization)."""
        idx = self.point_to_index(pts)
        dims = np.array(self.occ.shape)
        ok = np.all((idx >= 0) & (idx < dims), axis=-1)
        idx = idx[ok]
        self.occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True

    def voxel_centers(self) -> np.ndarray:
        """[X, Y, Z, 3] world coordinates of every voxel center."""
        X, Y, Z = self.occ.shape
        ix = (np.arange(X) + self.i0[0] + 0.5) * self.res
        iy = (np.arange(Y) + self.i0[1] + 0.5) * self.res
        iz = (np.arange(Z) + self.i0[2] + 0.5) * self.res
        return np.stack(np.meshgrid(ix, iy, iz, indexing="ij"), axis=-1)
