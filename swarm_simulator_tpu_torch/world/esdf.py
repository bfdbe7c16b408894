"""Euclidean distance field over the occupancy grid.

Replaces DynamicEDTOctomap (the only obstacle-query API in the reference —
ecbs_planner.hpp:93, rbp_corridor.hpp:66) with a precomputed dense
distance tensor.  Distances are voxel-center-to-voxel-center and clamped
to ``max_dist``, matching DynamicEDTOctomap(maxDist=1.0, ...) in
swarm_traj_planner_rbp.cpp:75.

Two forms:
  native  the C++ host runtime's EDT (search/native_binding), the default;
  device  ``esdf_from_occupancy``: the exact squared EDT is separable, one
          min-plus transform g(i) = min_j [f(j) + (i - j)^2] per axis
          (Felzenszwalb & Huttenlocher), each a min-reduction over a
          broadcast sum in plain torch on the occupancy tensor's device,
          then sqrt and the clamp, in float32 (the JAX package's XLA op).
          Every step rounds as IEEE float32 does (the square of a
          coordinate difference, then the sum, exact minima, the sqrt
          taken in float64 and rounded once, which is the correctly
          rounded float32 sqrt), so the CPU and the card give the same
          bits.  The JAX package's CPU form differs by at most one ulp of
          the grid's largest coordinate: XLA contracts the coordinate
          difference and the square-and-add into fused multiply-adds.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..search.native_binding import esdf_native
from .voxel import OccupancyGrid

#: the squared distance of a free voxel before the first pass
_BIG = 1e12

#: elements of one pass's [L, L, chunk] broadcast (256 MB of float32): the
#: trailing axis is cut into chunks of at most this many, so the memory of
#: a pass is bounded whatever the grid; each column's minimum is the same
#: sum and minimum in any chunking, so the result is the same bits
CHUNK_ELEMS = 1 << 26


def _minplus_axis(fsq: torch.Tensor, axis: int, res: float,
                  chunk_elems: int) -> torch.Tensor:
    """One exact 1-D squared-EDT pass along ``axis`` (lengths in world
    units): g[i, ...] = min_j (i - j)^2 res^2 + f[j, ...]."""
    L = fsq.shape[axis]
    idx = torch.arange(L, dtype=fsq.dtype, device=fsq.device) * res
    cost = (idx[:, None] - idx[None, :]) ** 2
    f = torch.movedim(fsq, axis, 0)
    rest = f.shape[1:]
    f = f.reshape(L, -1)
    step = max(1, chunk_elems // (L * L))
    g = torch.cat([torch.amin(cost[:, :, None] + f[None, :, c:c + step],
                              dim=1)
                   for c in range(0, f.shape[1], step)], dim=1)
    return torch.movedim(g.reshape((L,) + rest), 0, axis)


def esdf_from_occupancy(occ, *, res: float, max_dist: float = 1.0,
                        chunk_elems: int = CHUNK_ELEMS) -> torch.Tensor:
    """[X, Y, Z] bool occupancy (a tensor, on its device; numpy goes to the
    CPU) -> [X, Y, Z] float32 clamped Euclidean distances, on the same
    device: three min-plus passes, sqrt, clamp.  ``chunk_elems`` bounds a
    pass's broadcast (any value gives the same bits).  torch's float32
    sqrt on the CPU is not always correctly rounded, so the sqrt is taken
    in float64 and rounded once."""
    occ = torch.as_tensor(occ)
    fsq = torch.where(occ.bool(),
                      torch.zeros((), dtype=torch.float32, device=occ.device),
                      torch.full((), _BIG, dtype=torch.float32,
                                 device=occ.device))
    for axis in range(3):
        fsq = _minplus_axis(fsq, axis, res, chunk_elems)
    dist = torch.sqrt(fsq.double()).float()
    return torch.clamp(dist, max=float(np.float32(max_dist)))


class ESDF:
    """Host-side wrapper bundling the distance tensor (host numpy float32)
    with its voxelization.

    backend:
      "native"  the C++ EDT on the host (the default);
      "device"  esdf_from_occupancy on ``device`` (None = the card; raises
                without one: pass ``device="cpu"`` for the CPU), copied back;
      "auto"    "native".
    The JAX package's "auto" falls back to its XLA op when the native
    library fails; here a failing native build raises, and the device form
    runs only when asked for, so no path changes form silently."""

    def __init__(self, grid: OccupancyGrid, max_dist: float = 1.0,
                 backend: str = "native", device=None):
        if backend not in ("native", "device", "auto"):
            raise ValueError(f"ESDF backend {backend!r}: expected 'native', "
                             "'device' or 'auto'")
        self.grid = grid
        self.max_dist = float(max_dist)
        if backend == "device":
            occ = torch.as_tensor(np.ascontiguousarray(grid.occ),
                                  device=resolve_device(device))
            self.dist = esdf_from_occupancy(
                occ, res=grid.res, max_dist=max_dist).cpu().numpy()
        else:
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
