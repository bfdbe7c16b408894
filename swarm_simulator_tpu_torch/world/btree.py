"""Octomap .bt (binary tree) importer — replay parity with stored worlds.

The reference ships 56 octomap worlds (swarm_planner/worlds/*.bt) that its
benchmark sweep loads directly (swarm_traj_planner_rbp_test_all.cpp:51) and
its replay mode serves via octomap_server (plan_rbp_random_forest.launch:
84-93).  This is a from-scratch parser of the public octomap binary-tree
format:

  ASCII header:  "# Octomap OcTree file", "id <OcTree>", "size <n>",
                 "res <r>", "data"
  Body: recursive 2-bytes-per-inner-node encoding; per child, 2 bits:
        00 unknown, (bit i*2)=1 alone -> occupied leaf,
        (bit i*2+1)=1 alone -> free leaf, both -> inner node.
  Geometry: depth-16 octree, root centered at the coordinate origin with
  edge 2^16 * res; child i offsets by +/- size/4 per axis (bit 0 -> x,
  bit 1 -> y, bit 2 -> z; set bit = positive).

A copy of swarm_simulator_tpu/world/btree.py (host code),
so that the PyTorch port never imports the JAX package.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .voxel import OccupancyGrid

_MAX_DEPTH = 16


def read_bt(path: str | Path) -> tuple[np.ndarray, float]:
    """Parse a .bt file -> (occupied leaf table [K, 4], resolution).

    Each row is (cx, cy, cz, size): an occupied cube center + edge length.
    """
    raw = Path(path).read_bytes()
    # --- header ---
    pos = 0
    res = None
    size = None
    tree_id = None
    while True:
        eol = raw.index(b"\n", pos)
        line = raw[pos:eol].decode("latin-1").strip()
        pos = eol + 1
        if line.startswith("#") or not line:
            continue
        if line == "data":
            break
        key, _, val = line.partition(" ")
        if key == "res":
            res = float(val)
        elif key == "size":
            size = int(val)
        elif key == "id":
            tree_id = val
    if res is None:
        raise ValueError("missing res in .bt header")
    if tree_id not in (None, "OcTree"):
        raise ValueError(f"unsupported octree id {tree_id!r}")

    body = raw[pos:]
    leaves: list[tuple[float, float, float, float]] = []

    # iterative depth-first traversal (matches octomap's readBinaryNode
    # order: classify all 8 children, then recurse in child order)
    root_size = res * (1 << _MAX_DEPTH)
    stack = [(0.0, 0.0, 0.0, root_size)]
    offset = 0
    while stack:
        cx, cy, cz, s = stack.pop()
        if offset + 2 > len(body):
            raise ValueError("truncated .bt body")
        b1 = body[offset]
        b2 = body[offset + 1]
        offset += 2
        bits = b1 | (b2 << 8)
        quarter = s / 4.0
        recurse = []
        for i in range(8):
            occ_bit = (bits >> (2 * i)) & 1
            free_bit = (bits >> (2 * i + 1)) & 1
            if not (occ_bit or free_bit):
                continue
            ox = quarter if (i & 1) else -quarter
            oy = quarter if (i & 2) else -quarter
            oz = quarter if (i & 4) else -quarter
            ccx, ccy, ccz = cx + ox, cy + oy, cz + oz
            if occ_bit and free_bit:
                recurse.append((ccx, ccy, ccz, s / 2.0))
            elif occ_bit:
                leaves.append((ccx, ccy, ccz, s / 2.0))
            # free leaves are irrelevant for occupancy
        # LIFO stack: push in reverse so child 0 is processed first
        stack.extend(reversed(recurse))

    return np.asarray(leaves, dtype=np.float64).reshape(-1, 4), res


def load_bt_world(path: str | Path, world_min, world_max,
                  resolution: float | None = None) -> OccupancyGrid:
    """Rasterize a .bt file into an OccupancyGrid over the world AABB.

    Occupied leaves (possibly pruned cubes larger than one voxel) are
    expanded to all voxels they cover; leaves outside the AABB are cropped
    (DynamicEDT only considers the bounding box it is constructed with).
    """
    leaves, res = read_bt(path)
    if resolution is None:
        resolution = res
    grid = OccupancyGrid.empty(world_min, world_max, resolution)
    dims = np.array(grid.dims)
    for cx, cy, cz, s in leaves:
        half = s / 2.0
        lo = grid.point_to_index(
            np.array([[cx - half + 1e-9, cy - half + 1e-9, cz - half + 1e-9]]))[0]
        hi = grid.point_to_index(
            np.array([[cx + half - 1e-9, cy + half - 1e-9, cz + half - 1e-9]]))[0]
        lo = np.maximum(lo, 0)
        hi = np.minimum(hi, dims - 1)
        if np.any(hi < lo):
            continue
        grid.occ[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1] = True
    return grid


def write_bt(path: str | Path, grid: OccupancyGrid) -> None:
    """Write the occupied voxels of ``grid`` as a .bt file that
    ``load_bt_world`` reads back to the same grid (same AABB and
    resolution): one occupied depth-16 leaf a voxel, the inner nodes in
    octomap's depth-first child order, unknown children left out.  Voxel
    g (global index, ``grid.i0`` + local) has center (g + 0.5) * res, as
    a depth-16 leaf of the octree centered at the origin does."""
    keys = np.argwhere(grid.occ) + grid.i0 + (1 << (_MAX_DEPTH - 1))
    out = bytearray()

    def node(keys, depth):
        # child i of a node at this depth: bit 0 -> x, 1 -> y, 2 -> z
        shift = _MAX_DEPTH - 1 - depth
        child = (((keys >> shift) & 1) * np.array([1, 2, 4])).sum(axis=1)
        kids = [keys[child == i] for i in range(8)]
        bits = 0
        for i, k in enumerate(kids):
            if len(k):
                bits |= (1 if shift == 0 else 3) << (2 * i)
        out.extend((bits & 0xFF, bits >> 8))
        if shift:
            for k in kids:
                if len(k):
                    node(k, depth + 1)

    if len(keys):
        node(keys, 0)
    Path(path).write_bytes(b"# Octomap OcTree binary file\nid OcTree\n"
                           + f"size {len(keys)}\nres {grid.res}\n".encode()
                           + b"data\n" + bytes(out))
