"""Relative safe flight corridors: separating planes between agent pairs.

Vectorized form of Corridor::updateRelBox (rbp_corridor.hpp:338-398): for
every pair (qi < qj) and every segment, the plane normal is the closest
point to the origin of the downwash-scaled relative displacement segment,
normalized and z-rescaled.  The QP then enforces
    n . (c_j - c_i) >= r_i + r_j
for every pair of matching control points (rbp_planner.hpp:636-684).

Numpy form only (the JAX package's ``_pair_planes_numpy``, which its
tests pin equal to the jitted einsum form), at every size: the JAX
package takes its jitted form above 200,000 pair-segments (256 agents
have 2.3 M) to run it on its device; this chain is already vectorised
and stays on the host.
"""
from __future__ import annotations

import numpy as np


def _pair_planes_numpy(init_traj: np.ndarray, pair_idx: np.ndarray,
                       downwash: float):
    """init_traj [N, M+1, 3], pair_idx [P, 2] -> (normals [P, M, 3],
    minimum scaled distance per pair-segment [P, M])."""
    scale = np.array([1.0, 1.0, 1.0 / downwash])
    rel = (init_traj[pair_idx[:, 1]] - init_traj[pair_idx[:, 0]]) * scale
    a, b = rel[:, :-1, :], rel[:, 1:, :]
    na = np.linalg.norm(a, axis=-1)
    nb = np.linalg.norm(b, axis=-1)
    m = np.where((nb < na)[..., None], b, a)
    dmin = np.minimum(na, nb)
    seg = b - a
    seg_len = np.linalg.norm(seg, axis=-1, keepdims=True)
    degenerate = seg_len[..., 0] < 1e-12
    n_hat = seg / np.where(seg_len > 0, seg_len, 1.0)
    c = a - n_hat * np.sum(a * n_hat, axis=-1, keepdims=True)
    interior = np.sum((c - a) * (c - b), axis=-1) < 0
    nc = np.linalg.norm(c, axis=-1)
    use_c = interior & (dmin > nc) & ~degenerate
    m = np.where(use_c[..., None], c, m)
    dmin = np.where(use_c, nc, dmin)
    norm_m = np.linalg.norm(m, axis=-1, keepdims=True)
    normal = m / np.where(norm_m > 0, norm_m, 1.0) * scale
    return normal, dmin


def build_rsfc(init_traj: np.ndarray, downwash: float):
    """Host entry: returns (pair_idx [P,2], normals [P,M,3]).

    Raises if any pair's relative path passes through the origin — the
    reference's "initial trajectories are collided" error
    (rbp_corridor.hpp:385-388).
    """
    N = init_traj.shape[0]
    iu, ju = np.triu_indices(N, k=1)
    pair_idx = np.stack([iu, ju], axis=1).astype(np.int32)
    if len(pair_idx) == 0:
        M = init_traj.shape[1] - 1
        return pair_idx, np.zeros((0, M, 3))
    normals, dmin = _pair_planes_numpy(init_traj, pair_idx, float(downwash))
    if np.any(dmin <= 0):
        p, m = np.argwhere(dmin <= 0)[0]
        raise ValueError(
            f"initial trajectories of agents {iu[p]} and {ju[p]} collide at "
            f"segment {m}")
    return pair_idx, np.asarray(normals)
