"""Relative safe flight corridors: separating planes between agent pairs.

Vectorized form of Corridor::updateRelBox (rbp_corridor.hpp:338-398): for
every pair (qi < qj) and every segment, the plane normal is the closest
point to the origin of the downwash-scaled relative displacement segment,
normalized and z-rescaled.  The QP then enforces
    n . (c_j - c_i) >= r_i + r_j
for every pair of matching control points (rbp_planner.hpp:636-684).

Two forms of the same float64 math: the numpy chain
(``_pair_planes_numpy``, the JAX package's) for small swarms, and
``pair_separating_planes`` in torch on the device of its inputs (the JAX
package's jitted form), which ``build_rsfc`` takes above
LARGE_PAIR_SEGMENTS pair-segments (256 agents have 2.3 M), on the
caller's device.
"""
from __future__ import annotations

import numpy as np
import torch

#: pair-segments above which build_rsfc takes the torch form (the JAX
#: package's threshold)
LARGE_PAIR_SEGMENTS = 200_000


def pair_separating_planes(init_traj: torch.Tensor, pair_idx: torch.Tensor,
                           *, downwash: float):
    """init_traj [N, M+1, 3] float64, pair_idx [P, 2] -> (normals [P, M, 3],
    minimum scaled distance per pair-segment [P, M]), on the inputs'
    device: the closest point to the origin of each downwash-scaled
    relative displacement segment (start from a, replace by b if closer,
    by the perpendicular foot c only when it lies strictly between a and
    b and improves), normalised, z re-divided by downwash."""
    scale = torch.tensor([1.0, 1.0, 1.0 / downwash], dtype=init_traj.dtype,
                         device=init_traj.device)
    pair_idx = pair_idx.long()
    rel = (init_traj[pair_idx[:, 1]] - init_traj[pair_idx[:, 0]]) * scale
    a, b = rel[:, :-1, :], rel[:, 1:, :]
    na = torch.linalg.vector_norm(a, dim=-1)
    nb = torch.linalg.vector_norm(b, dim=-1)
    m = torch.where((nb < na)[..., None], b, a)
    dmin = torch.minimum(na, nb)
    seg = b - a
    seg_len = torch.linalg.vector_norm(seg, dim=-1, keepdim=True)
    degenerate = seg_len[..., 0] < 1e-12
    n_hat = seg / torch.where(seg_len > 0, seg_len, 1.0)
    c = a - n_hat * torch.sum(a * n_hat, dim=-1, keepdim=True)
    interior = torch.sum((c - a) * (c - b), dim=-1) < 0
    nc = torch.linalg.vector_norm(c, dim=-1)
    use_c = interior & (dmin > nc) & ~degenerate
    m = torch.where(use_c[..., None], c, m)
    dmin = torch.where(use_c, nc, dmin)
    norm_m = torch.linalg.vector_norm(m, dim=-1, keepdim=True)
    normal = m / torch.where(norm_m > 0, norm_m, 1.0) * scale
    return normal, dmin


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


def build_rsfc(init_traj: np.ndarray, downwash: float, device=None):
    """Host entry: returns (pair_idx [P,2], normals [P,M,3]) as numpy.

    Up to LARGE_PAIR_SEGMENTS pair-segments the numpy chain runs on the
    host; above it the torch form runs on ``device`` (a CUDA device: the
    card, the result copied back; None or "cpu": the host's torch), the
    faster route at 256 agents on an H100's host (PERF.md).

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
    if len(pair_idx) * (init_traj.shape[1] - 1) > LARGE_PAIR_SEGMENTS:
        dev = torch.device("cpu" if device is None else device)
        normals, dmin = pair_separating_planes(
            torch.as_tensor(np.asarray(init_traj, np.float64), device=dev),
            torch.as_tensor(pair_idx, device=dev), downwash=float(downwash))
        normals, dmin = normals.cpu().numpy(), dmin.cpu().numpy()
    else:
        normals, dmin = _pair_planes_numpy(init_traj, pair_idx,
                                           float(downwash))
    if np.any(dmin <= 0):
        p, m = np.argwhere(dmin <= 0)[0]
        raise ValueError(
            f"initial trajectories of agents {iu[p]} and {ju[p]} collide at "
            f"segment {m}")
    return pair_idx, np.asarray(normals)
