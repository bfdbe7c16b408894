"""Dense trajectory evaluation: batched piecewise-polynomial sampling.

Vectorized form of RBPPublisher::update_traj / update_quad_state
(rbp_publisher.hpp:169-235, 670-683): segment lookup by knot time, then
position/velocity/acceleration rows of the local-time Vandermonde.  The
acceptance metrics judge the gate, so sampling runs in float64 on the
plan's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device


def sample_trajectories(coef, T, t, *, n: int, derivatives: int = 3,
                        device=None) -> torch.Tensor:
    """coef [N, M, n+1, 3], T [M+1], t [S] -> states [N, S, derivatives, 3]
    (float64 on ``device``: None = the card, raising without one; pass
    ``device="cpu"`` for the CPU).

    derivative 0 = position, 1 = velocity, 2 = acceleration, ...
    Column j of coef multiplies tau^(n-j) with tau local to the segment.
    """
    device = resolve_device(device)
    f64 = torch.float64
    coef = torch.as_tensor(coef, dtype=f64, device=device)
    T = torch.as_tensor(T, dtype=f64, device=device)
    t = torch.as_tensor(t, dtype=f64, device=device)
    M = coef.shape[1]
    idx = torch.clamp(torch.searchsorted(T, t, right=True) - 1, 0, M - 1)
    tau = t - T[idx]  # [S]

    j = torch.arange(n + 1, device=device)
    rows = []
    for r in range(derivatives):
        power = torch.clamp(n - j - r, min=0).to(f64)
        fall = torch.ones(n + 1, dtype=f64, device=device)
        for k in range(r):
            fall = fall * torch.clamp(n - j - k, min=0).to(f64)
        basis = fall * torch.where(n - j - r >= 0, tau[:, None] ** power,
                                   torch.zeros((), dtype=f64, device=device))
        rows.append(basis)
    vand = torch.stack(rows, dim=1)  # [S, R, n+1]
    segs = coef[:, idx]  # [N, S, n+1, 3]
    return torch.einsum("srj,nsjk->nsrk", vand, segs)


def sample_times(T: np.ndarray, step: float = 0.1) -> np.ndarray:
    """Reference playback sampling grid (rbp_publisher.hpp:670-683)."""
    return np.arange(0.0, float(T[-1]) + 1e-9, step)
