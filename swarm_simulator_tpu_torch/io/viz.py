"""Visualization: dynamics, safety-margin, and trajectory plots.

Matplotlib equivalents of the reference's embedded plots
(rbp_publisher.hpp: plot_quad_dynamics :697-766, plot_safety_margin_ratio
:800-823) plus a top-view trajectory plot standing in for the rviz marker
topics.  The HSV agent colormap mirrors Param::setColor (param.hpp:78-124).

A copy of swarm_simulator_tpu/io/viz.py (host code),
so that the PyTorch port never imports the JAX package.
"""
from __future__ import annotations

import numpy as np


def agent_colors(qn: int) -> np.ndarray:
    """HSV wheel colors [qn, 3] (param.hpp:78-124)."""
    colors = np.zeros((qn, 3))
    for qi in range(qn):
        h = qi * 6 / qn
        i = int(h)
        f = h - i
        colors[qi] = {
            0: (1, f, 0), 1: (1 - f, 1, 0), 2: (0, 1, f),
            3: (0, 1 - f, 1), 4: (f, 0, 1), 5: (1, 0, 1 - f),
        }[i % 6]
    return colors


def plot_quad_dynamics(t, vel, acc, max_vel, max_acc, path=None):
    """3x2 grid of per-axis velocity/acceleration with limit lines.

    vel/acc: [N, S, 3]; limits [N, 3] (first agent's limits drawn, like the
    reference's homogeneous-case TODO)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    N = vel.shape[0]
    colors = agent_colors(N)
    fig, axes = plt.subplots(3, 2, figsize=(12.8, 9.6))
    names = ["x", "y", "z"]
    for k in range(3):
        for col, (data, lim, label) in enumerate(
                [(vel, max_vel, "velocity"), (acc, max_acc, "acceleration")]):
            ax = axes[k][col]
            for qi in range(N):
                ax.plot(t, data[qi, :, k], color=colors[qi], lw=0.8)
            ax.axhline(lim[0][k], color="r", ls="--")
            ax.axhline(-lim[0][k], color="r", ls="--")
            ax.set_title(f"{label} -{names[k]} axis")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_safety_margin(t, pos, radius, downwash, path=None):
    """Min/max inter-agent distance-ratio curves with the collision line at
    1 (plot_safety_margin_ratio)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    scale = np.array([1.0, 1.0, 1.0 / downwash])
    d = (pos[:, None] - pos[None, :]) * scale
    dist = np.linalg.norm(d, axis=-1)
    rsum = radius[:, None] + radius[None, :]
    ratio = dist / rsum[:, :, None]
    N = pos.shape[0]
    iu = np.triu_indices(N, k=1)
    r = ratio[iu[0], iu[1]]  # [P, S]

    fig, ax = plt.subplots(figsize=(4.8, 2.7))
    ax.plot(t, r.min(axis=0), label="min ratio")
    ax.plot(t, r.max(axis=0), label="max ratio", alpha=0.5)
    ax.axhline(1.0, color="r", ls="--", label="collision")
    ax.set_xlabel("t [s]")
    ax.set_ylabel("dist ratio")
    ax.legend(fontsize=7)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_trajectories_topview(pos, init_traj=None, world=None, path=None):
    """Top-view (x, y) trajectory plot; optional occupancy underlay."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    N = pos.shape[0]
    colors = agent_colors(N)
    fig, ax = plt.subplots(figsize=(7, 7))
    if world is not None:
        occ2d = world.occ.any(axis=2)
        x0 = (world.i0[0]) * world.res
        y0 = (world.i0[1]) * world.res
        ax.imshow(occ2d.T, origin="lower", cmap="Greys", alpha=0.4,
                  extent=[x0, x0 + occ2d.shape[0] * world.res,
                          y0, y0 + occ2d.shape[1] * world.res])
    for qi in range(N):
        ax.plot(pos[qi, :, 0], pos[qi, :, 1], color=colors[qi], lw=1.0)
        ax.plot(pos[qi, 0, 0], pos[qi, 0, 1], "o", color=colors[qi], ms=3)
        ax.plot(pos[qi, -1, 0], pos[qi, -1, 1], "x", color=colors[qi], ms=4)
        if init_traj is not None:
            ax.plot(init_traj[qi, :, 0], init_traj[qi, :, 1],
                    color=colors[qi], lw=0.5, ls=":", alpha=0.6)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def animate_swarm(ts, pos, radius, world=None, init_traj=None,
                  downwash: float = 2.0, path="swarm.gif",
                  fps: int = 20, trail: int = 30):
    """Top-view playback animation — the offline equivalent of the
    reference's 20 Hz interactive surface (RBPPublisher::update/publish,
    rbp_publisher.hpp:93-127: TF broadcast + collision-model markers at
    each tick, here rendered as physical-radius discs with fading
    trails over the occupancy underlay).

    ts [S], pos [N, S, 3], radius [N]; writes a GIF via pillow.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    N, S, _ = pos.shape
    colors = agent_colors(N)
    fig, ax = plt.subplots(figsize=(7, 7))
    if world is not None:
        occ2d = world.occ.any(axis=2)
        x0 = world.i0[0] * world.res
        y0 = world.i0[1] * world.res
        ax.imshow(occ2d.T, origin="lower", cmap="Greys", alpha=0.4,
                  extent=[x0, x0 + occ2d.shape[0] * world.res,
                          y0, y0 + occ2d.shape[1] * world.res])
    if init_traj is not None:
        for qi in range(N):
            ax.plot(init_traj[qi, :, 0], init_traj[qi, :, 1],
                    color=colors[qi], lw=0.5, ls=":", alpha=0.5)
    lo = pos.reshape(-1, 3).min(axis=0) - 0.5
    hi = pos.reshape(-1, 3).max(axis=0) + 0.5
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")

    discs = []
    trails = []
    for qi in range(N):
        c = plt.Circle((pos[qi, 0, 0], pos[qi, 0, 1]), float(radius[qi]),
                       color=colors[qi], alpha=0.8)
        ax.add_patch(c)
        discs.append(c)
        (ln,) = ax.plot([], [], color=colors[qi], lw=0.8, alpha=0.6)
        trails.append(ln)
    title = ax.set_title("t = 0.00 s")

    # ~fps frames per simulated second regardless of sample step
    step = max(1, int(round(1.0 / (fps * (ts[1] - ts[0])))) if S > 1
               else 1)
    frames = range(0, S, step)

    def update(s):
        for qi in range(N):
            discs[qi].center = (pos[qi, s, 0], pos[qi, s, 1])
            a = max(0, s - trail)
            trails[qi].set_data(pos[qi, a:s + 1, 0], pos[qi, a:s + 1, 1])
        title.set_text(f"t = {ts[s]:.2f} s")
        return discs + trails

    anim = FuncAnimation(fig, update, frames=frames, blit=False)
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return path


def plot_scp_distances(res, radius, path=None):
    """SCP pairwise-distance plot (scp_plotter.hpp): every pair's distance
    over the discrete horizon with its collision threshold."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pos = res.pos  # [3, N, K]
    N = pos.shape[1]
    t = np.arange(res.K) * res.h
    fig, ax = plt.subplots(figsize=(6, 3.2))
    for i in range(N):
        for j in range(i + 1, N):
            d = np.linalg.norm(pos[:, i] - pos[:, j], axis=0)
            ax.plot(t, d, lw=0.7)
    ax.axhline(float(np.max(radius) * 2), color="r", ls="--",
               label="max collision threshold")
    ax.set_xlabel("t [s]")
    ax.set_ylabel("inter-agent distance [m]")
    ax.legend(fontsize=7)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig
