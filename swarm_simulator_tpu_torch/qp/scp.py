"""SCP planner — the reference's second trajectory-optimization algorithm.

Discrete-time double-integrator formulation (scp_planner.hpp, the
SP_PT_SCP path): decision variables are per-timestep accelerations
u[dim, agent, k] over K = T/h + 1 steps; positions/velocities are linear
maps of u (build_mapping_mtx :173-200); endpoints pinned
(build_eq_const :202-223); |p|,|v|,|a|,|jerk| box-limited
(build_ineq_const :225-251); inter-agent distance constraints are
sequentially convexified around the previous solution and the QP is
re-solved until the cost stabilizes (update_ineq_const :253-291,
solveQP :95-157).

All constraint tensors are assembled as dense host arrays once; the SCP
outer loop re-fills only the collision block (vectorized over pairs and
steps), and each inner solve is qp/dense's ADMM on the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.types import Mission, Param
from . import dense

BIG = 1e8


@dataclass
class SCPResult:
    u: np.ndarray  # [3, N, K] accelerations
    pos: np.ndarray  # [3, N, K]
    vel: np.ndarray  # [3, N, K]
    h: float
    K: int
    cost: float
    iterations: int
    infos: list

    def traj_info_msg(self) -> np.ndarray:
        N = self.u.shape[1]
        return np.array([N, self.K, self.h], dtype=np.float64)

    def traj_input_msg(self) -> np.ndarray:
        return self.u.reshape(-1)


def _mapping_matrices(K: int, h: float):
    """P (p = P u + p_start), V (v = V u), J (jerk = J u) for one
    agent-axis chain of K steps (build_mapping_mtx)."""
    P = np.zeros((K, K))
    V = np.zeros((K, K))
    J = np.zeros((K, K))
    for k in range(K):
        for j in range(k):
            P[k, j] = 0.5 * h * h * (2 * (k - j) - 1)
            V[k, j] = h
        if k != 0:
            J[k, k] = 1.0 / h
            J[k, k - 1] = -1.0 / h
    return P, V, J


def plan_scp(
    mission: Mission,
    param: Param,
    *,
    horizon: float = 34.0,
    p_max: float = 5.0,
    v_max: float = 10.0,
    a_max: float = 10.0,
    j_max: float = 10.0,
    epsilon: float = 0.01,
    max_scp_iter: int = 20,
    settings: dense.DenseSettings | None = None,
    device=None,
) -> SCPResult:
    """The SCP plan of ``mission``, each QP solved on ``device`` (None =
    the card; raises without one: pass ``device="cpu"`` for the CPU) in
    ``param.solver_dtype``."""
    h = param.time_step
    K = int(round(horizon / h)) + 1
    N = mission.qn
    nx = 3 * N * K
    dtype = np.float64 if param.solver_dtype == "float64" else np.float32
    if settings is None:
        settings = dense.DenseSettings(max_iter=param.solver_max_iter)

    Pm, Vm, Jm = _mapping_matrices(K, h)

    # block layout: x[dim*N*K + qi*K + k]
    def blockdiag(Mk):
        out = np.zeros((nx, nx))
        for b in range(3 * N):
            out[b * K:(b + 1) * K, b * K:(b + 1) * K] = Mk
        return out

    Pfull = blockdiag(Pm)
    Vfull = blockdiag(Vm)
    Jfull = blockdiag(Jm)
    p_start = np.repeat(np.asarray(mission.start, np.float64)[:, :3].T,
                        K, axis=1).reshape(nx)
    p_goal = np.asarray(mission.goal, np.float64)[:, :3].T.reshape(3 * N)

    # equality rows: u_0 = 0, final pos = goal, final vel = 0, u_{K-1} = 0
    rows = np.arange(3 * N)
    pick0 = np.zeros((3 * N, nx))
    pickK = np.zeros((3 * N, nx))
    pick0[rows, rows * K] = 1.0
    pickK[rows, rows * K + K - 1] = 1.0
    A_eq = np.concatenate([pick0, pickK @ Pfull, pickK @ Vfull, pickK])
    b_eq = np.concatenate([np.zeros(3 * N), p_goal - pickK @ p_start,
                           np.zeros(3 * N), np.zeros(3 * N)])

    # dynamics rows (two-sided): P, V, A, J with box limits
    A_dyn = np.concatenate([Pfull, Vfull, np.eye(nx), Jfull])
    l_dyn = np.concatenate([
        -p_max - p_start, -np.full(nx, v_max), -np.full(nx, a_max),
        -np.full(nx, j_max)])
    u_dyn = np.concatenate([
        p_max - p_start, np.full(nx, v_max), np.full(nx, a_max),
        np.full(nx, j_max)])

    # collision rows: fixed allocation, inactive until the first SCP update
    n_pairs = N * (N - 1) // 2
    n_col = n_pairs * K

    def stack(Acol, lcol):
        A = np.concatenate([A_eq, A_dyn, Acol]).astype(dtype)
        l = np.concatenate([b_eq, l_dyn, lcol]).astype(dtype)
        u = np.concatenate([b_eq, u_dyn, np.full(n_col, BIG)]).astype(dtype)
        is_eq = np.zeros(len(l), dtype=bool)
        is_eq[:len(b_eq)] = True
        return A, l, u, is_eq

    Q = np.eye(nx, dtype=dtype)
    iu, ju = np.triu_indices(N, k=1)
    R = mission.radius[iu] + mission.radius[ju]  # [P]
    ps0 = p_start.reshape(3, N, K)[:, :, 0]       # [3, N]
    pairs = np.arange(n_pairs)

    def collision_rows(u_prev: np.ndarray):
        """Linearized pairwise-distance constraints around the previous
        solution (update_ineq_const, scp_planner.hpp:253-291): row
        p*K + k holds eta . (p_i - p_j)_new >= R as an l-bound, eta the
        unit direction between the pair's previous positions at step k."""
        p_prev = (Pfull @ u_prev + p_start).reshape(3, N, K)
        rel = p_prev[:, iu, :] - p_prev[:, ju, :]  # [3, P, K]
        dist = np.linalg.norm(rel, axis=0)  # [P, K]
        eta = rel / np.maximum(dist, 1e-12)  # [3, P, K]
        # [P, K, 3, K]: row (p, k), column block (dim, agent) holds
        # eta[dim, p, k] * Pm[k] for agent i and its negative for j
        blk = eta.transpose(1, 2, 0)[..., None] * Pm[None, :, None, :]
        A5 = np.zeros((n_pairs, K, 3, N, K))
        A5[pairs, :, :, iu, :] = blk
        A5[pairs, :, :, ju, :] = -blk
        terms = eta * (ps0[:, iu] - ps0[:, ju])[:, :, None]  # [3, P, K]
        const = terms[0] + terms[1] + terms[2]
        return A5.reshape(n_col, nx), (R[:, None] - const).reshape(n_col)

    u_prev = np.zeros(nx)
    Acol = np.zeros((n_col, nx))
    lcol = np.full(n_col, -BIG)
    cost_total, cost_prev = 1e9, 0.0  # SP_INFINITY (sp_const.hpp:6)
    it = 0
    infos = []
    while abs(cost_total - cost_prev) > epsilon * cost_total and it < max_scp_iter:
        A, l, ub, is_eq = stack(Acol, lcol)
        x, info = dense.solve_dense(Q, None, A, l, ub, settings, is_eq,
                                    u_prev.astype(dtype), device=device)
        u_prev = x.cpu().numpy().astype(np.float64)
        cost_prev = cost_total
        cost_total = float(info.obj)
        infos.append(info)
        it += 1
        Acol, lcol = collision_rows(u_prev)

    u = u_prev.reshape(3, N, K)
    pos = (Pfull @ u_prev + p_start).reshape(3, N, K)
    vel = (Vfull @ u_prev).reshape(3, N, K)
    return SCPResult(u=u, pos=pos, vel=vel, h=h, K=K, cost=cost_total,
                     iterations=it, infos=infos)
