"""Core data model: Mission, Param, GridSpec, PlanResult.

These mirror the reference's data model (swarm_planner/include/mission.hpp,
param.hpp, sp_const.hpp:16-28) as array-backed dataclasses: PlanResult
carries dense host arrays instead of nested std::vector structures.  A
numpy copy of swarm_simulator_tpu/core/types.py, so that the PyTorch port
never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np


@dataclass
class Mission:
    """Per-agent mission description (mission.hpp:11-17).

    start/goal are 9-dof states [pos(3), vel(3), acc(3)].
    """

    start: np.ndarray  # [N, 9]
    goal: np.ndarray  # [N, 9]
    radius: np.ndarray  # [N]
    speed: np.ndarray  # [N]
    max_vel: np.ndarray  # [N, 3]
    max_acc: np.ndarray  # [N, 3]
    names: list[str] = field(default_factory=list)

    @property
    def qn(self) -> int:
        return int(self.start.shape[0])

    def apply_noise(self, max_noise: float, seed: int) -> "Mission":
        """Seeded version of mission.hpp:90-98 (reference is unseeded)."""
        rng = np.random.default_rng(seed)
        start = self.start.copy()
        goal = self.goal.copy()
        # reference: rand()/RAND_MAX * max_noise added to xyz of both states
        start[:, :3] += rng.random((self.qn, 3)) * max_noise
        goal[:, :3] += rng.random((self.qn, 3)) * max_noise
        return dataclasses.replace(self, start=start, goal=goal)


@dataclass(frozen=True)
class Param:
    """Planner knobs with the reference defaults (param.hpp:44-75)."""

    log: bool = False

    world_x_min: float = -5.0
    world_y_min: float = -5.0
    world_z_min: float = 0.0
    world_x_max: float = 5.0
    world_y_max: float = 5.0
    world_z_max: float = 2.5

    ecbs_w: float = 1.3
    grid_xy_res: float = 0.3
    grid_z_res: float = 0.6
    grid_margin: float = 0.2

    box_xy_res: float = 0.1
    box_z_res: float = 0.1

    time_scale: bool = True
    time_step: float = 1.0
    downwash: float = 2.0
    n: int = 5
    phi: int = 3
    sequential: bool = False
    batch_size: int = 4
    batch_iter: int = 0
    iteration: int = 1

    # --- TPU-framework extensions (no reference counterpart) ---
    world_resolution: float = 0.1  # occupancy voxel size (octomap res)
    esdf_max_dist: float = 1.0  # EDT clamp (swarm_traj_planner_rbp.cpp:75)
    corridor_mode: str = "rbp"  # "rbp" | "flat" (update_flat_box variant)
    solver_dtype: str = "float32"  # "float32" on TPU, "float64" for parity
    solver_kkt: str = "auto"  # "auto" | "dense" | "cg" (see qp/admm.py)
    solver_max_iter: int = 2000
    solver_eps_abs: float = 1e-4
    solver_eps_rel: float = 1e-4
    # separate absolute dual tolerance (see qp/admm.ADMMSettings); the
    # acceptance metrics are primal — None uses solver_eps_abs
    solver_eps_dual: Optional[float] = None
    solver_adaptive_rho: bool = False
    parallel_mode: str = "gauss-seidel"  # or "jacobi" (batches in parallel)
    # "admm": per-batch ADMM / device sweeps (parallel/seqbatch.py).
    # "nullspace": the production JOINT path — whole-swarm QP via the
    # knot-state banded-KKT ADMM (qp/joint.py); ignores sequential/
    # batch_size, honors iteration as outer corridor replans
    solver: str = "admm"
    # joint-path prep modes (qp/joint.py solve_trajectories):
    #   cold_prep: "host" (f64 prep, max polish + fused warm cycles) |
    #              "device" (low time-to-first-plan)
    #   replan_prep: None = auto ("device" on accelerators, "fresh" on
    #              CPU) | "fresh" | "device" | "stale"
    cold_prep: str = "host"
    replan_prep: Optional[str] = None
    #   replan_budgets: per-round phase budgets for corridor replans
    #   (None = the cold phases' FULL budgets — the production
    #   default; short schedules are explicit opt-in, see
    #   qp/joint.REPLAN_BUDGETS_LARGE and the measured frontier in
    #   benchmarks/replan256_chain_tpu.json)
    replan_budgets: Optional[tuple] = None
    #   replan_polish: warm polish extensions after each replan round
    #   (None = auto, qp/joint.REPLAN_POLISH_LARGE for short-budget
    #   big swarms)
    replan_polish: Optional[int] = None
    #   polish_rounds: warm polish extensions after the cold solve
    #   (qp/joint ESCALATION_BUDGETS; x0-only updates on the resident
    #   operator) — how big swarms reach the 64-agent objective-margin
    #   standard (benchmarks/oracle256_polish_tpu.json).  None = auto:
    #   qp/joint.polish_rounds_for_swarm (4 for >= 128 agents, else 0)
    polish_rounds: Optional[int] = None
    #   exact_polish: host-f64 active-set polish of the final solution
    #   of every joint solve/replan round (qp/activeset.py) — one
    #   sparse KKT factorization on the ADMM-identified active set,
    #   returning the KKT-certified exact optimum (CPLEX parity,
    #   rbp_planner.hpp:158) when the certificate holds
    exact_polish: bool = False

    @property
    def world_min(self) -> np.ndarray:
        return np.array([self.world_x_min, self.world_y_min, self.world_z_min])

    @property
    def world_max(self) -> np.ndarray:
        return np.array([self.world_x_max, self.world_y_max, self.world_z_max])


@dataclass(frozen=True)
class GridSpec:
    """Discrete MAPF grid derived from the world AABB.

    Mirrors InitTrajPlanner's constructor (init_traj_planner.hpp:13-30):
    grid min/max are the world bounds snapped inward to grid resolution.
    """

    x_min: float
    y_min: float
    z_min: float
    x_max: float
    y_max: float
    z_max: float
    dimx: int
    dimy: int
    dimz: int
    xy_res: float
    z_res: float

    @classmethod
    def from_param(cls, param: Param) -> "GridSpec":
        eps = 1e-9  # SP_EPSILON (sp_const.hpp:4)
        gx0 = np.ceil((param.world_x_min - eps) / param.grid_xy_res) * param.grid_xy_res
        gy0 = np.ceil((param.world_y_min - eps) / param.grid_xy_res) * param.grid_xy_res
        gz0 = np.ceil((param.world_z_min - eps) / param.grid_z_res) * param.grid_z_res
        gx1 = np.floor((param.world_x_max + eps) / param.grid_xy_res) * param.grid_xy_res
        gy1 = np.floor((param.world_y_max + eps) / param.grid_xy_res) * param.grid_xy_res
        gz1 = np.floor((param.world_z_max + eps) / param.grid_z_res) * param.grid_z_res
        dimx = int(round((gx1 - gx0) / param.grid_xy_res)) + 1
        dimy = int(round((gy1 - gy0) / param.grid_xy_res)) + 1
        dimz = int(round((gz1 - gz0) / param.grid_z_res)) + 1
        return cls(gx0, gy0, gz0, gx1, gy1, gz1, dimx, dimy, dimz,
                   param.grid_xy_res, param.grid_z_res)

    def world_to_grid(self, pts: np.ndarray) -> np.ndarray:
        """Snap world xyz to nearest grid indices (ecbs_planner.hpp:112-136)."""
        pts = np.asarray(pts, dtype=np.float64)
        res = np.array([self.xy_res, self.xy_res, self.z_res])
        origin = np.array([self.x_min, self.y_min, self.z_min])
        return np.round((pts - origin) / res).astype(np.int64)

    def grid_to_world(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, dtype=np.float64)
        res = np.array([self.xy_res, self.xy_res, self.z_res])
        origin = np.array([self.x_min, self.y_min, self.z_min])
        return idx * res + origin


@dataclass
class PlanResult:
    """Pipeline interchange struct (sp_const.hpp:21-28), array-backed.

    init_traj : [N, M+1, 3]  discrete waypoints, one per knot time
    T         : [M+1]        global segment knot times T_0..T_M
    sfc       : per-agent list of (box[6] = [xmin ymin zmin xmax ymax zmax],
                end_time) pairs — raw, variable length
    rsfc      : dict {(qi, qj): list of (normal[3], end_time)} for qi < qj
    coef      : [N, M, n+1, 3] descending-power polynomial coefficients
    """

    init_traj: Optional[np.ndarray] = None
    T: Optional[np.ndarray] = None
    sfc: Optional[list] = None
    rsfc: Optional[dict] = None
    coef: Optional[np.ndarray] = None
    # Bernstein control points of the solved trajectories (the solver's
    # native output; coef is their power-basis conversion)
    ctrl: Optional[np.ndarray] = None  # [N, M, n+1, 3]
    # dense per-segment forms consumed by the QP (built by corridor.times)
    seg_boxes: Optional[np.ndarray] = None  # [N, M, 6]
    pair_normals: Optional[np.ndarray] = None  # [P, M, 3]
    pair_idx: Optional[np.ndarray] = None  # [P, 2] (qi, qj) with qi < qj
    solver_info: Optional[dict[str, Any]] = None

    @property
    def M(self) -> int:
        return int(len(self.T) - 1)

    def traj_info_msg(self, n: int) -> np.ndarray:
        """Flattened [N, n, T_0..T_M] (rbp_planner.hpp:269-274)."""
        N = self.init_traj.shape[0]
        return np.concatenate([[N, n], np.asarray(self.T, dtype=np.float64)])

    def traj_coef_msgs(self) -> list[np.ndarray]:
        """Per-agent [M(n+1), 3] coefficient matrices (rbp_planner.hpp:276-290)."""
        N, M, npp, _ = self.coef.shape
        return [self.coef[qi].reshape(M * npp, 3) for qi in range(N)]
