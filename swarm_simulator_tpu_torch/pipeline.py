"""End-to-end RBP planning pipeline (PyTorch port).

  occupancy world -> ESDF -> ECBS initial paths -> SFC/RSFC (or flat)
  corridors -> QP on the device: the batched ADMM of sequential batch
  planning (``Param.solver="admm"``, the default) or the joint knot-state
  ADMM (``"nullspace"``) -> time scaling -> coefficients + metrics
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .core.device import default_device  # noqa: F401
from .core.device import resolve_device as _resolve_device
from .core.types import Mission, Param, PlanResult
from .corridor.times import build_corridors
from .eval import safety, sample
from .parallel import seqbatch
from .qp import admm, joint, timescale
from .search.planner import plan_initial_trajectories
from .world.esdf import ESDF
from .world.voxel import OccupancyGrid


@dataclass
class StageTimes:
    esdf: float = 0.0
    init_traj: float = 0.0
    corridor: float = 0.0
    qp: float = 0.0
    timescale: float = 0.0
    total: float = 0.0
    extra: dict = field(default_factory=dict)


def plan(
    mission: Mission,
    param: Param,
    world: OccupancyGrid | None = None,
    *,
    settings: admm.ADMMSettings | None = None,
    search_backend: str = "auto",
    ns_phases: tuple | None = None,
    device: torch.device | str | None = None,
) -> tuple[PlanResult, StageTimes]:
    """Plan the mission; the QP solve runs on ``device`` (None = the card;
    raises without one: pass ``device="cpu"`` for the CPU).  ``settings``
    overrides the ADMM settings of ``solver="admm"``."""
    device = _resolve_device(device)
    times = StageTimes()
    t_all = time.perf_counter()

    if world is None:
        world = OccupancyGrid.empty(param.world_min, param.world_max,
                                    param.world_resolution)

    t0 = time.perf_counter()
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    times.esdf = time.perf_counter() - t0

    t0 = time.perf_counter()
    result = plan_initial_trajectories(esdf, mission, param,
                                       backend=search_backend)
    times.init_traj = time.perf_counter() - t0

    t0 = time.perf_counter()
    if param.corridor_mode == "flat":
        from .corridor.flat import build_flat_corridors
        build_flat_corridors(esdf, result, mission, param)
    else:
        build_corridors(esdf, result, mission.radius, param)
    times.corridor = time.perf_counter() - t0

    t0 = time.perf_counter()
    if param.solver == "nullspace":
        joint.solve_trajectories(result, mission, param, phases=ns_phases,
                                 polish_rounds=param.polish_rounds,
                                 replan_budgets=param.replan_budgets,
                                 replan_polish=param.replan_polish,
                                 replan_prep=param.replan_prep,
                                 cold_prep=param.cold_prep,
                                 exact_polish=param.exact_polish,
                                 device=device)
        times.extra["ns_prep"] = result.solver_info["prep_s"]
    else:
        seqbatch.solve_trajectories(result, mission, param, settings,
                                    device=device)
    times.qp = time.perf_counter() - t0

    if param.time_scale:
        t0 = time.perf_counter()
        scale = timescale.compute_time_scale(
            result.coef, result.T, mission.max_vel, mission.max_acc,
            param.n, param.phi)
        result.coef, result.T = timescale.apply_time_scale(
            result.coef, result.T, scale, param.n)
        if scale != 1.0:
            result.sfc = [[(box, t * scale) for box, t in agent_sfc]
                          for agent_sfc in result.sfc]
            if result.rsfc:
                result.rsfc = {k: [(nv, t * scale) for nv, t in v]
                               for k, v in result.rsfc.items()}
        times.extra["time_scale"] = scale
        times.timescale = time.perf_counter() - t0

    times.total = time.perf_counter() - t_all
    return result, times


def evaluate(result: PlanResult, mission: Mission, param: Param,
             step: float = 0.1,
             device: torch.device | str | None = None) -> dict:
    """Acceptance metrics (RBPPublisher::plot, rbp_publisher.hpp:117-127),
    sampled in float64 on ``device`` (None = the device the plan was
    solved on, else the card)."""
    if device is None:
        device = (result.solver_info or {}).get("device")
    device = _resolve_device(device)
    ts = sample.sample_times(result.T, step)
    states = sample.sample_trajectories(
        result.coef, np.asarray(result.T), ts, n=param.n,
        device=device).cpu().numpy()
    pos, vel, acc = states[:, :, 0], states[:, :, 1], states[:, :, 2]

    ratio = (safety.safety_margin_ratio(pos, mission.radius,
                                        downwash=param.downwash,
                                        device=device)
             if mission.qn > 1 else np.inf)
    return {
        "min_safety_ratio": ratio,
        "flight_distance": safety.flight_distance(pos, device=device),
        "knot_continuity_err": safety.knot_continuity_error(
            result.coef, result.T, param.n, param.phi, device=device),
        "dynamic_violation": safety.dynamic_limit_violation(
            vel, acc, mission.max_vel, mission.max_acc),
        "start_err": float(np.max(np.abs(pos[:, 0] - mission.start[:, :3]))),
        "goal_err": float(np.max(np.abs(pos[:, -1] - mission.goal[:, :3]))),
    }
