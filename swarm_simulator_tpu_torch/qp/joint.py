"""Joint all-agent trajectory optimization: the production path.

The whole swarm is ONE QP — every SFC box and every RSFC pair constraint
simultaneously active — solved by the knot-state ADMM over the
block-tridiagonal banded KKT (qp/nullspace.py).  The recipe:
  1. assemble the joint QP on the host (one bulk device transfer),
  2. host-f64 KKT rung inventory (prepare_ns_np), rounded once to the
     solver dtype,
  3. phased rho schedule (feasibility -> polish -> restore) on the
     device the data lives on; every check_every chunk goes through
     ops/nsfused.nsfused_chunk, one launch of the fused kernel on CUDA.

This port covers the cold solve (cold_prep="host", one outer iteration,
automatic polish rounds).  The modes that need code not yet ported raise
NotImplementedError naming the ROADMAP queue item that ports them.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.types import Mission, Param, PlanResult
from . import assemble, convert, nullspace

#: phase budgets tuned on the canonical 64-agent forest
PRODUCTION_BUDGETS = (200, 600, 100)

#: warm polish-extension budgets (escalation_phases)
ESCALATION_BUDGETS = (100, 400, 100)


def polish_rounds_for_swarm(qn: int) -> int:
    """Default warm polish extensions after the cold solve: 4 for swarms
    of >= 128 agents, none below."""
    return 4 if qn >= 128 else 0


def escalation_phases(base_phases) -> tuple:
    """Warm polish-extension schedule derived from ``base_phases``:
    ESCALATION_BUDGETS, warm_start='x0' (callers set data.x0 to the
    solution being escalated)."""
    b = dataclasses.replace(base_phases[1], warm_start="x0")
    return tuple(
        dataclasses.replace(b, max_iter=mi, rho_lo=lo)
        for mi, lo in zip(ESCALATION_BUDGETS, (1e-3, None, 1e-2)))


def production_settings(max_iter: int = 1500,
                        check_every: int = 50) -> nullspace.NSSettings:
    """The production joint-solver settings: banded KKT, 5-rung rho ladder
    logspace(1e-5, 1e-2), tighten margin for first-order residual
    infeasibility at the strict ratio >= 1 gate."""
    return nullspace.NSSettings(
        max_iter=max_iter, check_every=check_every,
        eps_abs=2e-4, eps_rel=2e-4, eps_dual_abs=5e-3, tighten=2e-3,
        warm_start="x0", rho_min=1e-5, rho_max=1e-2, n_rungs=5)


def production_phases(budgets: tuple[int, int, int] = PRODUCTION_BUDGETS,
                      base: nullspace.NSSettings | None = None,
                      ) -> tuple[nullspace.NSSettings, ...]:
    """Phased rho schedule: feasibility-first (low rungs fenced out) ->
    objective polish (unfenced) -> feasibility restore (fenced high)."""
    b = base if base is not None else production_settings()
    return (dataclasses.replace(b, max_iter=budgets[0], rho_lo=1e-3),
            dataclasses.replace(b, max_iter=budgets[1]),
            dataclasses.replace(b, max_iter=budgets[2], rho_lo=1e-2))


def rescue_box_batches(plan, mission, param, ctrl, tol: float = 1e-3):
    """The f64 interior-point best-response rescue of box-stalled agents
    needs the host IPM oracle, which is not ported yet."""
    raise NotImplementedError(
        "rescue_box_batches (the f64 IPM box rescue) is not ported "
        "(ROADMAP queue 1, item 9)")


def assemble_joint(plan: PlanResult, mission: Mission, param: Param,
                   dummy: np.ndarray | None = None):
    """The joint all-agent QP as host numpy.  dummy (the warm start,
    build_dummy's initTraj midpoint interpolation by default —
    rbp_planner.hpp:513-549) also seeds x0."""
    if dummy is None:
        dummy = assemble.build_dummy(plan.init_traj, param.n, plan.M)
    data = assemble.assemble_batch(plan, mission, param,
                                   np.arange(mission.qn), dummy)
    return data, dummy


def _run_schedule(data_dev, op_dev, phases):
    sched = nullspace.schedule_arrays(phases)
    if sched is None:
        raise NotImplementedError(
            "phase tuples that differ in more than max_iter/rho_lo/rho_hi "
            "(the per-phase solve) are not ported (ROADMAP queue 1, item 4)")
    s0, it_k, lo_k, hi_k = sched
    return nullspace.solve_ns_schedule(data_dev, op_dev, s0, it_k, lo_k,
                                       hi_k)


def solve_trajectories(plan: PlanResult, mission: Mission, param: Param,
                       phases: tuple[nullspace.NSSettings, ...] | None = None,
                       replan_prep: str | None = None,
                       cold_prep: str = "host",
                       polish_rounds: int | None = None,
                       exact_polish: bool = False,
                       device: torch.device | str = "cpu",
                       ) -> PlanResult:
    """Pipeline entry for Param.solver == "nullspace": fills plan.ctrl /
    plan.coef / plan.solver_info.  The QP and the operator move to
    ``device`` once; the solve runs there.

    polish_rounds None = auto (polish_rounds_for_swarm).  > 0 runs warm
    polish extensions after the cold solve with x0 <- the previous
    solution on the same device-resident operator."""
    device = torch.device(device)
    if cold_prep != "host":
        raise NotImplementedError(
            f"cold_prep={cold_prep!r}: the device-side prep is not ported "
            "(ROADMAP queue 1, item 8)")
    if replan_prep not in (None, "fresh"):
        raise NotImplementedError(
            f"replan_prep={replan_prep!r}: device/stale replans are not "
            "ported (ROADMAP queue 1, item 8)")
    if param.iteration > 1:
        raise NotImplementedError(
            "iteration > 1 (corridor replans) is not ported "
            "(ROADMAP queue 1, item 8)")
    if exact_polish:
        raise NotImplementedError(
            "exact_polish (the host active-set polish) is not ported "
            "(ROADMAP queue 1, item 9)")
    if polish_rounds is None:
        polish_rounds = polish_rounds_for_swarm(mission.qn)
    if phases is None:
        phases = production_phases()
    n, M, N = param.n, plan.M, mission.qn

    data, _ = assemble_joint(plan, mission, param)
    t0 = time.perf_counter()
    op = nullspace.prepare_ns_np(data, phases[0])   # host f64, once
    prep_s = time.perf_counter() - t0
    data_dev = data.to(device)
    op_dev = op.to(device)          # pivot inventory uploaded ONCE

    t0 = time.perf_counter()
    x, info = _run_schedule(data_dev, op_dev, phases)
    ctrl = convert.x_to_ctrl(x.double().cpu().numpy(), M, n)
    solve_s = time.perf_counter() - t0

    polish_s = 0.0
    if polish_rounds:
        pphases = escalation_phases(phases)
        for _ in range(polish_rounds):
            t0 = time.perf_counter()
            x0n = torch.as_tensor(
                ctrl.reshape(N, M * (n + 1), 3).transpose(0, 2, 1),
                dtype=data_dev.x0.dtype, device=device)
            data_dev = dataclasses.replace(data_dev, x0=x0n)
            x, info = _run_schedule(data_dev, op_dev, pphases)
            ctrl = convert.x_to_ctrl(x.double().cpu().numpy(), M, n)
            polish_s += time.perf_counter() - t0

    plan.ctrl = ctrl
    plan.coef = convert.ctrl_to_coef(ctrl, plan.T, n)
    D = M * (n + 1)
    n_pairs = len(np.asarray(plan.pair_idx))
    plan.solver_info = {
        "iters": [int(info.iters)],
        "r_prim": [float(info.r_prim)],
        "r_dual": [float(info.r_dual)],
        "obj": [float(info.obj)],
        "mode": "joint-nullspace",
        "device": str(device),
        "solved": np.ones(N, dtype=bool),
        "prep_s": prep_s,
        "solve_s": solve_s,
        "polish_rounds": polish_rounds,
        "polish_s": polish_s,
        "replan_rounds": 0,
        "problem_size": (f"x size={3 * N * D}, eq const size="
                         f"{3 * N * (M + 1) * param.phi}, ineq const size="
                         f"{2 * 3 * N * D + n_pairs * D}"),
    }
    return plan
