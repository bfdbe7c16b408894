"""Joint all-agent trajectory optimization: the production path.

The whole swarm is ONE QP — every SFC box and every RSFC pair constraint
simultaneously active — solved by the knot-state ADMM over the
block-tridiagonal banded KKT (qp/nullspace.py).  The recipe:
  1. assemble the joint QP on the host (one bulk device transfer),
  2. the KKT rung inventory: host-f64 (prepare_ns_np, rounded once to the
     solver dtype) or, for cold_prep="device" and corridor replans, on
     the device in the solver dtype (prepare_ns),
  3. phased rho schedule (feasibility -> polish -> restore, or any
     other phase tuple, phase by phase: nullspace.solve_ns_phases) on the
     device the data lives on.  Host-prepped rounds run each
     check_every chunk as one launch of the fused kernel
     (ops/nsfused); device-prepped and stale rounds refine every
     w-update with PCG against the fresh operator, each KKT solve one
     launch of the Thomas kernel (ops/thomas).

Outer corridor iteration (param.iteration > 1): each replan round
rebuilds the RSFC separating planes from the previous round's solution
and re-solves warm-started from it.  exact_polish finishes every round
with the host f64 active-set polish (qp/activeset.py), and
rescue_box_batches re-solves box-stalled agent batches with the host f64
IPM (qp/ipm.py).
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import Mission, Param, PlanResult
from ..corridor.rsfc import build_rsfc
from ..ops import nsfused
from ..parallel import seqbatch
from . import activeset, assemble, convert, ipm, nullspace

#: phase budgets tuned on the canonical 64-agent forest
PRODUCTION_BUDGETS = (200, 600, 100)

#: margin-triggered escalation: when a solution's objective margin
#: against the IPM best-response oracle (eval/gate) exceeds
#: ESCALATION_TRIGGER, it is re-solved warm-started from itself with the
#: warm polish-extension budgets ESCALATION_BUDGETS (escalation_phases)
ESCALATION_TRIGGER = 1.15
ESCALATION_BUDGETS = (100, 400, 100)

#: short per-round replan budgets for big swarms (>= 128 agents),
#: explicit opt-in only through replan_budgets (the default replans with
#: the cold phases' full budgets)
REPLAN_BUDGETS_LARGE = (100, 600, 100)

#: warm polish extensions per replan round when a short replan schedule
#: is chosen for a big swarm (replan_polish None)
REPLAN_POLISH_LARGE = 0


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
    """The production joint-solver settings: banded KKT (spelled out: the
    NSSettings default is dense, as in the JAX package), 5-rung rho ladder
    logspace(1e-5, 1e-2), tighten margin for first-order residual
    infeasibility at the strict ratio >= 1 gate."""
    return nullspace.NSSettings(
        max_iter=max_iter, check_every=check_every,
        eps_abs=2e-4, eps_rel=2e-4, eps_dual_abs=5e-3, tighten=2e-3,
        warm_start="x0", kkt_mode="banded", rho_min=1e-5, rho_max=1e-2,
        n_rungs=5)


def production_phases(budgets: tuple[int, int, int] = PRODUCTION_BUDGETS,
                      base: nullspace.NSSettings | None = None,
                      kkt_refine: int = 0,
                      ) -> tuple[nullspace.NSSettings, ...]:
    """Phased rho schedule: feasibility-first (low rungs fenced out) ->
    objective polish (unfenced) -> feasibility restore (fenced high).
    kkt_refine >= 1 (device-prepped or stale inventories) refines every
    w-update against the fresh operator, through the Thomas kernel."""
    b = dataclasses.replace(
        base if base is not None else production_settings(),
        kkt_refine=kkt_refine)
    return (dataclasses.replace(b, max_iter=budgets[0], rho_lo=1e-3),
            dataclasses.replace(b, max_iter=budgets[1]),
            dataclasses.replace(b, max_iter=budgets[2], rho_lo=1e-2))


def rescue_box_batches(plan, mission, param, ctrl, tol: float = 1e-3):
    """f64 IPM best-response rescue for box-stalled agents.

    SFC boxes can be degenerate (a 1-cell corridor minus the agent
    clearance collapses to a zero-width slot).  The instance stays
    feasible, and CPLEX/IPM solve it exactly (rbp_planner.hpp:158), but
    first-order ADMM converges sublinearly against a measure-zero face.
    The fallback is the reference's own sequential-batch architecture:
    find agents violating their boxes beyond ``tol``, re-solve only their
    batches' best-response QPs with the exact host f64 interior-point
    solver (everyone else fixed at ``ctrl``: the one-sided pair rows of
    rbp_planner.hpp:638-684), splice, and let the caller re-gate.

    Returns (ctrl, rescued_batch_indices)."""
    boxes = np.asarray(plan.seg_boxes)
    dm = np.asarray(ctrl, np.float64)
    viol = np.maximum(boxes[:, :, None, :3] - dm,
                      dm - boxes[:, :, None, 3:]).max(axis=(1, 2, 3))
    bad = np.where(viol > tol)[0]
    if bad.size == 0:
        return dm, []
    batches, _ = seqbatch.make_batches(mission.qn, param)
    bad_b = sorted({i for i, b in enumerate(batches)
                    if np.intersect1d(np.asarray(b), bad).size})
    out = dm.copy()
    for bi in bad_b:
        agents = np.asarray(batches[bi])
        data_b = assemble.host_f64(assemble.assemble_batch(
            plan, mission, param, agents, out))
        # relax zero-width duplicated knot rows by 5e-4 (the IPM needs
        # positive slack on every inequality; the residual face excursion
        # stays under the 1e-3 gate bound).  No other row is relaxed or
        # tightened: a blanket lb+t/ub-t collides with the equality-pinned
        # endpoints sitting on box faces and the IPM diverges
        lb_r, ub_r = assemble.relax_thin_knot_rows(data_b.lb, data_b.ub,
                                                   param.n)
        data_b = dataclasses.replace(data_b, lb=lb_r, ub=ub_r)
        res = ipm.solve_ipm_reduced(data_b)
        ipm.verify_optimal(data_b, res, tol=1e-5)
        out[agents] = convert.x_to_ctrl(res.x, plan.M, param.n)
    return out, bad_b


def select_kkt_path(phases, qn: int, M: int, n_pairs: int, phi: int,
                    device, limits: nsfused.CardLimits | None = None):
    """The KKT route of a host-prepped banded solve on ``device``: phases
    that would run each chunk through the fused kernel K1 (banded,
    kkt_refine 0) keep it where K1 holds the problem
    (ops/nsfused.fits: its ring plan in the block's shared memory, its
    grid, its indices), and otherwise all take thomas_kernel=True: each
    w-update one solve of the streaming Thomas kernel K2 at kkt_refine 0
    (the JAX package's route past its fused kernel's VMEM bound).  Where
    K1 fits it is kept (PERF.md times both routes at 96 agents on an
    H100).  Schedules on the CPU (the plain twins), and
    schedules that take no K1 chunk (dense, kkt_refine >= 1, already
    routed), pass through untouched.  ``limits``: the card's
    (ops/nsfused.CardLimits; None = queried from ``device``)."""
    device = torch.device(device)
    if device.type == "cpu" or not any(
            p.kkt_mode == "banded" and not p.kkt_refine
            and not p.thomas_kernel for p in phases):
        return phases
    if nsfused.fits(qn, M, n_pairs, limits or device, phi):
        return phases
    return tuple(dataclasses.replace(p, thomas_kernel=True) for p in phases)


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


def solve_trajectories(plan: PlanResult, mission: Mission, param: Param,
                       phases: tuple[nullspace.NSSettings, ...] | None = None,
                       replan_budgets: tuple[int, int, int] | None = None,
                       replan_polish: int | None = None,
                       replan_prep: str | None = None,
                       cold_prep: str = "host",
                       dummy: np.ndarray | None = None,
                       polish_rounds: int | None = None,
                       exact_polish: bool = False,
                       device: torch.device | str | None = None,
                       ) -> PlanResult:
    """Pipeline entry for Param.solver == "nullspace": fills plan.ctrl /
    plan.coef / plan.solver_info.  The QP and the operator move to
    ``device`` (None = the card; raises without one: pass
    ``device="cpu"`` for the CPU); the solve runs there.

    polish_rounds None = auto (polish_rounds_for_swarm).  > 0 runs warm
    polish extensions after the cold solve with x0 <- the previous
    solution on the same device-resident operator.

    param.iteration > 1 runs corridor replans: each extra round rebuilds
    the RSFC planes from the previous round's solution and re-solves
    warm-started from it, with replan_budgets (None = the cold phases'
    budgets) and replan_polish warm extensions per round.

    replan_prep, how a replan round gets its rung inventory:
      "device"  prepare_ns on the device in the solver dtype, with
                kkt_refine=1 phases (PCG against the fresh operator);
      "fresh"   the host-f64 prep again (kkt_refine=0, the fused kernel);
      "stale"   the round-0 host inventory with refreshed endpoint leaves
                (refresh_ns_op_np) and kkt_refine=1; only for small
                corridor changes;
      None      auto: "device" when ``device`` is not the CPU, else
                "fresh".
    cold_prep, the round-0 inventory: "host" (host f64) or "device"
    (prepare_ns + kkt_refine=1 phases, the low-latency first plan; the
    route of big swarms, whose host prep takes minutes).  Device-prepped
    rounds keep kkt_refine=1 in their warm polish extensions too, and
    take ``precond_dtype`` from ``phases`` (bf16 pivots need the refine).

    dummy: the warm start and x0 seed (None = the initTraj midpoint
    interpolation).

    exact_polish: finish every round (the cold solve after its warm polish
    extensions, and each replan round) with the host f64 active-set polish
    (qp/activeset.polish_ctrl): the exact QP optimum when its KKT
    certificate holds, else the best feasible improvement, else the round's
    solution unchanged.  solver_info["exact_polish"] holds the last
    round's diagnostics, ["exact_polish_rounds"] every round's, in order."""
    device = resolve_device(device)
    if polish_rounds is None:
        polish_rounds = polish_rounds_for_swarm(mission.qn)
    if phases is None:
        phases = production_phases()
    if replan_prep is None:
        replan_prep = "device" if device.type != "cpu" else "fresh"
    if replan_prep not in ("fresh", "stale", "device"):
        raise ValueError(f"replan_prep: unknown mode {replan_prep!r}")
    if cold_prep not in ("host", "device"):
        raise ValueError(f"cold_prep: unknown mode {cold_prep!r}")
    if cold_prep == "device" and replan_prep == "stale":
        raise ValueError("replan_prep='stale' needs the host-resident "
                         "round-0 operator (cold_prep='host')")
    n, M, N = param.n, plan.M, mission.qn

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    phases = select_kkt_path(phases, N, M, len(np.asarray(plan.pair_idx)),
                             param.phi, device)
    data, _ = assemble_joint(plan, mission, param, dummy=dummy)
    op = None
    t0 = time.perf_counter()
    if cold_prep == "device":
        phases = production_phases(tuple(p.max_iter for p in phases),
                                   base=phases[1], kkt_refine=1)
        op_dev = nullspace.prepare_ns(data.to(device), phases[0])
        sync()
    else:
        op = nullspace.prepare_ns_np(data, phases[0])   # host f64, once
        op_dev = op.to(device)      # pivot inventory uploaded ONCE
    prep_s = time.perf_counter() - t0
    inv = op_dev.Dinvs if op_dev.Dinvs is not None else op_dev.Kinvs
    inventory_bytes = inv.numel() * inv.element_size()

    def run(data_h, op_d, ph):
        t0 = time.perf_counter()
        x, info = nullspace.solve_ns_phases(data_h, ph, op=op_d,
                                            device=device)
        ctrl = convert.x_to_ctrl(x.double().cpu().numpy(), M, n)
        return ctrl, info, time.perf_counter() - t0

    def with_x0(data_h, ctrl):
        x0 = ctrl.reshape(N, M * (n + 1), 3).transpose(0, 2, 1)
        return dataclasses.replace(
            data_h, x0=np.asarray(x0, np.asarray(data_h.x0).dtype))

    as_rounds = []

    def run_exact_polish(data_h, ctrl_in):
        ctrl_out, ainfo = activeset.polish_ctrl(data_h, ctrl_in)
        as_rounds.append({k: ainfo.get(k) for k in (
            "accepted", "kkt_optimal", "passes", "n_active", "obj_in",
            "obj_out", "worst_slack_out", "pinned_box_viol", "t_s")})
        return np.asarray(ctrl_out, np.float64)

    ctrl, info, solve_s = run(data, op_dev, phases)

    polish_s = 0.0
    if polish_rounds:
        pphases = escalation_phases(phases)
        for _ in range(polish_rounds):
            ctrl, info, dt = run(with_x0(data, ctrl), op_dev, pphases)
            polish_s += dt
    if exact_polish:
        ctrl = run_exact_polish(data, ctrl)

    replan_prep_s, replan_solve_s, replan_iters = [], [], []
    if param.iteration > 1:
        rb = (tuple(replan_budgets) if replan_budgets is not None
              else tuple(p.max_iter for p in phases))
        short = (replan_budgets is not None
                 and sum(rb) < sum(p.max_iter for p in phases))
        rphases = production_phases(
            rb, base=phases[1],
            kkt_refine=1 if (replan_prep in ("stale", "device")
                             or (short and N >= 128)) else 0)
        rp_polish = (replan_polish if replan_polish is not None
                     else (REPLAN_POLISH_LARGE if N >= 128 and short
                           else 0))
        rpol_phases = escalation_phases(rphases) if rp_polish else None
        for _ in range(param.iteration - 1):
            knots = np.concatenate(
                [ctrl[:, :, 0, :], ctrl[:, -1:, -1, :]], axis=1)
            try:
                pair_idx, normals = build_rsfc(knots, param.downwash,
                                               device)
            except ValueError:
                # a residually-colliding pair leaves no separating plane:
                # keep the best solved round
                break
            if not np.array_equal(pair_idx, np.asarray(plan.pair_idx)):
                raise RuntimeError("replan changed the pair list")
            plan.pair_normals = np.asarray(normals, np.float64)
            data, _ = assemble_joint(plan, mission, param, dummy=ctrl)
            t0 = time.perf_counter()
            if replan_prep == "stale":
                # only the endpoint leaves change; the inventory stays on
                # the device
                op = nullspace.refresh_ns_op_np(op, data)
                op_dev = op_dev._replace(
                    x_pin=torch.as_tensor(op.x_pin, device=device),
                    g=torch.as_tensor(op.g, device=device))
            else:
                # free the previous round's inventory before the new one
                # is built (two at once may not fit for big swarms)
                op_dev = None
                if replan_prep == "device":
                    op_dev = nullspace.prepare_ns(data.to(device),
                                                  rphases[0])
                else:
                    op = nullspace.prepare_ns_np(data, rphases[0])
                    op_dev = op.to(device)
                sync()
            replan_prep_s.append(time.perf_counter() - t0)
            if replan_prep != "stale":
                prep_s += replan_prep_s[-1]
            ctrl, info, dt = run(data, op_dev, rphases)
            for _ in range(rp_polish):
                data = with_x0(data, ctrl)
                ctrl, info, dt_p = run(data, op_dev, rpol_phases)
                dt += dt_p
            replan_solve_s.append(dt)
            replan_iters.append(int(info.iters))
            if exact_polish:
                ctrl = run_exact_polish(data, ctrl)

    plan.ctrl = ctrl
    plan.coef = convert.ctrl_to_coef(ctrl, plan.T, n)
    D = M * (n + 1)
    n_pairs = len(np.asarray(plan.pair_idx))
    problem_size = (f"x size={3 * N * D}, eq const size="
                    f"{3 * N * (M + 1) * param.phi}, ineq const size="
                    f"{2 * 3 * N * D + n_pairs * D}")
    if param.log:
        print(problem_size)
        Path("log").mkdir(exist_ok=True)
        assemble.export_qp_npz("log/qp_joint.npz", data)
    plan.solver_info = {
        "iters": [int(info.iters)],
        "r_prim": [float(info.r_prim)],
        "r_dual": [float(info.r_dual)],
        "obj": [float(info.obj)],
        "mode": "joint-nullspace",
        "device": str(device),
        "solved": np.ones(N, dtype=bool),
        "prep_s": prep_s,
        "inventory_bytes": inventory_bytes,
        "solve_s": solve_s,
        "polish_rounds": polish_rounds,
        "polish_s": polish_s,
        "replan_prep": replan_prep,
        "replan_rounds": len(replan_iters),
        "replan_prep_s": replan_prep_s,
        "replan_solve_s": replan_solve_s,
        "replan_iters": replan_iters,
        "problem_size": problem_size,
    }
    if exact_polish:
        plan.solver_info["exact_polish"] = as_rounds[-1]
        plan.solver_info["exact_polish_rounds"] = as_rounds
    return plan
