"""Monte-Carlo scenario batching: the framework's scenario axis.

The reference's closest analog is the 50-map benchmark sweep
(swarm_traj_planner_rbp_test_all.cpp:49-103), which runs scenarios one at
a time.  Here many scenarios (map seeds x missions) run as one batch:

  host prep (ESDF + ECBS + corridors) ........ thread pool: the native
      C++ calls release the GIL, so scenarios prep in parallel
  QP solves .................................. scenarios bucketed by
      segment count M and agent count (shapes must match), each bucket's
      (scenario, agent group) problems folded into one leading axis and
      solved as one Jacobi sweep (mesh.stacked_sweep) on the device

This is BASELINE.md config 5 ("256 agents x 16 scenarios, Monte-Carlo
batched solves") at any scale the device memory fits; ``pipeline=k``
bounds the stack to k scenarios.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import Mission, Param, PlanResult
from ..corridor.times import build_corridors
from ..qp import admm, assemble, convert
from ..search.planner import plan_initial_trajectories
from ..utils import timing
from ..world.esdf import ESDF
from ..world.voxel import OccupancyGrid
from . import seqbatch


@dataclass
class Scenario:
    mission: Mission
    world: OccupancyGrid
    plan: PlanResult | None = None
    error: str | None = None
    #: host seconds of the prep stages (esdf, search, corridor)
    times: dict | None = None


def _prep_one(sc: Scenario, param: Param, submitted: float) -> Scenario:
    """ESDF, initial paths and corridors of one scenario; an exception is
    kept as the scenario's error string.  ``submitted``: the host time the
    scenario was handed to the pool (the ``wait_s`` of its span)."""
    times = {}
    t0 = time.perf_counter()
    try:
        esdf = ESDF(sc.world, max_dist=param.esdf_max_dist)
        t1 = time.perf_counter()
        timing.add_span("prep.esdf", t0, t1)
        plan = plan_initial_trajectories(esdf, sc.mission, param)
        t2 = time.perf_counter()
        timing.add_span("prep.search", t1, t2)
        build_corridors(esdf, plan, sc.mission.radius, param)
        t3 = time.perf_counter()
        timing.add_span("prep.corridor", t2, t3)
        times = {"esdf": t1 - t0, "search": t2 - t1, "corridor": t3 - t2}
        sc.plan = plan
    except Exception as e:
        sc.error = f"{type(e).__name__}: {e}"
    sc.times = times
    timing.add_span("mc.prep_map", t0, time.perf_counter(),
                    wait_s=t0 - submitted)
    return sc


def prep_scenarios(scenarios: list[Scenario], param: Param,
                   max_workers: int = 8) -> list[Scenario]:
    """ESDF + initial paths + corridors for every scenario, in threads."""
    with ThreadPoolExecutor(max_workers=max_workers) as pool, \
            timing.span("mc.prep"):
        submitted = time.perf_counter()
        return list(pool.map(lambda sc: _prep_one(sc, param, submitted),
                             scenarios))


#: segment-count quantum for scenario bucketing: every plan's M is padded
#: up to the next multiple, so scenarios whose makespans differ a little
#: share one bucket (one stack) instead of one each
M_BUCKET = 8


def quantize_M(M: int, bucket: int = M_BUCKET) -> int:
    return -(-M // bucket) * bucket


def pad_plan_segments(plan: PlanResult, M_target: int) -> PlanResult:
    """Extend a plan to M_target segments by APPENDING hold-at-goal
    segments: the relaxation the reference already applies when it pads
    every path to makespan+3 with the goal repeated (ecbs_planner.hpp:
    49-70), taken k steps further so scenarios share a shape.  The padded
    problem gives agents more time (T grows by k uniform steps); every
    safety property holds (the last SFC box contains the held goal, the
    last RSFC normal separates the goal positions it was built from), and
    the goal-state pin moves to the new final knot."""
    M = plan.M
    if M_target <= M:
        return plan
    k = M_target - M

    def rep_last(a, axis):
        last = np.take(a, [-1], axis=axis)
        return np.concatenate([a] + [last] * k, axis=axis)

    plan.init_traj = rep_last(np.asarray(plan.init_traj), 1)
    T = np.asarray(plan.T, np.float64)
    dtl = T[-1] - T[-2]
    plan.T = np.concatenate([T, T[-1] + dtl * np.arange(1, k + 1)])
    plan.seg_boxes = rep_last(np.asarray(plan.seg_boxes), 1)
    plan.pair_normals = rep_last(np.asarray(plan.pair_normals), 1)
    return plan


def default_settings(param: Param) -> admm.ADMMSettings:
    """The scenario solves' ADMM settings: cg KKT (no dense inverse held
    for the whole stack of scenarios), adaptive rho."""
    return admm.ADMMSettings(
        max_iter=param.solver_max_iter, eps_abs=param.solver_eps_abs,
        eps_rel=param.solver_eps_rel, kkt_solver="cg", adaptive_rho=True,
        eps_dual_abs=0.5)


def pair_pad_bound(qn: int, param: Param) -> int:
    """Deterministic upper bound on the pair rows any one agent batch can
    own (the global pair list is all C(qn, 2) pairs, rsfc.build_rsfc):
    B*(qn-B) one-sided rows + C(B, 2) intra-batch rows.  The pipelined
    path pads every chunk to it, so all chunks of a bucket share their
    shapes (masked rows are inactive by construction)."""
    batches, _ = seqbatch.make_batches(qn, param)
    return max(len(b) * (qn - len(b)) + len(b) * (len(b) - 1) // 2
               for b in batches)


def _assemble_scenario(sc: Scenario, param: Param, batch_iter: int,
                       batches, pad: int):
    dummy = assemble.build_dummy(sc.plan.init_traj, param.n, sc.plan.M)
    datas = [assemble.assemble_batch(sc.plan, sc.mission, param, b,
                                     dummy, pad)
             for b in batches[:batch_iter]]
    return seqbatch._stack_qpdata(datas), dummy


def _solve_stack(scenarios: list[Scenario], idxs: list[int], param: Param,
                 settings, pad: int, device, mode: str) -> None:
    """Assemble the scenarios ``idxs`` (one bucket: same M and agent
    count), fold (scenario, group) into one leading axis, run one Jacobi
    sweep on ``device`` and fill each plan's coef and solver_info."""
    from . import mesh as pmesh

    qn, M = scenarios[idxs[0]].mission.qn, scenarios[idxs[0]].plan.M
    batches, batch_iter = seqbatch.make_batches(qn, param)
    if batch_iter == 0:
        return
    rounds = max(1, param.iteration)
    t0 = time.perf_counter()
    per, dummies = zip(*(_assemble_scenario(scenarios[i], param,
                                            batch_iter, batches, pad)
                         for i in idxs))
    L = per[0].lb.shape[0]
    stacked = assemble.QPData(**{
        f.name: (None if getattr(per[0], f.name) is None else
                 np.concatenate([getattr(p, f.name) for p in per]))
        for f in dataclasses.fields(assemble.QPData)}).to(device)
    dm0 = torch.as_tensor(np.stack(dummies), dtype=stacked.lb.dtype,
                          device=device)
    scen = torch.arange(len(idxs), device=device).repeat_interleave(L)
    t1 = time.perf_counter()
    timing.add_span("mc.assemble", t0, t1)
    ctrls, info = pmesh.stacked_sweep(stacked, scen, dm0, settings,
                                      rounds=rounds)
    with timing.span("mc.readback"):
        ctrls = ctrls.cpu().numpy().astype(np.float64)
        t2 = time.perf_counter()
        iters = torch.as_tensor(info.iters).reshape(len(idxs), L).tolist()
        # the two reads above each waited on the card
        timing.count("solve.syncs", 2)
        for row, i in enumerate(idxs):
            plan = scenarios[i].plan
            plan.ctrl = ctrls[row]
            plan.coef = convert.ctrl_to_coef(ctrls[row], plan.T, param.n)
            plan.solver_info = {"mode": mode, "M": M, "rounds": rounds,
                                "iters": iters[row], "stack": len(idxs),
                                "assemble_s": t1 - t0, "solve_s": t2 - t1}


def solve_scenarios(scenarios: list[Scenario], param: Param,
                    settings=None, device=None) -> list[Scenario]:
    """Batched solves on ``device`` (None = the card; raises without one:
    pass ``device="cpu"`` for the CPU), scenarios bucketed by (segments,
    agents): each bucket's scenarios are stacked on the leading axis of
    the agent-group stack and the whole multi-round Jacobi sweep
    (coupling refresh, warm starts, dummy exchange) runs on the device.
    ``settings`` None = default_settings (cg KKT)."""
    device = resolve_device(device)
    if settings is None:
        settings = default_settings(param)

    buckets: dict[tuple[int, int], list[int]] = {}
    for i, sc in enumerate(scenarios):
        if sc.plan is not None and sc.error is None:
            pad_plan_segments(sc.plan, quantize_M(sc.plan.M))
            buckets.setdefault((sc.plan.M, sc.mission.qn), []).append(i)

    for (M, qn), idxs in sorted(buckets.items()):
        batches, batch_iter = seqbatch.make_batches(qn, param)
        members = [set(int(q) for q in b) for b in batches[:batch_iter]]
        pad = max((sum(1 for (qi, qj) in np.asarray(scenarios[i].plan
                                                    .pair_idx)
                       if int(qi) in m or int(qj) in m)
                   for i in idxs for m in members), default=0)
        _solve_stack(scenarios, idxs, param, settings, pad, device,
                     "scenario-batched-device")
    return scenarios


def run_monte_carlo(mission: Mission, param: Param, *, n_scenarios: int,
                    seed0: int = 0, forest_kwargs: dict | None = None,
                    settings=None, pipeline: int | None = None,
                    device=None) -> list[Scenario]:
    """Generate n_scenarios seeded forests and plan them all, batched, on
    ``device`` (None = the card; raises without one: pass
    ``device="cpu"`` for the CPU).

    pipeline=None: two phases, prep everything (thread pool), then one
    stacked solve per (M, qn) bucket.

    pipeline=k: streaming, the prep threads keep running while the main
    thread assembles and solves a chunk of k scenarios of one bucket as
    soon as their prep completes (the chunk's stack holds k scenarios at
    most, each padded to pair_pad_bound pair rows); the rest of a bucket
    goes last.  Each scenario's result equals the two-phase path's (the
    padded pair rows are inactive, and every stacked problem stops on its
    own residuals)."""
    from ..world.forest import generate_forest

    device = resolve_device(device)
    fk = dict(obs_num=20, r_min=0.3, r_max=0.3, h_min=0.0, h_max=2.5,
              margin=0.5)
    fk.update(forest_kwargs or {})
    with timing.span("mc.forest"):
        scenarios = [
            Scenario(mission=mission,
                     world=generate_forest(mission,
                                           world_min=param.world_min,
                                           world_max=param.world_max,
                                           resolution=param.world_resolution,
                                           seed=seed0 + i, **fk))
            for i in range(n_scenarios)
        ]
    if pipeline is None:
        prep_scenarios(scenarios, param)
        return solve_scenarios(scenarios, param, settings, device)
    return _run_pipelined(scenarios, param, settings, pipeline, device)


def _run_pipelined(scenarios: list[Scenario], param: Param, settings,
                   chunk: int, device, max_workers: int = 8
                   ) -> list[Scenario]:
    """Streaming prep -> assemble -> solve (see run_monte_carlo)."""
    if settings is None:
        settings = default_settings(param)
    pending: dict[tuple[int, int], list[int]] = {}

    def dispatch(key: tuple[int, int], idxs: list[int]):
        _solve_stack(scenarios, idxs, param, settings,
                     pair_pad_bound(key[1], param), device,
                     "scenario-pipelined-device")

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        submitted = time.perf_counter()
        futs = {pool.submit(_prep_one, sc, param, submitted): i
                for i, sc in enumerate(scenarios)}
        for fut in as_completed(futs):
            sc = fut.result()
            if sc.plan is None or sc.error is not None:
                continue
            pad_plan_segments(sc.plan, quantize_M(sc.plan.M))
            key = (sc.plan.M, sc.mission.qn)
            pending.setdefault(key, []).append(futs[fut])
            if len(pending[key]) == chunk:
                dispatch(key, pending.pop(key))
        for key, idxs in sorted(pending.items()):
            dispatch(key, idxs)
    return scenarios
