"""Sequential batch planning: agent-group decomposition of the joint QP.

The reference solves agents in contiguous batches of ``batch_size``, holding
all other agents fixed at their latest ``dummy`` control points
(setBatch/build_dummy/solveQP, rbp_planner.hpp:140-204, 513-549, 849-872).
This is a Gauss-Seidel sweep over agent groups:

  * ``gauss-seidel``: batches solved in order, each seeing earlier batches'
    fresh solutions (reference-faithful; feasibility guaranteed after one
    sweep because every pair constraint is enforced by the later batch),
    with the dummy kept on the device (parallel/mesh.gauss_seidel_sweep).
  * ``jacobi``: all batches solved as one stack against the previous
    dummy state, iterated; final safety is checked by the evaluator.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import Mission, Param, PlanResult
from ..qp import admm, assemble, convert
from ..utils.timing import ProblemSize


def make_batches(N: int, param: Param) -> tuple[list[np.ndarray], int]:
    """Mirror setBatch (rbp_planner.hpp:849-872): contiguous groups; returns
    (batches, batch_iter) where batch_iter counts how many run."""
    if param.sequential:
        batch_size = param.batch_size
        batch_max_iter = int(np.ceil(N / batch_size))
        batch_iter = param.batch_iter
        if batch_iter < 0 or batch_iter > batch_max_iter:
            batch_iter = batch_max_iter
    else:
        batch_size = N
        batch_max_iter = 1
        batch_iter = 1
    batches = [np.arange(l * batch_size, min((l + 1) * batch_size, N))
               for l in range(batch_max_iter)]
    return batches, batch_iter


def default_settings(plan: PlanResult, mission: Mission,
                     param: Param) -> admm.ADMMSettings:
    """The ADMM settings ``param`` asks for.  ``solver_kkt="auto"`` picks
    dense (one big matmul per iteration, best for small batch QPs) unless
    the stacked dense inverses of all batches, which the sweeps hold on
    the device at once, would pass 2 GB at 4 bytes an entry; then cg
    (O(D^2) memory, the only viable mode for large joint problems).  The
    rule is the JAX package's, so both pick the same mode; the port keeps
    its inverses in float64 (qp/admm.KINV_DTYPE), 8 bytes an entry, so
    the stack it picks dense for holds up to 4 GB (860 MB for the 64-agent
    forest's 16 batches of 4)."""
    N = mission.qn
    kkt = param.solver_kkt
    if kkt == "auto":
        B_eff = param.batch_size if param.sequential else N
        n_groups = int(np.ceil(N / B_eff)) if param.sequential else 1
        nx = 3 * B_eff * plan.M * (param.n + 1)
        kkt = "dense" if n_groups * nx * nx * 4 < 2e9 else "cg"
    return admm.ADMMSettings(max_iter=param.solver_max_iter,
                             eps_abs=param.solver_eps_abs,
                             eps_rel=param.solver_eps_rel,
                             eps_dual_abs=param.solver_eps_dual,
                             adaptive_rho=param.solver_adaptive_rho,
                             kkt_solver=kkt)


def solve_trajectories(
    plan: PlanResult,
    mission: Mission,
    param: Param,
    settings: admm.ADMMSettings | None = None,
    device: torch.device | str | None = None,
) -> PlanResult:
    """Solve all agent batches on ``device`` (None = the card; raises
    without one: pass ``device="cpu"`` for the CPU); fills plan.ctrl,
    plan.coef [N, M, n+1, 3] and plan.solver_info."""
    device = resolve_device(device)
    N = mission.qn
    if settings is None:
        settings = default_settings(plan, mission, param)
    n = param.n
    M = plan.M
    dummy = assemble.build_dummy(plan.init_traj, n, M)  # [N, M, n+1, 3]
    ctrl = dummy.copy()
    batches, batch_iter = make_batches(N, param)

    infos = []
    if param.sequential and batch_iter == 0:
        # publish the initial trajectory (rbp_planner.hpp:119-138)
        plan.ctrl = ctrl
        plan.coef = convert.ctrl_to_coef(ctrl, plan.T, n)
        plan.solver_info = {"iters": [], "mode": "init-only",
                            "device": str(device)}
        return plan

    # pad pair rows so every batch QP has identical shapes
    pair_idx = np.asarray(plan.pair_idx).reshape(-1, 2)
    pad_pairs = max(
        int(np.isin(pair_idx, b).any(axis=1).sum())
        for b in batches[:batch_iter])

    # problem-size counters, printed by the reference after each solve
    # (rbp_planner.hpp:58-60); exposed in solver_info and on param.log
    B_eff = param.batch_size if param.sequential else N
    psize = ProblemSize.of_batch(min(B_eff, N), M, n, param.phi, pad_pairs)
    if param.log:
        print(psize)

    def assemble_all(dummy):
        return [assemble.assemble_batch(plan, mission, param, b, dummy,
                                        pad_pairs)
                for b in batches[:batch_iter]]

    def maybe_export(datas):
        # QP-model export on log, like the reference's exportModel to
        # log/ (rbp_planner.hpp:150-153)
        if not param.log:
            return
        from pathlib import Path
        d = Path("log")
        d.mkdir(exist_ok=True)
        for l, dd in enumerate(datas):
            assemble.export_qp_npz(str(d / f"qp_batch{l}.npz"), dd)

    solved = np.zeros(N, dtype=bool)
    if param.parallel_mode == "gauss-seidel":
        from . import mesh as pmesh
        datas = assemble_all(dummy)
        maybe_export(datas)
        stacked = _stack_qpdata(datas).to(device)
        ctrl_dev, info = pmesh.gauss_seidel_sweep(
            stacked, torch.as_tensor(dummy, device=device), settings,
            rounds=max(1, param.iteration))
        ctrl_dev = ctrl_dev.cpu().numpy().astype(np.float64)
        for b in batches[:batch_iter]:
            ctrl[b] = ctrl_dev[b]
            solved[b] = True
        plan.ctrl = ctrl
        plan.coef = convert.ctrl_to_coef(ctrl, plan.T, n)
        plan.solver_info = {
            **_info_lists([info]),
            "mode": "gauss-seidel-device", "solved": solved,
            "problem_size": str(psize), "device": str(device),
        }
        return plan

    for it in range(param.iteration):
        if param.parallel_mode == "jacobi" and batch_iter > 1:
            datas = assemble_all(dummy)
            if it == 0:
                maybe_export(datas)
            xs, info = admm.solve_qp_batched(_stack_qpdata(datas), settings,
                                             device=device)
            xs = xs.cpu().numpy()
            for l, batch in enumerate(batches[:batch_iter]):
                ctrl[batch] = convert.x_to_ctrl(xs[l][: len(batch)], M, n)
                solved[batch] = True
            dummy = ctrl.copy()
            infos.append(info)
        else:
            for l, batch in enumerate(batches[:batch_iter]):
                data = assemble.assemble_batch(plan, mission, param, batch,
                                               dummy, pad_pairs)
                if it == 0 and l == 0:
                    maybe_export([data])
                x, info = admm.solve_qp(data, settings, device=device)
                cb = convert.x_to_ctrl(x.cpu().numpy(), M, n)
                ctrl[batch] = cb
                dummy[batch] = cb  # Gauss-Seidel dummy refresh (:183)
                solved[batch] = True
                infos.append(info)

    # agents never solved keep their dummy trajectory (rbp_planner.hpp:187-192)
    plan.ctrl = ctrl
    plan.coef = convert.ctrl_to_coef(ctrl, plan.T, n)
    plan.solver_info = {
        **_info_lists(infos),
        "mode": param.parallel_mode if param.sequential else "joint",
        "solved": solved,
        "problem_size": str(psize),
        "device": str(device),
    }
    return plan


def _info_lists(infos: list[admm.SolveInfo]) -> dict:
    """The solves' iters, r_prim, r_dual and obj as flat python lists, in
    solve order (one host copy per field)."""
    out = {}
    for field in admm.SolveInfo._fields:
        vals = [torch.as_tensor(getattr(i, field)).reshape(-1).cpu()
                for i in infos]
        flat = torch.cat(vals).tolist() if vals else []
        out[field] = ([int(v) for v in flat] if field == "iters"
                      else [float(v) for v in flat])
    return out


def _stack_qpdata(datas: list[assemble.QPData]) -> assemble.QPData:
    """Stack host batch QPs on a leading axis (one device transfer for the
    whole stack afterwards).  Batches may differ in agent count (the last
    batch): the shorter ones are padded (_pad_agents)."""
    Bmax = max(d.lb.shape[0] for d in datas)
    padded = [_pad_agents(d, Bmax) for d in datas]
    return dataclasses.replace(padded[0], **{
        f.name: (None if getattr(padded[0], f.name) is None else
                 np.stack([getattr(d, f.name) for d in padded]))
        for f in dataclasses.fields(padded[0])})


def _pad_agents(d: assemble.QPData, Bmax: int) -> assemble.QPData:
    """Pad a host batch QP to Bmax agents by repeating its last agent with
    free bounds and no pairs."""
    B = d.lb.shape[0]
    if B == Bmax:
        return d
    pad = Bmax - B

    def padB(a):
        return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)

    big = assemble.BIG
    lb = np.concatenate([d.lb, np.full((pad,) + d.lb.shape[1:], -big,
                                       d.lb.dtype)], axis=0)
    ub = np.concatenate([d.ub, np.full((pad,) + d.ub.shape[1:], big,
                                       d.ub.dtype)], axis=0)
    # padded agents get a sentinel id past every agent, so the sweep's
    # write-back drops them
    agents = np.concatenate([
        d.agents, np.full((pad,), 2**30, dtype=d.agents.dtype)])
    return dataclasses.replace(d, deq=padB(d.deq), lb=lb, ub=ub,
                               x0=padB(d.x0), agents=agents)
