"""Phase-budget knee at 256 agents on the port's device-prep solve.

    python3 -m swarm_simulator_tpu_torch.tools.budget256_study
        [--agents 256] [--refine 1] [--bf16] [--cpu]

The counterpart of the JAX package's tools/budget256_study.py.  The
production (200, 600, 100) phase budgets were tuned on the 64-agent
forest; this sweeps shorter schedules on the 256-agent scatter problem
(``scatter_mission(256, half=9.5, z=1.0, seed=7)`` in the empty
+-10 m world, z 0.3-2.5 m, grid 0.5/1.0 m, float32) and checks each arm:
safety ratio >= 1, box containment < 1e-3, C0 continuity < 1e-3, and the
objective against the full-budget arm's.

The rung inventory is prepared once on the device (``prepare_ns``: 5
rungs from rho 3e-5, the JAX study's ladder), in bf16 with ``--bf16``
(a preconditioner only: it needs ``--refine`` >= 1).  Each arm is one
phased solve through ``solve_ns_schedule``: with ``--refine`` >= 1 every
w-update is a PCG step against the fresh operator whose KKT solves go
through the Thomas kernel (K2); with ``--refine 0`` each 50-iteration
chunk is one launch of the fused kernel (K1).  Times are host clock
around the solve, ending in a device sync, after the kernels were built.
Per-arm lines go to stderr; the JSON is the last line of stdout (at 256
agents MAGMA's batched LU in the device prep prints size warnings to
stdout before it); no file is written.
``--cpu`` runs on the CPU with the kernels' plain twins (slow at 256
agents).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

#: the JAX study's four budget arms, full budget first
ARMS = ((200, 600, 100), (100, 400, 100), (100, 300, 100), (50, 200, 50))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def scatter_config(agents: int = 256, seed: int = 7):
    """(mission, param, world) of the scatter problem: the JAX study's
    mission, world and grid (tools/budget256_study.py:59-66 there), with
    the joint solver and a float32 solve."""
    from swarm_simulator_tpu_torch import Param
    from swarm_simulator_tpu_torch.io.mission_json import scatter_mission
    from swarm_simulator_tpu_torch.world.voxel import OccupancyGrid

    mission = scatter_mission(agents, half=9.5, z=1.0, seed=seed)
    param = Param(world_x_min=-10, world_x_max=10, world_y_min=-10,
                  world_y_max=10, world_z_min=0.3, world_z_max=2.5,
                  grid_xy_res=0.5, grid_z_res=1.0, solver="nullspace",
                  solver_dtype="float32")
    world = OccupancyGrid.empty(param.world_min, param.world_max,
                                param.world_resolution)
    return mission, param, world


def build_problem(agents: int = 256, seed: int = 7):
    """(plan, mission, param, host QPData) of the scatter problem: ESDF,
    ECBS and corridors through the port's host pipeline, the joint QP
    assembled from the initial-path warm start."""
    from swarm_simulator_tpu_torch.corridor.times import build_corridors
    from swarm_simulator_tpu_torch.qp import joint
    from swarm_simulator_tpu_torch.search.planner import \
        plan_initial_trajectories
    from swarm_simulator_tpu_torch.world.esdf import ESDF

    mission, param, world = scatter_config(agents, seed)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)
    data, _ = joint.assemble_joint(plan, mission, param)
    return plan, mission, param, data


def base_settings(refine: int, bf16: bool):
    """The JAX study's solver settings: the production tolerances, tighten
    and x0 warm start, a 5-rung ladder from rho 3e-5."""
    from swarm_simulator_tpu_torch.qp import nullspace as ns

    return ns.NSSettings(
        max_iter=1500, check_every=50, eps_abs=2e-4, eps_rel=2e-4,
        eps_dual_abs=5e-3, tighten=2e-3, warm_start="x0", kkt_mode="banded",
        rho_min=3e-5,
        n_rungs=5, kkt_refine=refine,
        precond_dtype="bfloat16" if bf16 else "float32")


def phases(base, budgets):
    """The production phases (fenced low -> polish -> fenced high) of
    ``budgets`` over ``base``."""
    from swarm_simulator_tpu_torch.qp import joint

    return joint.production_phases(budgets, base=base,
                                   kkt_refine=base.kkt_refine)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prepare(data_dev, base):
    """The device prep of the rung inventory for every arm."""
    from swarm_simulator_tpu_torch.qp import nullspace as ns

    return ns.prepare_ns(data_dev, phases(base, ARMS[0])[0])


def quality(x, plan, mission, param, data, dev):
    """(ratio, box violation, C0 continuity, objective) of a solution
    x [N, 3, D]: the JAX study's checks."""
    from swarm_simulator_tpu_torch.eval.safety import safety_margin_ratio
    from swarm_simulator_tpu_torch.eval.sample import (sample_times,
                                                       sample_trajectories)
    from swarm_simulator_tpu_torch.qp import convert

    N, M, n = mission.qn, plan.M, param.n
    ctrl = convert.x_to_ctrl(x, M, n)
    coef = convert.ctrl_to_coef(ctrl, plan.T, n)
    ts = sample_times(np.asarray(plan.T), 0.1)
    pos = sample_trajectories(coef, np.asarray(plan.T), ts, n=n,
                              derivatives=1, device=dev)[:, :, 0]
    ratio = float(safety_margin_ratio(pos, mission.radius,
                                      downwash=param.downwash, device=dev))
    boxes = plan.seg_boxes
    viol = float(np.maximum(boxes[:, :, None, :3] - ctrl,
                            ctrl - boxes[:, :, None, 3:]).max())
    cont = float(np.abs(ctrl[:, 1:, 0] - ctrl[:, :-1, -1]).max())
    Qseg = np.asarray(data.Qseg, np.float64)
    obj = 0.5 * float(np.einsum("bmik,mij,bmjk->", ctrl, Qseg, ctrl))
    return ratio, viol, cont, obj


def run_arm(data_dev, op, base, budgets, plan, mission, param, data, dev):
    """One budget arm: the phased solve (host clock, ending in a device
    sync), then its checks.  Returns the arm's record."""
    from swarm_simulator_tpu_torch.qp import nullspace as ns

    s0, it_k, lo_k, hi_k = ns.schedule_arrays(phases(base, budgets))
    t0 = time.perf_counter()
    x, info = ns.solve_ns_schedule(data_dev, op, s0, it_k, lo_k, hi_k)
    sync(dev)
    solve_s = time.perf_counter() - t0
    x = x.double().cpu().numpy()
    ratio, viol, cont, obj = quality(x, plan, mission, param, data, dev)
    ok = ratio >= 1.0 and viol < 1e-3 and cont < 1e-3
    return dict(budgets=list(budgets), solve_s=solve_s, iters=int(info.iters),
                r_prim=float(info.r_prim), ratio=ratio, box_viol=viol,
                cont=cont, obj=obj, ok=bool(ok))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agents", type=int, default=256)
    ap.add_argument("--refine", type=int, default=0,
                    help="kkt_refine PCG steps (1 = the replan mode)")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 pivot preconditioner (requires --refine"
                    " >= 1; halves the pivot stream)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("budget256_study: no CUDA card (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    from swarm_simulator_tpu_torch.ops import _build

    dev = torch.device("cpu" if args.cpu else "cuda")
    base = base_settings(args.refine, args.bf16)
    if dev.type == "cuda":
        _build.build("nsfused", "thomas")
    t0 = time.perf_counter()
    plan, mission, param, data = build_problem(args.agents)
    log(f"M={plan.M} pairs={len(plan.pair_idx)} host build "
        f"{time.perf_counter() - t0:.3f} s")
    data_dev = data.to(dev)
    t0 = time.perf_counter()
    op = prepare(data_dev, base)
    sync(dev)
    prep_s = time.perf_counter() - t0
    inv_bytes = op.Dinvs.numel() * op.Dinvs.element_size()
    log(f"device prep {prep_s:.3f} s: pivots {tuple(op.Dinvs.shape)} "
        f"{op.Dinvs.dtype}, {inv_bytes / 1e9:.3f} GB")

    results = []
    for budgets in ARMS:
        r = run_arm(data_dev, op, base, budgets, plan, mission, param, data,
                    dev)
        r["obj_vs_full"] = r["obj"] / results[0]["obj"] if results else 1.0
        log(f"budgets={tuple(budgets)}: {r['solve_s']:.3f} s "
            f"({r['iters']} iters) ratio={r['ratio']:.4f} "
            f"box={r['box_viol']:.1e} cont={r['cont']:.1e} "
            f"obj={r['obj']:.4f} (x{r['obj_vs_full']:.4f}) -> "
            f"{'OK' if r['ok'] else 'FAIL'}")
        results.append(r)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    # a diverged arm's NaNs become null, so the line stays strict JSON
    results = [{k: (None if isinstance(v, float) and not np.isfinite(v)
                    else v) for k, v in r.items()} for r in results]
    print(json.dumps(dict(agents=mission.qn, M=int(plan.M),
                          pairs=int(len(plan.pair_idx)), refine=args.refine,
                          bf16=bool(args.bf16), device=kind, prep_s=prep_s,
                          inventory_bytes=inv_bytes, results=results),
                     allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
