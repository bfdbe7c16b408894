"""CLI: plan a swarm mission end to end with the PyTorch port.

Equivalent of the swarm_traj_planner_rbp demo node
(src/swarm_traj_planner_rbp.cpp): load a mission + world, run the
pipeline on the card (or on ``--device cpu``), print per-stage runtimes
and the acceptance metrics, optionally dump crazyswarm CSVs and plots.
The flags are the JAX package's CLI's, with ``--device`` in place of
``--platform``.

Usage:
  python -m swarm_simulator_tpu_torch.cli.plan --mission missions/m.json \
      [--world worlds/map1.bt | --forest-seed 0 --obs-num 20] \
      [--sequential --batch-size 4] [--log-dir log/] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mission", default=None,
                   help="mission JSON path (optional with --preset: the "
                   "preset's mission file is looked up in "
                   "$SWARM_MISSIONS_DIR)")
    p.add_argument("--preset", default=None,
                   help="launch-file preset from core.config (overrides "
                        "world/grid/plan knobs)")
    p.add_argument("--noise", type=float, default=0.0,
                   help="seeded start/goal noise (applyNoise equivalent)")
    p.add_argument("--noise-seed", type=int, default=0)
    p.add_argument("--world", default=None, help=".bt octomap world (replay)")
    p.add_argument("--forest-seed", type=int, default=None,
                   help="generate a random forest with this seed")
    p.add_argument("--obs-num", type=int, default=20)
    p.add_argument("--obs-r-min", type=float, default=0.3)
    p.add_argument("--obs-r-max", type=float, default=0.3)
    p.add_argument("--obs-h-min", type=float, default=0.0)
    p.add_argument("--obs-h-max", type=float, default=2.5)
    p.add_argument("--obs-margin", type=float, default=0.5)
    # world AABB (launch defaults)
    p.add_argument("--world-min", type=float, nargs=3,
                   default=[-5.0, -5.0, 0.0], metavar=("X", "Y", "Z"))
    p.add_argument("--world-max", type=float, nargs=3,
                   default=[5.0, 5.0, 2.5], metavar=("X", "Y", "Z"))
    p.add_argument("--grid-xy-res", type=float, default=0.5)
    p.add_argument("--grid-z-res", type=float, default=1.0)
    p.add_argument("--grid-margin", type=float, default=0.2)
    p.add_argument("--ecbs-w", type=float, default=1.3)
    p.add_argument("--box-xy-res", type=float, default=0.1)
    p.add_argument("--box-z-res", type=float, default=0.1)
    p.add_argument("--time-step", type=float, default=1.0)
    p.add_argument("--downwash", type=float, default=2.0)
    p.add_argument("--no-time-scale", action="store_true")
    p.add_argument("--alg", choices=["rbp", "scp"], default="rbp",
                   help="rbp: Bernstein corridor QP; scp: discrete-time "
                        "sequential convex programming baseline")
    p.add_argument("--flat", action="store_true",
                   help="flat-corridor variant (rbp_flat entry)")
    p.add_argument("--sequential", action="store_true")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--batch-iter", type=int, default=-1)
    p.add_argument("--iteration", type=int, default=None,
                   help="outer re-solve rounds (default: preset value "
                        "or 1)")
    p.add_argument("--parallel-mode", choices=["gauss-seidel", "jacobi"],
                   default="gauss-seidel")
    p.add_argument("--solver", choices=["admm", "nullspace"],
                   default=None,
                   help="admm: per-batch solver/sweeps; nullspace: the "
                        "production JOINT whole-swarm path (qp/joint.py, "
                        "host-f64 prep + banded-KKT knot-state ADMM); "
                        "--iteration N>1 = outer corridor replans")
    p.add_argument("--cold-prep", choices=["host", "device"],
                   default="host",
                   help="joint-path round-0 KKT prep: host f64 (max "
                        "polish + fused warm cycles) or on-device f32 "
                        "+ PCG refine (low time-to-first-plan)")
    p.add_argument("--polish-rounds", type=int, default=None,
                   help="joint-path warm polish extensions after the "
                        "cold solve (default auto = 4 for >= 128 "
                        "agents, 0 below; see qp/joint.py)")
    p.add_argument("--replan-budgets", default=None,
                   help="per-round replan phase budgets 'a,b,c' "
                        "(default: the cold phases' full budgets)")
    p.add_argument("--replan-polish", type=int, default=None,
                   help="warm polish extensions per replan round "
                        "(default auto)")
    p.add_argument("--replan-prep",
                   choices=["auto", "fresh", "device", "stale"],
                   default="auto",
                   help="joint-path corridor-replan prep (auto: device "
                        "on the card, fresh host prep on the CPU)")
    p.add_argument("--exact-polish", action="store_true",
                   help="finish each joint solve/replan round with the "
                        "host-f64 active-set polish (qp/activeset.py); "
                        "prints each round's accepted / kkt_optimal / "
                        "passes / n_active")
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32")
    p.add_argument("--max-iter", type=int, default=2000)
    p.add_argument("--device", default=None,
                   help="torch device of the solve and the metrics "
                        "(default: the card; 'cpu' for the CPU)")
    p.add_argument("--log-dir", default=None,
                   help="write crazyswarm coef CSVs here")
    p.add_argument("--log", action="store_true",
                   help="verbose logging: problem-size counters + QP "
                        "model export to log/ (the reference's log flag, "
                        "param.hpp:45)")
    p.add_argument("--json", action="store_true",
                   help="print metrics as one JSON line")
    p.add_argument("--animate", action="store_true",
                   help="with --log-dir: write playback.gif — the "
                        "offline stand-in for the reference's 20 Hz "
                        "rviz playback (rbp_publisher.hpp:93-127)")
    return p


def _param(args):
    """The Param of the flags (a preset's with the flags it takes)."""
    import swarm_simulator_tpu_torch as stt
    from swarm_simulator_tpu_torch.core.config import preset as get_preset

    common = dict(
        solver_dtype=args.dtype, solver_max_iter=args.max_iter, log=args.log,
        cold_prep=args.cold_prep, polish_rounds=args.polish_rounds,
        replan_budgets=(tuple(int(b) for b in args.replan_budgets.split(","))
                        if args.replan_budgets else None),
        replan_polish=args.replan_polish,
        replan_prep=(None if args.replan_prep == "auto"
                     else args.replan_prep),
        exact_polish=args.exact_polish)
    if args.preset:
        pp = get_preset(args.preset)
        # only override preset fields the user explicitly set
        over = {}
        if args.solver is not None:
            over["solver"] = args.solver
        if args.iteration is not None:
            over["iteration"] = args.iteration
        return dataclasses.replace(
            pp.param, **common,
            corridor_mode="flat" if args.flat else pp.param.corridor_mode,
            **over)
    return stt.Param(
        world_x_min=args.world_min[0], world_y_min=args.world_min[1],
        world_z_min=args.world_min[2], world_x_max=args.world_max[0],
        world_y_max=args.world_max[1], world_z_max=args.world_max[2],
        ecbs_w=args.ecbs_w, grid_xy_res=args.grid_xy_res,
        grid_z_res=args.grid_z_res, grid_margin=args.grid_margin,
        box_xy_res=args.box_xy_res, box_z_res=args.box_z_res,
        time_scale=not args.no_time_scale, time_step=args.time_step,
        downwash=args.downwash, sequential=args.sequential,
        batch_size=args.batch_size, batch_iter=args.batch_iter,
        iteration=args.iteration if args.iteration is not None else 1,
        parallel_mode=args.parallel_mode,
        solver=args.solver if args.solver is not None else "admm",
        corridor_mode="flat" if args.flat else "rbp", **common)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import swarm_simulator_tpu_torch as stt
    from swarm_simulator_tpu_torch.core.config import preset as get_preset
    from swarm_simulator_tpu_torch.core.device import resolve_device
    from swarm_simulator_tpu_torch.io.mission_json import load_mission

    device = resolve_device(args.device)
    if args.mission is None:
        mdir = os.environ.get("SWARM_MISSIONS_DIR")
        if not args.preset or not mdir:
            print("error: --mission is required (or --preset with "
                  "$SWARM_MISSIONS_DIR set)", file=sys.stderr)
            return 2
        args.mission = os.path.join(mdir, get_preset(args.preset).mission)
    mission = load_mission(args.mission)
    if args.noise > 0:
        mission = mission.apply_noise(args.noise, args.noise_seed)
    param = _param(args)

    world = None
    if args.world:
        from swarm_simulator_tpu_torch.world.btree import load_bt_world
        world = load_bt_world(args.world, param.world_min, param.world_max)
    elif args.forest_seed is not None:
        from swarm_simulator_tpu_torch.world.forest import generate_forest
        world = generate_forest(
            mission, world_min=param.world_min, world_max=param.world_max,
            resolution=param.world_resolution, obs_num=args.obs_num,
            r_min=args.obs_r_min, r_max=args.obs_r_max,
            h_min=args.obs_h_min, h_max=args.obs_h_max,
            margin=args.obs_margin, seed=args.forest_seed)

    if args.alg == "scp":
        return _run_scp(mission, param, args, device)

    result, times = stt.plan(mission, param, world, device=device)
    metrics = stt.evaluate(result, mission, param, device=device)

    if args.log_dir:
        from pathlib import Path

        import numpy as np

        from swarm_simulator_tpu_torch.eval.sample import (
            sample_times, sample_trajectories)
        from swarm_simulator_tpu_torch.io.coef_csv import write_all
        from swarm_simulator_tpu_torch.io.viz import (
            animate_swarm, plot_quad_dynamics, plot_safety_margin,
            plot_trajectories_topview)
        write_all(args.log_dir, result.coef, result.T, param.n)
        # reference's plot(log): dynamics + safety plots (rbp_publisher)
        ts = sample_times(result.T, 0.1)
        st = sample_trajectories(result.coef, np.asarray(result.T), ts,
                                 n=param.n, device=device).cpu().numpy()
        d = Path(args.log_dir)
        plot_quad_dynamics(ts, st[:, :, 1], st[:, :, 2], mission.max_vel,
                           mission.max_acc, path=str(d / "dynamics.png"))
        plot_safety_margin(ts, st[:, :, 0], mission.radius, param.downwash,
                           path=str(d / "safety_margin.png"))
        plot_trajectories_topview(st[:, :, 0], result.init_traj, world,
                                  path=str(d / "trajectories.png"))
        if args.animate:
            animate_swarm(ts, st[:, :, 0], mission.radius, world,
                          result.init_traj, downwash=param.downwash,
                          path=str(d / "playback.gif"))

    polish = result.solver_info.get("exact_polish_rounds")
    if args.json:
        out = {"metrics": metrics, "times": dataclasses.asdict(times)}
        if polish is not None:
            out["exact_polish"] = polish
        print(json.dumps(out))
    else:
        print(f"agents={mission.qn} M={result.M} makespan={result.T[-1]:.2f}s")
        print(f"stage runtimes [s]: esdf={times.esdf:.3f} "
              f"search={times.init_traj:.3f} corridor={times.corridor:.3f} "
              f"qp={times.qp:.3f} timescale={times.timescale:.3f} "
              f"total={times.total:.3f}")
        for k, v in metrics.items():
            print(f"  {k}: {v:.6f}")
        for r, a in enumerate(polish or ()):
            print(f"exact polish round {r}: accepted={a['accepted']} "
                  f"kkt_optimal={a['kkt_optimal']} passes={a['passes']} "
                  f"n_active={a['n_active']} obj_in={a['obj_in']} "
                  f"obj_out={a['obj_out']}")
        ok = metrics["min_safety_ratio"] >= 1.0
        print("RESULT:", "collision-free" if ok else "COLLISION")
        return 0 if ok else 1
    return 0


def _run_scp(mission, param, args, device) -> int:
    """SCP baseline (swarm_traj_planner_scp.cpp: obstacle-free world; the
    reference adds 0.01 start noise, here ``--noise`` adds a seeded
    one), each QP on ``device``."""
    import numpy as np

    from swarm_simulator_tpu_torch.qp.scp import plan_scp

    res = plan_scp(mission, param, device=device)
    pos = res.pos  # [3, N, K]
    iu, ju = np.triu_indices(pos.shape[1], k=1)
    dmin = np.linalg.norm(pos[:, iu] - pos[:, ju], axis=0).min(axis=1)
    ratios = dmin / (mission.radius[iu] + mission.radius[ju])
    ratio = float(ratios.min()) if len(ratios) else float("inf")
    goal_err = float(np.max(np.abs(pos[:, :, -1].T - mission.goal[:, :3])))
    print(f"SCP: K={res.K} h={res.h} scp_iterations={res.iterations} "
          f"cost={res.cost:.4f}")
    if args.log_dir:
        from pathlib import Path

        from swarm_simulator_tpu_torch.io.viz import plot_scp_distances
        Path(args.log_dir).mkdir(parents=True, exist_ok=True)
        plot_scp_distances(res, mission.radius,
                           path=str(Path(args.log_dir) / "scp_distances.png"))
    print(f"  min_dist_ratio: {ratio:.4f}")
    print(f"  goal_err: {goal_err:.6f}")
    # SCP enforces (linearized) separation at discrete timesteps only,
    # like the reference (scp_planner.hpp:253-291), so the ratio check
    # allows discretization slack
    ok = ratio >= 0.99 and goal_err < 1e-2
    print("RESULT:", "collision-free" if ok else "CHECK FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
