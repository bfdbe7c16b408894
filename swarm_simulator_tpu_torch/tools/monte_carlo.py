"""The scenario axis on the card: Monte-Carlo forest planning, batched.

The port's counterpart of the JAX package's tools/monte_carlo_tpu.py.
Each run plans n seeded random-forest scenarios of one mission through
parallel/scenarios.run_monte_carlo: host prep (ESDF, ECBS, corridors) in
threads, then the (scenario, agent group) problems of each segment bucket
stacked on one axis and solved as one Jacobi sweep on the card.  Runs:

  8x16    the 8-agent swap, 16 scenarios (seeds 100-115): the JAX tool's
          mission, Param (batches of 4, two Jacobi rounds) and dense
          ADMM settings (max_iter 500), as benchmarks/monte_carlo16_tpu.json
  8x64    the same, 64 scenarios (benchmarks/monte_carlo64_tpu.json)
  256x16  256 agents x 16 scenarios through the scenario path: the
          256-agent scatter mission (seed 0, the same in every scenario)
          in the 20 x 20 m world of tools/monte_carlo256.py with 40
          obstacles, batches of 4, two Jacobi rounds, the module's cg
          settings, pipelined in chunks of 4 scenarios (the stack of 64
          groups x 16 scenarios, with 1014 pair rows a group, would hold
          ~10 GB of pair operands at once).  This is not the JAX
          package's tools/monte_carlo256.py run (one joint solve of all
          256 agents a scenario, a scatter mission a seed, the full
          gate), which the scenario path does not do.

Each run is done twice in one process (the second with the native
library and the card warm); per run: wall seconds, scenarios
collision-free (sampled safety ratio >= 1), the ratios, the pairs below
ratio 1 split by whether both agents are in one Jacobi group or in two,
the buckets, host prep seconds against stacked solve seconds, and the
card's name and power limit.  One JSON object a run on stdout.

Usage (on the card): python3 -m swarm_simulator_tpu_torch.tools.monte_carlo
    [--runs 8x16,8x64,256x16] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def collisions_by_group(plan, mission, param, dev) -> dict:
    """The pairs of ``plan`` whose sampled safety ratio (evaluate()'s,
    step 0.1) falls below 1, counted by whether both agents are in one
    Jacobi group (agent // batch_size) or in two, and each kind's least
    ratio."""
    import numpy as np

    from swarm_simulator_tpu_torch.eval import sample, safety

    ts = sample.sample_times(plan.T, 0.1)
    pos = sample.sample_trajectories(plan.coef, np.asarray(plan.T), ts,
                                     n=param.n, derivatives=1,
                                     device=dev)[:, :, 0]
    iu, ju, ratio = safety.pair_ratios(pos, mission.radius,
                                       downwash=param.downwash, device=dev)
    same = iu // param.batch_size == ju // param.batch_size
    out = {}
    for kind, sel in (("same_group", same), ("cross_group", ~same)):
        r = ratio[sel]
        out[kind] = {"pairs_below_1": int((r < 1).sum()),
                     "min_ratio": round(float(r.min()), 4)}
    return out


def run_config(name: str, dev) -> dict:
    import torch

    import swarm_simulator_tpu_torch as port
    from swarm_simulator_tpu_torch.io.mission_json import (scatter_mission,
                                                           swap_mission)
    from swarm_simulator_tpu_torch.parallel import scenarios as scn
    from swarm_simulator_tpu_torch.qp import admm

    if name.startswith("8x"):
        n = int(name[2:])
        mission = swap_mission(8, z=1.0, span=4.0, radius=0.12)
        param = port.Param(world_z_min=0.0, grid_xy_res=0.5, grid_z_res=1.0,
                           sequential=True, batch_size=4, batch_iter=-1,
                           iteration=2, solver_dtype="float32")
        settings = admm.ADMMSettings(max_iter=500, eps_abs=2e-4,
                                     eps_rel=2e-4, kkt_solver="dense",
                                     eps_dual_abs=1.5)
        kw = dict(n_scenarios=n, seed0=100, settings=settings)
    elif name == "256x16":
        mission = scatter_mission(256, half=9.5, z=1.0, seed=0)
        param = port.Param(world_x_min=-10, world_x_max=10, world_y_min=-10,
                           world_y_max=10, world_z_min=0.3, world_z_max=2.5,
                           grid_xy_res=0.5, grid_z_res=1.0, sequential=True,
                           batch_size=4, batch_iter=-1, iteration=2,
                           solver_dtype="float32")
        kw = dict(n_scenarios=16, seed0=100, pipeline=4,
                  forest_kwargs=dict(obs_num=40))
    else:
        raise ValueError(f"unknown run {name!r}")

    walls = []
    for _ in range(2):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = scn.run_monte_carlo(mission, param, device=dev, **kw)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    ratios, errors, groups = [], [], []
    for sc in out:
        if sc.error is not None or sc.plan is None:
            errors.append(sc.error)
            continue
        m = port.evaluate(sc.plan, mission, param, device=dev)
        ratios.append(round(float(m["min_safety_ratio"]), 4))
        groups.append(collisions_by_group(sc.plan, mission, param, dev))
    solves = {}
    for sc in out:
        if sc.plan is not None and sc.plan.solver_info:
            i = sc.plan.solver_info
            solves[(i["M"], i["solve_s"])] = i["solve_s"] + i["assemble_s"]
    prep = {k: float(sum(sc.times.get(k, 0.0) for sc in out))
            for k in ("esdf", "search", "corridor")}
    return {"run": name, "scenarios": kw["n_scenarios"],
            "agents": mission.qn, "pipeline": kw.get("pipeline"),
            "collision_free": int(sum(r >= 1.0 for r in ratios)),
            "ratios": ratios, "errors": errors,
            "collisions_by_group": groups,
            "wall_s": walls[0], "wall_warm_s": walls[1],
            "s_per_scenario_warm": walls[1] / kw["n_scenarios"],
            "host_prep_thread_s": prep,
            "assemble_solve_s": float(sum(solves.values())),
            "stacks": len(solves),
            "m_buckets": sorted({int(sc.plan.M) for sc in out
                                 if sc.plan is not None}),
            "iters": [sc.plan.solver_info["iters"] for sc in out
                      if sc.plan is not None and sc.plan.solver_info],
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default="8x16,8x64,256x16")
    ap.add_argument("--out", default=None,
                    help="also write the JSON objects, one a line, here")
    args = ap.parse_args(argv)

    import torch

    from swarm_simulator_tpu_torch.tools._timing import card

    if not torch.cuda.is_available():
        print("monte_carlo: no CUDA card (this tool measures the card)",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.init()
    smi = card()
    lines = []
    for name in args.runs.split(","):
        torch.cuda.reset_peak_memory_stats(dev)
        res = dict(run_config(name, dev), card=smi)
        print(json.dumps(res), flush=True)
        lines.append(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
