"""How float32 rounding moves the sequential-batch solve of the 64-agent
forest.

    python3 -m swarm_simulator_tpu_torch.tools.seqbatch_f32_study
        [--arms card,card-f32-inverse,card-f64] [--mode gauss-seidel]

Plans the forest (``perimeter_swap_mission(64)``, 20 obstacles, seed 0:
chip_smoke.py's problem) through ``plan()`` in one mode (gauss-seidel,
jacobi or default, as chip_smoke.py's phase 18 runs them), once per arm:

- ``card`` / ``cpu``: float32, as the port runs it (the dense KKT inverse
  computed, kept and applied in qp/admm.KINV_DTYPE, float64);
- ``card-f32-inverse`` / ``cpu-f32-inverse``: float32 with the dense
  inverse computed, kept and applied in float32, as the JAX package does
  (KINV_DTYPE set to float32 for the arm; the cg mode has no dense
  inverse, so there the arm is the plain one);
- ``card-f64`` / ``cpu-f64``: float64 (the converged plan).

Prints one JSON object: per arm the wall seconds, the solves' iters, max
r_prim and objectives, evaluate()'s metrics, and the largest control-point
distance to the float64 arm of the same device, where that arm ran.  A
card arm without a CUDA card exits 2.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

#: the modes: Param overrides by name (chip_smoke.SEQ_RUNS)
RUNS = {
    "gauss-seidel": dict(sequential=True, batch_size=4, batch_iter=-1),
    "jacobi": dict(sequential=True, batch_size=4, batch_iter=-1,
                   parallel_mode="jacobi", iteration=2),
    "default": dict(),
}


def forest64():
    """(mission, world) of the canonical 64-agent forest, seed 0."""
    from swarm_simulator_tpu_torch import Param
    from swarm_simulator_tpu_torch.io.mission_json import \
        perimeter_swap_mission
    from swarm_simulator_tpu_torch.world.forest import generate_forest

    param = Param(world_z_min=0.3)
    mission = perimeter_swap_mission(64, half=4.0, z=1.0, radius=0.15)
    world = generate_forest(mission, world_min=param.world_min,
                            world_max=param.world_max, obs_num=20,
                            r_min=0.3, r_max=0.3, h_min=0.0, h_max=2.5,
                            margin=0.5, seed=0)
    return mission, world


def run_arm(arm: str, mode: str, mission, world):
    """(result, the arm's JSON record) of one arm's plan."""
    import swarm_simulator_tpu_torch as port
    from swarm_simulator_tpu_torch import Param
    from swarm_simulator_tpu_torch.qp import admm

    dev = "cpu" if arm.startswith("cpu") else "cuda"
    dtype = "float64" if arm.endswith("-f64") else "float32"
    param = Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                  solver_dtype=dtype, **RUNS[mode])
    kinv = admm.KINV_DTYPE
    if arm.endswith("-f32-inverse"):
        admm.KINV_DTYPE = torch.float32
    try:
        t0 = time.perf_counter()
        result, _ = port.plan(mission, param, world, device=dev)
        wall = time.perf_counter() - t0
    finally:
        admm.KINV_DTYPE = kinv
    info = result.solver_info
    return result, {"wall_s": wall, "iters": info["iters"],
                    "max_r_prim": max(info["r_prim"]), "obj": info["obj"],
                    "metrics": port.evaluate(result, mission, param,
                                             device=dev)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", default="card,card-f32-inverse,card-f64")
    ap.add_argument("--mode", default="gauss-seidel", choices=tuple(RUNS))
    args = ap.parse_args()
    arms = args.arms.split(",")
    if (any(a.startswith("card") for a in arms)
            and not torch.cuda.is_available()):
        print("seqbatch_f32_study: a card arm needs a CUDA card",
              file=sys.stderr)
        return 2
    mission, world = forest64()
    out, ctrl = {}, {}
    for arm in arms:
        result, out[arm] = run_arm(arm, args.mode, mission, world)
        ctrl[arm] = result.ctrl
    for arm in ctrl:
        ref = arm.split("-")[0] + "-f64"
        if ref in ctrl:
            out[arm]["max_ctrl_gap_to_f64"] = float(
                np.abs(ctrl[arm] - ctrl[ref]).max())
    if torch.cuda.is_available():
        out["card_name"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
