"""How float32 rounding moves the knot-state Jacobi sweep of the 64-agent
forest on the card.

    python3 -m swarm_simulator_tpu_torch.tools.jacobi_f32_study

The sweep of chip_smoke.py's phase 20 (``perimeter_swap_mission(64)``, 20
obstacles, seed 0, 16 groups of 4, tighten 2e-3, the default max_iter),
run round by round (a round is a one-round sweep from the previous
round's control points, which is what a two-round sweep without carried
state does), once per arm:

- ``dense64``: the dense KKT mode in float64 (no float32 rounding; the
  reference of the other arms);
- ``k1``: the banded mode in float32, every chunk one launch of the fused
  kernel K1 a group;
- ``twin32``: the same with K1's plain twin in its place (~6 min).

Prints one JSON object a round and arm (seconds, the safety ratio of the
plan time-scaled as plan() scales it, the groups' iterations and
residuals), then one a round with each float32 arm's control-point error
a group relative to dense64 and k1's against twin32.  Without a CUDA
card it exits 2.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import sys
import time

import numpy as np
import torch

#: arm -> (kkt_mode, dtype, K1's twin in its place)
ARMS = {"dense64": ("dense", np.float64, False),
        "k1": ("banded", np.float32, False),
        "twin32": ("banded", np.float32, True)}
ROUNDS = 2
TIGHTEN = 2e-3


def forest64_groups():
    """(plan, mission, param, stacked groups, dummy) of the 64-agent
    forest: the host prep of chip_smoke.build_problem, batches of 4."""
    from swarm_simulator_tpu_torch.corridor.times import build_corridors
    from swarm_simulator_tpu_torch.parallel import seqbatch
    from swarm_simulator_tpu_torch.qp import assemble
    from swarm_simulator_tpu_torch.search.planner import \
        plan_initial_trajectories
    from swarm_simulator_tpu_torch.tools.seqbatch_f32_study import forest64
    from swarm_simulator_tpu_torch.world.esdf import ESDF
    from swarm_simulator_tpu_torch import Param

    mission, world = forest64()
    param = Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                  solver="nullspace", solver_dtype="float32")
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)
    batches, _ = seqbatch.make_batches(mission.qn, dataclasses.replace(
        param, sequential=True, batch_size=4, batch_iter=-1))
    dummy = assemble.build_dummy(plan.init_traj, param.n, plan.M)
    pairs = np.asarray(plan.pair_idx)
    pad = max(int(np.isin(pairs, b).any(axis=1).sum()) for b in batches)
    stacked = seqbatch._stack_qpdata([
        assemble.assemble_batch(plan, mission, param, b, dummy, pad)
        for b in batches])
    return plan, mission, param, stacked, dummy


def ratio(plan, mission, param, ctrl, dev) -> float:
    """evaluate()'s safety ratio of ``plan`` with control points ``ctrl``,
    time-scaled as plan() scales a solution."""
    import swarm_simulator_tpu_torch as port
    from swarm_simulator_tpu_torch.qp import convert, timescale

    res = copy.copy(plan)
    res.coef = convert.ctrl_to_coef(ctrl, plan.T, param.n)
    scale = timescale.compute_time_scale(res.coef, res.T, mission.max_vel,
                                         mission.max_acc, param.n, param.phi)
    res.coef, res.T = timescale.apply_time_scale(res.coef, res.T, scale,
                                                 param.n)
    return port.evaluate(res, mission, param,
                         device=dev)["min_safety_ratio"]


def run_arm(arm: str, plan, mission, param, stacked, dummy, dev):
    """The arm's control points after each round ([N, M, n+1, 3] float64
    on the host), printing a JSON object a round."""
    from unittest import mock

    from swarm_simulator_tpu_torch.ops import nsfused
    from swarm_simulator_tpu_torch.parallel import mesh
    from swarm_simulator_tpu_torch.qp import nullspace as ns

    mode, dtype, twin = ARMS[arm]
    s = ns.NSSettings(kkt_mode=mode, tighten=TIGHTEN)
    data = dataclasses.replace(stacked, **{
        f.name: np.asarray(getattr(stacked, f.name), dtype)
        for f in dataclasses.fields(stacked)
        if np.asarray(getattr(stacked, f.name)).dtype.kind == "f"})
    ctx = (mock.patch.object(nsfused, "nsfused_chunk",
                             nsfused.nsfused_chunk_reference)
           if twin else contextlib.nullcontext())
    out, cur = [], dummy.astype(dtype)
    with ctx:
        for r in range(ROUNDS):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            c, info = mesh.jacobi_sweep(data, cur, s, rounds=1, device=dev)
            torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            cur = c.cpu().numpy()
            out.append(cur.astype(np.float64))
            print(json.dumps({
                "arm": arm, "round": r + 1, "s": secs,
                "ratio": ratio(plan, mission, param, out[-1], dev),
                "iters": info.iters.tolist(),
                "r_prim": [float(v) for v in info.r_prim],
                "r_dual": [float(v) for v in info.r_dual]}), flush=True)
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]
                            ).parse_args(argv)
    if not torch.cuda.is_available():
        print("jacobi_f32_study: no CUDA card (this tool measures the card)",
              file=sys.stderr)
        return 2
    from swarm_simulator_tpu_torch.ops import _build
    from swarm_simulator_tpu_torch.ops.thomas import rel_error
    from swarm_simulator_tpu_torch.tools._timing import card

    dev = torch.device("cuda", 0)
    print(json.dumps({"card": card()}), flush=True)
    _build.build("nsfused")
    prob = forest64_groups()
    ctrl = {a: run_arm(a, *prob, dev) for a in ARMS}
    for r in range(ROUNDS):
        ref, k, t = (torch.as_tensor(ctrl[a][r]) for a in ARMS)
        rec = {"round": r + 1}
        for a, got in (("k1", k), ("twin32", t)):
            rec[f"{a}_vs_dense64_per_group"] = [
                rel_error(got[g:g + 4], ref[g:g + 4])
                for g in range(0, got.shape[0], 4)]
        rec["k1_vs_twin32"] = rel_error(k, t)
        rec["k1_vs_twin32_max_abs_m"] = float((k - t).abs().max())
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
