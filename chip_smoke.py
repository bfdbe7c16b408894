#!/usr/bin/env python3
"""Drive the PyTorch port's planning path once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi), then the build of the
     fused ADMM chunk kernel (csrc/nsfused.cu) from the checkout;
  2. the kernel against its plain torch twin at the canonical 64-agent
     shapes: one 50-iteration chunk from the cold state on every rho rung,
     through the kernel, the float32 twin and a float64 twin; on each part
     of the state, each error relative to that part's own scale, the
     kernel's worst error against the float64 twin held to a multiple of
     the float32 twin's (ops/nsfused.twin_gap_use states the tolerance);
     and the median chunk time of kernel and float32 twin (CUDA events);
  3. the end-to-end slice: ``plan(..., solver="nullspace")`` on the card
     for the 64-agent, 20-obstacle forest of seed 0, with the kernel's
     launch count read around that run, then the acceptance gate
     (collision ratio, continuity, endpoints, boxes, post-timescale
     dynamic limits) and the objective pin, then a second (warm) cycle;
  4. the phased solve alone, through the kernel and then (for comparison
     only) through the plain twin on the card, timed on the host clock.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA card the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
OBS_NUM = 20
N_AGENTS = 64
N_INNER = 50
OBJ_PIN = 4.0


def log(*a):
    print(*a, flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def build_problem(seed: int = 0):
    """The canonical 64-agent forest (plan_rbp_random_forest.launch knobs,
    random_map_generator.cpp:56-113 geometry, seeded) through the port's
    host pipeline: world, ESDF, ECBS, corridors."""
    from swarm_simulator_tpu_torch import Param
    from swarm_simulator_tpu_torch.corridor.times import build_corridors
    from swarm_simulator_tpu_torch.io.mission_json import \
        perimeter_swap_mission
    from swarm_simulator_tpu_torch.search.planner import \
        plan_initial_trajectories
    from swarm_simulator_tpu_torch.world.esdf import ESDF
    from swarm_simulator_tpu_torch.world.forest import generate_forest

    param = Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                  solver="nullspace", solver_dtype="float32")
    mission = perimeter_swap_mission(N_AGENTS, half=4.0, z=1.0, radius=0.15)
    world = generate_forest(mission, world_min=param.world_min,
                            world_max=param.world_max, obs_num=OBS_NUM,
                            r_min=0.3, r_max=0.3, h_min=0.0, h_max=2.5,
                            margin=0.5, seed=seed)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)
    return plan, mission, param, world


def cuda_ms(fn, reps: int) -> list[float]:
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def on_device(data, op, dev, dtype):
    """The host QP and operator on ``dev``, floating leaves in ``dtype``."""
    import dataclasses

    from swarm_simulator_tpu_torch.qp import nullspace as ns

    d = data.to(dev)
    d = dataclasses.replace(d, **{
        f.name: getattr(d, f.name).to(dtype) for f in dataclasses.fields(d)
        if torch.is_floating_point(getattr(d, f.name))})
    return d, ns.NSOp(*(v.to(dtype) for v in op.to(dev)))


def kernel_vs_twin(plan, mission, param, dev):
    """Phase 2: one chunk per rung through the kernel, the float32 twin and
    a float64 twin, all from the same cold state.  Returns the errors, the
    times, and the host problem and operator for phase 4."""
    from swarm_simulator_tpu_torch.ops import nsfused
    from swarm_simulator_tpu_torch.qp import joint, nullspace as ns

    s = joint.production_phases()[0]
    data, _ = joint.assemble_joint(plan, mission, param)
    t0 = time.perf_counter()
    op = ns.prepare_ns_np(data, s)
    log(f"host f64 prep: {time.perf_counter() - t0:.3f} s, pivots "
        f"{tuple(op.Dinvs.shape)} {op.Dinvs.dtype}")

    ops32, st32 = ns.cold_chunk_inputs(*on_device(data, op, dev,
                                                  torch.float32), s)
    ops64, st64 = ns.cold_chunk_inputs(*on_device(data, op, dev,
                                                  torch.float64), s)
    errs = {"k32": [], "k64": [], "t64": []}
    max_abs = 0.0
    k_ms, t_ms = [], []
    for r in range(op.Dinvs.shape[0]):
        a32 = (ops32, r, s.sigma, s.alpha, *st32)
        kern = nsfused.nsfused_chunk(*a32, n_inner=N_INNER)
        twin = nsfused.nsfused_chunk_reference(*a32, n_inner=N_INNER)
        twin64 = nsfused.nsfused_chunk_reference(
            ops64, r, s.sigma, s.alpha, *st64, n_inner=N_INNER)
        torch.cuda.synchronize()
        for name, k, t in zip(nsfused.STATE_PARTS,
                              (kern[0], *kern[1], *kern[2]),
                              (twin[0], *twin[1], *twin[2])):
            check(bool(torch.isfinite(k).all()),
                  f"rung {r}: kernel {name} not finite")
            max_abs = max(max_abs, float((k - t).abs().max()))
        errs["k32"].append(nsfused.state_errors(kern, twin))
        errs["k64"].append(nsfused.state_errors(kern, twin64))
        errs["t64"].append(nsfused.state_errors(twin, twin64))
        k_ms += cuda_ms(lambda: nsfused.nsfused_chunk(*a32, n_inner=N_INNER),
                        3)
        t_ms += cuda_ms(lambda: nsfused.nsfused_chunk_reference(
            *a32, n_inner=N_INNER), 1)
        log(f"rung {r} (rho {float(op.ladder[r]):.3g}) rel err "
            + " ".join(f"{n}: k-t32 {a:.1e} k-t64 {b:.1e} t32-t64 {c:.1e};"
                       for n, a, b, c in zip(nsfused.STATE_PARTS,
                                             errs["k32"][-1],
                                             errs["k64"][-1],
                                             errs["t64"][-1]))
            + f" kernel {np.median(k_ms[-3:]):.3f} ms twin {t_ms[-1]:.3f} ms")
    use = nsfused.twin_gap_use(errs["k64"], errs["t64"])
    log("share of the tolerance used per part (worst kernel vs float64 "
        f"twin over {nsfused.TWIN_GAP_FACTOR} x worst float32 twin vs "
        f"float64 twin + {nsfused.TWIN_GAP_FLOOR}; limit 1): "
        + " ".join(f"{n} {v:.2f}" for n, v in use.items()))
    for name, v in use.items():
        check(v <= 1.0, f"{name}: the kernel is less accurate than the "
              f"float32 twin allows ({v:.2f} of the tolerance)")
    worst = {key: max(max(e) for e in rows) for key, rows in errs.items()}
    return dict(worst=worst, use=max(use.values()), max_abs_err=max_abs,
                ms=float(np.median(k_ms)), plain_ms=float(np.median(t_ms)),
                data=data, op=op)


def solve_kernel_vs_twin(data, op, dev):
    """Phase 4: the production phased solve alone (host prep done), through
    the kernel, then through the plain twin put in the kernel's place for
    one float32 and one float64 run, then through the kernel again."""
    from unittest import mock

    from swarm_simulator_tpu_torch.ops import nsfused
    from swarm_simulator_tpu_torch.qp import joint, nullspace as ns

    s0, it_k, lo_k, hi_k = ns.schedule_arrays(joint.production_phases())

    def run(dtype):
        d, o = on_device(data, op, dev, dtype)
        t0 = time.perf_counter()
        x, info = ns.solve_ns_schedule(d, o, s0, it_k, lo_k, hi_k)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, int(info.iters), x.double()

    k1_s, k1_it, xk = run(torch.float32)
    with mock.patch.object(nsfused, "nsfused_chunk",
                           nsfused.nsfused_chunk_reference):
        tw_s, tw_it, xt = run(torch.float32)
        t64_s, t64_it, x64 = run(torch.float64)
    k2_s, k2_it, _ = run(torch.float32)

    def dx(a):
        return float((a - x64).abs().max()) / float(x64.abs().max())

    log(f"solve alone, host clock: kernel {k1_s:.3f} s ({k1_it} iters), "
        f"float32 twin {tw_s:.3f} s ({tw_it} iters), float64 twin "
        f"{t64_s:.3f} s ({t64_it} iters), kernel {k2_s:.3f} s ({k2_it} "
        f"iters); solution rel diff from the float64 twin's: kernel "
        f"{dx(xk):.2e}, float32 twin {dx(xt):.2e}")
    check(k1_it == k2_it, f"kernel solves disagree: {k1_it} vs {k2_it} "
          "iterations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on the "
              "card", file=sys.stderr)
        return 2
    import swarm_simulator_tpu_torch as port
    from swarm_simulator_tpu_torch.eval.gate import gate_quality
    from swarm_simulator_tpu_torch.ops import nsfused

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    path, build_s, ptxas = nsfused.build_kernel(verbose=True)
    log(f"kernel build: {build_s:.2f} s -> {path.name}")
    for line in ptxas.splitlines():
        if "nsfused" in line or "registers" in line or "spill" in line:
            log("  " + line.strip())

    t0 = time.perf_counter()
    plan0, mission, param, world = build_problem(SEED)
    log(f"problem: {mission.qn} agents, M={plan0.M}, pairs "
        f"{len(plan0.pair_idx)}, host build {time.perf_counter() - t0:.2f} s")

    k1 = kernel_vs_twin(plan0, mission, param, dev)
    w = k1["worst"]
    log(f"K1 vs twin, own-scale rel err: worst vs float32 twin "
        f"{w['k32']:.3e}, vs float64 twin {w['k64']:.3e}, float32 twin vs "
        f"float64 twin {w['t64']:.3e}; tolerance used {k1['use']:.2f}; "
        f"max abs err vs float32 twin {k1['max_abs_err']:.3e}; median "
        f"chunk kernel {k1['ms']:.3f} ms, twin {k1['plain_ms']:.3f} ms")

    # ---- phase 3: the end-to-end slice through the user entry point ----
    nsfused.nsfused_chunk.launches = 0
    nsfused.nsfused_chunk_reference.cuda_calls = 0
    t0 = time.perf_counter()
    result, times = port.plan(mission, param, world, device=dev)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = nsfused.nsfused_chunk.launches
    twin_cuda = nsfused.nsfused_chunk_reference.cuda_calls
    info = result.solver_info
    log(f"cold cycle {cold_s:.3f} s: esdf {times.esdf:.3f} search "
        f"{times.init_traj:.3f} corridor {times.corridor:.3f} qp "
        f"{times.qp:.3f} (prep {info['prep_s']:.3f} solve "
        f"{info['solve_s']:.3f}) timescale "
        f"{times.timescale:.3f}")
    log(f"iters {info['iters'][0]} r_prim {info['r_prim'][0]:.3e} r_dual "
        f"{info['r_dual'][0]:.3e} obj {info['obj'][0]:.4f} K1 launches "
        f"{launches} twin calls on CUDA {twin_cuda}")
    check(launches > 0, "the main path launched the kernel 0 times")
    check(twin_cuda == 0, f"the main path ran the plain twin on CUDA "
          f"{twin_cuda} times")
    check(bool(np.isfinite(result.ctrl).all()), "non-finite control points")
    check(result.ctrl.shape == (mission.qn, result.M, param.n + 1, 3),
          f"control points of shape {result.ctrl.shape}")

    ok, m = gate_quality(result.ctrl, result, mission, param, device=dev)
    log("gate: " + json.dumps({k: (float(v) if not isinstance(v, bool)
                                   else v) for k, v in m.items()}))
    check(ok, f"acceptance gate failed: {m}")
    check(info["obj"][0] < OBJ_PIN, f"objective {info['obj'][0]} >= "
          f"{OBJ_PIN}")
    metrics = port.evaluate(result, mission, param, device=dev)
    log("evaluate: " + json.dumps(metrics))

    t0 = time.perf_counter()
    result2, times2 = port.plan(mission, param, world, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"warm cycle {warm_s:.3f} s: qp {times2.qp:.3f} (prep "
        f"{result2.solver_info['prep_s']:.3f} solve "
        f"{result2.solver_info['solve_s']:.3f}) iters "
        f"{result2.solver_info['iters'][0]}")
    check(bool(np.isfinite(result2.ctrl).all()), "warm cycle not finite")

    solve_kernel_vs_twin(k1["data"], k1["op"], dev)

    print(json.dumps({"kernels": [{
        "name": "nsfused_chunk", "route": "cuda",
        "source": "swarm_simulator_tpu_torch/csrc/nsfused.cu",
        "replaces": "swarm_simulator_tpu/ops/pallas_nsfused.py:175",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
