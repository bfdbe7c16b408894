#!/usr/bin/env python3
"""Drive the PyTorch port's planning path once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi), then the build of the
     kernels from the checkout, one nvcc per source, started together: the
     fused ADMM chunk (K1, csrc/nsfused.cu) and its stacked form
     (csrc/nsfused_stack.cu), the Thomas solves (K2 and
     K3a/K3b, csrc/thomas.cu), the pivot stream (T4,
     csrc/thomas_stream.cu) and the probes (T2 csrc/thomas_prim.cu, T3
     csrc/thomas_probe.cu, T1 csrc/nsfused_probe.cu, T5
     csrc/row_patterns.cu);
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
     only) through the plain twin on the card, timed on the host clock;
  5. K2 against its twins at the 64-agent shapes: one seeded right-hand
     side per rung through the kernel, the float32 twin and a float64
     twin, the kernel's worst error over the rungs held to a multiple of
     the float32 twin's (thomas.twin_gap_use), on phase 2's host-prep
     inventory and again on a device-prep inventory (pivots not
     symmetric); and the median time per solve of kernel and float32
     twin (CUDA events); then the port's A x (a gather by pair index) on
     the device-prep problem's cold x against the dense-selection einsum
     form, computed in the script, float32, relative error <= 1e-5, both
     timed;
  6. the replan slice through the entry point: ``plan(..., iteration=2)``
     with replan_prep on its auto value ("device" on CUDA), with the K1
     and K2 launch counts read around it, then phase 3's gate; then
     ``plan(..., cold_prep="device")`` with the same checks;
  7. the replan round's refine-1 solve alone, through K2 and then (for
     comparison only) with the float32 twin in K2's place, host clock;
  8. the chunked Thomas sweeps K3a/K3b against their twins on phase 2's
     inventory: per rung, one seeded right-hand side through the chain
     split into n = 1 chunk (L = 35) and n = 4 chunks (L = 9, one pad
     knot), the carries chained in this process, through the kernels, the
     float32 twins and float64 twins; the kernels' worst error over the
     rungs held to thomas.twin_gap_use, and the chained result against
     K2's full solve; the median time per chunk sweep (CUDA events),
     K3a's and K3b's beside their first designs' recorded times and their
     bound;
  9. the sharded entry point: ``solve_ns_phases_sharded`` (chunk mode) on a
     1-rank NCCL group for the 64-agent forest with phase 2's host prep and
     the production phases, with the K1/K2/K3 launch counts read around
     it and a digest of its inputs, then phase 3's gate and objective pin
     on its solution;
 10. K2 on bf16 pivots against its twins at the 64-agent shapes: phase 5's
     device-prep inventory rounded to bf16, one seeded right-hand side per
     rung through the kernel, the float32 twin and the float64 twin, both
     twins on the same bf16 pivots (thomas.twin_gap_use); the median time
     per solve of K2 on the float32 inventory, K2 on the bf16 one and the
     bf16 twin (CUDA events);
 11. the refine-1 production solve of phase 2's problem (the one
     ``cold_prep="device"`` solves) on phase 5's float32 device-prep
     pivots, then with precond_dtype="bfloat16" (device prep rounded to
     bf16) through K2-bf16 and once more with the float32 twin in K2's
     place: K2-bf16 launched, K2 on float32 pivots and the twins not, a
     finite solution, and the kernel's run against the twin's (the same
     iterations, finite objectives within RUN_VS_TWIN); reported, not
     required: phase 3's gate and objective pin on it and its objective
     against the float32-pivot solve (a bf16 inventory preconditions the
     production ladder too poorly for one PCG step, in the JAX package
     too: PERF.md);
 12. the big-swarm route through the entry point: ``plan(...,
     cold_prep="device", iteration=2)`` of the 256-agent scatter problem
     (the budget256 study's, tools/budget256_study.py) with the
     large-swarm replan budgets (joint.REPLAN_BUDGETS_LARGE): stage times,
     the inventory's bytes, the peak device memory, iterations, objective,
     the gate (no objective pin at this size) on the cold round's and on
     the replan round's control points, and the replan round's prep and
     solve seconds, iterations and K2 launches (K1 none); then, on the
     same host problem, the study's full-budget arm (200, 600, 100) at refine 1: on
     float32 pivots K2 held against its twins on the arm's inventory (as
     in phase 5), A x against the einsum form as in phase 5, and the arm
     checked (ratio >= 1, box and continuity < 1e-3); on bf16 pivots
     K2-bf16 held against its twins likewise, the arm cut to its first 7
     chunks (BF16_ARM) run through the kernel and again with the float32
     twin in K2's place, the two runs held together as in phase 11, and
     its checks and objective gap against the float32 arm reported;
 13. the pivot-stream study T4 at the 256-agent shapes
     (tools/thomas_bw_study.py, [2, 71, 2304, 2304] made on the card):
     GB/s of every variant on float32 and bf16 pivots, of K2 on both and
     of torch.sum, with the launch counts read around the study; then each
     variant's output held against the plain version;
 14. the chain-primitive bench T2 (tools/thomas_prim_bench.py) at its own
     shape (bs 640, Mi 35), the 64-agent (576, 35) and the 256-agent
     (2304, 71) shapes: every mode and dma@4 on each grid timed there (one
     block and the chain ring; the ring alone at 2304), from zeros and
     from a seeded acc0, held against the plain version at REPS 2; then,
     with the launch counts read around it, us per step of each (one block
     at REPS 2, the ring at REPS 20) beside its bound, each timed launch
     held against the plain version at its own REPS;
 15. the staged Thomas probe T3 (tools/thomas_probe.py): its four stages
     (dma and mv also on the chain's spans) held against the plain version
     at its own shape (bs 256, Mi 4), then us per stage of each at the
     64-agent and 256-agent shapes beside K2's on the same pivots and mv
     beside torch.einsum, each held against the plain version, one line a
     shape splitting the chain stage (stream, dot, K2's exchange, fwd);
 16. the fused-chunk probes T1 (tools/nsfused_probe.py): P1-P4 against
     their plain versions (P3 also against float64, 3e-6) and timed, P3
     beside torch.matmul, P2 (the cluster apply) beside torch.einsum and
     its first design's recorded time, P4 (the re-layout, then the chain
     on K2's template) beside its first design's recorded time and per
     iteration beside K1's chunk as phase 2 timed it, and P4's re-layout
     alone (bit-equal to the plain permute) beside that PyTorch copy;
 17. the row-assembly patterns T5 (tools/row_patterns.py): all fourteen
     against their plain versions (bit-equal; P8's sum within 1e-6), and
     timed beside the one PyTorch call that computes each, where there is
     one (held to the plain version too), one line a pattern;
 18. the sequential-batch ADMM path (``Param.solver="admm"``, which runs no
     hand-written kernel, in the JAX package too) through
     ``plan(..., device=card)`` on the 64-agent forest, in the three modes
     of SEQ_RUNS: Gauss-Seidel batches of 4 (16 dense batch QPs), Jacobi
     with two rounds (the 16 stacked through solve_qp_batched) and
     ``Param()``'s one joint batch (cg KKT); each mode in float32, then in
     float64 as its witness; each run's stage seconds, per-batch iters,
     max r_prim and objectives, and evaluate()'s metrics; each float32
     plan held to tests/test_pipeline.py's acceptance, to the JAX
     package's float32 CPU plan of the same mode (JAX_CPU_FOREST64: the
     safety ratio no more than 1e-3 below its own, continuity and endpoint
     errors no more than twice its own), to the JAX package's float64 CPU
     plan (JAX_CPU_FOREST64_F64: the safety ratio within 1e-3, the flight
     distance within 1%, the dynamic margin within 0.01), and to its
     witness (the safety ratio within 1e-3, the control points within
     SEQ_CTRL_GAP); the kernels' and twins' counts read around the float32
     runs (all 0); the Jacobi run's QP solves per second;
 19. the oracle gate (eval/gate, the host f64 IPM of qp/ipm): gate seeds
     0-4 of the 64-agent forest, each planned through ``plan(...,
     device=card)`` (K1; phase 3's plan serves as seed 0 where its time
     scale is 1), graded on bench.py's rotating oracle batch (0, 7, 14,
     5, 12 of 16 batches of 4) by the full gate with the IPM objective
     criterion at obj_tol 1.25, each seed's margin obj_b0 / obj_ref, the
     oracle's seconds and any warm escalation (above
     joint.ESCALATION_TRIGGER, bench.py:464-479) printed; then seed 0
     planned with ``exact_polish`` (qp/activeset): K1 launched, no twin
     on CUDA, the polish accepted, its objective not above the input's,
     the full gate, and the margin within 1e-6 of the unpolished one or
     below and <= 1.01 (the polished plan's oracle with every pair rhs
     lowered by 1e-6, a stricter reading); the host's BLAS threads.
 20. the scenario axis, the per-phase solve and SCP: run_monte_carlo of
     forest seeds 0-7 (64 agents, float32, cg) two-phase and pipelined
     (chunks of 4), each scenario's bucket, rounds, iterations and stage
     seconds, held to no kernel or twin run, pipelined coefficients within
     MC_PIPE_TOL of the two-phase ones, safety ratio >= 1 - 1e-3, and the
     control points within phase 18's cg bar of a float64 run on the
     card; the knot-state Jacobi sweep (16 groups of 4, two rounds)
     banded in float32 (a chunk one launch of the stacked kernel for the
     running groups: at most 60 launches, no per-problem K1, no twin) and
     dense in float64 (the dense stack: no kernel), each with one host
     sync a chunk and no per-entry loop, each time-scaled plan
     held to tests/test_pipeline.py:_check but for its safety ratio,
     which is printed beside the JAX package's (below 1 there too:
     JAX_CPU_JACOBI64) and held to it in float64, and in float32 to the
     card's float32 twin sweep (CARD_TWIN_JACOBI_F32); the stacked kernel
     on the 16 groups' own operands at rung 0, the last rung and mixed
     rungs against its twins (phase 2's rule, each group and state part)
     and no less accurate than per-problem K1 on the same chunks
     and bit-equal to each group launched alone, one launch timed against
     16 per-problem K1 launches of the same chunk; the banded sweep at a
     short schedule, and group 0's first round at the sweep's own,
     through the stacked kernel and with the float32 twins in the
     kernels' places (stack launches 0 there, twin calls above 0), held
     to K1's tolerance against a float64 twin's; groups 0, 5 and 15 of
     each mode alone against the 16-stack (equal iterations and rungs;
     dense x within ALONE_DENSE_TOL, banded group 0 within K1's twin
     rule); plan() with per-phase
     production phases (restore tightened by RESTORE_TIGHTEN) through K1
     with the full oracle gate, its margin beside phase 19's; the sweep
     CLI (``python -m swarm_simulator_tpu_torch.cli.sweep``, two
     subprocesses, admm and nullspace) over forests 0-2 written as .bt:
     exit 0, ``# success 3/3``, map 1's ratio equal to the library plan's;
     ``cli.plan --preset scp --alg scp`` on the 8-agent swap with the
     reference's start noise in float32 and float64: exit 0 and the
     costs within SCP_COST_TOL.
 21. (a) Anderson acceleration: phase 2's problem through
     ``solve_ns_phases`` with the production phases at aa_depth 5 (per
     phase, K1 chunks) beside the production schedule: K1 launched, no
     twin on CUDA, the gate's clauses required and both objective margins
     printed (the 1.25 criterion printed, not required); the first three
     AA chunks through K1 against the float32 twin within K1's tolerance;
     (b) the KKT route: joint.select_kkt_path and ops/nsfused.fits at 64,
     96 and 256 agents (256 from the shapes alone), the 96-agent scatter
     problem (host prep) through K1 and through the K2 route, timed, each
     with the gate's clauses (no oracle), K1 and K2 held to their twins at its
     shapes; (c) the device EDT of the 64-agent forest and of the
     256-agent 20 m world on the card, bit-equal to the CPU form and
     within 1e-4 of the native EDT, timed; (d) the 256-agent RSFC planes
     through the numpy chain, the torch form on the CPU and on the card,
     timed and held together at 1e-12;
 22. the (scenario, batch) Jacobi sweep of 4 copies of the 64-agent
     forest's 16 groups on a 1 x 1 grid of one NCCL rank
     (tools/dryrun_multichip's part 2), bit-equal to stacked_sweep.
The host's OpenBLAS runs one thread unless the caller set
OPENBLAS_NUM_THREADS.  The line before the last is the kernels' JSON record (each kernel's
launches on its own path, errors, times of kernel and plain twin, and its
bound: the larger of its bytes over 3.35 TB/s and its operations over the
card's peak for their type, 67 TFLOP/s float32, 34 TFLOP/s float64 or
989 TFLOP/s bf16 on the tensor cores; the library time is that of the one PyTorch call computing
the same function, where there is one); the last line is
{"ok": true, "device": {...}}.  Without a CUDA card the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

# the host f64 prep and the oracles' factorizations on one BLAS thread
# (set before numpy loads): on the card's 8-CPU host OpenBLAS's default
# thread a CPU slows them 2-4x (PERF.md); a caller's own setting stands
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
#: bench.py's gate seeds, each graded by the IPM oracle in phase 19
GATE_SEEDS = (0, 1, 2, 3, 4)
#: bench.py's Param draws the oracle's agent batch from sequential batches
#: of 4 (bench.py:63-65); the joint solve ignores these fields
ORACLE_BATCHES = dict(sequential=True, batch_size=4, batch_iter=-1)
OBS_NUM = 20
N_AGENTS = 64
N_INNER = 50
OBJ_PIN = 4.0
#: H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, float32 FLOP/s on
#: the CUDA cores (the kernels' FMA arithmetic), dense bf16 FLOP/s on the
#: tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
#: phase 18's runs of the 64-agent forest: Param overrides by name (the
#: same as tests/test_torch_seqbatch.py's FOREST64_RUNS)
SEQ_RUNS = {
    "gauss-seidel": dict(sequential=True, batch_size=4, batch_iter=-1),
    "jacobi": dict(sequential=True, batch_size=4, batch_iter=-1,
                   parallel_mode="jacobi", iteration=2),
    "default": dict(),
}
#: the JAX package's plans of the same three runs on a CPU host
#: (``PYTHONPATH=. python tests/test_torch_seqbatch.py --dtype DTYPE``,
#: x64 on for float64 only, as its CLI; PERF.md): the evaluate() metrics
#: that phase 18 holds the port's float32 plans to
JAX_CPU_FOREST64 = {
    "gauss-seidel": dict(min_safety_ratio=1.0179721117019653,
                         flight_distance=817.0714721679688,
                         knot_continuity_err=0.0008441507816314697,
                         dynamic_violation=-0.6484875202178955,
                         start_err=3.814697265625e-06,
                         goal_err=4.291534423828125e-06),
    "jacobi": dict(min_safety_ratio=1.0132229328155518,
                   flight_distance=817.931396484375,
                   knot_continuity_err=0.0005767643451690674,
                   dynamic_violation=-1.037071657180786,
                   start_err=5.245208740234375e-06,
                   goal_err=4.76837158203125e-06),
    "default": dict(min_safety_ratio=1.0159355401992798,
                    flight_distance=794.4036865234375,
                    knot_continuity_err=0.0003867573104798794,
                    dynamic_violation=-1.0787240386009216,
                    start_err=7.152557373046875e-06,
                    goal_err=1.0967254638671875e-05),
}
JAX_CPU_FOREST64_F64 = {
    "gauss-seidel": dict(min_safety_ratio=1.0196210145512858,
                         flight_distance=806.2179333781313,
                         knot_continuity_err=1.1245064441278707e-05,
                         dynamic_violation=-0.652523565244169,
                         start_err=4.425265043295212e-09,
                         goal_err=3.3527109977171676e-09),
    "jacobi": dict(min_safety_ratio=1.0218912856739872,
                   flight_distance=798.132934129574,
                   knot_continuity_err=1.3010205804353525e-06,
                   dynamic_violation=-1.047696409685242,
                   start_err=3.0488491731262e-09,
                   goal_err=1.0261742566797238e-09),
    "default": dict(min_safety_ratio=1.0160191087237063,
                    flight_distance=794.4808964293383,
                    knot_continuity_err=1.2445377495784449e-06,
                    dynamic_violation=-1.0777517432519512,
                    start_err=3.746026600026653e-09,
                    goal_err=2.7848163774990553e-09),
}
#: the largest |ctrl32 - ctrl64| (m) a float32 plan may sit from its
#: float64 witness: the dense modes' float32 plans sit within 6 mm of it
#: (their inverse applied in float64), 0.4-0.75 m with the inverse applied
#: in float32 (the JAX package's operator); the cg mode's within 0.11 m,
#: the JAX package's float32 plan too (PERF.md)
SEQ_CTRL_GAP = {"gauss-seidel": 0.05, "jacobi": 0.05, "default": 0.25}


def bound(nbytes: float, flops: float,
          rate: float = F32_FLOPS) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take to move
    ``nbytes`` and do ``flops`` operations at ``rate`` a second."""
    t_b, t_f = nbytes / HBM_BPS, flops / rate
    return (1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations")


def log(*a):
    print(*a, flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def forest(seed: int = 0):
    """The canonical 64-agent forest (plan_rbp_random_forest.launch knobs,
    random_map_generator.cpp:56-113 geometry, seeded): mission, Param of
    the joint solve, world."""
    from swarm_simulator_tpu_torch import Param
    from swarm_simulator_tpu_torch.io.mission_json import \
        perimeter_swap_mission
    from swarm_simulator_tpu_torch.world.forest import generate_forest

    param = Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                  solver="nullspace", solver_dtype="float32")
    mission = perimeter_swap_mission(N_AGENTS, half=4.0, z=1.0, radius=0.15)
    world = generate_forest(mission, world_min=param.world_min,
                            world_max=param.world_max, obs_num=OBS_NUM,
                            r_min=0.3, r_max=0.3, h_min=0.0, h_max=2.5,
                            margin=0.5, seed=seed)
    return mission, param, world


def build_problem(seed: int = 0):
    """The canonical 64-agent forest of ``seed`` through the port's host
    pipeline: world, ESDF, ECBS, corridors."""
    from swarm_simulator_tpu_torch.corridor.times import build_corridors
    from swarm_simulator_tpu_torch.search.planner import \
        plan_initial_trajectories
    from swarm_simulator_tpu_torch.world.esdf import ESDF

    mission, param, world = forest(seed)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)
    return plan, mission, param, world


def digest(tree) -> str:
    """A short sha256 of a host problem's arrays (a QPData or an NSOp of
    numpy leaves), to tell whether two processes solved the same inputs."""
    import hashlib

    leaves = ([getattr(tree, f.name) for f in dataclasses.fields(tree)]
              if dataclasses.is_dataclass(tree) else tuple(tree))
    h = hashlib.sha256()
    for v in leaves:
        if v is not None:
            h.update(np.ascontiguousarray(np.asarray(v)).tobytes())
    return h.hexdigest()[:12]


def on_device(data, op, dev, dtype):
    """The host QP and operator on ``dev``, floating leaves in ``dtype``."""
    from swarm_simulator_tpu_torch.qp import nullspace as ns

    d = data.to(dev)
    d = dataclasses.replace(d, **{
        f.name: getattr(d, f.name).to(dtype) for f in dataclasses.fields(d)
        if torch.is_floating_point(getattr(d, f.name))})
    return d, ns.NSOp(*(None if v is None else v.to(dtype)
                        for v in op.to(dev)))


def kernel_vs_twin(plan, mission, param, dev):
    """Phase 2: one chunk per rung through the kernel, the float32 twin and
    a float64 twin, all from the same cold state.  Returns the errors, the
    times, and the host problem and operator for phase 4."""
    from swarm_simulator_tpu_torch.qp import joint, nullspace as ns

    s = joint.production_phases()[0]
    data, _ = joint.assemble_joint(plan, mission, param)
    t0 = time.perf_counter()
    op = ns.prepare_ns_np(data, s)
    log(f"host f64 prep: {time.perf_counter() - t0:.3f} s, pivots "
        f"{tuple(op.Dinvs.shape)} {op.Dinvs.dtype}")
    return dict(chunk_vs_twins(data, op, s, dev, ""), data=data, op=op)


def chunk_vs_twins(data, op, s, dev, label: str, rungs=None) -> dict:
    """One chunk per rung of the host problem ``data`` and its host-prep
    operator ``op`` through the kernel, the float32 twin and a float64
    twin, all from the same cold state: the errors (the kernel's against
    the float64 twin held to ops/nsfused.twin_gap_use), the median times
    of kernel and float32 twin, and the chunk's bound.  ``rungs``: the
    rungs to hold (None: every rung)."""
    from swarm_simulator_tpu_torch.ops import nsfused
    from swarm_simulator_tpu_torch.qp import nullspace as ns
    from swarm_simulator_tpu_torch.tools._timing import event_ms

    ops32, st32 = ns.cold_chunk_inputs(*on_device(data, op, dev,
                                                  torch.float32), s)
    ops64, st64 = ns.cold_chunk_inputs(*on_device(data, op, dev,
                                                  torch.float64), s)
    errs = {"k32": [], "k64": [], "t64": []}
    max_abs = 0.0
    k_ms, t_ms = [], []
    for r in rungs or range(op.Dinvs.shape[0]):
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
        k_ms += event_ms(lambda: nsfused.nsfused_chunk(
            *a32, n_inner=N_INNER), 3, warmup=0)
        t_ms += event_ms(lambda: nsfused.nsfused_chunk_reference(
            *a32, n_inner=N_INNER), 1, warmup=0)
        log(f"{label}rung {r} (rho {float(op.ladder[r]):.3g}) rel err "
            + " ".join(f"{n}: k-t32 {a:.1e} k-t64 {b:.1e} t32-t64 {c:.1e};"
                       for n, a, b, c in zip(nsfused.STATE_PARTS,
                                             errs["k32"][-1],
                                             errs["k64"][-1],
                                             errs["t64"][-1]))
            + f" kernel {np.median(k_ms[-3:]):.3f} ms twin {t_ms[-1]:.3f} ms")
    use = nsfused.twin_gap_use(errs["k64"], errs["t64"])
    log(f"{label}share of the tolerance used per part (worst kernel vs "
        "float64 "
        f"twin over {nsfused.TWIN_GAP_FACTOR} x worst float32 twin vs "
        f"float64 twin + {nsfused.TWIN_GAP_FLOOR}; limit 1): "
        + " ".join(f"{n} {v:.2f}" for n, v in use.items()))
    for name, v in use.items():
        check(v <= 1.0, f"{label}{name}: the kernel is less accurate than "
              f"the float32 twin allows ({v:.2f} of the tolerance)")
    worst = {key: max(max(e) for e in rows) for key, rows in errs.items()}
    return dict(worst=worst, use=max(use.values()), max_abs_err=max_abs,
                ms=float(np.median(k_ms)), plain_ms=float(np.median(t_ms)),
                bound=bound(*chunk_work(ops32, st32)))


def chunk_work(ops, state) -> tuple[int, int]:
    """(bytes, operations) of one N_INNER chunk of a problem: one rung of
    pivots and every other operand read once, the state (w, z, y) read
    and written once; the operations are the chunk's dominant terms per
    iteration (the 2Mi-1 pivot matvecs, the two N / N^T maps, the two
    pair applies A x and A^T y)."""
    d = ops.dims
    nbytes = (d["Mi"] * d["bs"] ** 2 * 4
              + sum(t.numel() * t.element_size() for t in ops
                    if isinstance(t, torch.Tensor) and t is not ops.dinv)
              + 2 * sum(t.numel() * t.element_size()
                        for t in (state[0], *state[1], *state[2])))
    nw = d["Mi"] * d["phi"]
    flops = N_INNER * ((2 * d["Mi"] - 1) * 2 * d["bs"] ** 2
                       + 2 * 2 * d["B3"] * d["D"] * nw
                       + 2 * 4 * d["P"] * 3 * d["D"])
    return nbytes, flops


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


def thomas_vs_twin(op, dev, label: str, pivots=torch.float32,
                   reps: tuple[int, int] = (20, 3)):
    """Phase 5 (and 10 and 12, with bf16 ``pivots``): one solve per rung
    through K2, the float32 twin and a float64 twin, on the rung inventory
    ``op`` (its pivots rounded to ``pivots``; both twins solve with those
    same pivots, the float64 one widening them to float64); ``reps`` timed
    solves per rung of kernel and twin."""
    from swarm_simulator_tpu_torch.ops import thomas
    from swarm_simulator_tpu_torch.tools._timing import event_ms

    dinv32 = torch.as_tensor(op.Dinvs, device=dev).to(pivots).contiguous()
    ho32 = torch.as_tensor(op.Kos, device=dev).float().contiguous()
    ho64 = ho32.double()
    dinv64 = dinv32.double() if pivots == torch.float32 else dinv32
    Mi, bs = dinv32.shape[1], dinv32.shape[-1]
    gen = torch.Generator().manual_seed(SEED)
    k64, t64, k32 = [], [], []
    max_abs = 0.0
    k_ms, t_ms = [], []
    for r in range(dinv32.shape[0]):
        b = torch.randn((Mi, bs), generator=gen, dtype=torch.float64)
        b32, b64 = b.float().to(dev), b.to(dev)
        kern = thomas.thomas_solve(dinv32, ho32, b32, r)
        twin = thomas.thomas_solve_reference(dinv32, ho32, b32, r)
        twin64 = thomas.thomas_solve_reference(dinv64, ho64, b64, r)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(kern).all()), f"K2 rung {r}: not finite")
        max_abs = max(max_abs, float((kern - twin).abs().max()))
        k32.append(thomas.rel_error(kern, twin))
        k64.append(thomas.rel_error(kern, twin64))
        t64.append(thomas.rel_error(twin, twin64))
        k_ms += event_ms(lambda: thomas.thomas_solve(dinv32, ho32, b32, r),
                         reps[0], warmup=0)
        t_ms += event_ms(lambda: thomas.thomas_solve_reference(
            dinv32, ho32, b32, r), reps[1], warmup=0)
        log(f"K2 {label} rung {r}: rel err k-t32 {k32[-1]:.1e} k-t64 "
            f"{k64[-1]:.1e} t32-t64 {t64[-1]:.1e}; kernel "
            f"{np.median(k_ms[-reps[0]:]):.4f} ms twin "
            f"{np.median(t_ms[-reps[1]:]):.3f} ms")
    del dinv64
    use = thomas.twin_gap_use(k64, t64)
    log(f"K2 {label}: share of the tolerance used (worst kernel vs float64 "
        f"twin over {thomas.TWIN_GAP_FACTOR} x worst float32 twin vs "
        f"float64 twin + {thomas.TWIN_GAP_FLOOR}; limit 1): {use:.2f}; "
        f"max abs err vs float32 twin {max_abs:.3e}; median solve kernel "
        f"{np.median(k_ms):.4f} ms, twin {np.median(t_ms):.3f} ms")
    check(use <= 1.0, f"K2 on the {label} inventory is less accurate than "
          f"the float32 twin allows ({use:.2f} of the tolerance)")
    # one rung's pivots, b, x and Ho once; 2Mi-1 pivot matvecs
    phi = ho32.shape[-1]
    nbytes = (Mi * bs * bs * dinv32.element_size()
              + 4 * (2 * Mi * bs + (Mi - 1) * phi * phi))
    return dict(use=use, max_abs_err=max_abs, ms=float(np.median(k_ms)),
                plain_ms=float(np.median(t_ms)),
                bound=bound(nbytes, (2 * Mi - 1) * 2 * bs * bs))


#: the port's A x against the einsum form it replaced: float32 on both
#: sides, the same products summed in another order
PAIR_ROWS_TOL = 1e-5


def pair_rows_vs_einsum(data, op, s, label: str) -> dict:
    """Phases 5 and 12: the port's A x (qp/nullspace._A_x, a gather of each
    pair's two agents and a multiply-and-sum over the three axes) on the
    cold state's x, against the dense-selection einsum form it replaced,
    computed here in plain torch (never on the port's path); float32,
    relative to the result's scale, both timed (CUDA events)."""
    from swarm_simulator_tpu_torch.qp import nullspace as ns
    from swarm_simulator_tpu_torch.tools._timing import median_ms

    pop, _, _, (w, _, _) = ns._cold_state(data, op, s)
    x = ns._x_of(op, w)

    def einsum_form():
        return torch.einsum("pkd,pkd->pd", pop.n_d,
                            torch.einsum("pb,bkd->pkd", pop.S, x))

    got, want = ns._A_x(x, pop).pair, einsum_form()
    err = rel_err(got, want)
    ms = median_ms(lambda: ns._A_x(x, pop), 10)
    old_ms = median_ms(einsum_form, 5)
    log(f"A x {label} ({tuple(x.shape)} x {pop.n_d.shape[0]} pairs, "
        f"{x.dtype}): gather {ms:.4f} ms, einsum form {old_ms:.4f} ms; "
        f"rel err {err:.2e} (limit {PAIR_ROWS_TOL})")
    check(x.dtype == torch.float32 and err <= PAIR_ROWS_TOL,
          f"A x {label} disagrees with the einsum form ({err:.2e})")
    return dict(err=err, ms=ms, einsum_ms=old_ms)


def _counters() -> dict:
    """{name: (function, counter attribute)}: each kernel's launches (K2's
    on float32 and on bf16 pivots apart) and each twin's calls on CUDA."""
    from swarm_simulator_tpu_torch.ops import nsfused, thomas
    from swarm_simulator_tpu_torch.ops import nsfused_probe as npb
    from swarm_simulator_tpu_torch.ops import row_patterns as rp
    from swarm_simulator_tpu_torch.ops import thomas_prim as tp
    from swarm_simulator_tpu_torch.ops import thomas_probe as tq
    from swarm_simulator_tpu_torch.ops import thomas_stream as ts

    return dict(k1=(nsfused.nsfused_chunk, "launches"),
                k2=(thomas.thomas_solve, "launches"),
                k2bf16=(thomas.thomas_solve, "launches_bf16"),
                k3a=(thomas.thomas_chunk_fwd, "launches"),
                k3b=(thomas.thomas_chunk_bwd, "launches"),
                t4=(ts.thomas_stream, "launches"),
                t2=(tp.thomas_prim, "launches"),
                t3=(tq.thomas_probe, "launches"),
                t1p1=(npb.p1_reshape_combine, "launches"),
                t1p2=(npb.p2_tile_apply, "launches"),
                t1p3=(npb.p3_split_pair_product, "launches"),
                t1p4=(npb.p4_resident_thomas, "launches"),
                t1p4r=(npb.p4_relayout, "launches"),
                t5=(rp.row_pattern, "launches"),
                kstack=(nsfused.nsfused_stack, "launches"),
                twin1=(nsfused.nsfused_chunk_reference, "cuda_calls"),
                twinstack=(nsfused.nsfused_stack_reference, "cuda_calls"),
                twin2=(thomas.thomas_solve_reference, "cuda_calls"),
                twin3a=(thomas.thomas_chunk_fwd_reference, "cuda_calls"),
                twin3b=(thomas.thomas_chunk_bwd_reference, "cuda_calls"))


def reset_counts():
    for f, attr in _counters().values():
        setattr(f, attr, 0)


def read_counts() -> dict:
    return {k: getattr(f, attr) for k, (f, attr) in _counters().items()}


TWINS = ("twin1", "twin2", "twin3a", "twin3b", "twinstack")


def gate(result, mission, param, dev, label: str, obj_ref=None,
         obj_b0=None):
    """Phase 3's checks on a plan: finite control points of the expected
    shape, the acceptance gate (with the IPM objective criterion at
    obj_tol 1.25 where the oracle pair ``obj_ref``, ``obj_b0`` is given)
    and the objective pin."""
    from swarm_simulator_tpu_torch.eval.gate import gate_quality

    check(bool(np.isfinite(result.ctrl).all()),
          f"{label}: non-finite control points")
    check(result.ctrl.shape == (mission.qn, result.M, param.n + 1, 3),
          f"{label}: control points of shape {result.ctrl.shape}")
    ok, m = gate_quality(result.ctrl, result, mission, param, obj_ref,
                         obj_b0, device=dev)
    log(f"{label} gate: " + json.dumps(
        {k: (float(v) if not isinstance(v, bool) else v)
         for k, v in m.items()}))
    check(ok, f"{label}: acceptance gate failed: {m}")
    obj = result.solver_info["obj"][0]
    check(obj < OBJ_PIN, f"{label}: objective {obj} >= {OBJ_PIN}")


def replan_paths(mission, param, world, dev):
    """Phase 6: the corridor replan (iteration=2, replan_prep auto) and
    the device-prep cold plan through the entry point."""
    import swarm_simulator_tpu_torch as port

    out = {}
    for label, change in (("replan", dict(iteration=2)),
                          ("cold_prep=device", dict(cold_prep="device"))):
        reset_counts()
        t0 = time.perf_counter()
        result, times = port.plan(mission, dataclasses.replace(param,
                                                               **change),
                                  world, device=dev)
        torch.cuda.synchronize()
        cycle_s = time.perf_counter() - t0
        counts = read_counts()
        info = result.solver_info
        log(f"{label} cycle {cycle_s:.3f} s: qp {times.qp:.3f} (prep "
            f"{info['prep_s']:.3f} cold solve {info['solve_s']:.3f}) "
            f"iters {info['iters'][0]} r_prim {info['r_prim'][0]:.3e} "
            f"obj {info['obj'][0]:.4f}; launches K1 {counts['k1']} K2 "
            f"{counts['k2']}, twin calls on CUDA K1 {counts['twin1']} K2 "
            f"{counts['twin2']}")
        check(counts["k2"] > 0, f"{label}: K2 launched 0 times")
        check(counts["twin1"] == 0 and counts["twin2"] == 0,
              f"{label}: a plain twin ran on CUDA ({counts})")
        if label == "replan":
            check(info["replan_prep"] == "device",
                  f"replan_prep resolved to {info['replan_prep']!r}")
            check(info["replan_rounds"] == 1,
                  f"replan rounds {info['replan_rounds']}, expected 1")
            check(counts["k1"] > 0, "the cold round launched K1 0 times")
            log(f"replan round: prep {info['replan_prep_s'][0]:.3f} s, "
                f"solve {info['replan_solve_s'][0]:.3f} s, iters "
                f"{info['replan_iters'][0]}, objective {info['obj'][0]:.6f}")
        gate(result, mission, param, dev, label)
        out[label] = dict(counts=counts, cycle_s=cycle_s, info=info)
    return out


def refine_solve_alone(plan, mission, param, cold_ctrl, dev):
    """Phase 7: the replan round's problem (RSFC planes from the cold
    solution, warm start from it), its device prep, and its refine-1
    phased solve timed through K2, then with the float32 twin in K2's
    place, then through K2 again."""
    import copy
    from unittest import mock

    from swarm_simulator_tpu_torch.corridor.rsfc import build_rsfc
    from swarm_simulator_tpu_torch.ops import thomas
    from swarm_simulator_tpu_torch.qp import joint, nullspace as ns

    plan = copy.deepcopy(plan)
    knots = np.concatenate([cold_ctrl[:, :, 0, :], cold_ctrl[:, -1:, -1, :]],
                           axis=1)
    _, plan.pair_normals = build_rsfc(knots, param.downwash)
    data, _ = joint.assemble_joint(plan, mission, param, dummy=cold_ctrl)
    phases = joint.production_phases(kkt_refine=1)
    s0, it_k, lo_k, hi_k = ns.schedule_arrays(phases)
    d = data.to(dev)
    t0 = time.perf_counter()
    op = ns.prepare_ns(d, phases[0])
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0

    def run():
        t0 = time.perf_counter()
        x, info = ns.solve_ns_schedule(d, op, s0, it_k, lo_k, hi_k)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, int(info.iters), x.double(),
                float(info.obj))

    k1_s, k1_it, xk, obj = run()
    with mock.patch.object(thomas, "thomas_solve",
                           thomas.thomas_solve_reference):
        tw_s, tw_it, xt, _ = run()
    k2_s, k2_it, _, _ = run()
    dx = float((xk - xt).abs().max()) / float(xt.abs().max())
    log(f"refine-1 solve alone (device prep {prep_s:.3f} s), host clock: "
        f"K2 {k1_s:.3f} s ({k1_it} iters), float32 twin {tw_s:.3f} s "
        f"({tw_it} iters), K2 {k2_s:.3f} s ({k2_it} iters); solution rel "
        f"diff K2 vs twin {dx:.2e}; objective {obj:.6f}")
    check(k1_it == k2_it, f"K2 solves disagree: {k1_it} vs {k2_it} "
          "iterations")


#: the kernel's run of a refine-1 solve on bf16 pivots against the same
#: solve with the float32 twin in K2's place: objectives within this share
#: of the twin's (900 float32 iterations stopped by their cap carry the
#: order of the sums into the objective; 2-4% on float32 pivots, PERF.md)
RUN_VS_TWIN = 0.05


@contextlib.contextmanager
def traced(twin: bool = False):
    """Record (rung, ||w||) after every chunk of the refine solves run
    inside (one host read per chunk, beside the loop's own), with the
    float32 twin in K2's place when ``twin``; yields the list."""
    from unittest import mock

    from swarm_simulator_tpu_torch.ops import thomas
    from swarm_simulator_tpu_torch.qp import nullspace as ns

    trace = []
    steps = ns.admm_steps

    def admm_steps(op, cop, l, u, rho_idx, *a, **k):
        w, z, y = steps(op, cop, l, u, rho_idx, *a, **k)
        trace.append((int(rho_idx),
                      float(torch.linalg.vector_norm(w.double()))))
        return w, z, y

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(ns, "admm_steps", admm_steps))
        if twin:
            stack.enter_context(mock.patch.object(
                thomas, "thomas_solve", thomas.thomas_solve_reference))
        yield trace


def compare_runs(label: str, kern: dict, twin: dict) -> None:
    """Check the kernel's run of a solve against the twin's run (records
    with "obj", "iters" and "trace", traced()'s (rung, ||w||) per chunk):
    the same iterations, the same first non-finite chunk (or none), and
    finite objectives within RUN_VS_TWIN; log the rungs and norms."""
    def first_bad(norms):
        return next((i for i, v in enumerate(norms) if not np.isfinite(v)),
                    None)

    rk, nk = (np.asarray(v) for v in zip(*kern["trace"]))
    rt, nt = (np.asarray(v) for v in zip(*twin["trace"]))
    both = np.isfinite(nk) & np.isfinite(nt)
    part = (np.abs(nk - nt)[both] / np.maximum(nt[both], 1e-30))
    bad = (first_bad(nk), first_bad(nt))
    upto = len(nk) if bad[0] is None else bad[0] + 1
    log(f"{label}, kernel vs twin run: objective {kern['obj']:.6g} vs "
        f"{twin['obj']:.6g}, iters {kern['iters']} vs {twin['iters']}; "
        f"first non-finite chunk {bad[0]} vs {bad[1]} of {len(nk)}; "
        f"per chunk up to it, rung kernel {rk[:upto].tolist()} twin "
        f"{rt[:upto].tolist()}, ||w|| kernel "
        + " ".join(f"{v:.4g}" for v in nk[:upto]) + ", twin "
        + " ".join(f"{v:.4g}" for v in nt[:upto])
        + f"; worst rel gap over {int(both.sum())} finite chunks "
        f"{part.max() if part.size else float('nan'):.2e}")
    check(kern["iters"] == twin["iters"], f"{label}: kernel and twin runs "
          f"took {kern['iters']} and {twin['iters']} iterations")
    check(bad[0] == bad[1], f"{label}: first non-finite chunk {bad[0]} in "
          f"the kernel's run, {bad[1]} in the twin's")
    if bad[0] is None:
        gap = abs(kern["obj"] - twin["obj"]) / abs(twin["obj"])
        check(gap <= RUN_VS_TWIN, f"{label}: objective {100 * gap:.2f}% "
              f"from the twin run's (limit {100 * RUN_VS_TWIN:.0f}%)")


def bf16_refine_solve(data, op32, plan, mission, param, dev):
    """Phase 11: the 64-agent forest's cold problem (phase 2's data, the one
    ``cold_prep="device"`` solves) through the refine-1 production phases
    on device-prep pivots: float32 (phase 5's inventory), then bf16
    through K2-bf16, then the same bf16 inventory with the float32 twin in
    K2's place.  Checked: the launches, a finite solution, and the kernel's
    run against the twin's (compare_runs).  Reported: phase 3's gate and
    objective pin on the bf16 solution and its objective against the
    float32-pivot solve's (5% wanted; the JAX package misses it on the
    same data too: tests/test_torch_bf16.py's witness_forest64, PERF.md)."""
    from swarm_simulator_tpu_torch.eval.gate import gate_quality
    from swarm_simulator_tpu_torch.qp import convert, joint, nullspace as ns

    base = dataclasses.replace(joint.production_settings(),
                               precond_dtype="bfloat16")
    phases = joint.production_phases(base=base, kkt_refine=1)
    sched = ns.schedule_arrays(phases)
    d = data.to(dev)
    log(f"bf16 refine-1 solve inputs: data {digest(data)}")
    t0 = time.perf_counter()
    _, info32 = ns.solve_ns_schedule(
        d, op32, *ns.schedule_arrays(joint.production_phases(kkt_refine=1)))
    torch.cuda.synchronize()
    solve32_s = time.perf_counter() - t0
    obj32 = float(info32.obj)
    t0 = time.perf_counter()
    op = ns.prepare_ns(d, phases[0])
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    check(op.Dinvs.dtype == torch.bfloat16,
          f"bf16 prep gave {op.Dinvs.dtype} pivots")
    runs = {}
    for twin in (False, True):
        reset_counts()
        t0 = time.perf_counter()
        with traced(twin) as trace:
            x, info = ns.solve_ns_schedule(d, op, *sched)
            torch.cuda.synchronize()
        runs[twin] = dict(x=x, obj=float(info.obj), iters=int(info.iters),
                          r_prim=float(info.r_prim), trace=trace,
                          solve_s=time.perf_counter() - t0,
                          counts=read_counts())
    counts, obj = runs[False]["counts"], runs[False]["obj"]
    gap = abs(obj - obj32) / abs(obj32)
    log(f"bf16-pivot refine-1 solve: device prep {prep_s:.3f} s (pivots "
        f"{op.Dinvs.numel() * 2 / 1e6:.1f} MB bf16), solve "
        f"{runs[False]['solve_s']:.3f} s host clock (twin in K2's place "
        f"{runs[True]['solve_s']:.3f} s), iters {runs[False]['iters']} "
        f"r_prim {runs[False]['r_prim']:.3e}, objective {obj:.6f} vs "
        f"float32 pivots {obj32:.6f} (gap {100 * gap:.2f}%, 5% wanted; "
        f"float32-pivot solve {solve32_s:.3f} s); launches K2-bf16 "
        f"{counts['k2bf16']} K2-f32 {counts['k2']} K1 {counts['k1']}, twin "
        f"calls on CUDA {sum(counts[k] for k in TWINS)}")
    check(counts["k2bf16"] > 0, "the bf16 solve launched K2-bf16 0 times")
    check(counts["k2"] == 0 and counts["k1"] == 0,
          f"the bf16 solve launched K2 on float32 pivots or K1 ({counts})")
    check(all(counts[k] == 0 for k in TWINS),
          f"the bf16 solve ran a plain twin on CUDA ({counts})")
    ct = runs[True]["counts"]
    check(ct["k2bf16"] == 0 and ct["twin2"] > 0,
          f"the twin run launched K2-bf16 or skipped the twin ({ct})")
    compare_runs("64-agent bf16 refine-1 solve", runs[False], runs[True])
    ctrl = convert.x_to_ctrl(runs[False]["x"].double().cpu().numpy(), plan.M,
                             param.n)
    check(bool(np.isfinite(ctrl).all()), "bf16 solve: non-finite")
    ok, m = gate_quality(ctrl, plan, mission, param, device=dev)
    # reported, not required: a bf16 inventory preconditions the production
    # ladder too poorly for a refine-1 solve to reach the float32-pivot
    # solve, in the JAX package too (PERF.md, the bf16 findings)
    log(f"bf16 solve quality (reported): gate {'passed' if ok else 'FAILED'}"
        f", objective {'within' if gap < 0.05 else 'NOT within'} 5% of the "
        f"float32-pivot solve's, pin < {OBJ_PIN} "
        f"{'held' if obj < OBJ_PIN else 'NOT held'}: " + json.dumps(
            {k: (float(v) if not isinstance(v, bool) else v)
             for k, v in m.items()}))
    return dict(counts=counts, obj=obj, obj32=obj32, gap=gap, gate=ok)


def chunked_solve(dinv, kos, b, rho_idx: int, n: int, fwd=None, bwd=None):
    """The chunk mode's KKT solve in one process: b [Mi, bs] through the
    chain of ``dinv`` [R, Mi, bs, bs] / ``kos`` split into n chunks (knot
    axis zero-padded to n*L), the carries handed from chunk to chunk as
    the ranks of qp/nullspace_shard hand them, through the sweeps
    ``fwd``/``bwd`` (default: the K3a/K3b wrappers).  Returns x [n*L, bs],
    the pad knots' rows last."""
    from swarm_simulator_tpu_torch.ops import thomas
    from swarm_simulator_tpu_torch.qp import nullspace_shard as shard
    from swarm_simulator_tpu_torch.qp.nullspace import NSOp

    fwd = fwd or thomas.thomas_chunk_fwd
    bwd = bwd or thomas.thomas_chunk_bwd
    Mi, bs = b.shape
    dpad = shard.pad_knots(NSOp(*([None] * 7), Dinvs=dinv, Kos=kos),
                           n).Dinvs
    L = dpad.shape[1] // n
    kin, kout = shard.chunk_couplings(kos, n * L)
    bp = b.new_zeros((n * L, bs))
    bp[:Mi] = b

    def chunk(c, t):
        sl = slice(c * L, (c + 1) * L)
        return dpad[:, sl].contiguous(), t[sl].contiguous()

    T, carry = [], b.new_zeros(bs)
    for c in range(n):
        d, k = chunk(c, kin)
        T.append(fwd(d, k, bp[c * L:(c + 1) * L], carry, rho_idx))
        carry = T[-1][-1]
    x, carry = [None] * n, b.new_zeros(bs)
    for c in range(n - 1, -1, -1):
        d, k = chunk(c, kout)
        x[c] = bwd(d, k, T[c], carry, rho_idx)
        carry = x[c][0]
    return torch.cat(x)


#: K3a's and K3b's median ms per sweep at 64 agents in their first design
#: (a warp per row group, a grid sync per knot), by chunk length:
#: chip_smoke phase 8 on an H100 80GB HBM3 at a 700 W power limit (PERF.md)
K3A_FIRST_DESIGN_MS = {35: 0.2566, 9: 0.0492}
K3B_FIRST_DESIGN_MS = {35: 0.2311, 9: 0.0479}


def chunk_sweeps_vs_twins(op, dev):
    """Phase 8: per rung, one seeded right-hand side through the chain
    split into n = 1 and n = 4 chunks, carries chained in this process,
    through K3a/K3b, the float32 twins and float64 twins, against K2's
    full solve too."""
    from swarm_simulator_tpu_torch.ops import thomas
    from swarm_simulator_tpu_torch.qp import nullspace_shard as shard
    from swarm_simulator_tpu_torch.tools._timing import event_ms

    dinv32 = torch.as_tensor(op.Dinvs, device=dev).float().contiguous()
    ho32 = torch.as_tensor(op.Kos, device=dev).float().contiguous()
    dinv64, ho64 = dinv32.double(), ho32.double()
    R, Mi, bs = dinv32.shape[0], dinv32.shape[1], dinv32.shape[-1]
    twins = (thomas.thomas_chunk_fwd_reference,
             thomas.thomas_chunk_bwd_reference)
    gen = torch.Generator().manual_seed(SEED + 1)
    out = {}
    for n in (1, 4):
        L = -(-Mi // n)
        # the timed sweeps run on the first chunk (all real knots)
        kin, kout = (k[:L].contiguous()
                     for k in shard.chunk_couplings(ho32, n * L))
        d0 = dinv32[:, :L].contiguous()
        k64, t64, k2_64, k3_k2 = [], [], [], []
        max_abs = 0.0
        ms = {"fwd": [], "bwd": [], "fwd_twin": [], "bwd_twin": []}
        for r in range(R):
            b = torch.randn((Mi, bs), generator=gen, dtype=torch.float64)
            b32, b64 = b.float().to(dev), b.to(dev)
            kern = chunked_solve(dinv32, ho32, b32, r, n)
            twin = chunked_solve(dinv32, ho32, b32, r, n, *twins)
            twin64 = chunked_solve(dinv64, ho64, b64, r, n, *twins)
            full = thomas.thomas_solve(dinv32, ho32, b32, r)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(kern).all()),
                  f"K3 n={n} rung {r}: not finite")
            check(int(torch.count_nonzero(kern[Mi:])) == 0,
                  f"K3 n={n} rung {r}: pad knots not exactly 0")
            kern, twin, twin64 = kern[:Mi], twin[:Mi], twin64[:Mi]
            max_abs = max(max_abs, float((kern - twin).abs().max()))
            k64.append(thomas.rel_error(kern, twin64))
            t64.append(thomas.rel_error(twin, twin64))
            k2_64.append(thomas.rel_error(full, twin64))
            k3_k2.append(thomas.rel_error(kern, full))
            bl = b32[:L].contiguous()
            t0 = torch.zeros(bs, device=dev)
            T0 = thomas.thomas_chunk_fwd(d0, kin, bl, t0, r)
            for key, f, args, reps in (
                    ("fwd", thomas.thomas_chunk_fwd, (d0, kin, bl), 20),
                    ("bwd", thomas.thomas_chunk_bwd, (d0, kout, T0), 20),
                    ("fwd_twin", twins[0], (d0, kin, bl), 3),
                    ("bwd_twin", twins[1], (d0, kout, T0), 3)):
                ms[key] += event_ms(lambda: f(*args, t0, r), reps, warmup=0)
            log(f"K3 n={n} (L={L}) rung {r}: rel err k-t64 {k64[-1]:.1e} "
                f"t32-t64 {t64[-1]:.1e} K2-t64 {k2_64[-1]:.1e} k-K2 "
                f"{k3_k2[-1]:.1e}")
        use = thomas.twin_gap_use(k64, t64)
        use_k2 = thomas.twin_gap_use(k2_64, t64)
        med = {k: float(np.median(v)) for k, v in ms.items()}
        phi = ho32.shape[-1]
        # one chunk sweep: its slab of the rung, the rows in and out, the
        # carry and the couplings once; L pivot matvecs
        nbytes = 4 * (L * bs * bs + 2 * L * bs + bs + L * phi * phi)
        bnd = bound(nbytes, L * 2 * bs * bs)
        for name, key, first in (("K3a", "fwd", K3A_FIRST_DESIGN_MS),
                                 ("K3b", "bwd", K3B_FIRST_DESIGN_MS)):
            old = first.get(L)
            log(f"{name} n={n} (L={L}): {med[key]:.4f} ms per sweep on the "
                "ring" + (f", first design {old} ms" if old else "")
                + f", bound {bnd[0]:.4f} ms ({bnd[1]})")
        log(f"K3 n={n} (L={L}): share of the tolerance used {use:.2f} "
            f"(K2 on the same inputs {use_k2:.2f}); max abs err vs float32 "
            f"twin {max_abs:.3e}; median per sweep K3a {med['fwd']:.4f} ms, "
            f"K3b {med['bwd']:.4f} ms, twins {med['fwd_twin']:.3f} / "
            f"{med['bwd_twin']:.3f} ms")
        check(use <= 1.0, f"K3 n={n} is less accurate than the float32 "
              f"twin allows ({use:.2f} of the tolerance)")
        # K2's full solve on the same input, judged by the same rule
        # against the chained float64 twin, stands beside the chained K3
        check(use_k2 <= 1.0, f"K2 disagrees with the chained float64 "
              f"twin ({use_k2:.2f} of the tolerance; K3 vs K2 {k3_k2})")
        out[n] = dict(use=use, max_abs_err=max_abs, L=L, bound=bnd, **med)
    return out


def sharded_solve(data, op, plan, mission, param, dev):
    """Phase 9: the sharded joint solve (chunk mode) on a 1-rank NCCL
    group, through the entry point, with the launch counts read around
    it; phase 3's gate and the objective pin on its solution."""
    from swarm_simulator_tpu_torch.eval.gate import gate_quality
    from swarm_simulator_tpu_torch.parallel import distributed as pd
    from swarm_simulator_tpu_torch.qp import convert, joint
    from swarm_simulator_tpu_torch.qp import nullspace_shard as shard

    reset_counts()
    t0 = time.perf_counter()
    x, iters, r_prim, obj, solve_s = pd.run_ranks(
        shard.rank_solve, 1, data, joint.production_phases(), op, "chunk",
        backend="nccl")
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    counts = read_counts()
    log(f"sharded solve inputs: data {digest(data)} pivots {digest(op)}")
    log(f"sharded solve (1-rank NCCL group, chunk mode): {solve_s:.3f} s "
        f"host clock, the group's first collectives included ({call_s:.3f} "
        f"s with the group and the upload), iters {iters}, r_prim "
        f"{r_prim:.3e}, obj {obj:.4f}; launches K3a {counts['k3a']} K3b "
        f"{counts['k3b']} K1 {counts['k1']} K2 {counts['k2']}, twin calls "
        f"on CUDA {counts}")
    check(counts["k3a"] > 0 and counts["k3b"] > 0,
          "the sharded solve launched K3a/K3b 0 times")
    check(counts["k1"] == 0 and counts["k2"] == 0,
          f"the sharded solve launched K1/K2 ({counts})")
    check(all(counts[k] == 0 for k in TWINS),
          f"the sharded solve ran a plain twin on CUDA ({counts})")
    ctrl = convert.x_to_ctrl(x, plan.M, param.n)
    check(bool(np.isfinite(ctrl).all()), "sharded solve: non-finite")
    check(ctrl.shape == (mission.qn, plan.M, param.n + 1, 3),
          f"sharded solve: control points of shape {ctrl.shape}")
    ok, m = gate_quality(ctrl, plan, mission, param, device=dev)
    log("sharded gate: " + json.dumps(
        {k: (float(v) if not isinstance(v, bool) else v)
         for k, v in m.items()}))
    check(ok, f"sharded solve: acceptance gate failed: {m}")
    check(obj < OBJ_PIN, f"sharded solve: objective {obj} >= {OBJ_PIN}")
    return dict(counts=counts, solve_s=solve_s, iters=iters)


def big_swarm_plan(dev, agents: int = 256):
    """Phase 12, first part: the 256-agent scatter problem through
    ``plan(..., cold_prep="device", iteration=2)`` with the large-swarm
    replan budgets (joint.REPLAN_BUDGETS_LARGE): the cold round and one
    corridor replan round from one call.  Stage times, inventory bytes,
    peak device memory, launch counts (K2 only, no twin), the gate without
    the 64-agent objective pin on the cold round's control points and on
    the replan round's, and the round's prep and solve seconds,
    iterations and K2 launches."""
    import copy

    import swarm_simulator_tpu_torch as port
    from swarm_simulator_tpu_torch.eval.gate import gate_quality
    from swarm_simulator_tpu_torch.qp import joint
    from swarm_simulator_tpu_torch.tools import budget256_study as bud

    mission, param, world = bud.scatter_config(agents)
    param = dataclasses.replace(param, cold_prep="device", iteration=2,
                                replan_budgets=joint.REPLAN_BUDGETS_LARGE)
    # the cold round's control points, its plan (T before the time scale)
    # and the launch counts when the replan round starts assembling
    cold = {}
    assemble = joint.assemble_joint

    def assemble_spy(plan, mission_, param_, dummy=None):
        if dummy is not None and "ctrl" not in cold:
            cold.update(ctrl=np.array(dummy), plan=copy.copy(plan),
                        counts=read_counts())
        return assemble(plan, mission_, param_, dummy=dummy)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    joint.assemble_joint = assemble_spy
    try:
        result, times = port.plan(mission, param, world, device=dev)
    finally:
        joint.assemble_joint = assemble
    torch.cuda.synchronize()
    cycle_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    info = result.solver_info
    log(f"{agents} agents, cold_prep=device, iteration=2: M={result.M} "
        f"pairs {len(result.pair_idx)}; cycle {cycle_s:.3f} s: esdf "
        f"{times.esdf:.3f} search {times.init_traj:.3f} corridor "
        f"{times.corridor:.3f} qp {times.qp:.3f} (device prep "
        f"{info['prep_s']:.3f} cold solve {info['solve_s']:.3f} polish "
        f"{info['polish_rounds']} rounds {info['polish_s']:.3f}) timescale "
        f"{times.timescale:.3f}; inventory {info['inventory_bytes'] / 1e9:.3f}"
        f" GB, peak device memory {peak / 1e9:.3f} GB; last round iters "
        f"{info['iters'][0]} r_prim {info['r_prim'][0]:.3e} objective "
        f"{info['obj'][0]:.4f}; launches K2 {counts['k2']} K2-bf16 "
        f"{counts['k2bf16']} K1 {counts['k1']}, twin calls on CUDA "
        f"{sum(counts[k] for k in TWINS)}")
    check(counts["k2"] > 0, "the big-swarm plan launched K2 0 times")
    check(counts["k1"] == 0, "the big-swarm device-prep plan launched K1")
    check(all(counts[k] == 0 for k in TWINS),
          f"the big-swarm plan ran a plain twin on CUDA ({counts})")
    check(info["replan_rounds"] == 1 and "ctrl" in cold,
          f"{agents} agents: {info['replan_rounds']} replan rounds")
    round_k2 = counts["k2"] - cold["counts"]["k2"]
    round_k1 = counts["k1"] - cold["counts"]["k1"]
    log(f"{agents}-agent replan round ({joint.REPLAN_BUDGETS_LARGE}, "
        f"replan_prep {info['replan_prep']}): replan_prep_s "
        f"{info['replan_prep_s'][0]:.3f} replan_solve_s "
        f"{info['replan_solve_s'][0]:.3f} replan_iters "
        f"{info['replan_iters'][0]}; K2 launches {round_k2}, K1 {round_k1}")
    check(round_k2 > 0 and round_k1 == 0,
          f"the replan round launched K2 {round_k2}, K1 {round_k1} times")
    for label, ctrl, plan in (("cold round", cold["ctrl"], cold["plan"]),
                              ("replan round", result.ctrl, result)):
        check(ctrl.shape == (agents, result.M, param.n + 1, 3)
              and bool(np.isfinite(ctrl).all()),
              f"{agents} agents, {label}: control points {ctrl.shape}, "
              f"finite {bool(np.isfinite(ctrl).all())}")
        ok, m = gate_quality(ctrl, plan, mission, param, device=dev)
        log(f"{agents}-agent {label} gate (no objective pin): " + json.dumps(
            {k: (float(v) if not isinstance(v, bool) else v)
             for k, v in m.items()}))
        check(ok, f"{agents} agents, {label}: acceptance gate failed: {m}")
    return dict(counts=counts, cycle_s=cycle_s, result=result,
                round_k2=round_k2, info=info, downwash=param.downwash)


#: phase 12's bf16 arm, run through K2-bf16 and through the float32 twin
#: and held together: the full-budget arm cut to its first 7 chunks (both
#: runs turn non-finite in the 6th of the full arm's 18, PERF.md), which
#: holds the same chunks at a third of the twin run's seconds
BF16_ARM = (200, 150, 0)


def budget_arms(dev, agents: int = 256):
    """Phase 12, second part: on the same host problem, the budget256
    study's full-budget arm (200, 600, 100) at refine 1, first on float32
    and then on bf16 pivots.  For each: the device prep; K2 (K2-bf16) held
    against its twins on that inventory, at the shapes the arm gives it
    (thomas_vs_twin: 96 cooperative blocks, rows of 2304); the arm through
    the kernel, checked (ratio >= 1, box and continuity < 1e-3) on float32
    pivots; on bf16 pivots the arm cut to BF16_ARM, through the kernel and
    once more with the float32 twin in K2's place, the two runs held
    together (compare_runs), and the bf16 arm's checks and objective
    against the float32 arm's reported."""
    from swarm_simulator_tpu_torch.tools import budget256_study as bud

    t0 = time.perf_counter()
    plan, mission, param, data = bud.build_problem(agents)
    log(f"budget arms: host problem rebuilt in {time.perf_counter() - t0:.3f}"
        " s")
    data_dev = data.to(dev)
    arms, k2 = {}, {}
    for bf16 in (False, True):
        label = "bf16" if bf16 else "float32"
        base = bud.base_settings(1, bf16)
        t0 = time.perf_counter()
        op = bud.prepare(data_dev, base)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        k2[label] = thomas_vs_twin(op, dev, f"{agents}-agent {label}",
                                   op.Dinvs.dtype, reps=(5, 1))
        if not bf16:
            pair_rows_vs_einsum(data_dev, op, base, f"{agents} agents")
        for twin in ((False, True) if bf16 else (False,)):
            reset_counts()
            with traced(twin) as trace:
                arm = BF16_ARM if bf16 else bud.ARMS[0]
                r = bud.run_arm(data_dev, op, base, arm, plan,
                                mission, param, data, dev)
            counts = read_counts()
            r["trace"] = trace
            check((counts["twin2"] > 0) == twin and (counts["k2bf16"]
                                                     > 0) == (bf16 and not
                                                              twin),
                  f"{label} arm (twin {twin}): launches {counts}")
            how = " (float32 twin in K2's place)" if twin else ""
            log(f"arm {arm}, refine 1, {label} pivots"
                f"{how}: prep {prep_s:.3f} s, solve {r['solve_s']:.3f} s "
                f"({r['iters']} iters, r_prim {r['r_prim']:.3e}) ratio "
                f"{r['ratio']:.4f} box {r['box_viol']:.2e} cont "
                f"{r['cont']:.2e} objective {r['obj']:.4f}")
            arms[label + (" twin" if twin else "")] = r
        del op
        torch.cuda.empty_cache()
    check(arms["float32"]["ok"], "the float32-pivot full-budget arm failed "
          f"its checks: {arms['float32']}")
    compare_runs(f"{agents}-agent bf16 arm {BF16_ARM}", arms["bf16"],
                 arms["bf16 twin"])
    gap = abs(arms["bf16"]["obj"] - arms["float32"]["obj"]) / abs(
        arms["float32"]["obj"])
    # reported, not required (see phase 11): the bf16 arm's checks and its
    # objective against the float32 arm's
    verdict = "passed" if arms["bf16"]["ok"] else "FAILED"
    log(f"bf16 arm (reported): checks {verdict}, objective "
        f"{100 * gap:.2f}% from the float32 arm's (5% wanted)")
    return dict(arms=arms, k2=k2)


def stream_study(dev, agents: int = 256):
    """Phase 13: T4 at the 256-agent shapes through the study
    (tools/thomas_bw_study.run_study), with the launch counts read around
    it; then each variant on float32 and bf16 pivots held against the
    plain version, and the plain version timed."""
    from swarm_simulator_tpu_torch.ops import thomas_stream as ts
    from swarm_simulator_tpu_torch.tools import thomas_bw_study as bw
    from swarm_simulator_tpu_torch.tools._timing import median_ms

    dinv = bw.synthetic_inventory(agents, 72, dev)
    R, Mi, bs = dinv.shape[0], dinv.shape[1], dinv.shape[-1]
    reset_counts()
    study = bw.run_study(dinv, 10)
    counts = read_counts()
    check(counts["t4"] > 0, "the study launched T4 0 times")
    for label in ("float32", "bfloat16"):
        rows = ", ".join(f"{k} {v['ms']:.4f} ms {v['gbps']:.1f} GB/s"
                         for k, v in study[label].items()
                         if isinstance(v, dict))
        log(f"T4 {label} (rung {study[label]['rung_gb']:.3f} GB): {rows}")
    max_abs, worst = 0.0, 0.0
    plain_ms = {}
    for dtype in (torch.float32, torch.bfloat16):
        d = dinv.to(dtype)
        for r in range(R):
            want = ts.thomas_stream_reference(d, r)
            absum = d[r].float().abs().sum(dim=(0, 1))
            for name, (slots, split) in ts.VARIANTS.items():
                got = ts.thomas_stream(d, r, slots, split)
                err = (got - want).abs()
                max_abs = max(max_abs, float(err.max()))
                worst = max(worst, float((err / absum).max()))
        plain_ms[dtype] = median_ms(
            lambda: ts.thomas_stream_reference(d, 0), 5, warmup=0)
        del d
    log(f"T4 vs plain on both dtypes, every variant, both rungs: max abs "
        f"err {max_abs:.3e}, worst over columns of err / column abs sum "
        f"{worst:.2e} (limit 1e-5); plain ms float32 "
        f"{plain_ms[torch.float32]:.4f} bf16 {plain_ms[torch.bfloat16]:.4f}")
    check(worst <= 1e-5, f"T4 disagrees with the plain version ({worst:.2e})")
    del dinv
    torch.cuda.empty_cache()
    f32 = study["float32"]
    # the default variant (2 slots, whole tiles) on float32 pivots: the
    # rung read once, [bs] written; one add per element
    return dict(counts=counts, max_abs_err=max_abs, ms=f32["dma2"]["ms"],
                plain_ms=plain_ms[torch.float32],
                library_ms=f32["torch.sum"]["ms"],
                bound=bound(Mi * bs * bs * 4 + bs * 4, Mi * bs * bs))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| relative to the plain output's scale max |want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


#: T2's modes as the JAX tool names them, and the ring variant it shows
T2_SPECS = ("dma", "mv_sub", "mv_lane", "mv_mxu", "trans", "fwd", "dmag",
            "dmaq", "dma@4")


#: T2's mv_mxu: rounding the carried row to bf16 errs by up to 2^-9 of a
#: value a step, so two runs whose float32 sums round it differently
#: walk apart by ~2^-9 sqrt(n) over n steps; they are held to twice that
MXU_WALK = 2.0 ** -8


def mxu_exact_pivots(Mi: int, bs: int, dev) -> torch.Tensor:
    """[1, Mi, bs, bs] pivots under which mv_mxu's chain is exact in any
    summation order: each block a seeded signed permutation of 0.5 +
    2^-12, which bf16 rounds to 0.5, so every output element is one
    product."""
    g = torch.Generator(device=dev).manual_seed(2)
    perm = torch.stack([torch.randperm(bs, generator=g, device=dev)
                        for _ in range(Mi)])
    sign = torch.randint(0, 2, (Mi, bs), generator=g, device=dev) * 2 - 1
    d = torch.zeros((1, Mi, bs, bs), device=dev)
    d[0, torch.arange(Mi, device=dev)[:, None],
      torch.arange(bs, device=dev)[None, :], perm] = sign * (0.5 + 2 ** -12)
    return d


def mxu_vs_plain(dinv, koM, b, acc0, grids) -> list[float]:
    """The shares of their tolerances that T2's mv_mxu uses against its
    plain version on ``grids``: from zeros at REPS 2 (zero, as the plain
    version: rel 1e-5); on mxu_exact_pivots from acc0 at REPS 2, where it
    must equal the plain version bit for bit (the bf16 rounding of row
    and block, the tensor-core tiles' wiring); and on the probe's pivots
    from acc0 * 2^64 (the row shrinks by 0.25-0.5 a step) at REPS 1 and 2,
    where its error against a float64 plain run is held to TWIN_GAP_FACTOR
    times the float32 plain run's plus MXU_WALK * sqrt(steps)."""
    from swarm_simulator_tpu_torch.ops import thomas
    from swarm_simulator_tpu_torch.ops import thomas_prim as tp

    Mi, bs = b.shape
    exact = mxu_exact_pivots(Mi, bs, b.device)
    use = []
    for grid in grids:
        got = tp.thomas_prim(dinv, koM, b, "mv_mxu", 2, 2, grid=grid)
        use.append(rel_err(got, torch.zeros_like(got)) / 1e-5)
        got = tp.thomas_prim(exact, koM, b, "mv_mxu", 2, 2, acc0, grid=grid)
        want = tp.thomas_prim_reference(exact, koM, b, "mv_mxu", 2, 2, acc0)
        use.append(0.0 if torch.equal(got, want) else float("inf"))
    start = acc0 * 2.0 ** 64
    for reps in (1, 2):
        want = tp.thomas_prim_reference(dinv, koM, b, "mv_mxu", 2, reps,
                                        start)
        w64 = tp.thomas_prim_reference(dinv, koM.double(), b.double(),
                                       "mv_mxu", 2, reps, start.double())
        tol = (thomas.TWIN_GAP_FACTOR * thomas.rel_error(want, w64)
               + MXU_WALK * (reps * Mi) ** 0.5)
        for grid in grids:
            got = tp.thomas_prim(dinv, koM, b, "mv_mxu", 2, reps, start,
                                 grid=grid)
            use.append(thomas.rel_error(got, w64) / tol)
    return use


def prim_vs_plain(spec: str, dinv, koM, b, acc0, grids) -> float:
    """The largest share of its tolerance that T2 in mode ``spec`` uses
    against its plain version on ``grids``, from zeros and from ``acc0`` at
    REPS 2, held to rel 1e-5 (mv_mxu: mxu_vs_plain)."""
    from swarm_simulator_tpu_torch.ops import thomas_prim as tp

    mode, nbuf = tp.parse_mode(spec)
    if mode == "mv_mxu":
        use = mxu_vs_plain(dinv, koM, b, acc0, grids)
    else:
        use = []
        for a0 in (None, acc0):
            want = tp.thomas_prim_reference(dinv, koM, b, mode, nbuf, 2, a0)
            for grid in grids:
                got = tp.thomas_prim(dinv, koM, b, mode, nbuf, 2, a0,
                                     grid=grid)
                use.append(rel_err(got, want) / 1e-5)
    check(all(u == u for u in use), f"T2 {spec} bs {b.shape[1]}: not "
          "finite")
    return max(use)


def prim_bench(dev):
    """Phase 14: T2 at its own shape (bs 640, Mi 35) and at the 64-agent
    (576, 35) and 256-agent (2304, 71) shapes: every mode held against its
    plain version at REPS 2 from zeros and from a seeded acc0 on each grid
    that is timed there, then timed through the tool (each timed launch
    held against the plain version at its own REPS), with the launch counts
    read around the timing runs.  One block streams each step's whole
    block through one SM, so it runs at REPS 2 and not at bs 2304 (the
    tool's)."""
    from swarm_simulator_tpu_torch.ops import thomas_prim as tp
    from swarm_simulator_tpu_torch.tools import thomas_prim_bench as t2

    launches, fwd = 0, None
    for bs, Mi in ((640, 35), (576, 35), (2304, 71)):
        d, k, bb = t2.inputs(bs, Mi, dev)
        acc0 = torch.randn((bs, bs), generator=torch.Generator(
            device=dev).manual_seed(1), device=dev)
        grids = ("ring",) if bs == 2304 else tp.GRIDS
        for spec in T2_SPECS:
            use = prim_vs_plain(spec, d, k, bb, acc0, grids)
            log(f"T2 {spec} vs plain (bs {bs}, Mi {Mi}, REPS 2; zero and "
                f"seeded start, grids {', '.join(grids)}): share of the "
                f"tolerance used {use:.2f}")
            check(use <= 1.0, f"T2 {spec} at bs {bs} disagrees with the "
                  f"plain version ({use:.2f} of the tolerance)")
        reset_counts()
        for spec in T2_SPECS:
            for grid in grids:
                reps = 2 if grid == "one" else 20
                # the JSON entry: the forward step on the chain ring at the
                # 64-agent shape, its plain version timed beside it
                entry = (bs, spec, grid) == (576, "fwd", "ring")
                r = t2.time_mode(d, k, bb, spec, reps, grid,
                                 plain_reps=1 if entry else 0)
                fwd = r if entry else fwd
                nbytes, ops, kind = t2.work(spec, bs, Mi, reps)
                bnd = bound(nbytes, ops,
                            BF16_FLOPS if kind == "bf16" else F32_FLOPS)
                log(f"T2 bs {bs} Mi {Mi} {spec:>7} {grid:>4} "
                    f"({r['blocks']} blocks, REPS {reps}): "
                    f"{r['us_per_step']:.3f} us/step ({r['ms']:.4f} ms; "
                    f"bound {1e3 * bnd[0] / (reps * Mi):.4f} us/step, "
                    f"{bnd[1]}), rel err vs plain {r['rel_err']:.2e}")
                check(t2.agrees(r), f"T2 {spec} {grid} at bs {bs}, REPS "
                      f"{reps}: rel err vs plain {r['rel_err']:.2e}")
        launches += read_counts()["t2"]
        del d, k, bb, acc0
        torch.cuda.empty_cache()
    check(launches > 0, "the T2 bench launched T2 0 times")
    return dict(counts={"t2": launches}, max_abs_err=fwd["max_abs_err"],
                ms=fwd["ms"], plain_ms=fwd["plain_ms"],
                bound=bound(*t2.work("fwd", 576, 35, 20)[:2]))


def t3_bound(stage: str, bs: int, Mi: int) -> tuple[float, str]:
    """The bound of T3's ``stage`` (ops/thomas_probe): the pivot blocks it
    needs (fwd Mi - 1, full all Mi) and koM (fwd, full) read once, b read
    and out written once, its FMAs at the float32 rate."""
    blocks = {"dma": Mi, "mv": Mi, "fwd": Mi, "full": Mi + 1}[stage]
    vecs = 1 if stage == "dma" else 2
    flops = {"dma": 0, "mv": 2 * Mi, "fwd": 4 * (Mi - 1),
             "full": 8 * Mi - 6}[stage] * bs * bs
    return bound(4 * (blocks * bs * bs + vecs * Mi * bs), flops)


def probe_stages(dev):
    """Phase 15: T3's stages against the plain version at its own shape
    (bs 256, Mi 4, within 1e-5), then through the tool at the 64-agent and
    256-agent shapes (each stage and K2 timed, each stage held against the
    plain version within 1e-4, mv beside torch.einsum in the same run),
    with the launch counts read around the tool's runs; one line a shape
    splits the chain stage: dma on the chain's spans (the stream), mv on
    them (+ the dot), K2 (+ one tagged exchange), fwd (+ a second exchange
    and the dense coupling); dma and mv on flat spans are the stages' own
    times."""
    from swarm_simulator_tpu_torch.ops import thomas_probe as tq
    from swarm_simulator_tpu_torch.tools import thomas_probe as t3
    from swarm_simulator_tpu_torch.tools._timing import median_ms

    dinvs, koM, b, dsym = t3.inputs(256, 4, 2, dev)
    max_abs = 0.0
    for name in t3.PROBES:
        st, knot = name.split("@")[0], name.endswith("@knot")
        piv = dsym if st == "full" else dinvs
        got = tq.thomas_probe(piv, koM, b, st, 1, knot)
        want = tq.thomas_probe_reference(piv, koM, b, st, 1)
        err = rel_err(got, want)
        max_abs = max(max_abs, float((got - want).abs().max()))
        log(f"T3 {name} vs plain (bs 256, Mi 4): rel err {err:.2e}")
        check(err <= 1e-5, f"T3 {name} disagrees with the plain version "
              f"({err:.2e})")
    out = {}
    reset_counts()
    for bs, Mi in ((576, 35), (2304, 71)):
        ins = t3.inputs(bs, Mi, 2, dev)
        res = t3.run_stages(*ins, t3.PROBES)
        for st in t3.PROBES:
            check(res[st]["finite"] and res[st]["rel_err"] <= 1e-4,
                  f"T3 {st} at bs {bs}: rel err {res[st]['rel_err']:.2e}")
        us = {k: res[k]["us_per_stage"] for k in res}
        for st in tq.STAGES:
            res[st]["bound"] = t3_bound(st, bs, Mi)
        log(f"T3 bounds bs {bs} Mi {Mi} (ms): " + ", ".join(
            f"{st} {res[st]['bound'][0]:.5f} ({res[st]['bound'][1]})"
            for st in tq.STAGES))
        log(f"T3 split bs {bs} Mi {Mi}, us a chain stage: stream (dma on "
            f"the chain's spans) {us['dma@knot']:.3f}, + dot (mv on them) "
            f"{us['mv@knot']:.3f}, K2 (+ one exchange) {us['k2']:.3f}, fwd "
            f"(+ a second, dense coupling) {us['fwd']:.3f}, full "
            f"{us['full']:.3f}; flat spans: dma {res['dma']['ms']:.4f} ms, "
            f"mv {res['mv']['ms']:.4f} ms beside torch.einsum "
            f"{res['mv']['library_ms']:.4f} ms")
        out[bs] = res
        if bs == 576:
            d, k, bb = ins[0], ins[1], ins[2]
            mv = dict(res["mv"], plain_ms=median_ms(
                lambda: tq.thomas_probe_reference(d, k, bb, "mv", 1), 3))
        del ins
        torch.cuda.empty_cache()
    counts = read_counts()
    check(counts["t3"] > 0, "the T3 probe launched T3 0 times")
    return dict(counts=counts, max_abs_err=max_abs, ms=mv["ms"],
                plain_ms=mv["plain_ms"], library_ms=mv["library_ms"],
                bound=mv["bound"], stages=out)


#: T1's first designs (P2 a block per (g, 32 columns); P4 24 cooperative
#: blocks with a grid sync a stage), median ms: chip_smoke phase 16 on an
#: H100 80GB HBM3 at a 700 W power limit (PERF.md)
P2_FIRST_DESIGN_MS = 0.01043
P4_FIRST_DESIGN_MS = 19.82


def nsfused_probes(dev, k1_ms: float):
    """Phase 16: T1's P1-P4 through the tool (each against its plain
    version, P3 also against float64; timed; P4 beside ``k1_ms``, phase
    2's K1 chunk) with the launch counts read around it."""
    from swarm_simulator_tpu_torch.ops import nsfused_probe as npb
    from swarm_simulator_tpu_torch.tools import nsfused_probe as t1

    reset_counts()
    res = t1.run((1, 2, 3, 4), dev, True, k1_ms=k1_ms)
    counts = read_counts()
    for p in range(1, 5):
        check(counts[f"t1p{p}"] > 0, f"T1 P{p} launched 0 times")
        check(res[f"P{p}"]["rel_err"] <= 1e-5, f"T1 P{p} disagrees with the "
              f"plain version ({res[f'P{p}']['rel_err']:.2e})")
    check(counts["t1p4r"] > 0, "T1 P4's re-layout launched 0 times")
    check(res["P4"]["relayout_max_abs_err"] == 0.0, "T1 P4's re-layout is "
          "not the plain permute")
    check(res["P3"]["rel_err_f64"] <= 3e-6, "T1 P3 is "
          f"{res['P3']['rel_err_f64']:.2e} from float64 (limit 3e-6)")
    log(f"T1 P2: kernel {res['P2']['ms']:.5f} ms, torch.einsum "
        f"{res['P2']['library_ms']:.5f} ms on the same inputs, first design "
        f"{P2_FIRST_DESIGN_MS} ms")
    log(f"T1 P3: kernel {res['P3']['ms']:.5f} ms, torch.matmul (highest) "
        f"{res['P3']['library_ms']:.5f} ms on the same inputs")
    p4 = res["P4"]
    log(f"T1 P4: {p4['ms']:.3f} ms per {npb.INNER}-iteration call (first "
        f"design {P4_FIRST_DESIGN_MS} ms), {p4['ms_per_iter']:.4f} ms per "
        f"iteration; K1 in phase 2: {k1_ms:.3f} ms per chunk, "
        f"{p4['k1_ms_per_iter']:.4f} ms per ADMM iteration (P4's iteration "
        f"{p4['ms_per_iter'] / p4['k1_ms_per_iter']:.1%} of it)")
    log(f"T1 P4 re-layout: kernel {p4['relayout_ms']:.5f} ms (inside the "
        f"call's time), PyTorch permute copy {p4['relayout_library_ms']:.5f}"
        " ms")
    B3, phi, Mi, MP, PL = npb.B3, npb.PHI, npb.MI, npb.MP, npb.PL
    n = phi * B3
    rung = 4 * Mi * phi * phi * B3 * B3
    bounds = {
        1: bound(4 * (MP * B3 + 108 * B3), 2 * 108 * B3),
        2: bound(4 * (phi * phi * B3 * B3 + 2 * n), 2 * n * n),
        3: bound(4 * (MP * B3 + B3 * PL + MP * PL), 3 * 2 * MP * B3 * PL,
                 BF16_FLOPS),
        4: bound(rung + 4 * (phi * phi + 2 * Mi * n),
                 npb.INNER * (2 * Mi - 1) * 2 * n * n),
        "4r": bound(2 * rung, 0)}
    out = {p: dict(res[f"P{p}"], launches=counts[f"t1p{p}"],
                   bound=bounds[p]) for p in range(1, 5)}
    out["4r"] = dict(launches=counts["t1p4r"],
                     max_abs_err=p4["relayout_max_abs_err"],
                     ms=p4["relayout_ms"],
                     plain_ms=p4["relayout_plain_ms"],
                     library_ms=p4["relayout_library_ms"],
                     bound=bounds["4r"])
    return out


def row_pattern_probes(dev):
    """Phase 17: T5's fourteen patterns through the tool (each against its
    plain version, bit-equal but P8; timed beside its plain version and,
    where one PyTorch call computes it, that call, held to the plain
    version too) with the launch counts read around it."""
    from swarm_simulator_tpu_torch.ops import row_patterns as rp
    from swarm_simulator_tpu_torch.tools import row_patterns as t5

    reset_counts()
    res = t5.run(dev, True)
    counts = read_counts()
    check(counts["t5"] > 0, "the T5 patterns launched T5 0 times")
    bad = [k for k, v in res.items() if not t5.agrees(v)]
    check(not bad, f"T5 patterns (or their library calls) disagree with "
          f"their plain versions: {bad}")
    nbytes = 0
    for name, ins in rp.pattern_inputs(dev).items():
        nbytes += 4 * (sum(t.numel() for t in ins)
                       + int(np.prod(rp.PATTERNS[name].out)))
    for name, v in res.items():
        lib = v["library_ms"]
        log(f"T5 {name.split()[0]}: kernel {v['ms']:.4f} ms, library call "
            + (f"{lib:.4f} ms" if lib else "none"))
    return dict(counts=counts, patterns=res,
                max_abs_err=max(v["max_abs_err"] for v in res.values()),
                ms=sum(v["ms"] for v in res.values()),
                plain_ms=sum(v["plain_ms"] for v in res.values()),
                bound=bound(nbytes, 2 * 3 * 192 * 192))


def accept_plan(label: str, m: dict, ratio: bool = True) -> None:
    """tests/test_pipeline.py's acceptance (_check) of a time-scaled
    plan's evaluate() metrics ``m``; ``ratio=False`` leaves out its safety
    ratio clause (phase 20's Jacobi sweeps: JAX_CPU_JACOBI64)."""
    if ratio:
        check(m["min_safety_ratio"] >= 1.0 - 1e-3, f"{label}: ratio {m}")
    check(m["knot_continuity_err"] < 1e-3, f"{label}: continuity {m}")
    check(max(m["start_err"], m["goal_err"]) < 1e-3, f"{label}: ends {m}")
    check(m["dynamic_violation"] < 1e-2, f"{label}: dynamics {m}")


def accept_seq(label: str, m: dict, f32: dict, f64: dict,
               witness: dict) -> None:
    """A float32 plan's metrics ``m``: tests/test_pipeline.py's acceptance
    (_check); then against the JAX package's float32 plan ``f32`` the
    safety ratio no more than 1e-3 below it and the continuity and
    endpoint errors no more than twice its own; against the JAX
    package's float64 plan ``f64`` the safety ratio within 1e-3, the
    flight distance within 1% and the dynamic margin within 0.01; against
    the port's float64 ``witness`` on the card the safety ratio within
    1e-3.  (The JAX float32 plans sit 0.28-0.46 m from its float64 ones
    in the dense modes, their ratios 1.6e-3 and 8.7e-3 below: the float32
    rounding floor, PERF.md; the float64 plans are the converged ones.)"""
    accept_plan(label, m)
    check(m["min_safety_ratio"] >= f32["min_safety_ratio"] - 1e-3,
          f"{label}: ratio {m['min_safety_ratio']} more than 1e-3 below "
          f"the JAX package's float32 {f32['min_safety_ratio']}")
    for k in ("knot_continuity_err", "start_err", "goal_err"):
        check(m[k] <= 2 * f32[k], f"{label}: {k} {m[k]} more than twice "
              f"the JAX package's float32 {f32[k]}")
    for k, tol in (("min_safety_ratio", 1e-3), ("dynamic_violation", 1e-2),
                   ("flight_distance", 1e-2 * f64["flight_distance"])):
        check(abs(m[k] - f64[k]) <= tol, f"{label}: {k} {m[k]} not within "
              f"{tol} of the JAX package's float64 {f64[k]}")
    check(abs(m["min_safety_ratio"] - witness["min_safety_ratio"]) <= 1e-3,
          f"{label}: ratio {m['min_safety_ratio']} not within 1e-3 of the "
          f"float64 witness's {witness['min_safety_ratio']}")


def seqbatch_plan(port, mission, world, dev, name: str, dtype: str):
    """One phase-18 plan of the 64-agent forest: (result, times, wall s,
    metrics), its lines logged and its output's shape checked."""
    from swarm_simulator_tpu_torch import Param

    param = Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                  solver_dtype=dtype, **SEQ_RUNS[name])
    label = f"seq {name} {dtype}"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, times = port.plan(mission, param, world, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info = result.solver_info
    check(bool(np.isfinite(result.ctrl).all()),
          f"{label}: non-finite control points")
    check(result.ctrl.shape == (mission.qn, result.M, param.n + 1, 3),
          f"{label}: control points of shape {result.ctrl.shape}")
    check(info["solved"].all(), f"{label}: agents left unsolved")
    metrics = port.evaluate(result, mission, param, device=dev)
    log(f"{label} ({info['mode']}, {info['problem_size']}): wall "
        f"{wall:.3f} s: esdf {times.esdf:.3f} search {times.init_traj:.3f}"
        f" corridor {times.corridor:.3f} qp {times.qp:.3f} timescale "
        f"{times.timescale:.3f}")
    log(f"{label}: iters {info['iters']} max r_prim "
        f"{max(info['r_prim']):.3e} obj "
        f"{[round(v, 4) for v in info['obj']]}")
    log(f"{label} evaluate: " + json.dumps(metrics))
    return result, times, metrics


def seqbatch_runs(dev, smi: str) -> dict:
    """Phase 18: the sequential-batch ADMM path through plan() on the card
    for the 64-agent forest, the three SEQ_RUNS in float32, each followed
    by its float64 witness."""
    import swarm_simulator_tpu_torch as port

    _, mission, _, world = build_problem(SEED)
    out = {}
    counts = {}
    for name in SEQ_RUNS:
        reset_counts()
        result, times, metrics = seqbatch_plan(port, mission, world, dev,
                                               name, "float32")
        for k, v in read_counts().items():
            counts[k] = counts.get(k, 0) + v
        r64, _, m64 = seqbatch_plan(port, mission, world, dev, name,
                                    "float64")
        gap = float(np.abs(result.ctrl - r64.ctrl).max())
        log(f"seq {name}: max |ctrl32 - ctrl64| {gap:.3e} m (at most "
            f"{SEQ_CTRL_GAP[name]})")
        log(f"seq {name} JAX package (CPU) float32: "
            + json.dumps(JAX_CPU_FOREST64[name]))
        log(f"seq {name} JAX package (CPU) float64: "
            + json.dumps(JAX_CPU_FOREST64_F64[name]))
        accept_seq(f"seq {name}", metrics, JAX_CPU_FOREST64[name],
                   JAX_CPU_FOREST64_F64[name], m64)
        check(gap <= SEQ_CTRL_GAP[name], f"seq {name}: the float32 plan "
              f"{gap} m from its float64 witness")
        out[name] = dict(result=result, times=times, metrics=metrics)
    log(f"seq kernel launches and twin calls on CUDA: {counts}")
    check(not any(counts.values()),
          f"the sequential-batch path ran a kernel or a twin: {counts}")

    jac = out["jacobi"]
    n_solves = len(jac["result"].solver_info["iters"])
    log(f"seq jacobi: {n_solves} QP solves ({n_solves // 2} batches x 2 "
        f"rounds) in {jac['times'].qp:.3f} s of qp: "
        f"{n_solves / jac['times'].qp:.2f} QP solves/s on {smi}")
    return out


def blas_threads() -> str:
    """numpy's BLAS, the thread variables set and the CPUs this process may
    use: the host f64 prep and the oracles' factorizations run on that
    BLAS (an OpenBLAS with no variable set runs a thread a CPU)."""
    import os

    blas = np.show_config(mode="dicts")["Build Dependencies"]["blas"]
    env = {k: os.environ[k] for k in ("OMP_NUM_THREADS",
                                      "OPENBLAS_NUM_THREADS",
                                      "MKL_NUM_THREADS") if k in os.environ}
    return (f"numpy's BLAS {blas.get('name')} {blas.get('version')}, "
            f"thread variables {env or 'unset'}, "
            f"{len(os.sched_getaffinity(0))} CPUs")


def oracle_pair(result, mission, oparam, b_idx: int,
                pair_relax: float = 0.0):
    """(obj_b0, obj_ref, oracle s): the plan's jerk objective on agent batch
    ``b_idx`` and the verified f64 IPM best-response optimum of that batch
    (eval/gate; a failed verification raises)."""
    from swarm_simulator_tpu_torch.eval import gate as gate_mod

    obj_b0, _ = gate_mod.batch0_objective(result.ctrl, result, mission,
                                          oparam, b_idx)
    obj_ref, ipm_s = gate_mod.ipm_best_response_batch0(
        result, mission, oparam, result.ctrl, b_idx, pair_relax=pair_relax)
    return obj_b0, obj_ref, ipm_s


def escalate(result, mission, param, dev):
    """bench.py:464-479's warm escalation through the port: the cold
    solve's operator (host f64 prep of the same problem, again), x0 <- the
    plan's control points, joint.escalation_phases through K1.  Sets
    result.ctrl; returns the solve's info."""
    from swarm_simulator_tpu_torch.qp import convert, joint
    from swarm_simulator_tpu_torch.qp import nullspace as ns

    data, _ = joint.assemble_joint(result, mission, param)
    phases = joint.production_phases()
    op_dev = ns.prepare_ns_np(data, phases[0]).to(dev)
    N, M, npp, _ = result.ctrl.shape
    x0 = result.ctrl.reshape(N, M * npp, 3).transpose(0, 2, 1)
    data = dataclasses.replace(data, x0=np.asarray(x0, data.x0.dtype))
    x, info = ns.solve_ns_phases(data, joint.escalation_phases(phases),
                                 op=op_dev, device=dev)
    result.ctrl = convert.x_to_ctrl(x.double().cpu().numpy(), M, param.n)
    return info


def oracle_gates(port, cold, dev) -> dict:
    """Phase 19: the full gate with its IPM objective criterion (obj_tol
    1.25) on gate seeds 0-4 of the 64-agent forest, the oracle batch
    rotating as bench.py's (oracle_batch: 0, 7, 14, 5, 12 of the 16
    batches of 4), each plan through ``port.plan`` (K1) and escalated
    above ESCALATION_TRIGGER as bench.py:464-479; then seed 0 planned with
    ``exact_polish``: accepted, its objective not above the input's, the
    full gate, its margin within 1e-6 of the unpolished one or below and
    <= 1.01.  Any failure raises.  ``cold``: phase 3's seed-0 (result,
    times), reused where its time scale is 1."""
    from swarm_simulator_tpu_torch.eval.gate import oracle_batch
    from swarm_simulator_tpu_torch.parallel import seqbatch
    from swarm_simulator_tpu_torch.qp import joint

    log(f"host BLAS threads: {blas_threads()}")
    out = {}
    for seed in GATE_SEEDS:
        mission, param, world = forest(seed)
        param = dataclasses.replace(param, time_scale=False)
        oparam = dataclasses.replace(param, **ORACLE_BATCHES)
        if seed == SEED and cold[1].extra.get("time_scale") == 1.0:
            result, plan_s, counts = cold[0], None, None
        else:
            reset_counts()
            t0 = time.perf_counter()
            result, _ = port.plan(mission, param, world, device=dev)
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t0
            counts = read_counts()
            check(counts["k1"] > 0, f"seed {seed}: K1 launched 0 times")
            check(all(counts[t] == 0 for t in TWINS),
                  f"seed {seed}: a plain twin ran on CUDA ({counts})")
        n_batches = len(seqbatch.make_batches(mission.qn, oparam)[0])
        b_idx = oracle_batch(seed, n_batches)
        obj_b0, obj_ref, ipm_s = oracle_pair(result, mission, oparam, b_idx)
        first = obj_b0 / obj_ref
        esc = None
        if obj_b0 > joint.ESCALATION_TRIGGER * obj_ref:
            t0 = time.perf_counter()
            info = escalate(result, mission, param, dev)
            torch.cuda.synchronize()
            esc = dict(s=time.perf_counter() - t0, iters=int(info.iters))
            obj_b0, obj_ref, ipm_s = oracle_pair(result, mission, oparam,
                                                 b_idx)
        row = dict(seed=seed, batch=b_idx, plan_s=plan_s,
                   k1=None if counts is None else counts["k1"],
                   obj_b0=obj_b0, obj_ref=obj_ref, margin=obj_b0 / obj_ref,
                   first_margin=first, oracle_s=ipm_s, escalated=esc)
        log(f"oracle gate seed {seed}: " + json.dumps(row))
        gate(result, mission, oparam, dev, f"oracle gate seed {seed}",
             obj_ref, obj_b0)
        out[seed] = row

    # the exact polish of seed 0, graded against the unpolished plan
    mission, param, world = forest(SEED)
    param = dataclasses.replace(param, time_scale=False, exact_polish=True)
    oparam = dataclasses.replace(param, **ORACLE_BATCHES)
    reset_counts()
    t0 = time.perf_counter()
    result, times = port.plan(mission, param, world, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    counts = read_counts()
    pinfo = result.solver_info["exact_polish"]
    log(f"exact polish plan {plan_s:.3f} s (qp {times.qp:.3f}, prep "
        f"{result.solver_info['prep_s']:.3f}, solve "
        f"{result.solver_info['solve_s']:.3f}); K1 launches {counts['k1']}, "
        f"twin calls on CUDA {counts['twin1']}; polish: " + json.dumps(
            pinfo))
    check(counts["k1"] > 0, "exact polish plan: K1 launched 0 times")
    check(all(counts[t] == 0 for t in TWINS),
          f"exact polish plan: a plain twin ran on CUDA ({counts})")
    check(pinfo["accepted"] is True,
          f"exact polish not accepted: {pinfo}")
    check(pinfo["obj_out"] <= pinfo["obj_in"] + 1e-9,
          f"exact polish raised the objective: {pinfo}")
    # the polished plan is exactly optimal, so pair rows may sit at zero
    # slack against the fixed neighbours and leave the barrier no strict
    # interior: the oracle lowers every pair rhs by 1e-6, which biases
    # obj_ref down and the margin up (a stricter reading)
    b_idx = out[SEED]["batch"]
    obj_b0, obj_ref, ipm_s = oracle_pair(result, mission, oparam, b_idx,
                                         pair_relax=1e-6)
    margin = obj_b0 / obj_ref
    before = out[SEED]["first_margin"]
    log(f"exact polish seed {SEED}: margin {margin:.6f} (unpolished "
        f"{before:.6f}), oracle {ipm_s:.3f} s, passes {pinfo['passes']} "
        f"n_active {pinfo['n_active']} kkt_optimal {pinfo['kkt_optimal']} "
        f"t_s {pinfo['t_s']:.3f}")
    check(margin <= before + 1e-6 and margin <= 1.01,
          f"exact polish margin {margin} (unpolished {before})")
    gate(result, mission, oparam, dev, "exact polish", obj_ref, obj_b0)
    out["polish"] = dict(plan_s=plan_s, margin=margin, oracle_s=ipm_s,
                         k1=counts["k1"], **pinfo)
    return out


#: phase 20's Monte-Carlo: the canonical forest's seeds 0..7, two-phase
#: and pipelined in chunks of MC_PIPELINE scenarios
MC_SCENARIOS = 8
MC_PIPELINE = 4
#: the pipelined path's coefficients against the two-phase path's
#: (float32: each scenario's problem is solved alone in both, padded to
#: other pair counts)
MC_PIPE_TOL = 1e-4
#: phase 20's knot-state Jacobi sweep: batches of 4, tighten, and the
#: short schedule of its kernel-against-twin comparison
JACOBI_TIGHTEN = 2e-3
JACOBI_CMP_ITERS = (50, 50)
#: the JAX package's knot-state Jacobi sweep of phase 20's problem (the
#: 64-agent forest of seed 0, 16 groups of 4, two rounds, tighten 2e-3) on
#: a CPU host: the safety ratio of its time-scaled plan by (mode, dtype)
#: (``PYTHONPATH=. python tests/test_torch_jacobi.py --package jax --mode
#: MODE --dtype DTYPE``, x64 only for float64 as the JAX CLI; PERF.md).
#: Every one is below 1: each group keeps the others at their previous
#: round's positions, and the groups' simultaneous moves collide across
#: groups (ROADMAP queue 3).  So phase 20 holds the sweeps to
#: tests/test_pipeline.py:_check's other clauses, prints their ratios
#: beside these, and holds the dense sweep in float64 to the float64 value
#: within JACOBI_RATIO_TOL
JAX_CPU_JACOBI64 = {("banded", "float32"): 0.5795884728431702,
                    ("banded", "float64"): 0.5660554629706032,
                    ("dense", "float32"): 0.5524252653121948,
                    ("dense", "float64"): 0.5660554629884789}
JACOBI_RATIO_TOL = 1e-3
#: the same banded float32 sweep on the card with K1's plain twin in K1's
#: place (python3 -m swarm_simulator_tpu_torch.tools.jacobi_f32_study, an
#: H100 80GB HBM3 at 700 W; ~6 min, too long for this script): the sweep
#: stops at max_iter with its dual residual far from converged, and the
#: float32 rounding of the card's twin lands its ratio at this value, of
#: the port's twin on a CPU at 0.5404 and of the JAX package's at 0.5796
#: (PERF.md).  The preps' rounding moves it too: with each group prepared
#: alone (before prepare_ns_stack) the twin's sweep read 0.4264031 and
#: the kernel's 0.4259370; the chunked preps' batched LU over 4 x 7
#: matrices rounds the pivots otherwise (4.2e-5 relative) and both moved,
#: the twin to this value and the kernel to 0.5211164.  Phase 20 holds
#: the sweep through K1 to it within JACOBI_F32_RATIO_TOL, ten times the
#: gap between K1's sweep and the twin's (5.0e-4 before, 2.9e-4 now)
CARD_TWIN_JACOBI_F32 = 0.5214104873550186
JACOBI_F32_RATIO_TOL = 5e-3
#: phase 20's per-phase joint solve: the restore phase tightens by this
#: (the production phases' 2e-3 elsewhere), which schedule_arrays refuses
RESTORE_TIGHTEN = 3e-3
#: the SCP run on float32 against the same run in float64: the cost's
#: relative gap
SCP_COST_TOL = 1e-3
#: the reference's start and goal noise of the SCP node
#: (swarm_traj_planner_scp.cpp, applyNoise 0.01; seeded here): without it
#: the antipodal swap sends every pair through the centre at one step, the
#: linearized separation direction of a coinciding pair is 0 and the QP
#: asks 0 >= R (in float64 the SCP then stops at ratio 0.58)
SCP_NOISE = 0.01


def plan_metrics(plan, mission, param, ctrl, dev) -> dict:
    """evaluate() of ``plan`` with control points ``ctrl``, time-scaled as
    plan() scales a solution."""
    import copy

    import swarm_simulator_tpu_torch as port
    from swarm_simulator_tpu_torch.qp import convert, timescale

    res = copy.copy(plan)
    res.ctrl = ctrl
    res.coef = convert.ctrl_to_coef(ctrl, plan.T, param.n)
    if param.time_scale:
        scale = timescale.compute_time_scale(
            res.coef, res.T, mission.max_vel, mission.max_acc, param.n,
            param.phi)
        res.coef, res.T = timescale.apply_time_scale(res.coef, res.T, scale,
                                                     param.n)
    return port.evaluate(res, mission, param, device=dev)


def monte_carlo(dev) -> dict:
    """Phase 20, Monte-Carlo: run_monte_carlo of the canonical forest's
    seeds 0..MC_SCENARIOS-1 (64 agents, 20 obstacles, float32, the
    module's cg settings) two-phase and pipelined, then the two-phase
    plans again in float64 (solve_scenarios) as the witness; each
    scenario's bucket, rounds, iterations and stage seconds; checks: no
    kernel and no twin ran, every scenario solved, pipelined coefficients
    within MC_PIPE_TOL of the two-phase ones, each plan's safety ratio >=
    1 - 1e-3, its control points within phase 18's cg bar of the
    witness's."""
    import copy

    import swarm_simulator_tpu_torch as port
    from swarm_simulator_tpu_torch.parallel import scenarios as scn

    mission, param, _ = forest(SEED)
    runs = {}
    reset_counts()
    for label, pipe in (("two-phase", None),
                        (f"pipeline={MC_PIPELINE}", MC_PIPELINE)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = scn.run_monte_carlo(mission, param, n_scenarios=MC_SCENARIOS,
                                  seed0=SEED, pipeline=pipe, device=dev)
        torch.cuda.synchronize()
        runs[label] = (out, time.perf_counter() - t0)
    counts = read_counts()
    check(not any(counts.values()),
          f"the Monte-Carlo path ran a kernel or a twin: {counts}")
    (two, two_s), (pipe, pipe_s) = runs.values()
    for a, b in zip(two, pipe):
        check(a.error is None and b.error is None,
              f"a Monte-Carlo scenario failed: {a.error} / {b.error}")
    wit = [scn.Scenario(sc.mission, sc.world, copy.deepcopy(sc.plan))
           for sc in two]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scn.solve_scenarios(wit, dataclasses.replace(param,
                                                 solver_dtype="float64"),
                        device=dev)
    torch.cuda.synchronize()
    wit_s = time.perf_counter() - t0
    prep = {k: sum(sc.times[k] for sc in two)
            for k in ("esdf", "search", "corridor")}
    solves = {}
    for label, out in (("two-phase", two), ("pipelined", pipe)):
        # one solve a stack: count each stack once
        seen = {}
        for sc in out:
            info = sc.plan.solver_info
            seen[(info["M"], info["solve_s"])] = (info["assemble_s"]
                                                  + info["solve_s"])
        solves[label] = sum(seen.values())
    for i, (a, b, w) in enumerate(zip(two, pipe, wit)):
        m = port.evaluate(a.plan, mission, param, device=dev)
        dcoef = float(np.abs(a.plan.coef - b.plan.coef).max())
        gap = float(np.abs(a.plan.ctrl - w.plan.ctrl).max())
        ia, ib = a.plan.solver_info, b.plan.solver_info
        log(f"mc seed {SEED + i}: M bucket {ia['M']} rounds {ia['rounds']} "
            f"iters {ia['iters']} (pipelined {ib['iters']}, stack "
            f"{ib['stack']}); prep s " + json.dumps(
                {k: round(v, 4) for k, v in a.times.items()})
            + f"; two-phase stack of {ia['stack']}: assemble "
            f"{ia['assemble_s']:.3f} s solve {ia['solve_s']:.3f} s; "
            f"ratio {m['min_safety_ratio']:.6f}; max |coef pipelined - "
            f"two-phase| {dcoef:.3e}; max |ctrl32 - ctrl64| {gap:.3e} m")
        check(dcoef <= MC_PIPE_TOL, f"mc seed {SEED + i}: pipelined "
              f"coefficients {dcoef} from the two-phase ones")
        check(m["min_safety_ratio"] >= 1.0 - 1e-3,
              f"mc seed {SEED + i}: safety ratio {m['min_safety_ratio']}")
        check(gap <= SEQ_CTRL_GAP["default"], f"mc seed {SEED + i}: the "
              f"float32 plan {gap} m from its float64 witness")
    log(f"mc {MC_SCENARIOS} scenarios x {mission.qn} agents: two-phase "
        f"{two_s:.3f} s ({two_s / MC_SCENARIOS:.3f} s a scenario), "
        f"pipelined {pipe_s:.3f} s ({pipe_s / MC_SCENARIOS:.3f} s a "
        f"scenario); host prep (thread seconds, summed) " + json.dumps(
            {k: round(v, 3) for k, v in prep.items()})
        + f"; assemble + solve: two-phase {solves['two-phase']:.3f} s, "
        f"pipelined {solves['pipelined']:.3f} s; two-phase prep wall "
        f"{two_s - solves['two-phase']:.3f} s; pipelined wall minus its "
        f"solves {pipe_s - solves['pipelined']:.3f} s; float64 witness "
        f"solve {wit_s:.3f} s")
    return dict(two_s=two_s, pipe_s=pipe_s, wit_s=wit_s, prep=prep,
                solves=solves)


def jacobi_stack(plan, mission, param):
    """The 64-agent forest's batch QPs of ORACLE_BATCHES (16 groups of 4)
    on the host, stacked and padded to one pair count, and the dummy."""
    from swarm_simulator_tpu_torch.parallel import seqbatch
    from swarm_simulator_tpu_torch.qp import assemble

    batches, _ = seqbatch.make_batches(
        mission.qn, dataclasses.replace(param, **ORACLE_BATCHES))
    dummy = assemble.build_dummy(plan.init_traj, param.n, plan.M)
    pairs = np.asarray(plan.pair_idx)
    pad = max(int(np.isin(pairs, b).any(axis=1).sum()) for b in batches)
    return seqbatch._stack_qpdata([
        assemble.assemble_batch(plan, mission, param, b, dummy, pad)
        for b in batches]), dummy


def jacobi_knot_state(plan, mission, param, dev) -> dict:
    """Phase 20, the knot-state Jacobi sweep (mesh.jacobi_sweep) of the
    64-agent forest's 16 groups of 4, two rounds, in both KKT modes:
    banded in float32 (each chunk one launch of the stacked kernel for the
    running groups, no per-problem K1) and dense in float64 (no kernel, no
    float32 rounding to amplify), each plan time-scaled and held to
    tests/test_pipeline.py:_check as JAX_CPU_JACOBI64 says, the float32
    ratio to CARD_TWIN_JACOBI_F32; the stacked kernel on the 16 groups'
    own operands against its twins and against itself alone, timed
    beside 16 per-problem K1 launches (stack_vs_twins); then the banded
    sweep at the short schedule JACOBI_CMP_ITERS through the stacked
    kernel, the float32 twin and a float64 twin in its place, the
    kernel's run held to K1's tolerance against the float64 twin's.  Each
    mode's first round also holds groups ALONE_GROUPS alone against the
    same groups in the stack (alone_vs_stack), group 0's banded solve
    alone through the kernel and the twins at the sweep's own schedule;
    each sweep's seconds, its preps' and its stack loop's host syncs are
    printed and the syncs held to one a chunk."""
    from unittest import mock

    from swarm_simulator_tpu_torch.ops import nsfused, thomas
    from swarm_simulator_tpu_torch.parallel import mesh
    from swarm_simulator_tpu_torch.qp import nullspace as ns
    from swarm_simulator_tpu_torch.utils import timing

    stacked, dummy = jacobi_stack(plan, mission, param)

    def cast(data, dtype):
        return dataclasses.replace(data, **{
            f.name: np.asarray(getattr(data, f.name), dtype)
            for f in dataclasses.fields(data)
            if np.asarray(getattr(data, f.name)).dtype.kind == "f"})

    out = {}
    for mode, dtype in (("banded", np.float32), ("dense", np.float64)):
        label = f"jacobi knot-state {mode} {np.dtype(dtype).name}"
        s = ns.NSSettings(kkt_mode=mode, tighten=JACOBI_TIGHTEN)
        st = cast(stacked, dtype)
        calls = {"loop": 0, "prep_s": 0.0}
        prep, loop = ns.prepare_ns_stack, ns._iterate_ns

        def timed_prep(*a, **kw):
            t0 = time.perf_counter()
            ops = prep(*a, **kw)
            torch.cuda.synchronize()
            calls["prep_s"] += time.perf_counter() - t0
            return ops

        def counted_loop(*a, **kw):
            calls["loop"] += 1
            return loop(*a, **kw)

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(ns, "prepare_ns_stack", timed_prep), \
                mock.patch.object(ns, "_iterate_ns", counted_loop), \
                timing.recording() as rec:
            ctrl, info = mesh.jacobi_sweep(st, dummy.astype(dtype), s,
                                           rounds=2, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        syncs = rec.counters.get("solve.syncs", 0)
        m = plan_metrics(plan, mission, param,
                         ctrl.double().cpu().numpy(), dev)
        ref = JAX_CPU_JACOBI64[mode, np.dtype(dtype).name]
        log(f"{label}: 2 rounds {secs:.3f} s (PR 16: "
            f"{JACOBI_PR16_S[mode]}), of which the stacked preps "
            f"{calls['prep_s']:.3f} s; last round iters "
            f"{info.iters.tolist()}, stack loop host syncs {syncs}, "
            f"per-entry loops {calls['loop']}, stack launches "
            f"{counts['kstack']}, K1 launches {counts['k1']}, twin calls on "
            f"CUDA {sum(counts[t] for t in TWINS)}; evaluate "
            "(time-scaled): " + json.dumps(m)
            + f"; the JAX package's ratio (CPU) {ref}")
        accept_plan(label, m, ratio=False)
        # two rounds of at most max_iter / check_every chunks, each one
        # host sync for the whole stack, no entry through _iterate_ns
        most = 2 * -(-s.max_iter // s.check_every)
        check(0 < syncs <= most and calls["loop"] == 0,
              f"{label}: {syncs} host syncs of the stack loop (1 to {most}) "
              f"and {calls['loop']} per-entry loops (0)")
        if dtype == np.float64:
            check(abs(m["min_safety_ratio"] - ref) <= JACOBI_RATIO_TOL,
                  f"{label}: ratio {m['min_safety_ratio']} not within "
                  f"{JACOBI_RATIO_TOL} of the JAX package's {ref}")
        else:
            log(f"{label}: ratio beside the float32 twin's sweep on the "
                f"card {CARD_TWIN_JACOBI_F32}")
            check(abs(m["min_safety_ratio"] - CARD_TWIN_JACOBI_F32)
                  <= JACOBI_F32_RATIO_TOL,
                  f"{label}: ratio {m['min_safety_ratio']} not within "
                  f"{JACOBI_F32_RATIO_TOL} of the float32 twin's sweep on "
                  f"the card, {CARD_TWIN_JACOBI_F32}")
        if mode == "banded":
            # each chunk one launch for the running groups
            check(counts["kstack"] == syncs,
                  f"the banded Jacobi sweep launched the stacked kernel "
                  f"{counts['kstack']} times in {syncs} chunks")
            check(counts["k1"] == 0, f"the banded Jacobi sweep launched "
                  f"per-problem K1 {counts['k1']} times")
            check(all(counts[t] == 0 for t in TWINS),
                  f"the banded Jacobi sweep ran a twin on CUDA ({counts})")
        else:
            check(not any(counts.values()), "the dense Jacobi sweep ran a "
                  f"kernel or a twin: {counts}")
        out[mode, np.dtype(dtype).name] = dict(
            s=secs, prep_s=calls["prep_s"], syncs=syncs, counts=counts,
            metrics=m, alone=alone_vs_stack(st, s, dev, label))

    s = ns.NSSettings(kkt_mode="banded", tighten=JACOBI_TIGHTEN)
    out["stack"] = stack_vs_twins(stacked, s, dev)

    # through the stacked kernel, the float32 twin and a float64 twin in
    # its place (and in K1's, which the sweep must not reach): the whole
    # sweep at the short schedule (group 0's first round at the sweep's
    # own, max_iter and 30 chunks, runs so in alone_vs_stack)
    # the counters of the functions themselves, not of the names the
    # patches below rebind
    counted = dict(kstack=(nsfused.nsfused_stack, "launches"),
                   k1=(nsfused.nsfused_chunk, "launches"),
                   twinstack=(nsfused.nsfused_stack_reference, "cuda_calls"))

    def through_kernel_and_twins(label, data, rows, **kw):
        def sweep(dtype):
            before = {k: getattr(f, a) for k, (f, a) in counted.items()}
            t0 = time.perf_counter()
            c, _ = mesh.jacobi_sweep(cast(data, dtype), dummy.astype(dtype),
                                     s, device=dev, **kw)
            c = c[rows].double()
            return c, time.perf_counter() - t0, {
                k: getattr(f, a) - before[k] for k, (f, a) in counted.items()}

        (ck, sk, nk) = sweep(np.float32)
        check(nk["kstack"] > 0 and nk["k1"] == 0 and nk["twinstack"] == 0,
              f"{label}: the kernel run's counts {nk}")
        with mock.patch.object(nsfused, "nsfused_chunk",
                               nsfused.nsfused_chunk_reference), \
                mock.patch.object(nsfused, "nsfused_stack",
                                  nsfused.nsfused_stack_reference):
            (ct, st, nt), (c64, s64, _) = sweep(np.float32), \
                sweep(np.float64)
        check(nt["kstack"] == 0 and nt["k1"] == 0 and nt["twinstack"] > 0,
              f"{label}: the float32 twin run's counts {nt}")
        ek, et = thomas.rel_error(ck, c64), thomas.rel_error(ct, c64)
        use = thomas.twin_gap_use([ek], [et])
        log(f"{label}: ctrl rel err kernel vs float64 twin {ek:.3e}, "
            f"float32 twin vs float64 twin {et:.3e}, kernel vs float32 twin "
            f"{thomas.rel_error(ck, ct):.3e}; tolerance used {use:.2f}; "
            f"seconds kernel {sk:.2f}, twins {st:.2f} and {s64:.2f}; "
            f"stack launches {nk['kstack']}, twin stack calls on CUDA "
            f"{nt['twinstack']}")
        check(use <= 1.0, f"{label} through the stacked kernel is less "
              f"accurate than the float32 twin allows ({use:.2f} of the "
              "tolerance)")
        return use

    out["short_use"] = through_kernel_and_twins(
        f"jacobi banded sweep at {JACOBI_CMP_ITERS}", stacked,
        slice(None), rounds=2, iters_schedule=JACOBI_CMP_ITERS)
    out["full_use"] = out["banded", "float32"]["alone"]["full_use"]
    return out


#: phase 20's groups solved alone against the same groups in the stack
ALONE_GROUPS = (0, 5, 15)
#: the dense float64 stack's x against the group alone, relative to max |x|:
#: the card's linear algebra takes another kernel for the prep's batched
#: inverse of 4 x 7 rungs than for one group's 7, which parts the K(rho)^-1
#: by ~1.8e-14 and the 3000-iteration solves by up to 7.9e-12 (PERF.md §6)
ALONE_DENSE_TOL = 1e-10
#: the banded group solved alone through the stacked kernel, its float32
#: twin and a float64 twin in its place (~20 s), its first round at the
#: sweep's own schedule held to K1's twin rule, and so is the group in
#: the stack; the other ALONE_GROUPS to equal iterations and rungs, their
#: gaps printed
ALONE_TWIN_GROUP = 0
#: PR 16's two-round sweeps on an H100 80GB HBM3 at 700 W (PERF.md §5)
JACOBI_PR16_S = {"banded": "2.097 s", "dense": "29.978 s"}


def alone_vs_stack(stacked, s, dev, label: str) -> dict:
    """Phase 20: the first round's solve of the 16 groups as one stack
    (prepare_ns_stack in chunks of 4, iterate_ns_stack) against groups
    ALONE_GROUPS each prepared and solved alone: equal iterations and
    final rungs, and x within ALONE_DENSE_TOL (dense float64).  Banded
    float32 group ALONE_TWIN_GROUP is solved alone also through the float32
    twin and a float64 twin in the stacked kernel's place: its kernel
    solve alone, and its solve in the stack where that is not bit-equal,
    are held to K1's twin rule against them ("full_use": the kernel's
    share alone)."""
    from unittest import mock

    from swarm_simulator_tpu_torch.ops import nsfused, thomas
    from swarm_simulator_tpu_torch.qp import nullspace as ns

    data = stacked.to(dev)
    G = data.lb.shape[0]
    datas = [dataclasses.replace(data, **{
        f.name: getattr(data, f.name)[g] for f in dataclasses.fields(data)
        if getattr(data, f.name) is not None}) for g in range(G)]
    whole = ns.iterate_ns_stack(datas, ns.prepare_ns_stack(data, s, 4), s,
                                return_state=True)
    out = {}
    for g in ALONE_GROUPS:
        def solve(d=datas[g]):
            return ns.iterate_ns_stack([d], [ns.prepare_ns(d, s)], s,
                                       return_state=True)[0]

        one = solve()
        x, x1 = whole[g][0].double(), one[0].double()
        gap = float((x - x1).abs().max()) / max(float(x1.abs().max()),
                                                 1e-30)
        same = (int(whole[g][1].iters) == int(one[1].iters)
                and int(whole[g][2][3]) == int(one[2][3]))
        use = None
        if s.kkt_mode == "banded" and g == ALONE_TWIN_GROUP:
            before = (nsfused.nsfused_stack.launches,
                      nsfused.nsfused_stack_reference.cuda_calls)
            t0 = time.perf_counter()
            with mock.patch.object(nsfused, "nsfused_stack",
                                   nsfused.nsfused_stack_reference):
                t32 = solve()[0].double()
                t64 = solve(dataclasses.replace(datas[g], **{
                    f.name: getattr(datas[g], f.name).double()
                    for f in dataclasses.fields(datas[g])
                    if torch.is_floating_point(getattr(datas[g],
                                                       f.name))}))[0]
            twins_s = time.perf_counter() - t0
            check(nsfused.nsfused_stack.launches == before[0]
                  and nsfused.nsfused_stack_reference.cuda_calls
                  > before[1], f"{label}: group {g}'s twin solves launched "
                  "the kernel or ran no twin")
            e32 = thomas.rel_error(t32, t64)
            out["full_use"] = full = thomas.twin_gap_use(
                [thomas.rel_error(x1, t64)], [e32])
            log(f"{label}: group {g}'s first round alone at max_iter "
                f"{s.max_iter}: x rel err kernel vs float64 twin "
                f"{thomas.rel_error(x1, t64):.3e}, float32 twin vs float64 "
                f"twin {e32:.3e}, kernel vs float32 twin "
                f"{thomas.rel_error(x1, t32):.3e}; tolerance used "
                f"{full:.2f}; twins {twins_s:.2f} s")
            check(full <= 1.0, f"{label}: group {g} alone through the "
                  f"stacked kernel is less accurate than the float32 twin "
                  f"allows ({full:.2f} of the tolerance)")
            if gap:
                use = thomas.twin_gap_use([thomas.rel_error(x, t64)], [e32])
        log(f"{label}: group {g} alone vs in the stack of {G}: iters "
            f"{int(one[1].iters)}/{int(whole[g][1].iters)}, final rung "
            f"{int(one[2][3])}/{int(whole[g][2][3])}, x rel gap {gap:.3e}"
            + ("" if use is None else f", twin-rule share {use:.2f}"))
        check(same, f"{label}: group {g} alone and in the stack differ in "
              "iterations or final rung")
        if s.kkt_mode == "dense":
            check(gap <= ALONE_DENSE_TOL, f"{label}: group {g} alone and "
                  f"in the stack differ by {gap:.3e} (> {ALONE_DENSE_TOL})")
        elif use is not None:
            check(use <= 1.0, f"{label}: group {g} alone and in the stack "
                  f"differ beyond K1's twin rule ({use:.2f})")
        out[g] = dict(gap=gap, use=use)
    return out


def stack_vs_twins(stacked, s, dev) -> dict:
    """Phase 20, the stacked kernel on the 16 groups' own operands (each
    group's host prep, cold state): one N_INNER chunk of every group at
    rung 0, at the last rung and with group g on rung g mod R (one launch
    each), through the kernel, the float32 twin and a float64 twin; each
    group's error on each state part over the three held to
    ops/nsfused.twin_gap_use (phase 2's rule), and each part's worst share
    no larger than per-problem K1's on the same chunks (the float64 state
    is there to be more accurate than K1 at a group's size);
    each group's result bit-equal to the kernel on that group alone; then
    CUDA events time one launch for the 16 groups against the 16
    per-problem K1 launches of the same chunk and the float32 twin,
    beside the stack's bound (each group's chunk_work summed)."""
    from swarm_simulator_tpu_torch.ops import nsfused
    from swarm_simulator_tpu_torch.qp import nullspace as ns
    from swarm_simulator_tpu_torch.tools._timing import event_ms

    G = np.asarray(stacked.lb).shape[0]
    groups = [dataclasses.replace(stacked, **{
        f.name: np.asarray(getattr(stacked, f.name))[g]
        for f in dataclasses.fields(stacked)
        if getattr(stacked, f.name) is not None}) for g in range(G)]
    t0 = time.perf_counter()
    ops_h = [ns.prepare_ns_np(g, s) for g in groups]
    prep_s = time.perf_counter() - t0
    R = ops_h[0].Dinvs.shape[0]
    inputs = {}
    for dtype in (torch.float32, torch.float64):
        prep = [ns.cold_chunk_inputs(*on_device(g, op, dev, dtype), s)
                for g, op in zip(groups, ops_h)]
        inputs[dtype] = (nsfused.stack_operands([p[0] for p in prep]),
                         [p[0] for p in prep],
                         ns.stack_states([p[1] for p in prep]))
    sops, ops32, state = inputs[torch.float32]
    sops64, _, state64 = inputs[torch.float64]
    every = list(range(G))
    rows = [ns.entry_state(state, g) for g in every]
    errs = {k: [[] for _ in every] for k in ("k64", "t64", "K1")}
    scale = [0.0] * G
    max_abs, n_alone = 0.0, 0
    for name, rungs in (("rung 0", [0] * G), (f"rung {R - 1}", [R - 1] * G),
                        ("rung g mod R", [g % R for g in every])):
        args = (s.sigma, s.alpha)
        kern = nsfused.nsfused_stack(sops, every, rungs, *args, *state,
                                     N_INNER)
        twin = nsfused.nsfused_stack_reference(sops, every, rungs, *args,
                                               *state, N_INNER)
        twin64 = nsfused.nsfused_stack_reference(sops64, every, rungs, *args,
                                                 *state64, N_INNER)
        torch.cuda.synchronize()
        for g in every:
            kg, tg, t64 = (ns.entry_state(o, g) for o in (kern, twin, twin64))
            for a, b in zip((kg[0], *kg[1], *kg[2]), (tg[0], *tg[1], *tg[2])):
                check(bool(torch.isfinite(a).all()),
                      f"stack {name}: group {g} not finite")
                max_abs = max(max_abs, float((a - b).abs().max()))
            errs["k64"][g].append(nsfused.state_errors(kg, t64))
            errs["t64"][g].append(nsfused.state_errors(tg, t64))
            # per-problem K1 on the same chunk, under the same rule
            errs["K1"][g].append(nsfused.state_errors(nsfused.nsfused_chunk(
                ops32[g], rungs[g], *args, *rows[g], N_INNER), t64))
            scale[g] = max(scale[g], float(t64[2].box.abs().max()))
            alone = ns.entry_state(nsfused.nsfused_stack(
                nsfused.stack_operands([ops32[g]]), [0], rungs[g:g + 1],
                *args, *ns.entry_state(state, slice(g, g + 1)), N_INNER), 0)
            n_alone += 1
            for a, b in zip((kg[0], *kg[1], *kg[2]),
                            (alone[0], *alone[1], *alone[2])):
                check(torch.equal(a, b), f"stack {name}: group {g} differs "
                      "from the kernel on that group alone")
    use = [nsfused.twin_gap_use(errs["k64"][g], errs["t64"][g])
           for g in every]
    k1_use = [nsfused.twin_gap_use(errs["K1"][g], errs["t64"][g])
              for g in every]
    for g in every:
        log(f"stack group {g}: max |y_box| {scale[g]:.3e}; share of the "
            "tolerance per part, stack / per-problem K1: " + " ".join(
                f"{p} {use[g][p]:.2f}/{k1_use[g][p]:.2f}"
                for p in nsfused.STATE_PARTS)
            + "; worst rel err vs float64 twin over the runs, stack / K1 "
            "/ float32 twin: " + " ".join(
                f"{p} " + "/".join(f"{max(e[i] for e in errs[k][g]):.1e}"
                                   for k in ("k64", "K1", "t64"))
                for i, p in enumerate(nsfused.STATE_PARTS)))
    worst = {p: max(u[p] for u in use) for p in nsfused.STATE_PARTS}
    k1_worst = {p: max(u[p] for u in k1_use) for p in nsfused.STATE_PARTS}
    log(f"stack of {G} groups (bs {sops.dims['bs']}, Mi {sops.dims['Mi']}, "
        f"P {sops.dims['P']}, a rung {4 * sops.dims['rung']} bytes; host "
        f"preps {prep_s:.3f} s): the worst group's share of the tolerance "
        "per part (limit 1), stack / per-problem K1: " + " ".join(
            f"{p} {v:.2f}/{k1_worst[p]:.2f}" for p, v in worst.items())
        + f"; max abs err vs float32 twin {max_abs:.3e}; {n_alone} groups "
        "alone bit-equal to the stack")
    for p, v in worst.items():
        check(v <= 1.0, f"stack {p}: a group is less accurate than the "
              f"float32 twin allows ({v:.2f} of the tolerance)")
        check(v <= k1_worst[p], f"stack {p}: less accurate than "
              f"per-problem K1 on the same chunks ({v:.2f} against "
              f"{k1_worst[p]:.2f} of the tolerance)")

    a = (every, [0] * G, s.sigma, s.alpha, *state, N_INNER)
    reset_counts()
    ms = event_ms(lambda: nsfused.nsfused_stack(sops, *a), 5)
    k1_ms = event_ms(lambda: [nsfused.nsfused_chunk(
        ops32[g], 0, s.sigma, s.alpha, *rows[g], N_INNER)
        for g in every], 3)
    plain_ms = event_ms(lambda: nsfused.nsfused_stack_reference(sops, *a),
                        1, warmup=0)
    counts = read_counts()
    check(counts["kstack"] == 6 and counts["k1"] == 4 * G,
          f"stack timing: launches {counts}")
    work = [chunk_work(o, r) for o, r in zip(ops32, rows)]
    # at the function's type, float32 (the float64 state inside the
    # block is the kernel's own choice)
    bnd = bound(sum(b for b, _ in work), sum(f for _, f in work))
    log(f"stack of {G} groups, one N_INNER={N_INNER} chunk at rung 0: one "
        f"stack launch median {np.median(ms):.4f} ms, {G} per-problem K1 "
        f"launches {np.median(k1_ms):.4f} ms ({np.median(k1_ms) / G:.4f} ms "
        f"each), the float32 twin {plain_ms[0]:.3f} ms; the stack's bound "
        f"{bnd[0]:.5f} ms ({bnd[1]})")
    return dict(use=max(worst.values()), max_abs_err=max_abs,
                ms=float(np.median(ms)), k1_ms=float(np.median(k1_ms)),
                plain_ms=float(plain_ms[0]), bound=bnd)


def per_phase_joint(port, phase19, dev) -> dict:
    """Phase 20, the per-phase joint solve: plan() of forest seed 0 with
    the production phases whose restore phase tightens by
    RESTORE_TIGHTEN (a tuple that schedule_arrays refuses): K1 launched,
    no twin, the full gate with the IPM oracle on phase 19's batch, its
    margin beside phase 19's schedule-path margin of the same seed."""
    from swarm_simulator_tpu_torch.qp import joint, nullspace as ns

    mission, param, world = forest(SEED)
    param = dataclasses.replace(param, time_scale=False)
    oparam = dataclasses.replace(param, **ORACLE_BATCHES)
    ph = joint.production_phases()
    ph = ph[:2] + (dataclasses.replace(ph[2], tighten=RESTORE_TIGHTEN),)
    check(ns.schedule_arrays(ph) is None, "the per-phase tuple is "
          "schedule-compatible")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result, times = port.plan(mission, param, world, ns_phases=ph,
                              device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    counts = read_counts()
    check(counts["k1"] > 0, "per-phase joint solve: K1 launched 0 times")
    check(all(counts[t] == 0 for t in TWINS),
          f"per-phase joint solve: a plain twin ran on CUDA ({counts})")
    b_idx = phase19[SEED]["batch"]
    obj_b0, obj_ref, ipm_s = oracle_pair(result, mission, oparam, b_idx)
    margin = obj_b0 / obj_ref
    info = result.solver_info
    log(f"per-phase joint solve {plan_s:.3f} s (prep {info['prep_s']:.3f} "
        f"solve {info['solve_s']:.3f}), iters {info['iters'][0]}, K1 "
        f"launches {counts['k1']}; margin {margin:.6f} against the "
        f"schedule path's {phase19[SEED]['first_margin']:.6f} (phase 19), "
        f"oracle {ipm_s:.3f} s")
    gate(result, mission, oparam, dev, "per-phase joint", obj_ref, obj_b0)
    return dict(plan_s=plan_s, margin=margin, k1=counts["k1"])


#: phase 20's sweep CLI: the maps this process plans again through the
#: library, each row's ratio held to the CLI's (one map suffices for the
#: determinism check; the other two only run through the CLI)
SWEEP_LIB_MAPS = (1,)


def sweep_cli(dev) -> dict:
    """Phase 20, the sweep CLI: forest seeds 0-2 written as map1-3.bt
    (world/btree.write_bt) and the 64-agent mission as JSON in a
    temporary directory, ``python -m swarm_simulator_tpu_torch.cli.sweep``
    run as two subprocesses (the admm default and --solver nullspace)
    while this process plans the maps of SWEEP_LIB_MAPS through the
    library with the CLI's Param; checks: exit 0, ``# success 3/3``, a row
    a map, and those maps' ratios equal to the library plan's."""
    import shutil
    import tempfile
    from pathlib import Path

    import swarm_simulator_tpu_torch as port
    from swarm_simulator_tpu_torch.cli import sweep
    from swarm_simulator_tpu_torch.io.mission_json import (load_mission,
                                                           write_mission)
    from swarm_simulator_tpu_torch.world.btree import load_bt_world, write_bt

    d = Path(tempfile.mkdtemp(prefix="chip_smoke_sweep_"))
    procs = {}
    try:
        for i in range(3):
            mission, param, world = forest(i)
            write_bt(d / f"map{i + 1}.bt", world)
        write_mission(d / "mission.json", mission)
        base = ["--mission", str(d / "mission.json"), "--worlds-dir", str(d),
                "--maps", "1-3", "--world-min", "-5", "-5",
                str(param.world_z_min), "--device", str(dev), "--json"]
        t0 = time.perf_counter()
        for solver in ("admm", "nullspace"):
            procs[solver] = subprocess.Popen(
                [sys.executable, "-m", "swarm_simulator_tpu_torch.cli.sweep",
                 *base, "--solver", solver], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                cwd=Path(__file__).resolve().parent)
        lib = {}
        mission = load_mission(d / "mission.json")
        for solver in procs:
            sparam = sweep.sweep_param(sweep.build_argparser().parse_args(
                [*base, "--solver", solver]))
            for mi in SWEEP_LIB_MAPS:
                world = load_bt_world(d / f"map{mi}.bt", sparam.world_min,
                                      sparam.world_max)
                result, _ = port.plan(mission, sparam, world, device=dev)
                m = port.evaluate(result, mission, sparam, device=dev)
                lib[solver, mi] = round(m["min_safety_ratio"], 4)
        out = {}
        for solver, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            lines = stdout.strip().splitlines()
            log(f"sweep cli --solver {solver} (rc {p.returncode}, "
                f"{time.perf_counter() - t0:.1f} s since start):")
            for ln in lines:
                log("  " + ln)
            check(p.returncode == 0, f"sweep cli {solver}: exit "
                  f"{p.returncode}: {stderr[-2000:]}")
            check(lines[-1] == "# success 3/3",
                  f"sweep cli {solver}: {lines[-1]!r}")
            rows = [json.loads(ln) for ln in lines[:-1]]
            check(sorted(r["map"] for r in rows) == [1, 2, 3],
                  f"sweep cli {solver}: rows {rows}")
            for r in (r for r in rows if r["map"] in SWEEP_LIB_MAPS):
                check(r["ratio"] == lib[solver, r["map"]],
                      f"sweep cli {solver} map {r['map']}: ratio "
                      f"{r['ratio']}, the library plan's "
                      f"{lib[solver, r['map']]}")
            out[solver] = rows
        log("sweep cli: the ratios equal the library plan's: "
            + json.dumps({f"{k[0]} map{k[1]}": v for k, v in lib.items()}))
        return out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(d, ignore_errors=True)


def scp_cli(dev) -> dict:
    """Phase 20, SCP: ``cli.plan --preset scp --alg scp`` (time_step 0.5)
    on the card for the 8-agent swap as a mission JSON with the
    reference's SCP_NOISE, in float32 and in float64; checks: exit 0 (min
    ratio >= 0.99, goal error < 1e-2) and the float32 cost within
    SCP_COST_TOL of the float64 one."""
    import contextlib
    import io
    import shutil
    import tempfile
    from pathlib import Path

    from unittest import mock

    from swarm_simulator_tpu_torch.cli.plan import main as plan_main
    from swarm_simulator_tpu_torch.io.mission_json import (swap_mission,
                                                           write_mission)
    from swarm_simulator_tpu_torch.qp import scp

    d = Path(tempfile.mkdtemp(prefix="chip_smoke_scp_"))
    out = {}
    results = []
    orig = scp.plan_scp

    def plan_scp(*a, **k):
        # the CLI prints the cost to 4 decimals: keep the result itself
        results.append(orig(*a, **k))
        return results[-1]

    try:
        write_mission(d / "m.json", swap_mission(8, z=1.0, span=2.0,
                                                 radius=0.2))
        for dtype in ("float32", "float64"):
            buf = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf), mock.patch.object(
                    scp, "plan_scp", plan_scp):
                rc = plan_main(["--preset", "scp", "--mission",
                                str(d / "m.json"), "--alg", "scp",
                                "--noise", str(SCP_NOISE), "--dtype", dtype,
                                "--device", str(dev)])
            secs = time.perf_counter() - t0
            lines = buf.getvalue().strip().splitlines()
            res = results[-1]
            log(f"scp {dtype} ({secs:.3f} s, rc {rc}): " + " | ".join(lines)
                + f"; cost {res.cost!r}, inner iterations "
                f"{[i.iters for i in res.infos]}")
            check(rc == 0, f"scp {dtype}: exit {rc}")
            out[dtype] = dict(s=secs, cost=res.cost, lines=lines)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gap = abs(out["float32"]["cost"] - out["float64"]["cost"]) / abs(
        out["float64"]["cost"])
    log(f"scp cost float32 {out['float32']['cost']} float64 "
        f"{out['float64']['cost']}: relative gap {gap:.3e}")
    check(gap <= SCP_COST_TOL, f"scp: float32 cost {gap:.3e} from float64")
    return out


#: phase 21a: the JAX package's Anderson study arm (tools/schedule_study.py:
#: 33-64 there): the production phases at check_every 50, aa_depth 5
AA_DEPTH = 5
#: phase 21a: the AA chunks held against the float32 twin on the card
AA_CHECK_CHUNKS = 3


def production_result(plan, ctrl, param):
    """A PlanResult of ``plan``'s host problem with the joint solve's
    control points ``ctrl`` (time scale 1), for the gate and the oracle."""
    import copy

    from swarm_simulator_tpu_torch.qp import convert

    out = copy.copy(plan)
    out.ctrl = ctrl
    out.coef = convert.ctrl_to_coef(ctrl, plan.T, param.n)
    return out


def gate_clauses(result, mission, param, dev, label: str,
                 oracle: bool = True) -> dict:
    """The gate's safety, continuity, endpoint, box and dynamics clauses
    (eval/gate.gate_quality without the objective criterion), required,
    and with ``oracle`` the IPM objective margin of batch 0 (obj_b0 /
    obj_ref), printed beside the 1.25 criterion."""
    from swarm_simulator_tpu_torch.eval.gate import gate_quality

    check(bool(np.isfinite(result.ctrl).all()),
          f"{label}: non-finite control points")
    ok, m = gate_quality(result.ctrl, result, mission, param, device=dev)
    margin, note = None, ""
    if oracle:
        oparam = dataclasses.replace(param, **ORACLE_BATCHES)
        obj_b0, obj_ref, ipm_s = oracle_pair(result, mission, oparam, 0)
        margin = obj_b0 / obj_ref
        note = (f"; objective margin on batch 0 {margin:.6f} (the 1.25 "
                f"criterion: {'met' if margin <= 1.25 else 'not met'}; "
                f"oracle {ipm_s:.3f} s)")
    log(f"{label} gate (no objective criterion): " + json.dumps(
        {k: (float(v) if not isinstance(v, bool) else v)
         for k, v in m.items()}) + note)
    check(ok, f"{label}: the gate's clauses failed: {m}")
    return dict(metrics=m, margin=margin)


def anderson_solve(k1, plan, mission, param, dev) -> dict:
    """Phase 21a: the 64-agent forest's host-prep problem (phase 2's)
    through ``solve_ns_phases`` with the production phases at check_every
    50 and aa_depth AA_DEPTH (per phase, Anderson-accelerated chunks
    through K1), beside the production schedule: launches (K1 > 0, no
    twin on CUDA), iterations, seconds, the gate's clauses and both
    objective margins; then the first AA_CHECK_CHUNKS chunks of an AA
    phase through K1 held against the same chunks through the float32
    twin and a float64 twin on the card (ops/nsfused.twin_gap_use)."""
    from unittest import mock

    from swarm_simulator_tpu_torch.ops import nsfused
    from swarm_simulator_tpu_torch.qp import convert, joint
    from swarm_simulator_tpu_torch.qp import nullspace as ns

    data, op = k1["data"], k1["op"]
    prod = joint.production_phases()
    aa = tuple(dataclasses.replace(p, aa_depth=AA_DEPTH) for p in prod)
    op_dev = op.to(dev)
    out = {}
    for label, phases in (("production", prod), ("aa", aa)):
        reset_counts()
        t0 = time.perf_counter()
        x, info = ns.solve_ns_phases(data, phases, op=op_dev, device=dev)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        counts = read_counts()
        ctrl = convert.x_to_ctrl(x.double().cpu().numpy(), plan.M, param.n)
        log(f"21a {label} solve: {solve_s:.3f} s host clock, iters "
            f"{int(info.iters)}, r_prim {float(info.r_prim):.3e}, objective "
            f"{float(info.obj):.6f}; launches K1 {counts['k1']}, twin calls "
            f"on CUDA {sum(counts[t] for t in TWINS)}")
        check(counts["k1"] > 0, f"21a {label}: K1 launched 0 times")
        check(all(counts[t] == 0 for t in TWINS),
              f"21a {label}: a plain twin ran on CUDA ({counts})")
        g = gate_clauses(production_result(plan, ctrl, param), mission,
                         param, dev, f"21a {label}")
        out[label] = dict(counts=counts, solve_s=solve_s,
                          iters=int(info.iters), obj=float(info.obj), **g)
    log(f"21a objective margins: aa_depth {AA_DEPTH} "
        f"{out['aa']['margin']:.6f}, production schedule "
        f"{out['production']['margin']:.6f}")

    # the first chunks of the feasibility phase, the third from an
    # extrapolated state: kernel, float32 twin and float64 twin on the
    # same inputs
    ops64, _ = ns.cold_chunk_inputs(*on_device(data, op, dev,
                                               torch.float64), aa[0])
    errs = {"k32": [], "k64": [], "t64": []}
    max_abs = [0.0]
    kernel = nsfused.nsfused_chunk

    def held(ops, rho_idx, sigma, alpha, w, z, y, n_inner):
        kern = kernel(ops, rho_idx, sigma, alpha, w, z, y, n_inner)
        if len(errs["k32"]) < AA_CHECK_CHUNKS:
            twin = nsfused.nsfused_chunk_reference(
                ops, rho_idx, sigma, alpha, w, z, y, n_inner)
            up = (w.double(), ns.NSConstr(*(t.double() for t in z)),
                  ns.NSConstr(*(t.double() for t in y)))
            twin64 = nsfused.nsfused_chunk_reference(
                ops64, rho_idx, sigma, alpha, *up, n_inner)
            for k, t in zip((kern[0], *kern[1], *kern[2]),
                            (twin[0], *twin[1], *twin[2])):
                max_abs[0] = max(max_abs[0], float((k - t).abs().max()))
            errs["k32"].append(nsfused.state_errors(kern, twin))
            errs["k64"].append(nsfused.state_errors(kern, twin64))
            errs["t64"].append(nsfused.state_errors(twin, twin64))
        return kern

    # the kernel's wrapper counts its launches on the name it is bound to
    held.launches = 0
    first = (dataclasses.replace(aa[0], max_iter=AA_CHECK_CHUNKS
                                 * aa[0].check_every),)
    with mock.patch.object(nsfused, "nsfused_chunk", held):
        ns.solve_ns_phases(data, first, op=op_dev, device=dev)
    check(len(errs["k32"]) == AA_CHECK_CHUNKS,
          f"21a: {len(errs['k32'])} AA chunks checked")
    use = nsfused.twin_gap_use(errs["k64"], errs["t64"])
    log(f"21a first {AA_CHECK_CHUNKS} AA chunks, K1 against the float32 "
        "twin (worst own-scale rel err per part): "
        + " ".join(f"{n} {max(e[i] for e in errs['k32']):.1e}"
                   for i, n in enumerate(nsfused.STATE_PARTS))
        + "; share of K1's tolerance used: "
        + " ".join(f"{n} {v:.2f}" for n, v in use.items())
        + f"; max abs err vs float32 twin {max_abs[0]:.3e}")
    for name, v in use.items():
        check(v <= 1.0, f"21a AA chunks: {name} uses {v:.2f} of K1's "
              "tolerance")
    out["max_abs_err"] = max_abs[0]
    out["use"] = max(use.values())
    return out


#: phase 21b: the 96-agent host-prepped problem (the budget256 study's
#: scatter mission and empty 20 m world at 96 agents)
ROUTE_AGENTS = 96


def kkt_route(plan64, dev) -> dict:
    """Phase 21b: joint.select_kkt_path's decision and ops/nsfused.fits at
    64 agents (phase 2's problem), 96 (the scatter problem of
    ROUTE_AGENTS) and 256 (phase 12's scatter shapes alone: its host prep
    takes minutes), on this card; then the 96-agent host-prepped problem
    solved with the production phases through K1 (where it fits) and
    through the K2 route (thomas_kernel=True, each w-update one K2 solve
    at kkt_refine 0): seconds, iterations and launches of each, the gate's
    clauses required (the 96-agent oracle takes 13-16 s a solve, so no
    margin here); K1 (rungs 0 and 4) and K2 held against their twins at
    the 96-agent shapes and timed."""
    from swarm_simulator_tpu_torch.corridor.times import build_corridors
    from swarm_simulator_tpu_torch.ops import nsfused
    from swarm_simulator_tpu_torch.qp import convert, joint
    from swarm_simulator_tpu_torch.qp import nullspace as ns
    from swarm_simulator_tpu_torch.search.planner import \
        plan_initial_trajectories
    from swarm_simulator_tpu_torch.tools import budget256_study as bud
    from swarm_simulator_tpu_torch.world.esdf import ESDF

    t0 = time.perf_counter()
    mission, param, world = bud.scatter_config(ROUTE_AGENTS)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param, dev)
    phases = joint.production_phases()
    data, _ = joint.assemble_joint(plan, mission, param)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = ns.prepare_ns_np(data, phases[0])
    prep_s = time.perf_counter() - t0
    log(f"21b problem: scatter_mission({ROUTE_AGENTS}, half=9.5, z=1.0, "
        f"seed=7) in the empty 20 m world (tools/budget256_study."
        f"scatter_config({ROUTE_AGENTS})): M={plan.M}, pairs "
        f"{len(plan.pair_idx)}, pivots {tuple(op.Dinvs.shape)}; host build "
        f"{host_s:.3f} s, host f64 prep {prep_s:.3f} s")
    limits = nsfused.card_limits(dev)
    shapes = {len(plan64.init_traj): (plan64.M, len(plan64.pair_idx)),
              ROUTE_AGENTS: (plan.M, len(plan.pair_idx)),
              256: (72, 256 * 255 // 2)}
    decisions = {}
    for n_ag, (M, P) in shapes.items():
        routed = joint.select_kkt_path(phases, n_ag, M, P, param.phi, dev)
        decisions[n_ag] = "K2" if routed[0].thomas_kernel else "K1"
        log(f"21b select_kkt_path at {n_ag} agents (M={M}, {P} pairs): "
            f"{decisions[n_ag]}; nsfused.fits "
            f"{nsfused.fits(n_ag, M, P, dev)} "
            f"{nsfused.unfit_reasons(n_ag, M, P, limits)} on {limits}")
    op_dev = op.to(dev)
    routes = {"K1": phases,
              "K2": tuple(dataclasses.replace(p, thomas_kernel=True)
                          for p in phases)}
    out = dict(decisions=decisions)
    for name, ph in routes.items():
        if name == "K1" and decisions[ROUTE_AGENTS] != "K1":
            continue
        reset_counts()
        t0 = time.perf_counter()
        x, info = ns.solve_ns_phases(data, ph, op=op_dev, device=dev)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        counts = read_counts()
        log(f"21b {ROUTE_AGENTS} agents through the {name} route: "
            f"{solve_s:.3f} s host clock, iters "
            f"{int(info.iters)}, r_prim {float(info.r_prim):.3e}, "
            f"objective {float(info.obj):.6f}; launches K1 "
            f"{counts['k1']} K2 {counts['k2']}, twin calls on CUDA "
            f"{sum(counts[t] for t in TWINS)}")
        check(counts["k1" if name == "K1" else "k2"] > 0
              and counts["k2" if name == "K1" else "k1"] == 0,
              f"21b {name} route: launches {counts}")
        check(all(counts[t] == 0 for t in TWINS),
              f"21b {name} route: a plain twin ran on CUDA ({counts})")
        ctrl = convert.x_to_ctrl(x.double().cpu().numpy(), plan.M, param.n)
        g = gate_clauses(production_result(plan, ctrl, param), mission,
                         param, dev, f"21b {name} route", oracle=False)
        out[name] = dict(counts=counts, solve_s=solve_s,
                         iters=int(info.iters), obj=float(info.obj), **g)
    out["k1"] = chunk_vs_twins(data, op, phases[0], dev,
                               f"21b K1 at {ROUTE_AGENTS} agents: ",
                               rungs=(0, op.Dinvs.shape[0] - 1))
    out["k2"] = thomas_vs_twin(op, dev, f"{ROUTE_AGENTS}-agent host-prep",
                               reps=(10, 1))
    return out


def device_edt(world64, dev) -> dict:
    """Phase 21c: world/esdf.esdf_from_occupancy on the card for the
    64-agent forest's occupancy and for the 256-agent 20 m world
    (tools/monte_carlo.py's 256x16 scenario 0: scatter_mission(256, seed
    0), 40 obstacles, forest seed 100), each bit-equal to the torch form
    on the CPU and within tests/test_esdf.py's 1e-4 of the native EDT;
    ESDF(backend="device") on the card against the native ESDF; the
    seconds of each form."""
    from swarm_simulator_tpu_torch.io.mission_json import scatter_mission
    from swarm_simulator_tpu_torch.search.native_binding import esdf_native
    from swarm_simulator_tpu_torch.tools import budget256_study as bud
    from swarm_simulator_tpu_torch.tools._timing import median_ms
    from swarm_simulator_tpu_torch.world.esdf import ESDF, esdf_from_occupancy
    from swarm_simulator_tpu_torch.world.forest import generate_forest

    _, param256, _ = bud.scatter_config(256)
    world256 = generate_forest(
        scatter_mission(256, half=9.5, z=1.0, seed=0),
        world_min=param256.world_min, world_max=param256.world_max,
        resolution=param256.world_resolution, obs_num=40, r_min=0.3,
        r_max=0.3, h_min=0.0, h_max=2.5, margin=0.5, seed=100)
    out = {}
    for label, world in (("64-agent forest", world64),
                         ("256-agent 20 m world", world256)):
        occ_cpu = torch.as_tensor(np.ascontiguousarray(world.occ))
        occ = occ_cpu.to(dev)
        card = esdf_from_occupancy(occ, res=world.res, max_dist=1.0)
        ms = median_ms(lambda: esdf_from_occupancy(occ, res=world.res,
                                                   max_dist=1.0), 5)
        t0 = time.perf_counter()
        cpu = esdf_from_occupancy(occ_cpu, res=world.res, max_dist=1.0)
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nat = esdf_native(world.occ, world.res, 1.0)
        nat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dev_esdf = ESDF(world, 1.0, backend="device", device=dev)
        esdf_s = time.perf_counter() - t0
        got = card.cpu().numpy()
        ulps = int(np.abs(got.view(np.int32).astype(np.int64)
                          - cpu.numpy().view(np.int32)).max())
        gap = float(np.abs(got - nat).max())
        log(f"21c device EDT, {label} {tuple(world.occ.shape)} "
            f"({int(world.occ.sum())} occupied): card {ms:.3f} ms (CUDA "
            f"events), torch on the CPU {1e3 * cpu_s:.1f} ms, native "
            f"{1e3 * nat_s:.1f} ms, ESDF(backend='device') with the copies "
            f"{1e3 * esdf_s:.1f} ms; card vs CPU form: largest ulp "
            f"difference {ulps}; vs native: {gap:.2e} (limit 1e-4)")
        check(ulps == 0, f"21c {label}: the card's EDT differs from the "
              f"CPU form by {ulps} ulps")
        check(gap <= 1e-4 and float(np.abs(dev_esdf.dist - nat).max())
              <= 1e-4, f"21c {label}: device EDT {gap:.2e} from native")
        out[label] = dict(ms=ms, cpu_s=cpu_s, native_s=nat_s)
    return out


def rsfc_forms(init_traj, downwash: float, dev) -> dict:
    """Phase 21d: the RSFC planes of the 256-agent scatter plan's initial
    trajectories (2.3 M pair-segments) through the numpy chain, the torch
    form on the CPU and the torch form on the card (the result copied
    back), each timed on the host clock (the card's after a warm-up, the
    median of 3; the host forms once), held to each other at 1e-12, and
    the form build_rsfc takes on the card."""
    from swarm_simulator_tpu_torch.corridor import rsfc

    N, K = init_traj.shape[:2]
    iu, ju = np.triu_indices(N, k=1)
    pairs = np.stack([iu, ju], axis=1).astype(np.int32)
    traj = np.asarray(init_traj, np.float64)

    def torch_form(d):
        n, m = rsfc.pair_separating_planes(
            torch.as_tensor(traj, device=d), torch.as_tensor(pairs, device=d),
            downwash=float(downwash))
        return n.cpu().numpy(), m.cpu().numpy()

    times, res = {}, {}
    for name, fn, reps in (("numpy", lambda: rsfc._pair_planes_numpy(
            traj, pairs, float(downwash)), 1),
                           ("torch cpu", lambda: torch_form("cpu"), 1),
                           ("torch card", lambda: torch_form(dev), 3)):
        if reps > 1:
            fn()
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res[name] = fn()
            runs.append(time.perf_counter() - t0)
        times[name] = float(np.median(runs))
    gaps = {name: max(float(np.abs(res[name][0] - res["numpy"][0]).max()),
                      float(np.abs(res[name][1] - res["numpy"][1]).max()))
            for name in ("torch cpu", "torch card")}
    calls = []
    form = rsfc.pair_separating_planes
    rsfc.pair_separating_planes = lambda *a, **k: (
        calls.append(a[0].device.type) or form(*a, **k))
    try:
        rsfc.build_rsfc(traj, downwash, dev)
    finally:
        rsfc.pair_separating_planes = form
    log(f"21d RSFC planes, {N} agents, {len(pairs) * (K - 1)} "
        f"pair-segments, host clock: numpy chain "
        f"{times['numpy']:.4f} s, torch form on the CPU "
        f"{times['torch cpu']:.4f} s, on the card with the copies "
        f"{times['torch card']:.4f} s (median of 3); largest difference "
        f"from the numpy "
        f"chain: " + ", ".join(f"{k} {v:.1e}" for k, v in gaps.items())
        + f" (limit 1e-12); build_rsfc on the card ran the torch form on "
        f"{calls}")
    check(max(gaps.values()) <= 1e-12, f"21d RSFC forms disagree: {gaps}")
    check(calls == ["cuda"], f"21d build_rsfc took {calls}")
    return dict(times=times, gaps=gaps)


#: phase 22: copies of the 64-agent forest's 16 groups on a 1 x 1 grid
GRID_SCENARIOS = 4


def scenario_grid(dev) -> dict:
    """Phase 22: tools/dryrun_multichip's part 2 on one NCCL rank: the
    (scenario, batch) Jacobi sweep (mesh.grid_sweep: ADMM, cg, two rounds
    of (50, 25) iterations carrying the state) of GRID_SCENARIOS copies of
    the 64-agent forest's 16 groups of 4 on a 1 x 1 grid, its control
    points held bit for bit to mesh.stacked_sweep of the same stack in
    this process."""
    from swarm_simulator_tpu_torch.parallel import distributed as pd
    from swarm_simulator_tpu_torch.parallel import mesh, seqbatch
    from swarm_simulator_tpu_torch.qp import assemble
    from swarm_simulator_tpu_torch.tools import dryrun_multichip as dry

    kw = dict(iters_schedule=dry.SWEEP_ITERS, carry_state=True)
    reset_counts()
    t0 = time.perf_counter()
    got, shape, iters, sweep_s = pd.run_ranks(
        dry.sweep_rank, 1, dry.forest_share, (SEED,), GRID_SCENARIOS,
        dry.sweep_settings(), dry.SWEEP_ROUNDS, kw, (1, 1),
        backend="nccl" if dev.type == "cuda" else "gloo")
    call_s = time.perf_counter() - t0
    counts = read_counts()
    plan, mission, param, batches, pad, dummy = dry.forest_groups(SEED)
    groups = seqbatch._stack_qpdata([
        assemble.assemble_batch(plan, mission, param, b, dummy, pad)
        for b in batches])
    stacked, scen, dm = dry.copies(groups, dummy, GRID_SCENARIOS)
    t0 = time.perf_counter()
    want, _ = mesh.stacked_sweep(stacked.to(dev), scen.to(dev), dm.to(dev),
                                 dry.sweep_settings(), dry.SWEEP_ROUNDS,
                                 **kw)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    want = want.double().cpu().numpy()
    log(f"22 (scenario, batch) grid {shape} on one NCCL rank: "
        f"{GRID_SCENARIOS} copies x {len(batches)} groups of 4, ctrl "
        f"{list(got.shape)}, iters {iters}, sweep {sweep_s:.3f} s "
        f"({call_s:.3f} s with the group and the host build); "
        f"stacked_sweep of the same stack {one_s:.3f} s; bit-equal "
        f"{np.array_equal(got, want)}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    check(shape == (1, 1), f"22: grid {shape}")
    check(np.array_equal(got, want), "22: the grid sweep differs from "
          f"stacked_sweep by {float(np.abs(got - want).max()):.3e}")
    return dict(sweep_s=sweep_s, one_s=one_s)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on the "
              "card", file=sys.stderr)
        return 2
    import swarm_simulator_tpu_torch as port
    from swarm_simulator_tpu_torch.ops import _build
    from swarm_simulator_tpu_torch.qp import joint, nullspace as ns

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"host BLAS threads: {blas_threads()}")

    t0 = time.perf_counter()
    built = _build.build("nsfused", "nsfused_stack", "thomas",
                         "thomas_stream", "thomas_prim", "thomas_probe",
                         "nsfused_probe", "row_patterns", verbose=True)
    log(f"kernel builds (parallel): {time.perf_counter() - t0:.2f} s")
    for name, (path, build_s, ptxas) in built.items():
        log(f"  {name}: {build_s:.2f} s -> {path.name}")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log("    " + line.strip())

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
    reset_counts()
    t0 = time.perf_counter()
    result, times = port.plan(mission, param, world, device=dev)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = read_counts()
    launches, twin_cuda = counts["k1"], counts["twin1"]
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
    gate(result, mission, param, dev, "cold")
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

    # ---- phase 5: K2 against its twins, host- and device-prep pivots ----
    k2 = thomas_vs_twin(k1["op"], dev, "host-prep")
    t0 = time.perf_counter()
    op_dev = ns.prepare_ns(k1["data"].to(dev),
                           joint.production_phases(kkt_refine=1)[0])
    torch.cuda.synchronize()
    log(f"device prep (float32, 5 rungs batched): "
        f"{time.perf_counter() - t0:.3f} s")
    k2_dev = thomas_vs_twin(op_dev, dev, "device-prep")
    pair_rows_vs_einsum(k1["data"].to(dev), op_dev,
                        joint.production_phases(kkt_refine=1)[0], "64 agents")

    # ---- phases 6 and 7: the replan slice, then its solve alone ----
    rp = replan_paths(mission, param, world, dev)
    refine_solve_alone(plan0, mission, param, result.ctrl, dev)

    # ---- phases 8 and 9: the chunked sweeps, then the sharded solve ----
    k3 = chunk_sweeps_vs_twins(k1["op"], dev)
    sh = sharded_solve(k1["data"], k1["op"], plan0, mission, param, dev)

    # ---- phases 10 and 11: K2 on bf16 pivots, then the bf16 solve ----
    k2_16 = thomas_vs_twin(op_dev, dev, "device-prep bf16", torch.bfloat16)
    log(f"K2 median ms per solve at 64 agents: float32 pivots "
        f"{k2_dev['ms']:.4f}, bf16 pivots {k2_16['ms']:.4f}, bf16 twin "
        f"{k2_16['plain_ms']:.3f}")
    b16 = bf16_refine_solve(k1["data"], op_dev, plan0, mission, param, dev)
    del op_dev

    # ---- phases 12 and 13: the 256-agent route, then the stream study ----
    bigp = big_swarm_plan(dev)
    big = budget_arms(dev)
    t4 = stream_study(dev)

    # ---- phases 14-17: the probes T2, T3, T1, T5 ----
    t2 = prim_bench(dev)
    t3 = probe_stages(dev)
    t1 = nsfused_probes(dev, k1["ms"])
    t5 = row_pattern_probes(dev)

    # ---- phase 18: the sequential-batch ADMM path ----
    seqbatch_runs(dev, smi)

    # ---- phase 19: the oracle gate on seeds 0-4, the exact polish ----
    og = oracle_gates(port, (result, times), dev)

    # ---- phase 20: the scenario axis, the per-phase solve, SCP ----
    t20 = time.perf_counter()
    monte_carlo(dev)
    jac = jacobi_knot_state(plan0, mission, param, dev)
    per_phase_joint(port, og, dev)
    sweep_cli(dev)
    scp_cli(dev)
    log(f"phase 20: {time.perf_counter() - t20:.1f} s")

    # ---- phase 21: AA, the KKT route, the device EDT, the RSFC forms ----
    t21 = time.perf_counter()
    aa = anderson_solve(k1, plan0, mission, param, dev)
    route = kkt_route(plan0, dev)
    device_edt(world, dev)
    rsfc_forms(bigp["result"].init_traj, bigp["downwash"], dev)
    log(f"phase 21: {time.perf_counter() - t21:.1f} s")

    # ---- phase 22: the scenario axis on a 1 x 1 grid of NCCL ranks ----
    t22 = time.perf_counter()
    scenario_grid(dev)
    log(f"phase 22: {time.perf_counter() - t22:.1f} s")

    def entry(name, source, replaces, launches, max_abs_err, ms, plain_ms,
              bnd, library_ms=None):
        # no single PyTorch call computes a Thomas solve or sweep from
        # stored pivot inverses, a fused ADMM chunk, a chain-primitive
        # recurrence, P4's sweeps or T5's fourteen patterns together, so
        # those have no library time (phase 17 times each pattern's own);
        # T4's function is one torch.sum, T3's mv stage and T1's P2 one
        # torch.einsum, P1 one torch.add on views, P3 one torch.matmul,
        # P4's re-layout one copy of the permuted rung (its plain version)
        return {"name": name, "route": "cuda",
                "source": "swarm_simulator_tpu_torch/csrc/" + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    # the sharded solve's path runs one rank: the chunk sweeps at n = 1
    k3_1 = k3[1]
    k3_err = max(k3[1]["max_abs_err"], k3[4]["max_abs_err"])
    print(json.dumps({"kernels": [
        entry("nsfused_chunk", "nsfused.cu",
              "swarm_simulator_tpu/ops/pallas_nsfused.py:506", launches,
              k1["max_abs_err"], k1["ms"], k1["plain_ms"], k1["bound"]),
        entry("nsfused_stack", "nsfused_stack.cu",
              "swarm_simulator_tpu/ops/pallas_nsfused.py:506",
              jac["banded", "float32"]["counts"]["kstack"],
              jac["stack"]["max_abs_err"], jac["stack"]["ms"],
              jac["stack"]["plain_ms"], jac["stack"]["bound"]),
        entry("nsfused_chunk_aa", "nsfused.cu",
              "swarm_simulator_tpu/ops/pallas_nsfused.py:506",
              aa["aa"]["counts"]["k1"], aa["max_abs_err"], k1["ms"],
              k1["plain_ms"], k1["bound"]),
        entry(f"nsfused_chunk_{ROUTE_AGENTS}", "nsfused.cu",
              "swarm_simulator_tpu/ops/pallas_nsfused.py:506",
              route.get("K1", {}).get("counts", {}).get("k1", 0),
              route["k1"]["max_abs_err"], route["k1"]["ms"],
              route["k1"]["plain_ms"], route["k1"]["bound"]),
        entry(f"thomas_solve_{ROUTE_AGENTS}_route", "thomas.cu",
              "swarm_simulator_tpu/ops/pallas_thomas.py:359",
              route["K2"]["counts"]["k2"], route["k2"]["max_abs_err"],
              route["k2"]["ms"], route["k2"]["plain_ms"],
              route["k2"]["bound"]),
        entry("thomas_solve_replan256", "thomas.cu",
              "swarm_simulator_tpu/ops/pallas_thomas.py:359",
              bigp["round_k2"], big["k2"]["float32"]["max_abs_err"],
              big["k2"]["float32"]["ms"], big["k2"]["float32"]["plain_ms"],
              big["k2"]["float32"]["bound"]),
        entry("thomas_solve", "thomas.cu",
              "swarm_simulator_tpu/ops/pallas_thomas.py:359",
              rp["replan"]["counts"]["k2"],
              max(k2["max_abs_err"], k2_dev["max_abs_err"],
                  big["k2"]["float32"]["max_abs_err"]), k2["ms"],
              k2["plain_ms"], k2["bound"]),
        entry("thomas_chunk_fwd", "thomas.cu",
              "swarm_simulator_tpu/ops/pallas_thomas.py:291",
              sh["counts"]["k3a"], k3_err, k3_1["fwd"], k3_1["fwd_twin"],
              k3_1["bound"]),
        entry("thomas_chunk_bwd", "thomas.cu",
              "swarm_simulator_tpu/ops/pallas_thomas.py:326",
              sh["counts"]["k3b"], k3_err, k3_1["bwd"], k3_1["bwd_twin"],
              k3_1["bound"]),
        entry("thomas_solve_bf16", "thomas.cu",
              "swarm_simulator_tpu/ops/pallas_thomas.py:359",
              b16["counts"]["k2bf16"],
              max(k2_16["max_abs_err"], big["k2"]["bf16"]["max_abs_err"]),
              k2_16["ms"], k2_16["plain_ms"], k2_16["bound"]),
        entry("thomas_stream", "thomas_stream.cu",
              "tools/thomas_bw_study.py:103", t4["counts"]["t4"],
              t4["max_abs_err"], t4["ms"], t4["plain_ms"], t4["bound"],
              t4["library_ms"]),
        entry("thomas_prim", "thomas_prim.cu",
              "tools/pallas_debug/thomas_prim_bench.py:188",
              t2["counts"]["t2"], t2["max_abs_err"], t2["ms"],
              t2["plain_ms"], t2["bound"]),
        entry("thomas_probe", "thomas_probe.cu",
              "tools/pallas_debug/thomas_probe.py:83", t3["counts"]["t3"],
              t3["max_abs_err"], t3["ms"], t3["plain_ms"], t3["bound"],
              t3["library_ms"]),
        *(entry(f"nsfused_probe_p{p}", "nsfused_probe.cu",
                f"tools/pallas_debug/nsfused_probe.py:{line}",
                t1[p]["launches"], t1[p]["max_abs_err"], t1[p]["ms"],
                t1[p]["plain_ms"], t1[p]["bound"], t1[p]["library_ms"])
          for p, line in ((1, 67), (2, 106), (3, 156), (4, 231))),
        entry("nsfused_probe_p4_relayout", "nsfused_probe.cu",
              "tools/pallas_debug/nsfused_probe.py:231",
              t1["4r"]["launches"], t1["4r"]["max_abs_err"], t1["4r"]["ms"],
              t1["4r"]["plain_ms"], t1["4r"]["bound"],
              t1["4r"]["library_ms"]),
        entry("row_pattern", "row_patterns.cu",
              "tools/pallas_debug/mosaic_patterns.py:21",
              t5["counts"]["t5"], t5["max_abs_err"], t5["ms"],
              t5["plain_ms"], t5["bound"])]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
