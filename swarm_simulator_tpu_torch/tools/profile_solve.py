"""Profile the phased solve of the 64-agent forest on one CUDA card.

    python3 -m swarm_simulator_tpu_torch.tools.profile_solve [--seed 0]
        [--refine | --sharded | --scatter AGENTS | --seqbatch MODE]

Run from the repository root (it takes the problem from chip_smoke.py).
Builds the problem and its rung inventory once, runs the production
phased solve once to warm up, once more unprofiled, then once under
torch.profiler, and prints: the solves' wall times (host clock, ending in
a device sync), the device time the profiler saw, the device-busy share
(device time / wall time of the profiled run and of the unprofiled
second run; one stream, so kernels do not overlap), the shares of the
device time of the fused chunk kernel (K1), the Thomas solve kernel
(K2), the chunked sweeps K3a and K3b and the rest (torch operations and
copies), the device spans of the NCCL collectives, the host time per
iteration (wall time over iterations), the device entries (kernels and
copies) per iteration, and the tables of the costliest device and host
entries.

Without an option: the cold solve (host-f64 prep, kkt_refine=0, one K1
launch per chunk).  With ``--refine``: the refine path of replans and
device-prep cold plans (device prep, kkt_refine=1, three K2 launches and
the PCG's torch operations per iteration).  With ``--sharded``: the
sharded joint solve (qp/nullspace_shard, chunk mode, host-f64 prep) on a
1-rank NCCL group, one K3a and one K3b launch per iteration.  With
``--scatter AGENTS``: the refine solve of the big-swarm route instead,
on the scatter problem of tools/budget256_study.py (device prep, float32
pivots): first the median CUDA-event time of one refine iteration and of
its parts (the PCG w-update, one inventory solve through K2, A x and
A^T y of the constraint rows), printed as they are measured, then the
profile of a 150-iteration schedule, budgets (50, 50, 50).  With
``--seqbatch MODE``: the sequential-batch ADMM solve
(parallel/seqbatch.solve_trajectories, ``Param.solver="admm"``) of the
64-agent forest in one of chip_smoke.py's SEQ_RUNS modes (gauss-seidel,
jacobi, default) in float32, each batch solve capped at 200 iterations;
its iterations are those run one after another (a Jacobi round's stacked
batches count once, at the most any of them ran).
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--refine", action="store_true",
                      help="profile the device-prep kkt_refine=1 solve")
    mode.add_argument("--sharded", action="store_true",
                      help="profile the sharded chunk-mode solve on a "
                           "1-rank NCCL group")
    mode.add_argument("--scatter", type=int, metavar="AGENTS",
                      help="profile the refine solve of the AGENTS-agent "
                           "scatter problem (tools/budget256_study.py)")
    mode.add_argument("--seqbatch",
                      choices=["gauss-seidel", "jacobi", "default"],
                      help="profile the sequential-batch ADMM solve in "
                           "this mode of chip_smoke.SEQ_RUNS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_solve: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from swarm_simulator_tpu_torch.qp import joint, nullspace as ns

    dev = torch.device("cuda", 0)
    if args.scatter:
        from swarm_simulator_tpu_torch.tools import budget256_study as bud

        _, _, _, data = bud.build_problem(args.scatter)
        base = bud.base_settings(1, False)
        d = data.to(dev)
        o = bud.prepare(d, base)
        refine_parts(d, o, base)
        sched = ns.schedule_arrays(bud.phases(base, (50, 50, 50)))
        return profile_run(lambda: timed_solve(d, o, sched))
    plan, mission, param, _ = chip_smoke.build_problem(args.seed)
    if args.seqbatch:
        return profile_run(lambda: seq_solve(plan, mission, args.seqbatch))
    phases = joint.production_phases(kkt_refine=int(args.refine))
    s0, it_k, lo_k, hi_k = ns.schedule_arrays(phases)
    data, _ = joint.assemble_joint(plan, mission, param)
    if args.sharded:
        from swarm_simulator_tpu_torch.parallel import distributed as pd
        from swarm_simulator_tpu_torch.qp import nullspace_shard as shard

        op = ns.prepare_ns_np(data, phases[0])

        def run_sharded():
            d, o = shard.place(data, op)

            def solve():
                t0 = time.perf_counter()
                _, info = shard.solve_ns_phases_sharded(d, phases, o)
                torch.cuda.synchronize()
                return time.perf_counter() - t0, int(info.iters)

            return profile_run(solve)

        return pd.run_ranks(run_sharded, 1, backend="nccl")
    d = data.to(dev)
    o = (ns.prepare_ns(d, phases[0]) if args.refine
         else ns.prepare_ns_np(data, phases[0]).to(dev))
    return profile_run(lambda: timed_solve(d, o, (s0, it_k, lo_k, hi_k)))


def refine_parts(d, o, s, rho_idx: int = 2, reps: int = 10) -> None:
    """Median CUDA-event ms of one refine iteration (admm_steps with one
    inner step) and of its parts, from the cold state at rung ``rho_idx``;
    each line is printed as soon as it is measured."""
    import numpy as np

    from swarm_simulator_tpu_torch.qp import nullspace as ns

    pop, l, u, (w, z, y) = ns._cold_state(d, o, s)
    cop = ns.constr_op(pop)
    B, K3, _ = d.lb.shape
    kinv = ns.make_kinv_apply(o, B, K3, o.F0.shape[0], o.F0.shape[1])
    w_update = ns.pcg_w_update(d, o, cop, s, kinv, rho_idx)
    rho = o.ladder[rho_idx]
    x = ns._x_of(o, w)
    parts = {
        "refine iteration": lambda: ns.admm_steps(
            o, cop, l, u, rho_idx, s.sigma, s.alpha, w, z, y, 1, w_update),
        "PCG w-update": lambda: w_update(w, rho),
        "inventory solve (K2)": lambda: kinv(rho_idx, w),
        "A x": lambda: cop.A_x(x),
        "A^T y": lambda: cop.AT_x(z),
    }
    for name, fn in parts.items():
        fn()
        ms = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        print(f"{name}: {float(np.median(ms)):.3f} ms (median of {reps})",
              flush=True)


def timed_solve(d, o, sched):
    """One phased solve: (host seconds ending in a device sync,
    iterations)."""
    from swarm_simulator_tpu_torch.qp import nullspace as ns

    t0 = time.perf_counter()
    _, info = ns.solve_ns_schedule(d, o, *sched)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, int(info.iters)


def seq_solve(plan, mission, mode: str, max_iter: int = 200):
    """One sequential-batch solve of ``plan`` in chip_smoke.SEQ_RUNS's
    ``mode`` (float32, each batch solve capped at ``max_iter``): (host
    seconds ending in a device sync, iterations run one after another)."""
    import chip_smoke
    from swarm_simulator_tpu_torch import Param
    from swarm_simulator_tpu_torch.parallel import seqbatch

    param = Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                  solver_dtype="float32", **chip_smoke.SEQ_RUNS[mode])
    settings = dataclasses.replace(
        seqbatch.default_settings(plan, mission, param), max_iter=max_iter)
    t0 = time.perf_counter()
    result = seqbatch.solve_trajectories(copy.deepcopy(plan), mission,
                                         param, settings, device="cuda")
    torch.cuda.synchronize()
    iters = result.solver_info["iters"]
    if mode == "jacobi":
        per_round = len(iters) // param.iteration
        iters = [max(iters[i:i + per_round])
                 for i in range(0, len(iters), per_round)]
    return time.perf_counter() - t0, sum(iters)


def profile_run(solve) -> int:
    """Run ``solve() -> (seconds, iterations)`` once to warm up (first-use
    costs in), once unprofiled and once under torch.profiler; print the
    readings."""
    first_s, _ = solve()
    warm_s, iters = solve()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_s, iters_p = solve()
    avg = prof.key_averages()
    # device-side entries only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched
    on_dev = [e for e in avg if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    dev_us = sum(e.self_device_time_total for e in on_dev)
    dev_n = sum(e.count for e in on_dev)
    k1_us = sum(e.self_device_time_total for e in on_dev
                if "nsfused" in e.key)
    k2_us = sum(e.self_device_time_total for e in on_dev
                if "thomas_kernel" in e.key)
    # K3a/K3b: one template, chunk_kernel<back, early loads>, since the
    # sweeps share the chain ring; chunk_fwd_kernel/chunk_bwd_kernel before
    k3a_us = sum(e.self_device_time_total for e in on_dev
                 if "chunk_kernel<false" in e.key
                 or "chunk_fwd_kernel" in e.key)
    k3b_us = sum(e.self_device_time_total for e in on_dev
                 if "chunk_kernel<true" in e.key
                 or "chunk_bwd_kernel" in e.key)
    # a collective shows as the device span of its "nccl:" annotation (a
    # copy on one rank, and any wait for the peers), not as a kernel
    nccl_us = sum(e.self_device_time_total for e in avg
                  if e.key.startswith("nccl:"))
    print(f"solve: first {first_s:.3f} s, unprofiled {warm_s:.3f} s "
          f"({iters} iters), profiled "
          f"{wall_s:.3f} s ({iters_p} iters); host time per iteration "
          f"{1e3 * warm_s / max(iters, 1):.3f} ms unprofiled, "
          f"{1e3 * wall_s / max(iters_p, 1):.3f} ms profiled")
    if dev_us <= 0:
        print("profile_solve: the profiler saw no device time",
              file=sys.stderr)
        return 1
    # the profiler slows the host side (each launch is recorded), so the
    # busy share against the unprofiled warm-up run is printed too
    print(f"device time {dev_us / 1e3:.1f} ms, device busy "
          f"{100 * dev_us / 1e6 / wall_s:.1f}% of the profiled wall time, "
          f"{100 * dev_us / 1e6 / warm_s:.1f}% of the unprofiled one; "
          + ", ".join(f"{name} {us / 1e3:.1f} ms = {100 * us / dev_us:.1f}%"
                      for name, us in (
                          ("K1", k1_us), ("K2", k2_us), ("K3a", k3a_us),
                          ("K3b", k3b_us),
                          ("the rest (torch ops, copies)",
                           dev_us - k1_us - k2_us - k3a_us - k3b_us)))
          + f" of the device time; the NCCL collectives' device spans "
          f"{nccl_us / 1e3:.1f} ms = {100 * nccl_us / dev_us:.1f}%; "
          f"{dev_n / max(iters_p, 1):.1f} device entries per iteration")
    print(avg.table(sort_by="self_device_time_total", row_limit=12))
    # a solve whose card idles is bound by the host: what it spends there
    print(avg.table(sort_by="self_cpu_time_total", row_limit=15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
