"""Profile the phased solve of the 64-agent forest on one CUDA card.

    python3 -m swarm_simulator_tpu_torch.tools.profile_solve [--seed 0]
        [--refine | --sharded]

Run from the repository root (it takes the problem from chip_smoke.py).
Builds the problem and its rung inventory once, runs the production
phased solve once to warm up, then once under torch.profiler, and prints:
the solve's wall time (host clock, ending in a device sync), the device
time the profiler saw, the device-busy share (device time / wall time of
the profiled run and of the unprofiled warm-up run; one stream, so
kernels do not overlap), the shares of the device time of
the fused chunk kernel (K1), the Thomas solve kernel (K2) and the chunked
sweeps (K3a/K3b), and the table of the costliest device entries.

Without an option: the cold solve (host-f64 prep, kkt_refine=0, one K1
launch per chunk).  With ``--refine``: the refine path of replans and
device-prep cold plans (device prep, kkt_refine=1, three K2 launches and
the PCG's torch operations per iteration).  With ``--sharded``: the
sharded joint solve (qp/nullspace_shard, chunk mode, host-f64 prep) on a
1-rank NCCL group, one K3a and one K3b launch per iteration.
"""
from __future__ import annotations

import argparse
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_solve: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from swarm_simulator_tpu_torch.qp import joint, nullspace as ns

    dev = torch.device("cuda", 0)
    plan, mission, param, _ = chip_smoke.build_problem(args.seed)
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

    def solve():
        t0 = time.perf_counter()
        _, info = ns.solve_ns_schedule(d, o, s0, it_k, lo_k, hi_k)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, int(info.iters)

    return profile_run(solve)


def profile_run(solve) -> int:
    """Run ``solve() -> (seconds, iterations)`` once to warm up and once
    under torch.profiler; print the readings."""
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
    k1_us = sum(e.self_device_time_total for e in on_dev
                if "nsfused" in e.key)
    k2_us = sum(e.self_device_time_total for e in on_dev
                if "thomas_kernel" in e.key)
    k3_us = sum(e.self_device_time_total for e in on_dev
                if "chunk_fwd_kernel" in e.key or "chunk_bwd_kernel" in e.key)
    print(f"solve: warm-up {warm_s:.3f} s ({iters} iters), profiled "
          f"{wall_s:.3f} s ({iters_p} iters)")
    if dev_us <= 0:
        print("profile_solve: the profiler saw no device time",
              file=sys.stderr)
        return 1
    # the profiler slows the host side (each launch is recorded), so the
    # busy share against the unprofiled warm-up run is printed too
    print(f"device time {dev_us / 1e3:.1f} ms, device busy "
          f"{100 * dev_us / 1e6 / wall_s:.1f}% of the profiled wall time, "
          f"{100 * dev_us / 1e6 / warm_s:.1f}% of the unprofiled one; "
          f"K1 {k1_us / 1e3:.1f} ms = {100 * k1_us / dev_us:.1f}%, K2 "
          f"{k2_us / 1e3:.1f} ms = {100 * k2_us / dev_us:.1f}%, K3a+K3b "
          f"{k3_us / 1e3:.1f} ms = {100 * k3_us / dev_us:.1f}% of the "
          "device time")
    print(avg.table(sort_by="self_device_time_total", row_limit=12))
    # a solve whose card idles is bound by the host: what it spends there
    print(avg.table(sort_by="self_cpu_time_total", row_limit=15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
