"""The readings that the limits of ``correct`` are set from.

    python3 -m swarmbench.calibrate --workload <cell> --seeds 1,2,3
        [--control bfloat16,nobox,nopair] [--control-seeds 1,2,3]

In one process (one set-up): the traffic's whole pool planned by the
program once, a block a batch, as a run's window plans it, and every map
judged by what its plan states; then for each seed the sample a run of
that seed works out again (swarmbench/reference/check.py), and for each
control seed the same sample with each control's plan in the program's
place.  One JSON line a batch and a seed, then each number's largest
program reading and, for each control, its least.  Needs the card.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from .manifest import Manifest  # noqa: E402
from .run import pin_env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    man = Manifest()
    cell = man.cell(args.workload)
    cfg = man.config(cell["config"])
    pin_env(cfg)
    import torch

    from . import program, traffic
    from .reference import check

    dev = torch.device("cuda:0")
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    mix = man.traffic(cell["traffic"])
    n = mix["maps_per_batch"]
    ref_dev = dev if cfg.get("reference_device") == "card" else "cpu"
    prog = program.Program(cfg, dev)
    lows, highs, kept, unplanned = {}, {}, {}, 0

    def low(nums):
        for k, v in nums.items():
            lows[k] = max(lows.get(k, 0.0), v)

    with prog.traced():
        prog.plan(mix["warmup_block"], n)
        print(json.dumps({"setup_s": time.perf_counter() - T_START}),
              flush=True)
        for s0 in mix["blocks"]:
            t0 = time.perf_counter()
            scs = prog.plan(s0, n)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            got = {s0 + i: program.keep(sc) for i, sc in enumerate(scs)}
            del scs
            rows = {s: check.judge_plan(cfg, k) for s, k in got.items()
                    if k["plan"] is not None}
            bad = sum(k["plan"] is None for k in got.values())
            unplanned += bad
            nums = check.worst(list(rows.values()))
            nums["maps_unplanned"] = float(bad)
            low(nums)
            # each number's three largest maps, to see the tail
            top = {k: sorted(((r[k], s) for s, r in rows.items()),
                             reverse=True)[:3]
                   for k in ("pos_jump_m", "vel_jump_mps", "acc_jump_mps2",
                             "jerk_vs_dummy", "box_viol_m", "pair_viol_m")}
            print(json.dumps({"block": s0, "batch_s": t1 - t0,
                              "judge_s": time.perf_counter() - t1,
                              "program": nums, "top": top}), flush=True)
            kept.update(got)
    del prog
    maps = [(s, len(k["plan"]["T"]) - 1) for s, k in kept.items()
            if k["plan"] is not None]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = {int(s) for s in args.control_seeds.split(",") if s}
    controls = [c for c in args.control.split(",") if c]
    for seed in seeds:
        picked = traffic.sample(seed, maps, mix["check_maps"])
        t0 = time.perf_counter()
        nums = check.worst([check.judge_map(cfg, s, kept[s], ref_dev)
                            for s in picked])
        low(nums)
        line = {"seed": seed, "judged": picked,
                "judge_s": time.perf_counter() - t0, "program": nums}
        for c in controls if seed in cseeds else ():
            t1 = time.perf_counter()
            cn = check.worst([check.judge_map(cfg, s, kept[s], ref_dev,
                                              control=c) for s in picked])
            line[c] = cn
            line[f"{c}_s"] = time.perf_counter() - t1
            for k, v in cn.items():
                highs.setdefault(c, {})
                highs[c][k] = min(highs[c].get(k, float("inf")), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"program_max": lows, "unplanned": unplanned,
                      "control_min": highs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
