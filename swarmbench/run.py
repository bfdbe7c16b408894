"""Run one cell of BENCHMARK.json once and print its result.

    python3 -m swarmbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (the program's modules, the card, the native library, one warm-up
batch of the traffic's warm-up block) counts from the start of this
module to the end of the warm-up.  The window then plans the traffic's
pool of map blocks, one block a batch, in an order drawn from the seed,
and starts another whole pass while ``--seconds`` have not passed, so
that every run plans the same maps; ``plans_per_s`` is the maps planned
over the time of all the batches run.  After the window the reference judges
every map the window planned by what its plan states, and works a sample
of them out again from the seed (swarmbench/reference/check.py).  The last
lines of standard error give each compared number beside its limit, and
the last line of standard output is the result, its ``check`` key last.
The card's name, power limit, clocks and power draw before and after the
window go to a line of their own before it.  With ``--trace 1`` the window
runs under the profiler (swarmbench/trace.py) and the metrics are the
cell's per-layer ones.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from .manifest import Manifest  # noqa: E402

#: top-level modules the process that prints a result must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "swarm_simulator_tpu")

GB = 1e9


def forbidden_loaded() -> list[str]:
    """The forbidden top-level modules in sys.modules, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def pin_env(cfg: dict) -> None:
    """The configuration's environment pins (the host's BLAS threads);
    before numpy or torch load."""
    for k, v in cfg.get("env", {}).items():
        os.environ[k] = str(v)


def card() -> dict:
    """nvidia-smi's reading of card 0."""
    keys = ("name", "power.limit", "power.draw", "clocks.sm", "clocks.mem",
            "temperature.gpu")
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return {"error": f"{type(e).__name__}: {e}"}
    return dict(zip(keys, (v.strip() for v in line.split(","))))


def run_cell(man: Manifest, cell_name: str, seed: int, seconds: float,
             trace: bool, device,
             control: str | None = None, log=None, note=None) -> dict:
    """One run of a cell on ``device``; returns the result (the ``check``
    key last).  ``control``: a dtype's name or one of check.RELAXED; the
    reference's own plan so computed then takes the program's place on
    the sample (reference/check.py)."""
    import torch

    from . import program, roofline, traffic
    from . import trace as trace_mod
    from .reference import check

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    note = note or (lambda *a: print(*a, flush=True))
    cell = man.cell(cell_name)
    cfg = man.config(cell["config"])
    mix = man.traffic(cell["traffic"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    prog = program.Program(cfg, dev)
    n = mix["maps_per_batch"]
    with prog.traced():
        prog.plan(mix["warmup_block"], n)
        sync()
        setup_s = time.perf_counter() - T_START
        gc.collect()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        before = card() if cuda else {}
        prog.spans.clear()
        if trace and cuda:
            trace_mod.start()
            marked = trace_mod.mark(dev)
        batches, kept = [], {}
        t0 = time.perf_counter()
        blocks = len(mix["blocks"])
        # whole passes of the pool, so every run plans the same maps
        while (time.perf_counter() - t0 < seconds
               or len(batches) % blocks):
            s0 = traffic.batch_seed0(seed, len(batches), mix)
            first = len(prog.spans)
            launched = prog.k1_launches()
            b0 = time.perf_counter()
            scs = prog.plan(s0, n)
            sync()
            b1 = time.perf_counter()
            ok = [program.planned(sc) for sc in scs]
            span = {k: sum(e - a for name, a, e in prog.spans[first:]
                           if name == k) for k in ("prep", "solve")}
            batches.append({
                "t0": b0, "t1": b1, "maps": len(scs), "span": span,
                "planned": sum(ok), "stacks": program.stacks(scs),
                "iters": [list(sc.plan.solver_info["iters"])
                          for sc, good in zip(scs, ok) if good],
                "errors": [sc.error for sc in scs if sc.error],
                "times": [sc.times for sc in scs],
                "shapes": [prog.shape(sc) for sc in scs],
                "k1_launches": prog.k1_launches() - launched})
            for i, sc in enumerate(scs):
                kept[s0 + i] = program.keep(sc)
            del scs
        sync()
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        tr = None
        if trace:
            ops, off = trace_mod.stop(marked) if cuda else ([], 0.0)
            tr = trace_mod.summarise(ops, [
                ("swarmbench.window", t0 + off, t0 + window_s + off)] + [
                (f"swarmbench.{name}", a + off, b + off)
                for name, a, b in prog.spans])
        after = card() if cuda else {}
        spans = list(prog.spans)
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    note(json.dumps({"card": {"before_window": before,
                              "after_window": after}}))

    attempted = sum(b["maps"] for b in batches)
    planned = sum(b["planned"] for b in batches)
    maps = [(s, len(k["plan"]["T"]) - 1) for s, k in kept.items()
            if k["plan"] is not None]
    picked = traffic.sample(seed, maps, mix["check_maps"])
    ref_dev = dev if cfg.get("reference_device") == "card" else "cpu"
    j0 = time.perf_counter()
    # every planned map by what its plan states; under a control only the
    # sample, where the control's plan takes the program's place
    rows = [] if control else [check.judge_plan(cfg, kept[s])
                               for s, _ in maps]
    j1 = time.perf_counter()
    rows += [check.judge_map(cfg, s, kept[s], ref_dev, control=control)
             for s in picked]
    j2 = time.perf_counter()
    numbers = check.worst(rows)
    numbers["maps_unplanned"] = float(attempted - planned)
    limits = cfg["limits"]
    compared = {k: [numbers[k], lim] for k, lim in limits.items()}
    correct = bool(rows) and all(v <= lim for v, lim in compared.values())

    record = {"batches": batches, "spans": spans, "trace": tr}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in man.metrics(cell_name, kind):
        if m["name"] == "setup_s":
            v = setup_s
        elif m["name"] == "plans_per_s":
            v = planned / (batches[-1]["t1"] - batches[0]["t0"])
        elif m["name"] == "peak_mem_gb":
            v = peak / GB if cuda else None
        else:
            v = man.reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    devinfo = {"platform": "gpu" if cuda else dev.type,
               "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
               "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted,
              "failed": attempted - planned, "metrics": metrics,
              "device": devinfo}
    if tr:
        devinfo["busy_s"] = tr["busy_s"]
        devinfo["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    log("run " + json.dumps({
        "cell": cell_name, "seed": seed, "batches": len(batches),
        "window_s": window_s, "batch_s": [b["t1"] - b["t0"] for b in batches],
        "prep_s": [b["span"]["prep"] for b in batches],
        "solve_s": [b["span"]["solve"] for b in batches],
        "errors": [e for b in batches for e in b["errors"]][:5],
        "judged": picked, "judge_all_s": j1 - j0, "judge_sample_s": j2 - j1,
        "k1_launches": sum(b["k1_launches"] for b in batches),
        "k1_in_trace": roofline.k1_in_trace(tr)[0] if tr else None,
        "time_scaled": sorted(k.get("time_scale", 1.0) for k in kept.values()
                              if k.get("time_scale", 1.0) != 1.0),
        "numbers": numbers}))
    for k, (v, lim) in compared.items():
        log(f"check {k} {v!r} limit {lim!r} " + ("ok" if v <= lim
                                                   else "FAIL"))
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in compared.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="judge the reference's plan in this precision "
                         "(bfloat16), or relaxed (nobox, nopair), in the "
                         "program's place on the sample")
    args = ap.parse_args(argv)

    man = Manifest()
    cell = man.cell(args.workload)
    pin_env(man.config(cell["config"]))
    import torch

    if not torch.cuda.is_available():
        print("swarmbench: no CUDA card; this benchmark measures the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"swarmbench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 3
    result = run_cell(man, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", control=args.control)
    bad = forbidden_loaded()
    if bad:
        print(f"swarmbench: the process holds {bad}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
