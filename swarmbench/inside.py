"""The program timed from inside: its own spans and counters
(swarm_simulator_tpu_torch/utils/timing) beside the device trace.

    python3 -m swarmbench.inside --workload <cell> --seed <n>
        --seconds <s> [--out <file>]

runs a cell's window as swarmbench/run.py does, under the profiler
(trace.py) and a ``timing.recording()``, drains the recorder after each
batch into that batch's ``program`` entry, and prints one JSON line: the
per-layer numbers ``READERS`` compute from the record, the device trace
with each idle gap named by the innermost span (the program's main-thread
spans or the harness's), ``by_span``, and the checks that tie the
numbers together.  Beside run.py's ranges the window holds one more,
``swarmbench.after_batch``: the harness's own work after a batch (what
the reference reads kept, the batch freed).  No reference judges the
plans: ``swarmbench.run`` does that.  On the CPU (``window(..., device="cpu")``) there is no
trace, and the numbers that read it are None.

``summarise`` is trace.summarise with the program's main-thread spans
besides the harness's ranges.  For each name it gives in ``by_span``
the span's seconds, the device-busy seconds and the device operations
started inside it, and the idle seconds of which it is the innermost
span: with ``swarmbench.window`` (idle outside every other span) the
names' idle seconds add up to the window's.
"""
from __future__ import annotations

import bisect
import heapq
import json
import sys
import threading
import time

from . import trace

WINDOW = "swarmbench.window"


def innermost(named: list[tuple[str, float, float]]
              ) -> list[tuple[float, float, str]]:
    """The time the intervals ``named`` (name, start, end) cover, cut into
    (start, end, name) pieces, each named by the innermost interval over
    it: the latest to start, the shortest of those that start together."""
    cuts = sorted({t for _, a, b in named for t in (a, b)})
    order = sorted(named, key=lambda r: r[1])
    live: list = []
    out: list[list] = []
    k = 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(order) and order[k][1] <= a:
            name, s, e = order[k]
            heapq.heappush(live, (-s, e - s, e, name))
            k += 1
        while live and live[0][2] <= a:
            heapq.heappop(live)
        if not live:
            continue
        name = live[0][3]
        if out and out[-1][2] == name and out[-1][1] == a:
            out[-1][1] = b
        else:
            out.append([a, b, name])
    return [(a, b, name) for a, b, name in out]


def summarise(device_ops: list[tuple[str, float, float]],
              ranges: list[tuple[str, float, float]],
              program: list[tuple[str, float, float]], top: int = 10
              ) -> dict:
    """trace.summarise of ``device_ops`` and the harness's ``ranges``, its
    idle gaps named by the innermost of ``ranges`` and ``program`` (the
    program's main-thread spans, on the same clock), and ``by_span``."""
    out = trace.summarise(device_ops, ranges, top)
    if not out:
        return out
    _, lo, hi = next(r for r in ranges if r[0] == WINDOW)
    merged = trace.union(trace.clip([(a, b) for _, a, b in device_ops],
                                    lo, hi))
    gaps, t = [], lo
    for a, b in merged + [(hi, hi)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    named = [(n, max(a, lo), min(b, hi)) for n, a, b in ranges + program
             if b > lo and a < hi]
    pieces = innermost(named)
    starts = [a for a, _, _ in pieces]

    def name_at(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return pieces[i][2] if i >= 0 and t < pieces[i][1] else WINDOW

    idle: dict[str, float] = {}
    i = 0
    for a, b in gaps:
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        t, j = a, i
        while t < b:
            if j < len(pieces) and pieces[j][0] <= t:
                e = min(b, pieces[j][1])
                idle[pieces[j][2]] = idle.get(pieces[j][2], 0.0) + e - t
                j += 1
            else:
                e = min(b, pieces[j][0]) if j < len(pieces) else b
                idle[WINDOW] = idle.get(WINDOW, 0.0) + e - t
            t = e

    m_start = [a for a, _ in merged]
    cum = [0.0]
    for a, b in merged:
        cum.append(cum[-1] + b - a)

    def busy_until(t: float) -> float:
        k = bisect.bisect_right(m_start, t)
        if k == 0:
            return 0.0
        return cum[k - 1] + min(t, merged[k - 1][1]) - merged[k - 1][0]

    op_starts = sorted(a for _, a, _ in device_ops)
    by: dict[str, dict] = {}
    for n, a, b in named:
        e = by.setdefault(n, {"s": 0.0, "busy_s": 0.0, "ops": 0,
                              "idle_s": 0.0})
        e["s"] += b - a
        e["busy_s"] += busy_until(b) - busy_until(a)
        e["ops"] += (bisect.bisect_left(op_starts, b)
                     - bisect.bisect_left(op_starts, a))
    for n, v in idle.items():
        by[n]["idle_s"] = v
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    out["idle_gaps"] = [[f"idle in {name_at((a + b) / 2)}", b - a]
                        for a, b in longest]
    out["by_span"] = by
    return out


def _spans(batch: dict, name: str) -> list:
    return [s for s in batch.get("program", {}).get("spans", ())
            if s[0] == name]


def _per_batch(record: dict, fn):
    """The mean over the window's batches of fn(batch), None where no
    batch has a value."""
    vals = [v for v in (fn(b) for b in record["batches"]) if v is not None]
    return sum(vals) / len(vals) if vals else None


def _total(name: str):
    def fn(b):
        spans = _spans(b, name)
        return sum(e - a for _, _, a, e, _ in spans) if spans else None
    return fn


def _mean(name: str, value=lambda s: s[3] - s[2]):
    def fn(b):
        spans = _spans(b, name)
        return sum(value(s) for s in spans) / len(spans) if spans else None
    return fn


def _admm_host_ms(b):
    steps = b.get("program", {}).get("counters", {}).get("admm.steps")
    if not steps:
        return None
    check, sync = _total("admm.check")(b), _total("admm.sync")(b)
    return 1e3 * (check - sync) / steps


def _counter(name: str):
    def fn(b):
        return b.get("program", {}).get("counters", {}).get(name)
    return fn


def _launches_per_iter(record: dict):
    by = (record.get("trace") or {}).get("by_span") or {}
    steps = sum(_counter("admm.steps")(b) or 0 for b in record["batches"])
    if "admm.check" not in by or not steps:
        return None
    return by["admm.check"]["ops"] / steps


def _stack_gb(record: dict):
    vals = [v for v in map(_counter("stack.bytes"), record["batches"])
            if v is not None]
    return max(vals) / 1e9 if vals else None


#: the per-layer numbers of the program's spans and counters: name ->
#: read(record), None where the record holds nothing to read
READERS = {
    "forest_gen_s.maps": lambda r: _per_batch(r, _total("mc.forest")),
    "prep_map_s.maps": lambda r: _per_batch(r, _mean("mc.prep_map")),
    "prep_wait_s.maps": lambda r: _per_batch(
        r, _mean("mc.prep_map", lambda s: s[4]["wait_s"])),
    "search_s.maps": lambda r: _per_batch(r, _mean("prep.search")),
    "kkt_prep_s.maps": lambda r: _per_batch(r, _total("sweep.prepare")),
    "admm_host_ms.maps": lambda r: _per_batch(r, _admm_host_ms),
    "admm_sync_s.maps": lambda r: _per_batch(r, _total("admm.sync")),
    "host_syncs.maps": lambda r: _per_batch(r, _counter("solve.syncs")),
    "launches_per_iter.maps": _launches_per_iter,
    "stack_gb.maps": _stack_gb,
}


def checks(record: dict, prep_workers: int, peak_gb: float | None) -> dict:
    """The numbers held against each other: the stack's bytes within the
    peak, each batch's ADMM steps at least its largest iteration count,
    and each batch's summed map prep within the pool's width times the
    harness's prep span (+1%)."""
    out = {}
    gb = _stack_gb(record)
    if gb is not None and peak_gb:
        out["stack_gb_within_peak"] = gb <= peak_gb
    steps = [(_counter("admm.steps")(b), max(map(max, b["iters"])))
             for b in record["batches"] if b["iters"]]
    out["steps_cover_iters"] = all(s is not None and s >= i
                                   for s, i in steps)
    preps = [(sum(e - a for _, _, a, e, _ in _spans(b, "mc.prep_map")),
              b["prep_s"]) for b in record["batches"]]
    out["prep_within_pool"] = all(
        work <= prep_workers * span * 1.01 for work, span in preps)
    return out


def window(man, cell_name: str, seed: int, seconds: float, device) -> dict:
    """A cell's window run as swarmbench/run.py runs it, under a
    recording and, on a card, the profiler; returns the record: the
    batches (each with its ``program``), the harness's spans, the trace
    summary with ``by_span``, the card and the peak memory."""
    import gc

    import torch

    from swarm_simulator_tpu_torch.utils import timing

    from . import program, traffic
    from .run import card

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
    with prog.traced(), timing.recording() as rec:
        main = threading.get_ident()
        prog.plan(mix["warmup_block"], n)
        sync()
        gc.collect()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        before = card() if cuda else {}
        prog.spans.clear()
        rec.drain()
        if cuda:
            trace.start()
            marked = trace.mark(dev)
        batches, kept, ends = [], {}, []
        t0 = time.perf_counter()
        blocks = len(mix["blocks"])
        while (time.perf_counter() - t0 < seconds
               or len(batches) % blocks):
            first = len(prog.spans)
            s0 = traffic.batch_seed0(seed, len(batches), mix)
            b0 = time.perf_counter()
            scs = prog.plan(s0, n)
            sync()
            b1 = time.perf_counter()
            ok = [program.planned(sc) for sc in scs]
            batches.append({
                "t0": b0, "t1": b1, "seed0": s0, "maps": len(scs),
                "planned": sum(ok),
                "prep_s": sum(e - a for name, a, e in prog.spans[first:]
                              if name == "prep"),
                "iters": [list(sc.plan.solver_info["iters"])
                          for sc, good in zip(scs, ok) if good],
                "program": rec.drain()})
            # what swarmbench/run.py keeps of a batch for the reference,
            # then the batch freed: the harness's own time between batches
            for i, sc in enumerate(scs):
                kept[s0 + i] = program.keep(sc)
            k1 = time.perf_counter()
            del scs
            ends.append((b1, k1, time.perf_counter()))
        sync()
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        tr = None
        if cuda:
            ops, off = trace.stop(marked)
            tr = summarise(ops, [(WINDOW, t0 + off, t0 + window_s + off)] + [
                (f"swarmbench.{name}", a + off, b + off)
                for name, a, b in prog.spans] + [
                ("swarmbench.after_batch", a + off, e + off)
                for a, _, e in ends], [
                (name, a + off, b + off)
                for bt in batches for name, ident, a, b, _
                in bt["program"]["spans"] if ident == main])
        after = card() if cuda else {}
        spans = list(prog.spans)
    for bt, (a, k, e) in zip(batches, ends):
        bt["keep_s"], bt["free_s"] = k - a, e - k
    return {"batches": batches, "spans": spans, "trace": tr,
            "window_s": window_s, "peak_gb": peak / 1e9 if cuda else None,
            "prep_workers": prog.prep_workers,
            "card": {"before_window": before, "after_window": after}}


def report(record: dict) -> dict:
    """The printed line of a window's record."""
    tr = record["trace"] or {}
    idle = (tr["window_s"] - tr["busy_s"]) if tr else None
    by = tr.get("by_span", {})
    mine = sum(v["idle_s"] for n, v in by.items()
               if not n.startswith("swarmbench."))
    return {
        "metrics": {k: fn(record) for k, fn in READERS.items()},
        "checks": checks(record, record["prep_workers"],
                         record["peak_gb"]),
        "window_s": record["window_s"], "peak_gb": record["peak_gb"],
        "batches": len(record["batches"]),
        "prep_s": [b["prep_s"] for b in record["batches"]],
        "keep_s": [b["keep_s"] for b in record["batches"]],
        "free_s": [b["free_s"] for b in record["batches"]],
        "counters": [b["program"]["counters"] for b in record["batches"]],
        "busy_s": tr.get("busy_s"), "idle_s": idle,
        "idle_in_program_share": mine / idle if idle else None,
        "idle_gaps": tr.get("idle_gaps"), "by_span": by,
        "device_ops": tr.get("device_ops"), "card": record["card"]}


def main(argv=None) -> int:
    import argparse

    from .manifest import Manifest
    from .run import pin_env

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None,
                    help="write the whole record (every span) here")
    args = ap.parse_args(argv)
    man = Manifest()
    pin_env(man.config(man.cell(args.workload)["config"]))
    import torch

    if not torch.cuda.is_available():
        print("swarmbench.inside: no CUDA card", file=sys.stderr)
        return 3
    record = window(man, args.workload, args.seed, args.seconds, "cuda:0")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f)
    print(json.dumps({"cell": args.workload, "seed": args.seed,
                      **report(record)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
