"""T3's ring on the card: what a stage's row stream costs, and what moves
it.

    python3 -m swarm_simulator_tpu_torch.tools.t3_ring_study [--reps 10]

Times the staged Thomas probe T3 (ops/thomas_probe) on variants of its
ring plan (ops/thomas_probe.ring_variant), each launch held against the
plain version (within 1e-4 of its scale) on tools/thomas_probe's inputs,
rung 1:
  depth     dma on the chain's spans at bs 576 (a block's 5 rows of a
            knot: one 11.5 KB copy a stage) with 2, 4 and 8 slots at Mi
            35, and with the plan's 8 at Mi 8 and 140 (the cost a knot);
  tiles     dma and mv on flat spans at bs 576, Mi 35 through two slots
            of 10, 21 and 39 rows (the plan's), a copy of 23 to 90 KB;
  coupling  fwd at bs 2304, Mi 71 with koM^T resident beside two slots of
            3 rows (the plan's) and of 2 rows, and with koM^T read through
            L2 beside four slots of 5 rows;
beside torch.sum and torch.einsum("kbc,kc->kb") on the same rungs (the
card's stream rate).  CUDA events after the stream spin (tools/_timing),
the median of --reps launches.  Lines go to stderr, one JSON line to
stdout; no file is written.  It exits non-zero without a card, or when a
variant disagrees with the plain version.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("t3_ring_study: needs a CUDA card", file=sys.stderr)
        return 2
    from swarm_simulator_tpu_torch.ops import thomas, thomas_probe as tq
    from swarm_simulator_tpu_torch.tools import thomas_probe as t3
    from swarm_simulator_tpu_torch.tools._timing import card, median_ms

    dev = torch.device("cuda")
    sms = thomas.sm_count(dev)
    out = dict(device=torch.cuda.get_device_name(dev), card=card(),
               cases={}, failed=[])
    log(out["card"])

    def run(tag, ins, stage, plan, knot=False):
        d, k, b = ins
        got = tq.thomas_probe(d, k, b, stage, 1, knot, plan)
        want = tq.thomas_probe_reference(d, k, b, stage, 1)
        err = float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        if not err <= 1e-4:
            out["failed"].append(tag)
        ms = median_ms(lambda: tq.thomas_probe(d, k, b, stage, 1, knot,
                                               plan), args.reps)
        out["cases"][tag] = dict(ms=ms, rel_err=err, plan=plan._asdict())
        log(f"{tag}: {ms:.4f} ms, rel err {err:.1e} ({plan.blocks} blocks "
            f"of {plan.rows} rows, tiles of {plan.tile_rows}, "
            f"{plan.slots} slots" + (", coupling resident" if plan.resident
                                     else "") + ")")

    def library(bs, Mi, d, b):
        for name, fn in (("torch.sum", lambda: torch.sum(d)),
                         ("torch.einsum", lambda: torch.einsum(
                             "kbc,kc->kb", d, b))):
            ms = median_ms(fn, args.reps)
            out["cases"][f"{name} bs {bs} Mi {Mi}"] = dict(ms=ms)
            log(f"{name} bs {bs} Mi {Mi}: {ms:.4f} ms")

    for Mi in (8, 35, 140):
        d, k, b, _ = t3.inputs(576, Mi, 2, dev)
        ins = (d, k, b)
        base = tq.probe_plan(576, Mi, "dma", sms, knot_spans=True)
        for n in (2, 4, 8) if Mi == 35 else (base.slots,):
            run(f"depth: dma@knot bs 576 Mi {Mi} slots {n}", ins, "dma",
                tq.ring_variant(base, 576, Mi, "dma", True, slots=n), True)
        library(576, Mi, d[1], b)
        if Mi == 35:
            for st in ("dma", "mv"):
                flat = tq.probe_plan(576, Mi, st, sms)
                for t in (10, 21, flat.tile_rows):
                    run(f"tiles: {st} bs 576 Mi 35 tiles of {t}", ins, st,
                        tq.ring_variant(flat, 576, Mi, st, tile_rows=t,
                                        slots=2))
        del d, k, b, ins
        torch.cuda.empty_cache()

    d, k, b, _ = t3.inputs(2304, 71, 2, dev)
    ins = (d, k, b)
    base = tq.probe_plan(2304, 71, "fwd", sms)
    for tag, plan in (
            ("resident, the plan's", base),
            ("resident, tiles of 2", tq.ring_variant(base, 2304, 71, "fwd",
                                                     tile_rows=2)),
            ("through L2", tq.ring_variant(base, 2304, 71, "fwd",
                                           resident=False, tile_rows=5,
                                           slots=4))):
        run(f"coupling: fwd bs 2304 Mi 71 {tag}", ins, "fwd", plan)
    library(2304, 71, d[1], b)
    print(json.dumps(out))
    return 1 if out["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
