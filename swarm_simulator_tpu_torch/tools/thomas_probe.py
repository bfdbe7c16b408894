"""T3, the staged Thomas probe: microseconds per chain stage of each stage
(copy only, matvec, forward sweep, full solve with a dense coupling),
beside K2's on the same pivots.

    python3 -m swarm_simulator_tpu_torch.tools.thomas_probe
        [--bs 256] [--mi 4] [--rungs 2]
        [--probes dma,mv,fwd,full,dma@knot,mv@knot] [--cpu]

The counterpart of the JAX package's tools/pallas_debug/thomas_probe.py
(ops/thomas_probe has the stages; ``dma@knot`` and ``mv@knot`` run dma
and mv on the chain's spans, a block's rows of every knot, whose stream
is that of a chain stage of fwd, full and K2).  The inputs are the JAX
tool's draws (numpy default_rng(0): pivots (1 + 0.1 r) I + 0.01 N(0, 1), koM 0.1
N(0, 1), b N(0, 1); rung 1 % R; ``full`` on the pivots symmetrised) up to
2^26 pivot elements, and above that the same pivots made on the card from
a seeded torch.Generator, with koM of 0.5 / sqrt(bs) N(0, 1) so that the
sweeps stay bounded at production widths (the probe's 0.1 grows them by
~1.9 a stage at bs 2304, past float32's range over both sweeps).  On
the card every stage is timed (median of five CUDA-event launches after a
warm-up), held against the plain version and reported with its ring plan
(ops/thomas_probe.probe_plan); mv beside ``torch.einsum("kbc,kc->kb")``,
the one PyTorch call that computes it; K2 (ops/thomas, per-knot Ho [phi,
phi] of 0.1 N(0, 1), phi = 3 where bs allows) runs on the same pivots.
Per stage: dma and mv over Mi stages, fwd over Mi, full and K2 over
2 Mi - 1.
``--cpu`` runs the plain version on the CPU and reports checksums, no
time.  Lines go to stderr, one JSON line to stdout; no file is written.
Without a card and without ``--cpu`` it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

#: pivot elements up to which the inputs are numpy's draws
NUMPY_LIMIT = 1 << 26


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def probe_inputs(bs: int, Mi: int, R: int) -> tuple[np.ndarray, ...]:
    """The JAX tool's inputs (thomas_probe.py:54-60, 160): dinvs [R, Mi,
    bs, bs], koM [bs, bs], b [Mi, bs] and the symmetrised pivots dsym,
    float32."""
    rng = np.random.default_rng(0)
    dinvs = np.stack([np.eye(bs) * (1 + 0.1 * r) for r in range(R)])
    dinvs = dinvs[:, None] + 0.01 * rng.standard_normal((R, Mi, bs, bs))
    dinvs = dinvs.astype(np.float32)
    koM = (0.1 * rng.standard_normal((bs, bs))).astype(np.float32)
    b = rng.standard_normal((Mi, bs)).astype(np.float32)
    dsym = np.ascontiguousarray(0.5 * (dinvs
                                       + dinvs.transpose(0, 1, 3, 2)))
    return dinvs, koM, b, dsym


def inputs(bs: int, Mi: int, R: int, dev,
           seed: int = 0) -> tuple[torch.Tensor, ...]:
    """(dinvs, koM, b, dsym) on ``dev``: numpy's draws up to NUMPY_LIMIT
    pivot elements, else made on ``dev``."""
    if R * Mi * bs * bs <= NUMPY_LIMIT:
        return tuple(torch.from_numpy(a).to(dev)
                     for a in probe_inputs(bs, Mi, R))
    gen = torch.Generator(device=dev).manual_seed(seed)
    dinvs = torch.randn((R, Mi, bs, bs), generator=gen, device=dev).mul_(0.01)
    for r in range(R):
        dinvs[r].diagonal(dim1=-2, dim2=-1).add_(1 + 0.1 * r)
    koM = torch.randn((bs, bs), generator=gen,
                      device=dev).mul_(0.5 / bs ** 0.5)
    b = torch.randn((Mi, bs), generator=gen, device=dev)
    dsym = dinvs.transpose(-1, -2).add(dinvs).mul_(0.5).contiguous()
    return dinvs, koM, b, dsym


def k2_phi(bs: int) -> int:
    """The row-group width K2 runs with on these pivots: 3, as in the
    planner, where bs allows, else the largest of 4, 2, 1 dividing bs."""
    return next(p for p in (3, 4, 2, 1) if bs % p == 0)


#: every probe the tool runs: the four stages, then dma and mv on the
#: chain's spans
PROBES = ("dma", "mv", "fwd", "full", "dma@knot", "mv@knot")


def run_stages(dinvs, koM, b, dsym, stages, reps: int = 5) -> dict:
    """Each stage through the kernel (rung 1 % R): median ms and us per
    stage, its error against the plain version relative to the plain
    output's scale, its plan; mv's library call (torch.einsum) timed in
    the same way; then K2 on dsym."""
    from swarm_simulator_tpu_torch.ops import thomas, thomas_probe as tq
    from swarm_simulator_tpu_torch.tools._timing import median_ms

    R, Mi, bs = dinvs.shape[0], dinvs.shape[1], dinvs.shape[-1]
    r = 1 % R
    out = {}
    for name in stages:
        st, knot = name.split("@")[0], name.endswith("@knot")
        piv = dsym if st == "full" else dinvs
        got = tq.thomas_probe(piv, koM, b, st, r, knot)
        want = tq.thomas_probe_reference(piv, koM, b, st, r)
        err = float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        ms = median_ms(lambda: tq.thomas_probe(piv, koM, b, st, r, knot),
                       reps)
        n = tq.stages_of(st, Mi)
        plan = tq.probe_plan(bs, Mi, st, thomas.sm_count(b.device), knot)
        out[name] = e = dict(ms=ms, us_per_stage=1e3 * ms / n, rel_err=err,
                             stages=n, finite=bool(torch.isfinite(got).all()),
                             plan=plan._asdict())
        if name == "mv":
            e["library_ms"] = median_ms(
                lambda: torch.einsum("kbc,kc->kb", piv[r], b), reps)
        log(f"T3 {name:>8} bs {bs} Mi {Mi}: {e['us_per_stage']:.3f} "
            f"us/stage ({ms:.4f} ms, {n} stages), rel err vs plain "
            f"{err:.2e}; {plan.blocks} blocks of {plan.rows} rows, tiles "
            f"of {plan.tile_rows}, {plan.slots} slots" + (
                "" if st in ("dma", "mv") else ", coupling rows "
                + ("resident" if plan.resident else "through L2")) + (
                f"; torch.einsum {e['library_ms']:.4f} ms"
                if name == "mv" else ""))
    phi = k2_phi(bs)
    gen = torch.Generator(device=b.device).manual_seed(1)
    ho = torch.randn((Mi - 1, phi, phi), generator=gen,
                     device=b.device).mul_(0.1)
    ms = median_ms(lambda: thomas.thomas_solve(dsym, ho, b, r), reps)
    out["k2"] = dict(ms=ms, us_per_stage=1e3 * ms / (2 * Mi - 1),
                     stages=2 * Mi - 1, phi=phi)
    log(f"T3   K2 bs {bs} Mi {Mi} (phi {phi}): "
        f"{out['k2']['us_per_stage']:.3f} us/stage ({ms:.4f} ms)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bs", type=int, default=256)
    ap.add_argument("--mi", type=int, default=4)
    ap.add_argument("--rungs", type=int, default=2)
    ap.add_argument("--probes", default=",".join(PROBES))
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain version on the CPU (no timing)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("thomas_probe: needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    from swarm_simulator_tpu_torch.ops import thomas_probe as tq

    dev = torch.device("cpu" if args.cpu else "cuda")
    dinvs, koM, b, dsym = inputs(args.bs, args.mi, args.rungs, dev)
    stages = args.probes.split(",")
    out = dict(bs=args.bs, mi=args.mi, rungs=args.rungs)
    if args.cpu:
        out.update(device="cpu", stages={})
        for st in stages:
            got = tq.thomas_probe(dsym if st == "full" else dinvs, koM, b,
                                  st.split("@")[0], 1 % args.rungs)
            out["stages"][st] = dict(abs_sum=float(got.abs().sum()))
            log(f"T3 {st}: abs sum {out['stages'][st]['abs_sum']:.6g} (plain "
                "version on the CPU, not timed)")
        print(json.dumps(out))
        return 0
    from swarm_simulator_tpu_torch.tools._timing import card

    out.update(device=torch.cuda.get_device_name(dev), card=card())
    log(out["card"])
    out["stages"] = run_stages(dinvs, koM, b, dsym, stages)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
