"""T2, the chain-primitive bench: microseconds per step of each primitive
of the Thomas chain, on one block and on the chain ring.

    python3 -m swarm_simulator_tpu_torch.tools.thomas_prim_bench
        [--bs 640] [--mi 35] [--reps 20]
        [--modes dma,mv_sub,mv_lane,mv_mxu,trans,fwd] [--grids one,ring]
        [--cpu]

The counterpart of the JAX package's tools/pallas_debug/thomas_prim_bench.py
(ops/thomas_prim has the modes; ``mode@N`` sets the ring's slots).  The
inputs are the JAX tool's draws (numpy default_rng(0): dinvs [1, Mi, bs,
bs] 0.01 N(0, 1), koM 0.1 N(0, 1), b N(0, 1)) up to 2^26 pivot elements,
and above that the same pivots and b made on the card from a seeded
torch.Generator, with koM of 0.5 / sqrt(bs) N(0, 1) so that the forward
step stays bounded at production widths (the probe's 0.1 grows fwd's row
by ~2.3 a step at bs 2304, past float32's range in ~106 steps).  On the
card each mode and grid is launched once to warm up, then timed three
times with CUDA events; the tool prints the median over REPS x Mi steps
(as the JAX tool divides) in microseconds per step, and the last timed
launch's error against the plain version at the same REPS, relative to
the plain output's scale (limit REL_TOL).  ``--cpu`` runs the plain
version on the CPU instead and reports each mode's output checksum, no
time.  Lines go to stderr, one JSON line to stdout; no file is written.
It exits non-zero when a timed launch disagrees with the plain version,
and without a card and without ``--cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

#: pivot elements up to which the inputs are numpy's draws
NUMPY_LIMIT = 1 << 26
#: a timed launch against the plain version from the same zero start,
#: relative to the plain output's scale
REL_TOL = 1e-5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def probe_inputs(bs: int, Mi: int) -> tuple[np.ndarray, ...]:
    """The JAX tool's inputs (thomas_prim_bench.py:53-56): dinvs [1, Mi,
    bs, bs], koM [bs, bs], b [Mi, bs], float32."""
    rng = np.random.default_rng(0)
    dinvs = (0.01 * rng.standard_normal((1, Mi, bs, bs))).astype(np.float32)
    koM = (0.1 * rng.standard_normal((bs, bs))).astype(np.float32)
    b = rng.standard_normal((Mi, bs)).astype(np.float32)
    return dinvs, koM, b


def inputs(bs: int, Mi: int, dev, seed: int = 0) -> tuple[torch.Tensor, ...]:
    """The inputs on ``dev``: numpy's draws up to NUMPY_LIMIT pivot
    elements, else the same distributions from a torch.Generator on
    ``dev``."""
    if Mi * bs * bs <= NUMPY_LIMIT:
        return tuple(torch.from_numpy(a).to(dev) for a in probe_inputs(bs, Mi))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((1, Mi, bs, bs), generator=gen, device=dev).mul_(0.01),
            torch.randn((bs, bs), generator=gen,
                        device=dev).mul_(0.5 / bs ** 0.5),
            torch.randn((Mi, bs), generator=gen, device=dev))


def work(spec: str, bs: int, Mi: int, reps: int) -> tuple[int, int, str]:
    """(bytes, operations, their type) of REPS x Mi steps of ``spec`` for
    a bound: the pivot blocks the mode reads (dmag Mi // nbuf groups of
    nbuf), the start state acc0, and fwd's koM and b read once, the output
    [Mi, bs] written once; per step bs additions (dma, dmag, dmaq), 2 bs^2
    operations (mv_sub, mv_lane, trans; mv_mxu's on bf16 tensor cores) or
    6 bs^2 (fwd: the row's matvec, then two FMAs an element)."""
    from swarm_simulator_tpu_torch.ops import thomas_prim as tp

    mode, nbuf = tp.parse_mode(spec)
    grp = nbuf if mode == "dmag" else 1
    steps = reps * (Mi // grp)
    blocks = Mi // grp * grp
    nbytes = 4 * (blocks * bs * bs + bs * bs + Mi * bs
                  + (bs * bs + Mi * bs if mode == "fwd" else 0))
    per = {"mv_sub": 2, "mv_lane": 2, "mv_mxu": 2, "trans": 2,
           "fwd": 6}.get(mode)
    ops = steps * (per * bs * bs if per else bs)
    return nbytes, ops, "bf16" if mode == "mv_mxu" else "float32"


def time_mode(dinv, koM, b, spec: str, reps: int, grid: str,
              plain_reps: int = 0) -> dict:
    """One mode on one grid from a zero start: median CUDA-event ms of
    three launches after a warm-up, microseconds per step over REPS x Mi,
    and the last timed launch's output against the plain version's at the
    same REPS (``rel_err`` relative to the plain output's scale,
    ``max_abs_err``, ``finite``); with ``plain_reps`` > 0 also the plain
    version's median ms over that many runs."""
    from swarm_simulator_tpu_torch.ops import thomas_prim as tp
    from swarm_simulator_tpu_torch.tools._timing import median_ms

    mode, nbuf = tp.parse_mode(spec)
    Mi = b.shape[0]
    last = {}

    def kernel():
        last["out"] = tp.thomas_prim(dinv, koM, b, mode, nbuf, reps,
                                     grid=grid)

    def plain():
        return tp.thomas_prim_reference(dinv, koM, b, mode, nbuf, reps)

    ms = median_ms(kernel, 3)
    got, want = last["out"], plain()
    err = float((got - want).abs().max())
    blocks = tp.prim_plan(b.shape[1], mode, nbuf, grid,
                          torch.cuda.get_device_properties(b.device)
                          .multi_processor_count).blocks
    r = dict(ms=ms, us_per_step=1e3 * ms / (reps * Mi), blocks=blocks,
             rel_err=err / max(float(want.abs().max()), 1e-30),
             max_abs_err=err, finite=bool(torch.isfinite(got).all()))
    if plain_reps:
        r["plain_ms"] = median_ms(plain, plain_reps, warmup=0)
    return r


def agrees(r: dict) -> bool:
    """A timed launch of time_mode matched the plain version."""
    return r["finite"] and r["rel_err"] <= REL_TOL


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bs", type=int, default=640)
    ap.add_argument("--mi", type=int, default=35)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--modes", default="dma,mv_sub,mv_lane,mv_mxu,trans,fwd")
    ap.add_argument("--grids", default="one,ring")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain version on the CPU (no timing)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("thomas_prim_bench: needs a CUDA card (or --cpu)",
              file=sys.stderr)
        return 2
    from swarm_simulator_tpu_torch.ops import thomas_prim as tp

    dev = torch.device("cpu" if args.cpu else "cuda")
    dinv, koM, b = inputs(args.bs, args.mi, dev)
    out = dict(bs=args.bs, mi=args.mi, reps=args.reps, modes={})
    if args.cpu:
        out["device"] = "cpu"
        for spec in args.modes.split(","):
            mode, nbuf = tp.parse_mode(spec)
            row = tp.thomas_prim(dinv, koM, b, mode, nbuf, args.reps)[0]
            out["modes"][spec] = dict(row0_abs_sum=float(row.abs().sum()))
            log(f"{spec:>8}: row 0 abs sum "
                f"{out['modes'][spec]['row0_abs_sum']:.6g} (plain version "
                "on the CPU, not timed)")
        print(json.dumps(out))
        return 0
    from swarm_simulator_tpu_torch.tools._timing import card

    out.update(device=torch.cuda.get_device_name(dev), card=card())
    log(out["card"])
    ok = True
    for spec in args.modes.split(","):
        out["modes"][spec] = {}
        for grid in args.grids.split(","):
            r = time_mode(dinv, koM, b, spec, args.reps, grid)
            out["modes"][spec][grid] = r
            ok &= agrees(r)
            log(f"{spec:>8} {grid:>3} ({r['blocks']} blocks): "
                f"{r['us_per_step']:8.3f} us/step ({r['ms']:.3f} ms total, "
                f"reps={args.reps}), rel err vs plain {r['rel_err']:.2e}"
                + ("" if agrees(r) else " FAIL"))
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
