"""T2's mv_mxu drift against witnesses of its summation order.

    python3 -m swarm_simulator_tpu_torch.tools.t2_mxu_drift
        [--bs 576,640,2304] [--seeds 5] [--mi 6]

mv_mxu rounds its carried row to bf16 each step, so two float32 runs that
sum a step's products in different orders round some entries to
neighbouring bf16 values and walk apart.  For each width and seed this
tool draws the inputs as tests/test_torch_cuda.py's
test_prim_kernel_matches_plain_on_cuda does (a seeded torch.Generator on
the card: dinv 0.01 N(0, 1), koM, b, acc0 N(0, 1); Mi knots), runs
mv_mxu over REPS 1 and 2 (Mi and 2 Mi steps) on T2's grids "one" and
"ring", and prints each result's error relative to the float64 plain
run's scale (``thomas.rel_error``) beside:
  plain  the plain version in float32 (``thomas_prim_reference``);
  wit    a witness of each grid's order (``order_witness``): the plain
         recurrence in float32 with each step's sum formed as the grid
         forms it, a block's rows tile by tile into its partial row, the
         partial rows added in the order csrc/thomas_prim.cu's sum_blocks
         adds them (a tile's own products, which the tensor cores sum,
         in torch's order);
and the kernel against its grid's witness.  ``step1`` rows hold one
step (Mi = 1, REPS 1): no rounding of a carried row, so they measure the
float32 sum of a single step alone.  A kernel that sides with its witness
(its error near the witness's, far from the plain version's) drifts by
its order; one that does not has another cause.  Lines go to stderr, one
JSON line to stdout; it exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def draw(bs: int, Mi: int, seed: int, dev) -> tuple[torch.Tensor, ...]:
    """(dinv [1, Mi, bs, bs], koM, b, acc0) as the card test draws them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dinv = torch.randn((1, Mi, bs, bs), generator=gen, device=dev) * 0.01
    koM = (torch.randn((bs, bs), generator=gen, device=dev)
           * (0.1 if bs < 2304 else 0.5 / bs ** 0.5))
    b = torch.randn((Mi, bs), generator=gen, device=dev)
    acc0 = torch.randn((bs, bs), generator=gen, device=dev)
    return dinv, koM, b, acc0


def sum_blocks(P: torch.Tensor) -> torch.Tensor:
    """The sum over P's rows [ncb, n] in csrc/thomas_prim.cu's sum_blocks
    order: under 32 blocks one after another from zero; else lane l of a
    warp adds blocks l, l + 32, ... from zero, then the warp's xor
    butterfly (offsets 16, 8, 4, 2, 1)."""
    ncb = P.shape[0]
    if ncb < 32:
        v = torch.zeros_like(P[0])
        for c in range(ncb):
            v = v + P[c]
        return v
    lanes = torch.zeros((32,) + P.shape[1:], dtype=P.dtype, device=P.device)
    for c in range(ncb):
        lanes[c % 32] = lanes[c % 32] + P[c]
    idx = torch.arange(32, device=P.device)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[idx ^ off]
    return lanes[0]


def order_witness(dinv: torch.Tensor, acc0: torch.Tensor, reps: int,
                  rows: int, tile_rows: int) -> torch.Tensor:
    """mv_mxu's REPS x Mi steps from acc0's row 0 in dinv's dtype, each
    step summed as a grid of blocks of ``rows`` rows in tiles of
    ``tile_rows`` sums it; returns the end row [bs]."""
    rung = dinv[0].to(torch.bfloat16).to(dinv.dtype)
    Mi, bs = rung.shape[0], rung.shape[1]
    v = acc0[0].to(dinv.dtype)
    for _ in range(reps):
        for k in range(Mi):
            x = v.to(torch.bfloat16).to(dinv.dtype)
            parts = []
            for r0 in range(0, bs, rows):
                part = torch.zeros_like(v)
                for a0 in range(r0, min(r0 + rows, bs), tile_rows):
                    a1 = min(a0 + tile_rows, r0 + rows, bs)
                    part = part + x[a0:a1] @ rung[k, a0:a1]
                parts.append(part)
            v = sum_blocks(torch.stack(parts))
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bs", default="576,640,2304")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--mi", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("t2_mxu_drift: needs a CUDA card", file=sys.stderr)
        return 2
    from swarm_simulator_tpu_torch.ops import thomas
    from swarm_simulator_tpu_torch.ops import thomas_prim as tp
    from swarm_simulator_tpu_torch.tools._timing import card

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = dict(card=card(), mi=args.mi, rows=[])
    log(out["card"])
    for bs in (int(x) for x in args.bs.split(",")):
        plans = {g: tp.prim_plan(bs, "mv_mxu", 2, g, sms) for g in tp.GRIDS}
        for seed in range(args.seeds):
            dinv, koM, b, acc0 = draw(bs, args.mi, seed, dev)
            for label, Mi, reps in (("step1", 1, 1),
                                    (f"{args.mi} steps", args.mi, 1),
                                    (f"{2 * args.mi} steps", args.mi, 2)):
                d, bb = dinv[:, :Mi].contiguous(), b[:Mi].contiguous()
                w64 = tp.thomas_prim_reference(d, koM.double(), bb.double(),
                                               "mv_mxu", 2, reps,
                                               acc0.double())[0]
                plain = tp.thomas_prim_reference(d, koM, bb, "mv_mxu", 2,
                                                 reps, acc0)[0]
                r = dict(bs=bs, seed=seed, steps=label,
                         plain=thomas.rel_error(plain, w64))
                for g, plan in plans.items():
                    got = tp.thomas_prim(d, koM, bb, "mv_mxu", 2, reps, acc0,
                                         grid=g)[0]
                    wit = order_witness(d, acc0, reps, plan.rows,
                                        plan.tile_rows)
                    r[g] = thomas.rel_error(got, w64)
                    r[f"{g}_wit"] = thomas.rel_error(wit, w64)
                    r[f"{g}_vs_wit"] = thomas.rel_error(got, wit)
                out["rows"].append(r)
                log(f"bs {bs} seed {seed} {label:>9}: plain {r['plain']:.2e}"
                    + "".join(f"; {g} {r[g]:.2e} (witness {r[g + '_wit']:.2e},"
                              f" against it {r[g + '_vs_wit']:.2e})"
                              for g in plans))
            del dinv, koM, b, acc0
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
