"""Device-memory bandwidth study of the Thomas pivot stream on one card.

    python3 -m swarm_simulator_tpu_torch.tools.thomas_bw_study
        [--agents 256] [--M 72] [--reps 20]

The counterpart of the JAX package's tools/thomas_bw_study.py.  On one
synthetic inventory of R = 2 rungs, Mi = M - 1 knots and bs = 9 * agents
(256 agents: [2, 71, 2304, 2304], a 1.508 GB float32 rung; made on the
card from seed 0, and rounded to bf16 for the bf16 half) it times:

  dma2 / dma4            the stream kernel T4 (ops/thomas_stream) with a
                         2- or 4-slot ring of whole-tile copies
  dma2split / dma4split  the same with each tile copied as two halves on
                         separate barriers
  thomas                 the Thomas solve K2 (ops/thomas), which reads
                         the rung twice (both sweeps)
  torch.sum              one PyTorch call computing T4's function

each on float32 and on bf16 pivots, alternating the rung from call to
call as the JAX study does.  Times are CUDA events around each call
(tools/_timing, after a ~0.5 ms stream spin), the median of ``--reps``
calls after one warm-up call; GB/s is the rung's bytes (twice them for
K2) over that time.  Lines go to stderr, the JSON to stdout; no file is
written.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys

import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def synthetic_inventory(agents: int, M: int, dev, R: int = 2,
                        seed: int = 0) -> torch.Tensor:
    """[R, M-1, 9*agents, 9*agents] float32 pivots, N(0, 0.01^2), made on
    ``dev`` from ``seed`` (the JAX study's sizes; its numbers are made
    with numpy, these on the card)."""
    bs = agents * 9
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((R, M - 1, bs, bs), generator=gen,
                       device=dev).mul_(0.01)


def rung_ms(fn, R: int, reps: int) -> float:
    """Median CUDA-event milliseconds of ``fn(rung)`` over ``reps`` calls
    after one warm-up call, the rung alternating 0, 1, ..."""
    from swarm_simulator_tpu_torch.tools._timing import median_ms

    rungs = itertools.cycle(range(R))
    return median_ms(lambda: fn(next(rungs)), reps)


def run_study(dinv32: torch.Tensor, reps: int) -> dict:
    """Every variant, K2 and torch.sum on float32 and bf16 pivots: {dtype:
    {name: {"ms", "gbps"}}} plus the stream's bytes."""
    from swarm_simulator_tpu_torch.ops import thomas, thomas_stream as ts

    R, Mi, bs = dinv32.shape[0], dinv32.shape[1], dinv32.shape[-1]
    dev = dinv32.device
    phi = 3
    ho = torch.eye(phi, device=dev).expand(Mi - 1, phi, phi).contiguous()
    b = torch.randn((Mi, bs), generator=torch.Generator(device=dev)
                    .manual_seed(1), device=dev)
    out = {"R": R, "Mi": Mi, "bs": bs}
    for dtype in (torch.float32, torch.bfloat16):
        label = str(dtype).removeprefix("torch.")
        dinv = dinv32.to(dtype)
        rung_bytes = Mi * bs * bs * dinv.element_size()
        rows = {}
        for name, (slots, split) in ts.VARIANTS.items():
            ms = rung_ms(lambda r, s=slots, p=split: ts.thomas_stream(
                dinv, r, s, p), R, reps)
            rows[name] = dict(ms=ms, gbps=rung_bytes / ms / 1e6)
        ms = rung_ms(lambda r: thomas.thomas_solve(dinv, ho, b, r), R, reps)
        rows["thomas"] = dict(ms=ms, gbps=2 * rung_bytes / ms / 1e6)
        ms = rung_ms(lambda r: torch.sum(dinv[r], dim=(0, 1),
                                         dtype=torch.float32), R, reps)
        rows["torch.sum"] = dict(ms=ms, gbps=rung_bytes / ms / 1e6)
        for name, v in rows.items():
            log(f"{label} {name}: {v['ms']:.4f} ms -> {v['gbps']:.1f} GB/s")
        out[label] = dict(rung_gb=rung_bytes / 1e9, **rows)
        del dinv
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agents", type=int, default=256)
    ap.add_argument("--M", type=int, default=72)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("thomas_bw_study: needs a CUDA card", file=sys.stderr)
        return 2
    from swarm_simulator_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    _build.build("thomas", "thomas_stream")
    dinv = synthetic_inventory(args.agents, args.M, dev)
    log(f"agents {args.agents}: pivots {tuple(dinv.shape)}, rung "
        f"{dinv[0].numel() * 4 / 1e9:.3f} GB float32")
    out = run_study(dinv, args.reps)
    out.update(agents=args.agents, device=torch.cuda.get_device_name(dev))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
