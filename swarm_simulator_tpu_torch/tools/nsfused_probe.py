"""T1, the fused-chunk probes: the pieces of the fused ADMM chunk (K1) at
the 64-agent tile form, each held against its plain version and timed.

    python3 -m swarm_simulator_tpu_torch.tools.nsfused_probe [--probe N]
        [--cpu]

The counterpart of the JAX package's tools/pallas_debug/nsfused_probe.py
(ops/nsfused_probe has the four probes; ``--probe 0``, the default, runs
all, N in 1-4 one).  The inputs are the JAX tool's draws, in its order
(numpy default_rng(0), drawn only for the probes run).  On the card: P1-P3
against their plain versions (P3 also against float64, relative 3e-6 as
the JAX probe holds it) and timed with CUDA events (median of 20 after a
warm-up) beside the plain version and, where one PyTorch call computes the
same function, that call (``LIBRARY``: P1 one ``torch.add`` on views of
x, P2 ``torch.einsum``, P3 ``torch.matmul`` at "highest" precision);
P4's 50 iterations against the plain version and timed, milliseconds per
call and per iteration, and its re-layout of the rung alone beside the
PyTorch copy that computes it (``relayout_library``); ``run(...,
k1_ms=)`` also reports P4 per iteration beside K1's chunk time measured
by the caller (chip_smoke.py's phase 2).  ``--cpu`` runs the
plain versions on the CPU and reports their errors, no time.  Lines go to
stderr, one JSON line to stdout; no file is written.  Without a card and
without ``--cpu`` it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

def _p1_library(x: torch.Tensor) -> torch.Tensor:
    x4 = x.view(36, 6, -1)
    return torch.add(x4[:, 0:3], x4[:, 3:6], alpha=2.0).view(108, -1)


#: the one PyTorch call that computes each probe's function, where there
#: is one (P4's fifty sweeps have none)
LIBRARY = {1: _p1_library,
           2: lambda d6, y, r: torch.einsum("fgbc,fb->gc", d6[r, 3], y),
           3: lambda x, s: torch.matmul(x, s)}


def relayout_library(d6: torch.Tensor, r: int) -> torch.Tensor:
    """P4's re-layout as one PyTorch copy of the permuted rung."""
    return d6[r].permute(0, 4, 2, 3, 1).contiguous()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def probe_inputs(probes=(1, 2, 3, 4)) -> dict:
    """The JAX tool's inputs for ``probes``, drawn from one
    default_rng(0) in its order (nsfused_probe.py:54, 66, 104-105,
    150-155, 225-229): {1: (x,), 2: (d6, y), 3: (x, s), 4: (d6, ho, b)}."""
    from swarm_simulator_tpu_torch.ops.nsfused_probe import B3, MI, MP, PHI, PL

    rng = np.random.default_rng(0)
    out = {}
    if 1 in probes:
        out[1] = (rng.standard_normal((216, 192)).astype(np.float32),)
    if 2 in probes:
        d6 = rng.standard_normal((2, MI, PHI, PHI, B3, B3)).astype(np.float32)
        y = rng.standard_normal((PHI, B3)).astype(np.float32)
        out[2] = (d6, y)
    if 3 in probes:
        x = (rng.standard_normal((MP, B3)) * 3).astype(np.float32)
        s = np.zeros((B3, PL), np.float32)
        cols = rng.integers(0, PL, size=B3)
        for b, c in enumerate(cols):
            s[b, c] = 1.0 if b % 2 else -1.0
        s[:, :64] = rng.integers(-1, 2, size=(B3, 64))
        out[3] = (x, s)
    if 4 in probes:
        d6 = (rng.standard_normal((1, MI, PHI, PHI, B3, B3)) * 0.1
              ).astype(np.float32)
        hom = rng.standard_normal((PHI, PHI)).astype(np.float32) * 0.1
        b = rng.standard_normal((MI, PHI, B3)).astype(np.float32)
        out[4] = (d6, hom, b)
    return out


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max(max |want|, 1), as the JAX probe scales."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


def run(probes, dev, timed: bool, k1_ms: float | None = None) -> dict:
    """Each probe through its wrapper on ``dev`` against its plain version
    (and P3 against float64); on the card also the times, P4's beside
    ``k1_ms``, K1's milliseconds per 50-iteration chunk, where given."""
    from swarm_simulator_tpu_torch.ops import nsfused_probe as npb

    if timed:
        from swarm_simulator_tpu_torch.tools._timing import median_ms
    data = {k: tuple(torch.from_numpy(a).to(dev) for a in v)
            for k, v in probe_inputs(probes).items()}
    fns = {1: (npb.p1_reshape_combine, npb.p1_reshape_combine_reference,
               ()),
           2: (npb.p2_tile_apply, npb.p2_tile_apply_reference, (1,)),
           3: (npb.p3_split_pair_product,
               npb.p3_split_pair_product_reference, ()),
           4: (npb.p4_resident_thomas, npb.p4_resident_thomas_reference,
               (0, npb.INNER))}
    out = {}
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        for p in probes:
            kern, plain, extra = fns[p]
            lib = LIBRARY.get(p)
            args = data[p] + extra
            got = kern(*args)
            want = plain(*args)
            r = dict(rel_err=rel(got, want),
                     max_abs_err=float((got - want).abs().max()))
            if p == 3:
                x, s = data[3]
                r["rel_err_f64"] = rel(got, x.double() @ s.double())
            if timed:
                reps = 3 if p == 4 else 20
                r["ms"] = median_ms(lambda: kern(*args), reps)
                r["plain_ms"] = median_ms(lambda: plain(*args), 1 if p == 4
                                          else 5)
                r["library_ms"] = (median_ms(lambda: lib(*args), reps)
                                   if lib else None)
                if p == 4:
                    r["ms_per_iter"] = r["ms"] / npb.INNER
                    if k1_ms is not None:
                        r["k1_ms_per_iter"] = k1_ms / npb.INNER
                    d6 = args[0]
                    m = npb.p4_relayout(d6, 0)
                    r["relayout_max_abs_err"] = float(
                        (m - npb.p4_relayout_reference(d6, 0)).abs().max())
                    r["relayout_ms"] = median_ms(
                        lambda: npb.p4_relayout(d6, 0), 20)
                    r["relayout_plain_ms"] = median_ms(
                        lambda: npb.p4_relayout_reference(d6, 0), 5)
                    r["relayout_library_ms"] = median_ms(
                        lambda: relayout_library(d6, 0), 20)
            out[f"P{p}"] = r
            log(f"P{p}: " + ", ".join(f"{k} {v:.4g}" if isinstance(v, float)
                                      else f"{k} {v}" for k, v in r.items()))
    finally:
        torch.set_float32_matmul_precision(prec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", type=int, default=0, choices=range(5),
                    help="0 = all")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (no timing)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("nsfused_probe: needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    probes = (1, 2, 3, 4) if args.probe == 0 else (args.probe,)
    if args.cpu:
        out = dict(device="cpu", probes=run(probes, torch.device("cpu"),
                                            False))
    else:
        from swarm_simulator_tpu_torch.tools._timing import card

        dev = torch.device("cuda")
        out = dict(device=torch.cuda.get_device_name(dev), card=card())
        log(out["card"])
        out["probes"] = run(probes, dev, True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
