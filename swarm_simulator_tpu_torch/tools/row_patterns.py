"""T5, the row-assembly patterns: each of the fourteen index maps through
the kernel, PASS or FAIL against its plain version.

    python3 -m swarm_simulator_tpu_torch.tools.row_patterns [--cpu]

The counterpart of the JAX package's tools/pallas_debug/mosaic_patterns.py
(ops/row_patterns has the patterns and the probe's arange inputs).  On the
card a pattern passes when the kernel's output is bit-equal to the plain
version's (P8, a sum of products, within 1e-6 of the output's scale); each
is timed with CUDA events (median of 20 after a warm-up), beside its plain
version and, where one PyTorch call computes the pattern (all but P6 and
P6b: ``torch.cat``, ``F.pad``, ``torch.roll``, ``torch.mul`` on views,
``torch.einsum`` for P8), that call, whose output is held to the plain
version's by the same rule (P8 within LIB_RTOL).  ``--cpu`` runs the
plain versions (every pattern passes by construction) and checks the
library calls, no time.  The PASS/FAIL lines go to stderr, one JSON line
to stdout; no file is written.  It exits non-zero when a pattern or a
library call disagrees, and without a card and without ``--cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

#: P8's sum of products against the plain version: float32 sums of 192
#: products in another order
SUM_RTOL = 1e-6
#: P8's library call (a matrix product) against the plain version: the
#: 192 products summed in the BLAS library's order
LIB_RTOL = 1e-5


def check(name: str, got: torch.Tensor, want: torch.Tensor,
          rtol: float = SUM_RTOL) -> tuple:
    """(passed, error): bit-equal, or for P8 within ``rtol`` of the
    output's scale."""
    from swarm_simulator_tpu_torch.ops.row_patterns import SUM_PATTERN

    if got.shape != want.shape:
        return False, float("inf")
    err = float((got - want).abs().max())
    if name == SUM_PATTERN:
        return err <= rtol * float(want.abs().max()), err
    return bool(torch.equal(got, want)), err


def run(dev, timed: bool) -> dict:
    from swarm_simulator_tpu_torch.ops import row_patterns as rp

    if timed:
        from swarm_simulator_tpu_torch.tools._timing import median_ms
    out = {}
    for name, ins in rp.pattern_inputs(dev).items():
        pat = rp.PATTERNS[name]
        got = rp.row_pattern(name, *ins)
        want = pat.plain(*ins)
        ok, err = check(name, got, want)
        r = dict(passed=ok, max_abs_err=err, library_passed=None)
        if pat.library:
            r["library_passed"] = check(name, pat.library(*ins), want,
                                        LIB_RTOL)[0]
        if timed:
            r["ms"] = median_ms(lambda: rp.row_pattern(name, *ins), 20)
            r["plain_ms"] = median_ms(lambda: pat.plain(*ins), 20)
            r["library_ms"] = (median_ms(lambda: pat.library(*ins), 20)
                               if pat.library else None)
        out[name] = r
        lib = {None: "", True: "; library call agrees",
               False: "; library call DISAGREES"}[r["library_passed"]]
        print(f"{'PASS' if ok else 'FAIL'}  {name}" + (
            f": kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
            if timed else "") + lib, file=sys.stderr, flush=True)
    return out


def agrees(r: dict) -> bool:
    """A pattern of run() matched its plain version, and so did its
    library call where it has one."""
    return r["passed"] and r["library_passed"] is not False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (no timing)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("row_patterns: needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    if args.cpu:
        out = dict(device="cpu", patterns=run(torch.device("cpu"), False))
    else:
        from swarm_simulator_tpu_torch.tools._timing import card

        dev = torch.device("cuda")
        out = dict(device=torch.cuda.get_device_name(dev), card=card())
        print(out["card"], file=sys.stderr, flush=True)
        out["patterns"] = run(dev, True)
    print(json.dumps(out))
    return 0 if all(map(agrees, out["patterns"].values())) else 1


if __name__ == "__main__":
    sys.exit(main())
