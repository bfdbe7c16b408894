"""How the chunked device prep rounds on the card, and what that moves.

    python3 -m swarm_simulator_tpu_torch.tools.prep_batch_study
        [--against ROOT]

Run from the repository root (it takes phase 20's problem from
chip_smoke.py).  Prints one JSON object a line:

- ``ops``: each batched operation of the prep (torch.linalg.inv,
  lu_factor, solve_triangular, matmul, the Newton step) on 28 seeded
  well-conditioned matrices (a chunk of 4 entries x 7 rungs) against the
  same operation on their first 7 (one entry alone), at the banded
  inventory's 36 x 36 in float32 and the dense one's 1260 x 1260 in
  float64: the largest gap relative to the result's scale, and
  torch.linalg.inv's at batches of 8 to 28;
- ``preps``: phase 20's 16 groups of 4 prepared by prepare_ns_stack in
  chunks of 4 and of 16 against each group's prepare_ns alone (and, with
  ``--against``, against that checkout's prepare_ns), each NSOp leaf's
  largest relative gap over the groups, banded float32 and dense float64;
- ``sweeps``: phase 20's two-round Jacobi sweep in each mode with the
  chunked preps, with the one-group preps in their place (and the other
  checkout's preps, and that checkout's own sweep): the safety ratio of
  the time-scaled plan and the seconds.

Without a CUDA card it exits 2.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import sys
import time
from unittest import mock

import numpy as np
import torch


def op_gaps(dev) -> list[dict]:
    """The ``ops`` lines."""
    out = []
    g = torch.Generator().manual_seed(0)
    for dtype, n in ((torch.float32, 36), (torch.float64, 1260)):
        X = torch.randn(28, n, n, generator=g, dtype=torch.float64)
        A = (X @ X.mT / n + torch.eye(n, dtype=torch.float64)).to(
            device=dev, dtype=dtype)
        eye = torch.eye(n, dtype=dtype, device=dev)
        U = torch.triu(A) + n * eye

        def gap(f, k=28):
            a, b = f(A[:7]), f(A[:k])[:7]
            return float((a - b).abs().max() / b.abs().max())

        ops = {
            "linalg.inv": torch.linalg.inv,
            "linalg.lu_factor": lambda M: torch.linalg.lu_factor(M)[0],
            "linalg.solve_triangular": lambda M: (
                torch.linalg.solve_triangular(U[:M.shape[0]],
                                              eye.expand_as(M), upper=True)),
            "matmul": lambda M: M @ M,
            "Newton step X (2I - S X)": lambda M: M @ (2 * eye - M @ M),
        }
        rel = {name: gap(f) for name, f in ops.items()}
        rel["linalg.inv, batch 7 of k"] = {
            k: gap(torch.linalg.inv, k) for k in (8, 9, 12, 14, 16, 28)}
        out.append({"ops": str(dtype), "n": n, "rel_gap": rel})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="ROOT",
                    help="another checkout whose prepare_ns and sweep "
                         "are run beside this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prep_batch_study: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from swarm_simulator_tpu_torch.ops import _build
    from swarm_simulator_tpu_torch.parallel import mesh
    from swarm_simulator_tpu_torch.qp import nullspace as ns
    from swarm_simulator_tpu_torch.tools._timing import card

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"card": card()}), flush=True)
    for line in op_gaps(dev):
        print(json.dumps(line), flush=True)
    _build.build("nsfused", "nsfused_stack")
    other = None
    if args.against:
        from swarm_simulator_tpu_torch.tools.chain_bench import load_checkout

        load_checkout(args.against, "prep_batch_other")
        other = (importlib.import_module("prep_batch_other.qp.nullspace"),
                 importlib.import_module("prep_batch_other.parallel.mesh"))
    plan, mission, param, _ = chip_smoke.build_problem(0)
    stacked, dummy = chip_smoke.jacobi_stack(plan, mission, param)
    for mode, dtype in (("banded", np.float32), ("dense", np.float64)):
        s = ns.NSSettings(kkt_mode=mode, tighten=chip_smoke.JACOBI_TIGHTEN)
        host = dataclasses.replace(stacked, **{
            f.name: np.asarray(getattr(stacked, f.name), dtype)
            for f in dataclasses.fields(stacked)
            if np.asarray(getattr(stacked, f.name)).dtype.kind == "f"})
        data = host.to(dev)
        datas = [dataclasses.replace(data, **{
            f.name: getattr(data, f.name)[g]
            for f in dataclasses.fields(data)
            if getattr(data, f.name) is not None})
            for g in range(data.lb.shape[0])]
        preps = {"one group": [ns.prepare_ns(d, s) for d in datas],
                 "chunks of 4": ns.prepare_ns_stack(data, s, 4),
                 "chunks of 16": ns.prepare_ns_stack(data, s, 16)}
        if other:
            so = other[0].NSSettings(kkt_mode=mode,
                                     tighten=chip_smoke.JACOBI_TIGHTEN)
            preps["other checkout"] = [other[0].prepare_ns(d, so)
                                       for d in datas]

        def gaps(a, b):
            out = {}
            for f in ns.NSOp._fields:
                if getattr(a[0], f) is None:
                    continue
                out[f] = max(
                    float((getattr(u, f).double() - getattr(v, f).double())
                          .abs().max())
                    / max(float(getattr(v, f).double().abs().max()), 1e-300)
                    for u, v in zip(a, b))
            return out

        print(json.dumps({"preps": mode, "dtype": np.dtype(dtype).name,
                          "rel_gap_to_one_group": {
                              k: gaps(v, preps["one group"])
                              for k, v in preps.items()
                              if k != "one group"}}), flush=True)
        # this checkout's sweep with each set of preps in its prep's
        # place, then the other checkout's own sweep
        runs = {k: (mesh, s, mock.patch.object(ns, "prepare_ns_stack",
                                               lambda *a, _o=v: _o))
                for k, v in preps.items()}
        if other:
            runs["other checkout's sweep"] = (other[1], so,
                                              contextlib.nullcontext())
        for name, (m, sw, patch) in runs.items():
            with patch:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                c, _ = m.jacobi_sweep(host, dummy.astype(dtype), sw,
                                      rounds=2, device=dev)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            ratio = chip_smoke.plan_metrics(
                plan, mission, param, c.double().cpu().numpy(),
                dev)["min_safety_ratio"]
            print(json.dumps({"sweeps": mode, "preps": name,
                              "ratio": ratio, "s": secs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
