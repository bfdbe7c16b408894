"""ONE joint solve of the 64-agent forest partitioned over the ranks of a
torch.distributed group, held to the acceptance gate.

    python3 -m swarm_simulator_tpu_torch.tools.dryrun_multichip
        [--ranks N] [--cpu] [--mode chunk|blockrow] [--seed 0]

Run from the repository root (it takes the problem from chip_smoke.py).
Builds the canonical 64-agent forest (20 obstacles), preps its rung
inventory on the host in float64 (rounded to float32), and runs
qp/nullspace_shard.solve_ns_phases_sharded with the production phases
over N ranks: by default one rank per CUDA card on ``nccl`` (raises
without a card); ``--cpu`` runs N gloo ranks on the CPU (default 4),
where the plain twins stand in for the kernels.  On the cards the kernel
library is built once before the ranks start.  Each rank places its share
and solves twice: the first solve carries the group's first-use costs,
such as NCCL's communicator set-up, the second is the steady state.
Prints a digest of the host problem's arrays (to tell whether two runs
solved the same inputs), the pivot bytes per rank, the collectives
per KKT apply, the iterations, objective and host seconds of each solve,
and the gate's metrics on the second solution; exits non-zero if the
gate fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks (default: the CUDA card count, or 4 with "
                         "--cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU instead of nccl on the cards")
    ap.add_argument("--mode", default="chunk", choices=("chunk", "blockrow"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("dryrun_multichip: no CUDA card (pass --cpu for gloo ranks "
              "on the CPU)", file=sys.stderr)
        return 2
    backend = "gloo" if args.cpu else "nccl"
    n = args.ranks or (4 if args.cpu else torch.cuda.device_count())
    dev = torch.device("cpu" if args.cpu else "cuda")

    import chip_smoke
    from swarm_simulator_tpu_torch.eval.gate import gate_quality
    from swarm_simulator_tpu_torch.ops import _build
    from swarm_simulator_tpu_torch.parallel import distributed as pd
    from swarm_simulator_tpu_torch.qp import convert, joint
    from swarm_simulator_tpu_torch.qp import nullspace as ns
    from swarm_simulator_tpu_torch.qp import nullspace_shard as shard

    t0 = time.perf_counter()
    plan, mission, param, _ = chip_smoke.build_problem(args.seed)
    phases = joint.production_phases()
    data, _ = joint.assemble_joint(plan, mission, param)
    op = ns.prepare_ns_np(data, phases[0])
    R, Mi, bs = op.Dinvs.shape[0], op.Dinvs.shape[1], op.Dinvs.shape[-1]
    print(f"problem: {mission.qn} agents, M={plan.M}, pairs "
          f"{len(plan.pair_idx)}, pivots {tuple(op.Dinvs.shape)} "
          f"{op.Dinvs.dtype}; host build and prep "
          f"{time.perf_counter() - t0:.2f} s; inputs: data "
          f"{chip_smoke.digest(data)} pivots {chip_smoke.digest(op)}",
          flush=True)

    L = -(-Mi // n)
    per_rank = (R * L * bs * bs if args.mode == "chunk"
                else R * Mi * (bs // n) * bs) * op.Dinvs.itemsize / 1e6
    kkt = (f"{2 * (n - 1)} point-to-point [{bs}] carries + 1 all_gather"
           if args.mode == "chunk" else f"{2 * Mi - 1} all_gathers")
    if not args.cpu:
        _build.build("thomas")
    t0 = time.perf_counter()
    solves = pd.run_ranks(shard.rank_solve_many, n,
                          [(data, phases, op, args.mode)] * 2,
                          backend=backend)
    call_s = time.perf_counter() - t0
    x, iters, r_prim, obj, _ = solves[-1]

    ctrl = convert.x_to_ctrl(x, plan.M, param.n)
    ok, metrics = gate_quality(ctrl, plan, mission, param, device=dev)
    print(f"dryrun_multichip sharded joint ({args.mode}, {n} {backend} "
          f"ranks): pivot inventory {per_rank:.1f} MB per rank; per KKT "
          f"apply {kkt}, per A^T y 1 all_reduce; iters {iters}, r_prim "
          f"{r_prim:.3e}; objective of each solve "
          + ", ".join(f"{s[3]:.6f}" for s in solves) + "; solves "
          + ", ".join(f"{s[4]:.3f}" for s in solves) + " s host clock "
          f"({call_s:.3f} s with the ranks' start and placement)",
          flush=True)
    print("gate " + ("passed" if ok else "FAILED") + ": " + json.dumps(
        {k: (float(v) if not isinstance(v, bool) else v)
         for k, v in metrics.items()}), flush=True)
    return 0 if ok and obj < chip_smoke.OBJ_PIN and np.isfinite(obj) else 1


if __name__ == "__main__":
    sys.exit(main())
