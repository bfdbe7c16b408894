"""The multi-card decompositions of the 64-agent forest over the ranks of a
torch.distributed group, at full problem shapes.

    python3 -m swarm_simulator_tpu_torch.tools.dryrun_multichip
        [--ranks N] [--cpu] [--mode chunk|blockrow|spike] [--seed 0]
        [--parts 1,2,3]

Run from the repository root (it takes the problem from chip_smoke.py).
By default one rank per CUDA card on ``nccl`` (raises without a card);
``--cpu`` runs N gloo ranks on the CPU (default 4), where the plain twins
stand in for the kernels.  On the cards the kernel libraries are built
once before the ranks start.  The three parts of the JAX package's
``__graft_entry__.dryrun_multichip``:

  1. ONE joint solve partitioned over the ranks
     (qp/nullspace_shard.solve_ns_phases_sharded, ``--mode``; spike needs
     2+ ranks and its own prep, prepare_spike_np) with the host-f64 rung
     inventory and the production phases, solved twice (the first solve
     carries the group's first-use costs, such as NCCL's communicator
     set-up; the second is the steady state), held to the acceptance gate
     and the objective pin;
  2. the Jacobi sequential-batch sweep over a (scenario, batch) grid of
     the ranks (parallel/mesh.grid_sweep; the grid by the JAX package's
     rule, parallel/mesh.factor): as many copies of the forest's 16 agent
     groups of 4 as the grid has rows, each rank assembling only its own
     groups; ADMM with the cg KKT, two rounds of (50, 25) iterations
     carrying the solver state; rank 0 then runs the one-process
     stacked_sweep of the whole stack and prints the largest difference;
  3. scenario-replicated joint banded solves: every rank solves the joint
     64-agent QP (device prep, NSSettings(max_iter=20, check_every=10,
     kkt_mode="banded", n_rungs=3): each chunk one launch of K1 on a card)
     and rank 0 gathers the solutions in one collective.

Prints a digest of the host problem's arrays (to tell whether two runs
solved the same inputs) and, per part, its shapes, iterations, seconds and
checks; exits non-zero if a check fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

#: part 2's sweep (the JAX package's dryrun): the cg KKT, two rounds of
#: (50, 25) iterations carrying the solver state
SWEEP_ROUNDS = 2
SWEEP_ITERS = (50, 25)
#: part 3's joint solves
REPLICA_SETTINGS = dict(max_iter=20, check_every=10, kkt_mode="banded",
                        n_rungs=3)


def sweep_settings():
    from swarm_simulator_tpu_torch.qp import admm

    return admm.ADMMSettings(max_iter=50, kkt_solver="cg")


def forest_groups(seed: int = 0):
    """The 64-agent forest of ``seed`` (chip_smoke's), its batches of 4 and
    the pair count every group's QP is padded to: (plan, mission, param,
    batches, pad, dummy)."""
    import chip_smoke
    from swarm_simulator_tpu_torch.parallel import seqbatch
    from swarm_simulator_tpu_torch.qp import assemble

    plan, mission, param, _ = chip_smoke.build_problem(seed)
    batches, _ = seqbatch.make_batches(
        mission.qn, dataclasses.replace(param, **chip_smoke.ORACLE_BATCHES))
    pairs = np.asarray(plan.pair_idx)
    pad = max(int(np.isin(pairs, b).any(axis=1).sum()) for b in batches)
    dummy = assemble.build_dummy(plan.init_traj, param.n, plan.M)
    return plan, mission, param, batches, pad, dummy


def copies(groups, dummy, n: int):
    """A (scenario, group) stack of ``n`` copies of one scenario's stacked
    groups, folded into one leading axis, with each group's scenario and
    the n dummies: (stacked [n G, ...], scen [n G], dummy [n, ...])."""
    from swarm_simulator_tpu_torch.parallel import mesh

    G = groups.lb.shape[0]
    stacked = mesh._leaves(groups, lambda x: torch.as_tensor(x).repeat(
        (n,) + (1,) * (x.ndim - 1)))
    scen = torch.arange(n).repeat_interleave(G)
    return stacked, scen, torch.as_tensor(np.asarray(dummy))[None].repeat(
        (n,) + (1,) * np.asarray(dummy).ndim)


def forest_share(grid, n_scenarios: int, seed: int):
    """A rank's share of part 2's stack: its row's copies of its column's
    groups of the forest, assembled on this rank alone."""
    from swarm_simulator_tpu_torch.parallel import distributed as pd
    from swarm_simulator_tpu_torch.parallel import seqbatch
    from swarm_simulator_tpu_torch.qp import assemble

    plan, mission, param, batches, pad, dummy = forest_groups(seed)
    mine = batches[pd.block(len(batches), grid.col, grid.n_batch)]
    groups = seqbatch._stack_qpdata([
        assemble.assemble_batch(plan, mission, param, b, dummy, pad)
        for b in mine])
    rows = pd.block(n_scenarios, grid.row, grid.n_scenario)
    return copies(groups, dummy, rows.stop - rows.start)


def stack_share(grid, n_scenarios: int, groups, dummy):
    """A rank's share of ``n_scenarios`` copies of the host stack ``groups``
    [G, ...]: its column's block of the groups (parallel/mesh.shard_stacked
    on the batch axis), copied for its row's block of the scenarios."""
    from swarm_simulator_tpu_torch.parallel import distributed as pd
    from swarm_simulator_tpu_torch.parallel import mesh

    mine = mesh.shard_stacked(groups, grid, ("batch",), device="cpu")
    rows = pd.block(n_scenarios, grid.row, grid.n_scenario)
    return copies(mine, dummy, rows.stop - rows.start)


def sweep_rank(share, args: tuple, n_scenarios: int, settings,
               rounds: int, sweep_kw: dict, grid_shape=(None, None)):
    """Rank worker of part 2: this rank's place in the (scenario, batch)
    grid of the default group (``grid_shape`` = (n_scenario, n_batch),
    None for the JAX package's rule), its share from ``share(grid,
    n_scenarios, *args)``, then mesh.grid_sweep.  Returns (ctrl [n, N, M,
    n+1, 3] float64 numpy, the grid's shape, the largest iteration count
    of this rank's groups, host seconds of the sweep ending in a device
    sync)."""
    from swarm_simulator_tpu_torch.parallel import distributed as pd
    from swarm_simulator_tpu_torch.parallel import mesh

    grid = pd.global_mesh(*grid_shape)
    stacked, scen, dummy = share(grid, n_scenarios, *args)
    dev = pd.group_device()
    stacked, scen, dummy = stacked.to(dev), scen.to(dev), dummy.to(dev)
    sync(dev)
    t0 = time.perf_counter()
    ctrl, info = mesh.grid_sweep(stacked, scen, dummy, settings, grid,
                                 n_scenarios, rounds, **sweep_kw)
    sync(dev)
    return (ctrl.double().cpu().numpy(), (grid.n_scenario, grid.n_batch),
            int(info.iters.max()), time.perf_counter() - t0)


def replica_rank(data, settings):
    """Rank worker of part 3: this rank's joint solve (solve_single_ns on
    its device), the solutions of all ranks gathered in one collective.
    Returns (x [n, B, 3, D] float64 numpy, this rank's iterations, host
    seconds ending in a device sync)."""
    from swarm_simulator_tpu_torch.parallel import distributed as pd
    from swarm_simulator_tpu_torch.qp import nullspace as ns

    dev = pd.group_device()
    sync(dev)
    t0 = time.perf_counter()
    x, info = ns.solve_single_ns(data, settings, device=dev)
    xs = pd.all_gather_tiled(x[None])
    sync(dev)
    return (xs.double().cpu().numpy(), int(info.iters),
            time.perf_counter() - t0)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def part1(args, n, backend, dev) -> bool:
    import chip_smoke
    from swarm_simulator_tpu_torch.eval.gate import gate_quality
    from swarm_simulator_tpu_torch.parallel import distributed as pd
    from swarm_simulator_tpu_torch.qp import convert, joint
    from swarm_simulator_tpu_torch.qp import nullspace as ns
    from swarm_simulator_tpu_torch.qp import nullspace_shard as shard

    t0 = time.perf_counter()
    plan, mission, param, _ = chip_smoke.build_problem(args.seed)
    phases = joint.production_phases()
    data, _ = joint.assemble_joint(plan, mission, param)
    op = (shard.prepare_spike_np(data, phases[0], n) if args.mode == "spike"
          else ns.prepare_ns_np(data, phases[0]))
    spike = args.mode == "spike"
    piv = op.Dloc if spike else op.Dinvs
    R, bs, Mi = piv.shape[0], piv.shape[-1], plan.M - 1
    print(f"part 1 problem: {mission.qn} agents, M={plan.M}, pairs "
          f"{len(plan.pair_idx)}, pivots {tuple(piv.shape)} {piv.dtype}; "
          f"host build and prep {time.perf_counter() - t0:.2f} s; inputs: "
          f"data {chip_smoke.digest(data)} pivots {chip_smoke.digest(piv)}",
          flush=True)
    per_rank = (piv[:, 0].nbytes + op.Ssch.nbytes + op.Soff.nbytes if spike
                else R * -(-Mi // n) * bs * bs * piv.itemsize
                if args.mode == "chunk"
                else R * Mi * (bs // n) * bs * piv.itemsize) / 1e6
    kkt = {"chunk": f"{2 * (n - 1)} point-to-point [{bs}] carries + 1 "
                    "all_gather",
           "blockrow": f"{2 * Mi - 1} all_gathers",
           "spike": "2 all_gathers"}[args.mode]
    t0 = time.perf_counter()
    solves = pd.run_ranks(shard.rank_solve_many, n,
                          [(data, phases, op, args.mode)] * 2,
                          backend=backend)
    call_s = time.perf_counter() - t0
    x, iters, r_prim, obj, _ = solves[-1]
    ctrl = convert.x_to_ctrl(x, plan.M, param.n)
    ok, metrics = gate_quality(ctrl, plan, mission, param, device=dev)
    print(f"part 1 sharded joint ({args.mode}, {n} {backend} ranks): pivot "
          f"inventory {per_rank:.1f} MB per rank; per KKT apply {kkt}, per "
          f"A^T y 1 all_reduce; iters {iters}, r_prim {r_prim:.3e}; "
          "objective of each solve "
          + ", ".join(f"{s[3]:.6f}" for s in solves) + "; solves "
          + ", ".join(f"{s[4]:.3f}" for s in solves) + " s host clock "
          f"({call_s:.3f} s with the ranks' start and placement)",
          flush=True)
    print("part 1 gate " + ("passed" if ok else "FAILED") + ": "
          + json.dumps({k: (float(v) if not isinstance(v, bool) else v)
                        for k, v in metrics.items()}), flush=True)
    return bool(ok and np.isfinite(obj) and obj < chip_smoke.OBJ_PIN)


def part2(args, n, backend, dev) -> bool:
    from swarm_simulator_tpu_torch.parallel import distributed as pd
    from swarm_simulator_tpu_torch.parallel import mesh

    a, b = mesh.factor(n)
    kw = dict(iters_schedule=SWEEP_ITERS, carry_state=True)
    t0 = time.perf_counter()
    ctrl, shape, iters, secs = pd.run_ranks(
        sweep_rank, n, forest_share, (args.seed,), a, sweep_settings(),
        SWEEP_ROUNDS, kw, backend=backend)
    call_s = time.perf_counter() - t0
    # the one-process sweep of the whole stack, on rank 0's device
    plan, mission, param, batches, pad, dummy = forest_groups(args.seed)
    from swarm_simulator_tpu_torch.parallel import seqbatch
    from swarm_simulator_tpu_torch.qp import assemble

    groups = seqbatch._stack_qpdata([
        assemble.assemble_batch(plan, mission, param, bb, dummy, pad)
        for bb in batches])
    stacked, scen, dm = copies(groups, dummy, a)
    sync(dev)
    t0 = time.perf_counter()
    want, _ = mesh.stacked_sweep(stacked.to(dev), scen.to(dev), dm.to(dev),
                                 sweep_settings(), SWEEP_ROUNDS, **kw)
    sync(dev)
    one_s = time.perf_counter() - t0
    gap = float(np.abs(ctrl - want.double().cpu().numpy()).max())
    ok = (ctrl.shape == (a, mission.qn, plan.M, param.n + 1, 3)
          and bool(np.isfinite(ctrl).all()) and shape == (a, b))
    print(f"part 2 (scenario, batch) grid {shape} over {n} {backend} ranks: "
          f"{a} scenarios x {len(batches)} groups of 4, ctrl "
          f"{list(ctrl.shape)}, finite {bool(np.isfinite(ctrl).all())}, "
          f"iters (last round, rank 0's groups) {iters}; sweep {secs:.3f} s "
          f"host clock ({call_s:.3f} s with the ranks' start and the host "
          f"builds); one-process stacked_sweep {one_s:.3f} s, largest "
          f"difference {gap:.3e}", flush=True)
    return ok


def part3(args, n, backend, dev) -> bool:
    import chip_smoke
    from swarm_simulator_tpu_torch.parallel import distributed as pd
    from swarm_simulator_tpu_torch.qp import joint
    from swarm_simulator_tpu_torch.qp import nullspace as ns

    plan, mission, param, _ = chip_smoke.build_problem(args.seed)
    data, _ = joint.assemble_joint(plan, mission, param)
    s = ns.NSSettings(**REPLICA_SETTINGS)
    t0 = time.perf_counter()
    xs, iters, secs = pd.run_ranks(replica_rank, n, data, s,
                                   backend=backend)
    call_s = time.perf_counter() - t0
    ok = (xs.shape[:2] == (n, mission.qn) and bool(np.isfinite(xs).all()))
    spread = float(np.abs(xs - xs[:1]).max())
    print(f"part 3 {n} scenario-replicated joint {mission.qn}-agent banded "
          f"solves ({backend}), x {list(xs.shape)}, finite "
          f"{bool(np.isfinite(xs).all())}, iters {iters}, largest "
          f"difference between replicas {spread:.3e}; {secs:.3f} s host "
          f"clock on rank 0 ({call_s:.3f} s with the ranks' start)",
          flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks (default: the CUDA card count, or 4 with "
                         "--cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU instead of nccl on the cards")
    ap.add_argument("--mode", default="chunk",
                    choices=("chunk", "blockrow", "spike"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="1,2,3",
                    help="comma-separated parts to run (1, 2, 3)")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("dryrun_multichip: no CUDA card (pass --cpu for gloo ranks "
              "on the CPU)", file=sys.stderr)
        return 2
    backend = "gloo" if args.cpu else "nccl"
    n = args.ranks or (4 if args.cpu else torch.cuda.device_count())
    dev = torch.device("cpu" if args.cpu else "cuda")
    if args.mode == "spike" and n < 2:
        print("dryrun_multichip: --mode spike needs 2+ ranks",
              file=sys.stderr)
        return 2
    if not args.cpu:
        from swarm_simulator_tpu_torch.ops import _build

        _build.build("thomas", "nsfused")
    ok = True
    for p in args.parts.split(","):
        ok &= {"1": part1, "2": part2, "3": part3}[p.strip()](
            args, n, backend, dev)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
