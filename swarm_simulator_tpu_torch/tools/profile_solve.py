"""Profile the phased solve of the 64-agent forest on one CUDA card.

    python3 -m swarm_simulator_tpu_torch.tools.profile_solve [--seed 0]
        [--refine | --sharded | --scatter AGENTS | --seqbatch MODE
         | --routes AGENTS | --stack {banded,dense} [--trace] | --kkt]

Run from the repository root (it takes the problem from chip_smoke.py).
Builds the problem and its rung inventory once, runs the production
phased solve once to warm up, once more unprofiled, then once under
torch.profiler, and prints: the solves' wall times (host clock, ending in
a device sync), the device time the profiler saw, the device-busy share
(device time / wall time of the profiled run and of the unprofiled
second run; one stream, so kernels do not overlap), the shares of the
device time of the fused chunk kernel (K1), the Thomas solve kernel
(K2), the chunked sweeps K3a and K3b and the rest (torch operations and
copies), the device spans of the NCCL collectives, the host time per
iteration (wall time over iterations), the device entries (kernels and
copies) per iteration, and the tables of the costliest device and host
entries.

Without an option: the cold solve (host-f64 prep, kkt_refine=0, one K1
launch per chunk).  With ``--refine``: the refine path of replans and
device-prep cold plans (device prep, kkt_refine=1, three K2 launches and
the PCG's torch operations per iteration).  With ``--sharded``: the
sharded joint solve (qp/nullspace_shard, chunk mode, host-f64 prep) on a
1-rank NCCL group, one K3a and one K3b launch per iteration.  With
``--scatter AGENTS``: the refine solve of the big-swarm route instead,
on the scatter problem of tools/budget256_study.py (device prep, float32
pivots): first the median CUDA-event time of one refine iteration and of
its parts (the PCG w-update, one inventory solve through K2, A x and
A^T y of the constraint rows), printed as they are measured, then the
profile of a 150-iteration schedule, budgets (50, 50, 50).  With
``--seqbatch MODE``: the sequential-batch ADMM solve
(parallel/seqbatch.solve_trajectories, ``Param.solver="admm"``) of the
64-agent forest in one of chip_smoke.py's SEQ_RUNS modes (gauss-seidel,
jacobi, default) in float32, each batch solve capped at 200 iterations;
its iterations are those run one after another (a Jacobi round's stacked
batches count once, at the most any of them ran).  With ``--routes
AGENTS``: no profile; the host-prepped production solve of the scatter
problem of tools/budget256_study.scatter_config(AGENTS) (chip_smoke.py
phase 21b's, 96 agents there) through both KKT routes of
joint.select_kkt_path, K1 (one fused chunk a check) and the K2 route
(``thomas_kernel``: each w-update one K2 solve), each also with its
float32 twin and with a float64 twin in the kernel's place: the
objective, the objective of each batch of 4 agents, the rung and the
residuals after every chunk (the rung walk), each kernel route's error
against its float64 twin beside its float32 twin's (thomas.twin_gap_use,
the twin rule), and the first chunk where two runs' rungs part.  With
``--stack MODE``: no profile; chip_smoke.py phase 20's knot-state Jacobi
sweep (the 64-agent forest's 16 groups of 4, two rounds, banded in
float32 or dense in float64) once to warm up, once timed, then once split
by part: each call of the functions below timed on the host clock with a
device sync at both ends (a call inside another timed call counts in the
outer one), so the parts and the rest add up to the split run's wall
time, which the syncs stretch a little: the preps (prepare_ns_stack, or
prepare_ns an entry), the stack operands (the cold states, the kernel's
and the plain parts' stacked operands, the rung walks' set-up), the
chunks (nsfused_stack launches, _dense_stack_chunk, or admm_steps of a
per-entry loop), the residual pass (RungWalk.test), the rung walk
(RungWalk.step), refresh and write-back (refresh_from_dummy,
RungWalk.finish, stack_solves); the rest (the loop itself, the host
syncs' reads, the dummy's write-back) is the remainder.  It names only
functions that earlier checkouts have too, so a copy of this file over
an earlier checkout's splits that checkout's sweep.  ``--trace`` adds a
sweep under torch.profiler (device activity only) for the device's busy
time, the union of its operations' intervals (swarmbench/trace.union,
so overlapping operations count once), and its share of the sweep.  With
``--kkt``: no profile; the dense KKT prep of the batch ADMM alone
(qp/admm._prepare_stack, ``kkt_chunk`` 4, as parallel/mesh.stacked_sweep
calls it) on a swap-shaped stack (``kkt_stack``: 256 problems of 4
agents over 32 segments, 22 pair rows, float64), timed with CUDA events
(5 calls after one untimed), with the peak of torch.cuda's allocated
memory over the calls, the block route's operations and bytes once (its
inverses written, its problems read) and its bound, max(bytes / 3.35
TB/s, operations / 67 TFLOP/s float64), and the inverses held to the
structured K (cg's operator) on random vectors.  It names only functions
that earlier checkouts have too, so a copy of this file over an earlier
checkout times that checkout's prep.  The JSON is the last line of
stdout.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--refine", action="store_true",
                      help="profile the device-prep kkt_refine=1 solve")
    mode.add_argument("--sharded", action="store_true",
                      help="profile the sharded chunk-mode solve on a "
                           "1-rank NCCL group")
    mode.add_argument("--scatter", type=int, metavar="AGENTS",
                      help="profile the refine solve of the AGENTS-agent "
                           "scatter problem (tools/budget256_study.py)")
    mode.add_argument("--routes", type=int, metavar="AGENTS",
                      help="solve the AGENTS-agent scatter problem through "
                           "K1 and the K2 route and their twins, and "
                           "compare them chunk by chunk")
    mode.add_argument("--seqbatch",
                      choices=["gauss-seidel", "jacobi", "default"],
                      help="profile the sequential-batch ADMM solve in "
                           "this mode of chip_smoke.SEQ_RUNS")
    mode.add_argument("--stack", choices=["banded", "dense"],
                      help="split phase 20's knot-state Jacobi sweep in "
                           "this KKT mode by part")
    mode.add_argument("--kkt", action="store_true",
                      help="time the dense KKT prep of a swap-shaped "
                           "stack of batch QPs")
    ap.add_argument("--trace", action="store_true",
                    help="with --stack: one more sweep under torch.profiler "
                         "for the device time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_solve: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if args.kkt:
        return kkt_prep(args.seed, dev)
    import chip_smoke
    from swarm_simulator_tpu_torch.qp import joint, nullspace as ns

    if args.routes:
        return routes(args.routes, dev)
    if args.stack:
        return stack_split(args.stack, args.seed, args.trace, dev)
    if args.scatter:
        from swarm_simulator_tpu_torch.tools import budget256_study as bud

        _, _, _, data = bud.build_problem(args.scatter)
        base = bud.base_settings(1, False)
        d = data.to(dev)
        o = bud.prepare(d, base)
        refine_parts(d, o, base)
        sched = ns.schedule_arrays(bud.phases(base, (50, 50, 50)))
        return profile_run(lambda: timed_solve(d, o, sched))
    plan, mission, param, _ = chip_smoke.build_problem(args.seed)
    if args.seqbatch:
        return profile_run(lambda: seq_solve(plan, mission, args.seqbatch))
    phases = joint.production_phases(kkt_refine=int(args.refine))
    s0, it_k, lo_k, hi_k = ns.schedule_arrays(phases)
    data, _ = joint.assemble_joint(plan, mission, param)
    if args.sharded:
        from swarm_simulator_tpu_torch.parallel import distributed as pd
        from swarm_simulator_tpu_torch.qp import nullspace_shard as shard

        op = ns.prepare_ns_np(data, phases[0])

        def run_sharded():
            d, o = shard.place(data, op)

            def solve():
                t0 = time.perf_counter()
                _, info = shard.solve_ns_phases_sharded(d, phases, o)
                torch.cuda.synchronize()
                return time.perf_counter() - t0, int(info.iters)

            return profile_run(solve)

        return pd.run_ranks(run_sharded, 1, backend="nccl")
    d = data.to(dev)
    o = (ns.prepare_ns(d, phases[0]) if args.refine
         else ns.prepare_ns_np(data, phases[0]).to(dev))
    return profile_run(lambda: timed_solve(d, o, (s0, it_k, lo_k, hi_k)))


def routes(agents: int, dev) -> int:
    """--routes: the scatter problem's solve through K1 and the K2 route,
    each through its kernel, its float32 twin and a float64 twin; prints
    one line a run and the JSON summary."""
    import json
    from unittest import mock

    import numpy as np

    import chip_smoke
    from swarm_simulator_tpu_torch.corridor.times import build_corridors
    from swarm_simulator_tpu_torch.ops import nsfused, thomas
    from swarm_simulator_tpu_torch.qp import joint, nullspace as ns
    from swarm_simulator_tpu_torch.search.planner import \
        plan_initial_trajectories
    from swarm_simulator_tpu_torch.tools import budget256_study as bud
    from swarm_simulator_tpu_torch.tools._timing import card
    from swarm_simulator_tpu_torch.world.esdf import ESDF

    mission, param, world = bud.scatter_config(agents)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param, dev)
    phases = joint.production_phases()
    data, _ = joint.assemble_joint(plan, mission, param)
    op = ns.prepare_ns_np(data, phases[0])
    ph = {"K1": phases, "K2": tuple(dataclasses.replace(p, thomas_kernel=True)
                                    for p in phases)}
    twins = {"nsfused_chunk": nsfused.nsfused_chunk_reference,
             "thomas_solve": thomas.thomas_solve_reference}
    walk_step = ns.RungWalk.step
    runs = {}
    for route in ("K1", "K2"):
        for form, dtype in (("kernel", torch.float32),
                            ("float32 twin", torch.float32),
                            ("float64 twin", torch.float64)):
            d, o = chip_smoke.on_device(data, op, dev, dtype)
            walk = []

            def step(self, vals, rho_idx, lo, hi, _walk=walk):
                done, nxt = walk_step(self, vals, rho_idx, lo, hi)
                _walk.append((int(rho_idx), float(vals[0]), float(vals[1])))
                return done, nxt

            launches = (nsfused.nsfused_chunk.launches,
                        thomas.thomas_solve.launches)
            with contextlib.ExitStack() as stack:
                stack.enter_context(mock.patch.object(ns.RungWalk, "step",
                                                      step))
                if form != "kernel":
                    for name, f in twins.items():
                        stack.enter_context(mock.patch.object(
                            nsfused if name == "nsfused_chunk" else thomas,
                            name, f))
                t0 = time.perf_counter()
                x, info = ns.solve_ns_phases(d, ph[route], op=o, device=dev)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            per_agent = 0.5 * (x * ns._apply_Qseg(d.Qseg, x)).sum(dim=(1, 2))
            batches = per_agent.reshape(-1, 4).sum(1).double().cpu().numpy()
            runs[route, form] = r = dict(
                x=x.double(), obj=float(info.obj), iters=int(info.iters),
                r_prim=float(info.r_prim), secs=secs, walk=walk,
                batches=batches.tolist(),
                launches=(nsfused.nsfused_chunk.launches - launches[0],
                          thomas.thomas_solve.launches - launches[1]))
            print(f"{route} {form}: objective {r['obj']:.6f}, iters "
                  f"{r['iters']}, r_prim {r['r_prim']:.3e}, {secs:.2f} s, "
                  f"launches K1/K2 {r['launches']}, rungs "
                  f"{[w[0] for w in walk]}", flush=True)
    out = {"card": card(), "agents": agents, "M": plan.M,
           "pairs": len(plan.pair_idx), "runs": {}, "twin_rule": {},
           "parting": {}}
    for (route, form), r in runs.items():
        out["runs"][f"{route} {form}"] = {k: v for k, v in r.items()
                                          if k != "x"}
    for route in ("K1", "K2"):
        ref = runs[route, "float64 twin"]["x"]
        ek = thomas.rel_error(runs[route, "kernel"]["x"], ref)
        et = thomas.rel_error(runs[route, "float32 twin"]["x"], ref)
        out["twin_rule"][route] = dict(
            kernel_vs_f64=ek, f32_twin_vs_f64=et,
            use=thomas.twin_gap_use([ek], [et]))
    names = list(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            wa, wb = ([w[0] for w in runs[k]["walk"]] for k in (a, b))
            part = next((c for c, (u, v) in enumerate(zip(wa, wb)) if u != v),
                        None if len(wa) == len(wb) else min(len(wa), len(wb)))
            out["parting"][f"{' '.join(a)} / {' '.join(b)}"] = part
    for route, v in out["twin_rule"].items():
        print(f"{route}: x rel err kernel vs float64 twin "
              f"{v['kernel_vs_f64']:.3e}, float32 twin vs float64 twin "
              f"{v['f32_twin_vs_f64']:.3e}, share of the twin rule "
              f"{v['use']:.2f}", flush=True)
    b1 = np.asarray(runs["K1", "kernel"]["batches"])
    b2 = np.asarray(runs["K2", "kernel"]["batches"])
    print("per batch of 4, K1 / K2 route (kernels): " + " ".join(
        f"{u:.4f}/{v:.4f}" for u, v in zip(b1, b2)), flush=True)
    print(json.dumps(out), flush=True)
    return 0


def stack_split(mode: str, seed: int, trace: bool, dev) -> int:
    """--stack: phase 20's sweep in ``mode`` timed, then split by part;
    prints a line of the split and the JSON summary."""
    import functools
    import json
    from unittest import mock

    import numpy as np

    import chip_smoke
    from swarm_simulator_tpu_torch.ops import nsfused
    from swarm_simulator_tpu_torch.parallel import mesh
    from swarm_simulator_tpu_torch.qp import assemble, nullspace as ns
    from swarm_simulator_tpu_torch.tools._timing import card
    from swarm_simulator_tpu_torch.utils import timing

    plan, mission, param, _ = chip_smoke.build_problem(seed)
    stacked, dummy = chip_smoke.jacobi_stack(plan, mission, param)
    dtype = np.float32 if mode == "banded" else np.float64
    data = dataclasses.replace(stacked, **{
        f.name: np.asarray(getattr(stacked, f.name), dtype)
        for f in dataclasses.fields(stacked)
        if np.asarray(getattr(stacked, f.name)).dtype.kind == "f"})
    s = ns.NSSettings(kkt_mode=mode, tighten=chip_smoke.JACOBI_TIGHTEN)

    def sweep():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, info = mesh.jacobi_sweep(data, dummy.astype(dtype), s, rounds=2,
                                    device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, info.iters.tolist()

    first_s, _ = sweep()
    # the stack loop's host syncs, where the checkout has the recorder
    recording = getattr(timing, "recording", None)
    with recording() if recording else contextlib.nullcontext() as rec:
        plain_s, iters = sweep()
    syncs = rec.counters.get("solve.syncs", 0) if rec else None
    parts = {
        "preps": [(ns, "prepare_ns_stack"), (ns, "prepare_ns")],
        "stack operands": [(ns, "_cold_state"), (ns, "cold_chunk_inputs"),
                           (ns, "stack_parts"), (ns, "stack_states"),
                           (nsfused, "build_operands"),
                           (nsfused, "stack_operands"),
                           (ns.RungWalk, "__init__")],
        "chunks": [(nsfused, "nsfused_stack"), (ns, "_dense_stack_chunk"),
                   (ns, "admm_steps")],
        "residual pass": [(ns.RungWalk, "test")],
        "rung walk": [(ns.RungWalk, "step")],
        "refresh and write-back": [(assemble, "refresh_from_dummy"),
                                   (ns.RungWalk, "finish"),
                                   (ns, "stack_solves")]}
    acc = {p: [0.0, 0] for p in parts}
    depth = [0]

    def timed(part, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                acc[part][0] += time.perf_counter() - t0
                acc[part][1] += 1
                depth[0] -= 1
        return run

    with contextlib.ExitStack() as stack:
        for part, names in parts.items():
            for owner, name in names:
                if name in vars(owner):
                    stack.enter_context(mock.patch.object(
                        owner, name, timed(part, getattr(owner, name))))
        split_s, _ = sweep()
    split = {p: {"s": v[0], "calls": v[1]} for p, v in acc.items()}
    rest = split_s - sum(v[0] for v in acc.values())
    out = {"card": card(), "mode": mode, "dtype": np.dtype(dtype).name,
           "first_s": first_s, "sweep_s": plain_s, "split_sweep_s": split_s,
           "last_round_iters": iters, "stack_loop_syncs": syncs,
           "split": split, "rest_s": rest}
    if trace:
        from swarmbench.trace import union

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced_s, _ = sweep()
        # busy: the union of the device operations' intervals, so that
        # operations which overlap count once
        busy_ns = sum(b - a for a, b in union([
            (e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if "cuda" in str(e.device_type()).lower()]))
        out.update(traced_sweep_s=traced_s, device_s=busy_ns / 1e9,
                   device_busy=busy_ns / 1e9 / traced_s)
    print(f"stack sweep {mode} ({out['card']}): first {first_s:.3f} s, "
          f"timed {plain_s:.3f} s, split run {split_s:.3f} s = " + ", ".join(
              f"{p} {v['s']:.3f} s ({v['calls']} calls)"
              for p, v in split.items()) + f", rest {rest:.3f} s"
          + (f"; device {out['device_s']:.3f} s, busy "
             f"{100 * out['device_busy']:.1f}% of {out['traced_sweep_s']:.3f}"
             " s" if trace else ""), flush=True)
    print(json.dumps(out), flush=True)
    return 0


def kkt_stack(L: int, M: int, B: int, seed: int = 0, device=None,
              swarm: int = 8):
    """A stack of ``L`` batch QPs of ``B`` agents of a ``swarm`` over ``M``
    segments (n 5, phi 3; random durations, boxes and plane normals), as
    the swap cell's groups are shaped: the batch's pairs two-sided, its
    pairs with the rest of the swarm one-sided; float64 leaves on
    ``device``."""
    import numpy as np

    from swarm_simulator_tpu_torch.core import bernstein
    from swarm_simulator_tpu_torch.qp import assemble

    rng = np.random.default_rng(seed)
    n, phi = 5, 3
    D = M * (n + 1)
    pairs = [(i, j) for i in range(swarm) for j in range(i + 1, swarm)
             if i < B]
    P = len(pairs)
    bi = np.array([i for i, _ in pairs], np.int32)
    bj = np.array([j if j < B else -1 for _, j in pairs], np.int32)
    leaves = {k: [] for k in ("Qseg", "Aeq", "lb", "pair_n", "dt")}
    for _ in range(L):
        T = np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 1.5, M))])
        dt = np.diff(T)
        leaves["Qseg"].append(bernstein.derivative_cost_matrix(n, phi)[None]
                              * (dt ** (1 - 2 * phi))[:, None, None])
        leaves["Aeq"].append(assemble.build_aeq(T, n, phi))
        leaves["lb"].append(rng.uniform(-3.0, -1.0, (B, 3, D)))
        normals = rng.standard_normal((P, M, 3))
        leaves["pair_n"].append(
            normals / np.linalg.norm(normals, axis=-1, keepdims=True))
        leaves["dt"].append(dt)
    st = {k: np.stack(v) for k, v in leaves.items()}
    Re = st["Aeq"].shape[1]
    return assemble.QPData(
        Qseg=st["Qseg"], Aeq=st["Aeq"],
        deq=rng.standard_normal((L, B, 3, Re)), lb=st["lb"],
        ub=st["lb"] + rng.uniform(2.0, 4.0, (L, B, 3, D)),
        pair_bi=np.tile(bi, (L, 1)), pair_bj=np.tile(bj, (L, 1)),
        pair_n=st["pair_n"], pair_rhs=rng.uniform(0.2, 0.4, (L, P, D)),
        pair_mask=np.ones((L, P)), x0=rng.standard_normal((L, B, 3, D)),
        agents=np.tile(np.arange(B, dtype=np.int32), (L, 1)),
        pair_qi=np.tile(np.array([i for i, _ in pairs], np.int32), (L, 1)),
        pair_qj=np.tile(np.array([j for _, j in pairs], np.int32), (L, 1)),
        pair_rsum=np.full((L, P), 0.24), dt=st["dt"]).to(device)


def block_inverse_work(L: int, M: int, B: int, npp: int = 6):
    """(operations, bytes once) of the block route's L inverses: per
    segment the S update, Cholesky, L^-1, G and F blocks ([b, b] work, b =
    3 B npp) and the [b, b] x [b, nx] products (forward from the second
    segment, backward one or two); the inverses written once and the
    problems' base and coupling read once, in float64."""
    b = 3 * B * npp
    nx = M * b
    blocks = M * (b ** 3 / 3 + b ** 3) + (M - 1) * (
        4 * b ** 3 + 2 * b * b * npp)
    slabs = (3 * M - 2) * 2 * b * b * nx
    data = (M * npp) ** 2 + M * (3 * B) ** 2
    return L * (blocks + slabs), 8 * L * (nx * nx + data)


def kkt_prep(seed: int, dev, L: int = 256, M: int = 32, B: int = 4) -> int:
    """--kkt: the dense KKT prep of a swap-shaped stack timed alone; prints
    a line and the JSON summary."""
    import json

    from swarm_simulator_tpu_torch.qp import admm
    from swarm_simulator_tpu_torch.tools._timing import card, event_ms

    data = kkt_stack(L, M, B, seed, dev)
    s = admm.ADMMSettings(kkt_solver="dense")
    prep = lambda: admm._prepare_stack(data, s, 4)  # noqa: E731
    sdata, _, op = prep()
    # the inverses against the structured K of the same scaled problems
    parts = admm.build_kkt_operator(
        sdata, dataclasses.replace(s, kkt_solver="cg"))
    x = torch.randn((L, B, 3, M * 6), dtype=torch.float64, device=dev,
                    generator=torch.Generator(dev).manual_seed(seed))
    kx = admm._kkt_matvec(parts, parts.base0 + s.rho * parts.base1,
                          s.rho * parts.coupling, x)
    back = torch.bmm(op.Kinv, kx.reshape(L, -1, 1)).view(x.shape)
    err = float(((back - x).abs().amax((1, 2, 3))
                 / x.abs().amax((1, 2, 3))).max())
    del sdata, op, parts, kx, back
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = event_ms(prep, reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    ops, nbytes = block_inverse_work(L, M, B)
    bound_ms = 1e3 * max(nbytes / 3.35e12, ops / 67e12)
    out = {"card": card(), "L": L, "M": M, "B": B, "ms": ms,
           "median_ms": sorted(ms)[len(ms) // 2], "peak_bytes": peak,
           "operations": ops, "bytes": nbytes, "bound_ms": bound_ms,
           "max_rel_err": err}
    print(f"kkt prep ({out['card']}): {out['median_ms']:.2f} ms median of "
          f"{ms}, peak {peak / 1e9:.3f} GB, bound {bound_ms:.2f} ms "
          f"({ops:.3e} operations, {nbytes:.3e} bytes), inverses against "
          f"K on random vectors: {err:.2e}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


def refine_parts(d, o, s, rho_idx: int = 2, reps: int = 10) -> None:
    """Median CUDA-event ms of one refine iteration (admm_steps with one
    inner step) and of its parts, from the cold state at rung ``rho_idx``;
    each line is printed as soon as it is measured."""
    import numpy as np

    from swarm_simulator_tpu_torch.qp import nullspace as ns

    pop, l, u, (w, z, y) = ns._cold_state(d, o, s)
    cop = ns.constr_op(pop)
    B, K3, _ = d.lb.shape
    kinv = ns.make_kinv_apply(o, B, K3, o.F0.shape[0], o.F0.shape[1])
    w_update = ns.pcg_w_update(d, o, cop, s, kinv, rho_idx)
    rho = o.ladder[rho_idx]
    x = ns._x_of(o, w)
    parts = {
        "refine iteration": lambda: ns.admm_steps(
            o, cop, l, u, rho_idx, s.sigma, s.alpha, w, z, y, 1, w_update),
        "PCG w-update": lambda: w_update(w, rho),
        "inventory solve (K2)": lambda: kinv(rho_idx, w),
        "A x": lambda: cop.A_x(x),
        "A^T y": lambda: cop.AT_x(z),
    }
    for name, fn in parts.items():
        fn()
        ms = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        print(f"{name}: {float(np.median(ms)):.3f} ms (median of {reps})",
              flush=True)


def timed_solve(d, o, sched):
    """One phased solve: (host seconds ending in a device sync,
    iterations)."""
    from swarm_simulator_tpu_torch.qp import nullspace as ns

    t0 = time.perf_counter()
    _, info = ns.solve_ns_schedule(d, o, *sched)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, int(info.iters)


def seq_solve(plan, mission, mode: str, max_iter: int = 200):
    """One sequential-batch solve of ``plan`` in chip_smoke.SEQ_RUNS's
    ``mode`` (float32, each batch solve capped at ``max_iter``): (host
    seconds ending in a device sync, iterations run one after another)."""
    import chip_smoke
    from swarm_simulator_tpu_torch import Param
    from swarm_simulator_tpu_torch.parallel import seqbatch

    param = Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                  solver_dtype="float32", **chip_smoke.SEQ_RUNS[mode])
    settings = dataclasses.replace(
        seqbatch.default_settings(plan, mission, param), max_iter=max_iter)
    t0 = time.perf_counter()
    result = seqbatch.solve_trajectories(copy.deepcopy(plan), mission,
                                         param, settings, device="cuda")
    torch.cuda.synchronize()
    iters = result.solver_info["iters"]
    if mode == "jacobi":
        per_round = len(iters) // param.iteration
        iters = [max(iters[i:i + per_round])
                 for i in range(0, len(iters), per_round)]
    return time.perf_counter() - t0, sum(iters)


def profile_run(solve) -> int:
    """Run ``solve() -> (seconds, iterations)`` once to warm up (first-use
    costs in), once unprofiled and once under torch.profiler; print the
    readings."""
    first_s, _ = solve()
    warm_s, iters = solve()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_s, iters_p = solve()
    avg = prof.key_averages()
    # device-side entries only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched
    on_dev = [e for e in avg if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    dev_us = sum(e.self_device_time_total for e in on_dev)
    dev_n = sum(e.count for e in on_dev)
    k1_us = sum(e.self_device_time_total for e in on_dev
                if "nsfused" in e.key)
    k2_us = sum(e.self_device_time_total for e in on_dev
                if "thomas_kernel" in e.key)
    # K3a/K3b: one template, chunk_kernel<back, early loads>, since the
    # sweeps share the chain ring; chunk_fwd_kernel/chunk_bwd_kernel before
    k3a_us = sum(e.self_device_time_total for e in on_dev
                 if "chunk_kernel<false" in e.key
                 or "chunk_fwd_kernel" in e.key)
    k3b_us = sum(e.self_device_time_total for e in on_dev
                 if "chunk_kernel<true" in e.key
                 or "chunk_bwd_kernel" in e.key)
    # a collective shows as the device span of its "nccl:" annotation (a
    # copy on one rank, and any wait for the peers), not as a kernel
    nccl_us = sum(e.self_device_time_total for e in avg
                  if e.key.startswith("nccl:"))
    print(f"solve: first {first_s:.3f} s, unprofiled {warm_s:.3f} s "
          f"({iters} iters), profiled "
          f"{wall_s:.3f} s ({iters_p} iters); host time per iteration "
          f"{1e3 * warm_s / max(iters, 1):.3f} ms unprofiled, "
          f"{1e3 * wall_s / max(iters_p, 1):.3f} ms profiled")
    if dev_us <= 0:
        print("profile_solve: the profiler saw no device time",
              file=sys.stderr)
        return 1
    # the profiler slows the host side (each launch is recorded), so the
    # busy share against the unprofiled warm-up run is printed too
    print(f"device time {dev_us / 1e3:.1f} ms, device busy "
          f"{100 * dev_us / 1e6 / wall_s:.1f}% of the profiled wall time, "
          f"{100 * dev_us / 1e6 / warm_s:.1f}% of the unprofiled one; "
          + ", ".join(f"{name} {us / 1e3:.1f} ms = {100 * us / dev_us:.1f}%"
                      for name, us in (
                          ("K1", k1_us), ("K2", k2_us), ("K3a", k3a_us),
                          ("K3b", k3b_us),
                          ("the rest (torch ops, copies)",
                           dev_us - k1_us - k2_us - k3a_us - k3b_us)))
          + f" of the device time; the NCCL collectives' device spans "
          f"{nccl_us / 1e3:.1f} ms = {100 * nccl_us / dev_us:.1f}%; "
          f"{dev_n / max(iters_p, 1):.1f} device entries per iteration")
    print(avg.table(sort_by="self_device_time_total", row_limit=12))
    # a solve whose card idles is bound by the host: what it spends there
    print(avg.table(sort_by="self_cpu_time_total", row_limit=15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
