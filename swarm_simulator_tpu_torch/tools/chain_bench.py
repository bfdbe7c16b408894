"""Time the chain kernels K2 and K1 (with --k3 the chunk sweeps K3a and
K3b, with --t3 the staged probe T3, with --p3 T1's pair product P3, with
--t2 the chain-primitive bench T2, with --p4 and --p2 T1's resident
Thomas probe and tile apply) of this checkout against other checkouts of
the port, in one process on one CUDA card; with --floor also an empty
kernel's launch.

    python3 -m swarm_simulator_tpu_torch.tools.chain_bench
        [--against ROOT ...] [--reps 20] [--no-256] [--k3] [--t3] [--p3]
        [--t2] [--p4] [--p2] [--floor] [--stack]

Run from the repository root (it takes the 64-agent problem from
chip_smoke.py).  Each ROOT is a directory holding a
``swarm_simulator_tpu_torch/`` package (for example the parent commit,
unpacked with ``git archive``); it is loaded under its own module name,
builds its kernels into its own ``build/``, and is called through the
same wrappers (``ops/thomas.thomas_solve``, ``ops/nsfused.nsfused_chunk``,
``ops/thomas_probe.thomas_probe``, ``ops/nsfused_probe``,
``ops/thomas_prim.thomas_prim``) on the same tensors.  Cases, each on
the pivots the planning paths give the kernel:
  K2 at 64 agents (the forest of seed 0): host-prep float32, device-prep
  float32 and device-prep rounded to bf16;
  K2 at 256 agents (tools/budget256_study's scatter problem, device prep,
  rung 0): float32 and rounded to bf16 (skipped with --no-256);
  K1: one 50-iteration chunk of the 64-agent cold problem from its cold
  state, rung 0;
  K3a and K3b (--k3): one sweep over the first L knots of the 64-agent
  host-prep inventory, rung 0, at L = 35 (the whole chain, the 1-rank
  sharded solve's chunk) and L = 9 (its first chunk split four ways), and
  at the 256-agent width at L = 71 (skipped with --no-256), a seeded
  right-hand side and carry, K3b on this checkout's twin's T;
  T3 (--t3): each stage at the 64-agent (bs 576, Mi 35) and 256-agent
  (bs 2304, Mi 71) shapes on tools/thomas_probe's inputs, rung 1;
  P3 (--p3): the pair product on tools/nsfused_probe's inputs, x of 216
  rows and its first 100, with ``torch.matmul`` ("highest") in turns;
  T2 (--t2): every mode of chip_smoke.py's phase 14 from a zero start on
  tools/thomas_prim_bench's inputs at its three shapes (bs 640 and 576,
  Mi 35; bs 2304, Mi 71; the last skipped with --no-256), on each
  checkout's many-block grid (the last of its ``GRIDS``: "ring" here,
  "k2" in checkouts before it) at REPS 20 and on one block at REPS 2
  (not at bs 2304), microseconds per step over REPS x Mi;
  P4 (--p4): the 50-iteration call on tools/nsfused_probe's inputs,
  here with 0 knots resident, with the most beside a full ring of
  MAX_SLOTS slots and with the most beside a two-slot ring
  (ops/nsfused_probe.p4_plan), each checkout's p4_resident_thomas beside
  them; then this checkout's chain alone on the re-laid rung at the same
  residencies, and its re-layout beside the PyTorch copy of the permuted
  rung (held to be bit-equal);
  P2 (--p2): the tile apply on tools/nsfused_probe's inputs (rung 1)
  with ``torch.einsum`` in turns;
  the floor (--floor): an empty kernel on 1 block of 256 threads and on
  P2's grid (ops/nsfused_probe.p2_plan) with and without its clusters;
  K1 stack (--stack): one 50-iteration chunk of chip_smoke.py phase 20's
  16 Jacobi groups of 4 at rung 0 through every checkout's
  ``nsfused_stack`` and this checkout's float32-state build
  (``nsfused_stack@stack_state_f32``), then the split of an iteration
  from this checkout's clock64 build (``nsfused_stack@stack_profile``).
Each variant's result is held against this checkout's float32 twin (the
largest error relative to the result's scale is printed; K1's is the
worst over the parts of the state).  Times are CUDA events after the
stream spin (tools/_timing), the variants in turns: this order, then
reversed, ``--reps`` calls a turn, the median over all of a variant's
calls.  The JSON is the last line of stdout, with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import functools
import importlib
import importlib.util
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_checkout(root: str, alias: str):
    """The ``swarm_simulator_tpu_torch`` package under ``root``, imported
    as ``alias``: (ops.thomas, ops.nsfused, ops.thomas_probe,
    ops.nsfused_probe, ops.thomas_prim) of that checkout."""
    pkg = Path(root).resolve() / "swarm_simulator_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{alias}.ops.{m}")
                 for m in ("thomas", "nsfused", "thomas_probe",
                           "nsfused_probe", "thomas_prim"))


def inputs(dev, big: bool):
    """({name: (dinv, ho)}: the pivot inventories K2 is timed on, rung 0
    of each; (data, host-prep operator) of the 64-agent problem for K1;
    its (plan, mission, param))."""
    import chip_smoke
    from swarm_simulator_tpu_torch.qp import joint, nullspace as ns

    plan, mission, param, _ = chip_smoke.build_problem(0)
    data, _ = joint.assemble_joint(plan, mission, param)
    host = ns.prepare_ns_np(data, joint.production_phases()[0])
    hd = host.to(dev)
    devp = ns.prepare_ns(data.to(dev),
                         joint.production_phases(kkt_refine=1)[0])
    cases = {
        "64 host-prep f32": (hd.Dinvs, hd.Kos),
        "64 device-prep f32": (devp.Dinvs, devp.Kos),
        "64 device-prep bf16": (devp.Dinvs[:1].to(torch.bfloat16), devp.Kos),
    }
    if big:
        from swarm_simulator_tpu_torch.tools import budget256_study as bud

        _, _, _, d256 = bud.build_problem(256)
        o = bud.prepare(d256.to(dev), bud.base_settings(1, False))
        cases["256 device-prep f32"] = (o.Dinvs, o.Kos)
        cases["256 device-prep bf16"] = (o.Dinvs[:1].to(torch.bfloat16),
                                         o.Kos)
    return cases, (data, host), (plan, mission, param)


def in_turns(variants: dict, reps: int, call, check) -> dict:
    """{variant: {ms, ms_all, err}}: ``call(variant)`` timed ``reps``
    times a turn over the variants in order and then reversed, after
    ``check(output) -> error`` of its first call."""
    from swarm_simulator_tpu_torch.tools._timing import event_ms

    res = {}
    order = list(variants)
    for v in order + order[::-1]:
        e = res.setdefault(v, {"ms_all": [], "err": 0.0})
        if "failed" in e:
            continue
        try:
            got = call(v)
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as exc:  # a refused launch
            e["failed"] = str(exc)
            continue
        e["err"] = max(e["err"], check(got))
        e["ms_all"] += event_ms(lambda: call(v), reps, warmup=0)
    for e in res.values():
        e["ms"] = float(np.median(e["ms_all"])) if e["ms_all"] else None
    return res


def k3_in_turns(variants: dict, reps: int, dev, cases: dict,
                out: dict) -> None:
    """K3a and K3b of every variant in turns into ``out`` ({"<case> L=<L>
    fwd|bwd": in_turns' result}): a sweep over the first L knots of rung 0
    of each inventory in ``cases`` ({name: (dinv, ho, [L, ...])}), each
    output held against this checkout's float32 twin."""
    from swarm_simulator_tpu_torch.ops import thomas
    from swarm_simulator_tpu_torch.qp import nullspace_shard as shard

    gen = torch.Generator().manual_seed(1)
    for case, (dinv, ho, lengths) in cases.items():
        bs = dinv.shape[-1]
        for L in lengths:
            n = -(-dinv.shape[1] // L)
            kin, kout = (k[:L].contiguous()
                         for k in shard.chunk_couplings(ho, n * L))
            d = dinv[:1, :L].contiguous()
            b = torch.randn((L, bs), generator=gen).to(dev)
            t_in = torch.randn(bs, generator=gen).to(dev)
            T = thomas.thomas_chunk_fwd_reference(d, kin, b, t_in, 0)
            x = thomas.thomas_chunk_bwd_reference(d, kout, T, t_in, 0)
            for sweep, want, name, args in (
                    ("fwd", T, "thomas_chunk_fwd", (d, kin, b, t_in, 0)),
                    ("bwd", x, "thomas_chunk_bwd", (d, kout, T, t_in, 0))):
                out[f"{case} L={L} {sweep}"] = res = in_turns(
                    variants, reps,
                    lambda v: getattr(variants[v][0], name)(*args),
                    lambda got: thomas.rel_error(got, want))
                log(f"K3{'a' if sweep == 'fwd' else 'b'} {case} L={L}: "
                    + ", ".join(f"{v} {e['ms']} ms (err {e['err']:.1e})"
                                for v, e in res.items()))
            del d, T, x
            torch.cuda.empty_cache()


def p3_in_turns(variants: dict, reps: int, dev, out: dict) -> None:
    """T1's P3 of every variant and ``torch.matmul`` in turns into ``out``
    ({"M=<rows>": in_turns' result}), each output held against this
    checkout's plain version."""
    from swarm_simulator_tpu_torch.ops import nsfused_probe as npb
    from swarm_simulator_tpu_torch.tools import nsfused_probe as t1

    x216, s = (torch.from_numpy(a).to(dev)
               for a in t1.probe_inputs((3,))[3])
    calls = {v: variants[v][3].p3_split_pair_product for v in variants}
    calls["torch.matmul"] = torch.matmul
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        for M in (216, 100):
            x = x216[:M].contiguous()
            want = npb.p3_split_pair_product_reference(x, s)
            out[f"M={M}"] = res = in_turns(
                calls, reps, lambda v: calls[v](x, s),
                lambda got: float((got - want).abs().max())
                / float(want.abs().max()))
            log(f"P3 M={M}: " + ", ".join(
                f"{v} {e['ms']} ms (err {e['err']:.1e})"
                for v, e in res.items()))
    finally:
        torch.set_float32_matmul_precision(prec)


def p4_in_turns(variants: dict, reps: int, dev, out: dict) -> None:
    """T1's P4 into ``out``: "call" (every checkout's p4_resident_thomas
    and this checkout's at each residency), "chain" (this checkout's
    chain alone on the re-laid rung) and "relayout" (its re-layout beside
    the PyTorch copy), each in turns; x held against this checkout's
    plain version (one iteration: each recomputes the same x)."""
    from swarm_simulator_tpu_torch.ops import nsfused_probe as npb
    from swarm_simulator_tpu_torch.ops import thomas
    from swarm_simulator_tpu_torch.tools import nsfused_probe as t1

    d6, ho, b = (torch.from_numpy(a).to(dev)
                 for a in t1.probe_inputs((4,))[4])
    want = npb.p4_resident_thomas_reference(d6, ho, b, 0, 1)
    sms = thomas.sm_count(dev)
    hmax = npb.p4_max_resident(npb.MI, sms)
    full = max(h for h in range(hmax + 1)
               if npb.p4_plan(h, npb.MI, sms).slots == thomas.MAX_SLOTS)
    hs = sorted({0, full, hmax})
    out["resident"] = {"full_ring": full, "max": hmax}
    m = npb.p4_relayout(d6, 0)

    def whole(h):  # p4_resident_thomas at h resident knots
        return npb.p4_chain(npb.p4_relayout(d6, 0), ho, b, npb.INNER, h)

    calls = {}
    for v, mods in variants.items():
        if v == "this":
            for h in hs:
                calls[f"this h={h}"] = functools.partial(whole, h)
        else:
            calls[v] = functools.partial(mods[3].p4_resident_thomas, d6, ho,
                                         b, 0, npb.INNER)
    chains = {f"chain h={h}": functools.partial(npb.p4_chain, m, ho, b,
                                                npb.INNER, h) for h in hs}
    relayouts = {"relayout": functools.partial(npb.p4_relayout, d6, 0),
                 "torch permute copy": functools.partial(
                     t1.relayout_library, d6, 0)}
    want_m = npb.p4_relayout_reference(d6, 0)
    for key, group, check in (
            ("call", calls, lambda got: thomas.rel_error(got, want)),
            ("chain", chains, lambda got: thomas.rel_error(got, want)),
            ("relayout", relayouts, lambda got: float(
                (got.reshape(want_m.shape) - want_m).abs().max()))):
        out[key] = res = in_turns(group, max(1, reps // 4),
                                  lambda v: group[v](), check)
        log(f"P4 {key}: " + ", ".join(
            f"{v} {e['ms']} ms (err {e['err']:.1e})"
            for v, e in res.items()))
    del d6, m, want_m
    torch.cuda.empty_cache()


def p2_in_turns(variants: dict, reps: int, dev, out: dict) -> None:
    """T1's P2 of every checkout and ``torch.einsum`` in turns into
    ``out``, each held against this checkout's plain version."""
    from swarm_simulator_tpu_torch.ops import nsfused_probe as npb
    from swarm_simulator_tpu_torch.tools import nsfused_probe as t1

    d6, y = (torch.from_numpy(a).to(dev) for a in t1.probe_inputs((2,))[2])
    want = npb.p2_tile_apply_reference(d6, y, 1)
    calls = {v: functools.partial(mods[3].p2_tile_apply, d6, y, 1)
             for v, mods in variants.items()}
    calls["torch.einsum"] = functools.partial(t1.LIBRARY[2], d6, y, 1)
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        out.update(in_turns(
            calls, reps, lambda v: calls[v](),
            lambda got: float((got - want).abs().max())
            / float(want.abs().max())))
    finally:
        torch.set_float32_matmul_precision(prec)
    log("P2: " + ", ".join(f"{v} {e['ms']} ms (err {e['err']:.1e})"
                           for v, e in out.items()))
    del d6
    torch.cuda.empty_cache()


def stack_in_turns(variants: dict, reps: int, dev, problem,
                   out: dict) -> None:
    """K1's stacked form into ``out``: one N_INNER chunk of phase 20's
    Jacobi groups (chip_smoke.jacobi_stack: the 64-agent forest's 16
    groups of 4, each group's host prep, cold state) at rung 0 through
    every checkout's ``nsfused_stack`` and this checkout's float32-state
    build in turns ("chunk"), each held against this checkout's float32
    twin (the worst group and part); then this checkout's STACK_PROFILE
    build ("split": each stamped phase's share of the iteration, the mean
    over the launch's blocks of each role, and its milliseconds at the
    profile build's own median time)."""
    import chip_smoke
    from swarm_simulator_tpu_torch.ops import nsfused
    from swarm_simulator_tpu_torch.qp import nullspace as ns
    from swarm_simulator_tpu_torch.tools._timing import event_ms

    stacked, _ = chip_smoke.jacobi_stack(*problem)
    s = ns.NSSettings(kkt_mode="banded", tighten=chip_smoke.JACOBI_TIGHTEN)
    G = np.asarray(stacked.lb).shape[0]
    groups = [chip_smoke.dataclasses.replace(stacked, **{
        f.name: np.asarray(getattr(stacked, f.name))[g]
        for f in chip_smoke.dataclasses.fields(stacked)
        if getattr(stacked, f.name) is not None}) for g in range(G)]
    prep = [ns.cold_chunk_inputs(*chip_smoke.on_device(
        g, ns.prepare_ns_np(g, s), dev, torch.float32), s) for g in groups]
    sops = nsfused.stack_operands([p[0] for p in prep])
    # the state as [G, ...] tensors, or one state a group for a checkout
    # whose nsfused_stack takes lists (before STACK_STATE_AXIS)
    state = ns.stack_states([p[1] for p in prep])
    lists = tuple(list(v) for v in zip(*(p[1] for p in prep)))

    def a(mod):
        return (list(range(G)), [0] * G, s.sigma, s.alpha,
                *(state if getattr(mod, "STACK_STATE_AXIS", False)
                  else lists), chip_smoke.N_INNER)

    def rows(got, g):
        if isinstance(got[0], torch.Tensor):
            return ns.entry_state(got, g)
        return got[0][g], got[1][g], got[2][g]

    want = nsfused.nsfused_stack_reference(sops, *a(nsfused))

    def err(got):
        return max(max(nsfused.state_errors(rows(got, g), rows(want, g)))
                   for g in range(G))

    calls = {v: functools.partial(mods[1].nsfused_stack, sops, *a(mods[1]))
             for v, mods in variants.items()}
    calls["this, float32 state"] = functools.partial(
        nsfused.nsfused_stack, sops, *a(nsfused),
        _lib=nsfused.stack_variant("stack_state_f32"), _state=torch.float32)
    out["groups"] = G
    out["dims"] = {k: sops.dims[k] for k in ("B", "M", "Mi", "bs", "P", "D")}
    out["chunk"] = res = in_turns(calls, max(1, reps // 4),
                                  lambda v: calls[v](), err)
    log(f"K1 stack of {G} groups: " + ", ".join(
        f"{v} {e['ms']} ms (err {e['err']:.1e})" for v, e in res.items()))
    prof = nsfused.stack_variant("stack_profile")
    ms = float(np.median(event_ms(lambda: nsfused.nsfused_stack(
        sops, *a(nsfused), _lib=prof), max(1, reps // 4))))
    names, cyc = nsfused.stack_stamps(prof)
    used = cyc[cyc[:, -1] > 0]
    shares = used[:, :-1] / used[:, -1:].astype(float)
    # a block that stamped a phase the others did not has its own role
    # (the chain block beside the partners); one role in a one-block form
    kinds = {tuple(row > 0) for row in shares}
    split = {}
    for kind in sorted(kinds, reverse=True):
        rows = shares[[tuple(r > 0) == kind for r in shares]]
        first = names[kind.index(True)] if any(kind) else "none"
        role = split.setdefault(f"blocks stamping {first} ...", {
            "blocks": len(rows),
            "cycles": float(np.median(used[[tuple(r > 0) == kind
                                            for r in shares], -1]))})
        for i, name in enumerate(names):
            if kind[i]:
                role[name] = {"share": float(rows[:, i].mean()),
                              "ms": float(rows[:, i].mean()) * ms}
    out["split"] = {"profile_build_ms": ms, "roles": split}
    for role, v in split.items():
        log(f"K1 stack split, {role} ({v['blocks']} blocks, {v['cycles']:.0f}"
            f" cycles; profile build {ms:.4f} ms): " + ", ".join(
                f"{k} {e['share']:.3f} ({e['ms']:.4f} ms)"
                for k, e in v.items() if isinstance(e, dict)))


def floor_in_turns(reps: int, dev, out: dict) -> None:
    """An empty kernel's launch in turns into ``out``: one block, and P2's
    grid with and without its clusters (this checkout's kernel)."""
    from swarm_simulator_tpu_torch.ops import nsfused_probe as npb
    from swarm_simulator_tpu_torch.ops import thomas

    plan = npb.p2_plan(sms=thomas.sm_count(dev))
    blocks = plan.tiles * plan.cluster
    calls = {
        "1 block x 256": (1, 256, 1),
        f"P2 grid {blocks} x {plan.threads}, clusters of {plan.cluster}":
            (blocks, plan.threads, plan.cluster),
        f"P2 grid {blocks} x {plan.threads}, no cluster":
            (blocks, plan.threads, 1)}
    out.update(in_turns(
        calls, reps, lambda v: npb.launch_floor(*calls[v], dev),
        lambda got: 0.0))
    log("launch floor: " + ", ".join(f"{v} {e['ms']} ms"
                                     for v, e in out.items()))


def t3_in_turns(variants: dict, reps: int, dev, out: dict) -> None:
    """T3's stages of every variant in turns, at 64 and 256 agents, into
    ``out`` ({"bs stage": in_turns' result}); each output held against
    this checkout's plain version."""
    from swarm_simulator_tpu_torch.ops import thomas_probe as tq
    from swarm_simulator_tpu_torch.tools import thomas_probe as t3

    for bs, Mi in ((576, 35), (2304, 71)):
        dinvs, koM, b, dsym = t3.inputs(bs, Mi, 2, dev)
        for st in tq.STAGES:
            piv = dsym if st == "full" else dinvs
            want = tq.thomas_probe_reference(piv, koM, b, st, 1)
            out[f"{bs} {st}"] = res = in_turns(
                variants, max(1, reps // 4),
                lambda v: variants[v][2].thomas_probe(piv, koM, b, st, 1),
                lambda got: float((got - want).abs().max())
                / max(float(want.abs().max()), 1e-30))
            log(f"T3 {st} bs {bs} Mi {Mi}: " + ", ".join(
                f"{v} {e['ms']} ms (err {e['err']:.1e})"
                for v, e in res.items()))
        del dinvs, koM, b, dsym, piv, want
        torch.cuda.empty_cache()


def t2_in_turns(variants: dict, reps: int, dev, big: bool,
                out: dict) -> None:
    """T2's modes of every variant in turns into ``out`` ({"<bs> <grid>
    <mode>": in_turns' result with ``us_per_step``}), each output held
    against this checkout's plain version at the same REPS."""
    import chip_smoke
    from swarm_simulator_tpu_torch.ops import thomas_prim as tp
    from swarm_simulator_tpu_torch.tools import thomas_prim_bench as t2

    for bs, Mi in ((640, 35), (576, 35)) + (((2304, 71),) if big else ()):
        d, k, bb = t2.inputs(bs, Mi, dev)
        for grid, R in (("many", 20), ("one", 2)):
            if grid == "one" and bs == 2304:
                continue
            for spec in chip_smoke.T2_SPECS:
                mode, nbuf = tp.parse_mode(spec)
                want = tp.thomas_prim_reference(d, k, bb, mode, nbuf, R)
                calls = {}
                for v, mods in variants.items():
                    g = mods[4].GRIDS[-1] if grid == "many" else "one"
                    calls[v] = functools.partial(mods[4].thomas_prim, d, k,
                                                 bb, mode, nbuf, R, grid=g)
                out[f"{bs} {grid} {spec}"] = res = in_turns(
                    calls, max(1, reps // 4), lambda v: calls[v](),
                    lambda got: float((got - want).abs().max())
                    / max(float(want.abs().max()), 1e-30))
                for e in res.values():
                    e["us_per_step"] = (1e3 * e["ms"] / (R * Mi)
                                        if e["ms"] else None)
                log(f"T2 bs {bs} {grid} {spec}: " + ", ".join(
                    f"{v} {e['us_per_step']} us/step (err {e['err']:.1e})"
                    for v, e in res.items()))
        del d, k, bb
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[], metavar="ROOT")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-256", action="store_true")
    ap.add_argument("--k3", action="store_true",
                    help="also time K3a and K3b at 64 agents (L = 35 and "
                         "9) and 256 agents (L = 71)")
    ap.add_argument("--t3", action="store_true",
                    help="also time T3's stages at 64 and 256 agents")
    ap.add_argument("--p3", action="store_true",
                    help="also time T1's P3 beside torch.matmul")
    ap.add_argument("--t2", action="store_true",
                    help="also time T2's modes at phase 14's shapes")
    ap.add_argument("--p4", action="store_true",
                    help="also time T1's P4 at each residency, its chain "
                         "and its re-layout")
    ap.add_argument("--p2", action="store_true",
                    help="also time T1's P2 beside torch.einsum")
    ap.add_argument("--floor", action="store_true",
                    help="also time an empty kernel's launch")
    ap.add_argument("--stack", action="store_true",
                    help="also time K1's stacked form on phase 20's "
                         "Jacobi groups, its float32-state build, and "
                         "split its iteration")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chain_bench: needs a CUDA card", file=sys.stderr)
        return 2
    from swarm_simulator_tpu_torch.ops import _build, nsfused, thomas
    from swarm_simulator_tpu_torch.ops import (nsfused_probe, thomas_prim,
                                               thomas_probe)
    from swarm_simulator_tpu_torch.qp import joint, nullspace as ns
    from swarm_simulator_tpu_torch.tools._timing import card

    dev = torch.device("cuda", 0)
    variants = {"this": (thomas, nsfused, thomas_probe, nsfused_probe,
                         thomas_prim)}
    for n, root in enumerate(args.against):
        variants[root] = load_checkout(root, f"chain_bench_v{n}")
    t0 = time.perf_counter()

    def build(th):
        # each checkout's own build helper, beside its ops/thomas
        importlib.import_module(th.__name__.rsplit(".", 1)[0] + "._build"
                                ).build("thomas", "nsfused",
                                        *(("thomas_probe",) if args.t3
                                          else ()),
                                        *(("nsfused_probe",)
                                          if args.p3 or args.p4 or args.p2
                                          or args.floor else ()),
                                        *(("thomas_prim",) if args.t2
                                          else ()),
                                        *(("nsfused_stack",) if args.stack
                                          else ()))

    with ThreadPoolExecutor(len(variants)) as ex:
        futs = {name: ex.submit(build, v[0])
                for name, v in variants.items()}
    for name, f in futs.items():
        if f.exception() is not None:
            log(f"{name}: build failed, left out: {f.exception()}")
            del variants[name]
    log(f"builds: {time.perf_counter() - t0:.1f} s")
    if args.stack:  # this checkout's measuring builds of the stack kernel
        _build.build("nsfused_stack@stack_profile",
                     "nsfused_stack@stack_state_f32")
    cases, (data, host), problem = inputs(dev, not args.no_256)

    out = {"card": card(), "torch": torch.__version__, "k2": {}, "k1": {},
           "k3": {}, "t3": {}, "p3": {}, "t2": {}, "p4": {}, "p2": {},
           "floor": {}, "stack": {}}
    gen = torch.Generator().manual_seed(0)
    for case, (dinv, ho) in cases.items():
        Mi, bs = dinv.shape[1], dinv.shape[-1]
        b = torch.randn((Mi, bs), generator=gen).to(dev)
        want = thomas.thomas_solve_reference(dinv, ho, b, 0)
        out["k2"][case] = res = in_turns(
            variants, args.reps,
            lambda v: variants[v][0].thomas_solve(dinv, ho, b, 0),
            lambda got: thomas.rel_error(got, want))
        log(f"K2 {case}: " + ", ".join(
            f"{v} {e['ms']} ms (err {e['err']:.1e})" for v, e in res.items()))
    if args.k3:
        k3 = {"64 host-prep f32": (*cases["64 host-prep f32"], (35, 9))}
        if not args.no_256:
            k3["256 device-prep f32"] = (*cases["256 device-prep f32"],
                                         (71,))
        k3_in_turns(variants, args.reps, dev, k3, out["k3"])
        del k3
    del cases
    torch.cuda.empty_cache()

    s = joint.production_phases()[0]
    ops, (w, z, y) = ns.cold_chunk_inputs(data.to(dev), host.to(dev), s)
    want = nsfused.nsfused_chunk_reference(ops, 0, s.sigma, s.alpha, w, z,
                                           y, 50)
    out["k1"]["64 host-prep chunk"] = res = in_turns(
        variants, max(1, args.reps // 4),
        lambda v: variants[v][1].nsfused_chunk(ops, 0, s.sigma, s.alpha, w,
                                               z, y, 50),
        lambda got: max(nsfused.state_errors(got, want)))
    log("K1 64-agent chunk: " + ", ".join(
        f"{v} {e['ms']} ms (err {e['err']:.1e})" for v, e in res.items()))
    if args.t3:
        t3_in_turns(variants, args.reps, dev, out["t3"])
    if args.p3:
        p3_in_turns(variants, args.reps, dev, out["p3"])
    if args.t2:
        t2_in_turns(variants, args.reps, dev, not args.no_256, out["t2"])
    if args.p4:
        p4_in_turns(variants, args.reps, dev, out["p4"])
    if args.p2:
        p2_in_turns(variants, args.reps, dev, out["p2"])
    if args.floor:
        floor_in_turns(args.reps, dev, out["floor"])
    if args.stack:
        stack_in_turns(variants, args.reps, dev, problem, out["stack"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
