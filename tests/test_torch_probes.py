"""PyTorch port, the probe slice (T2, T3, T1, T5): each probe's plain
version against the JAX package's Pallas kernels, run by the JAX tools
themselves in interpret mode.

Each JAX tool (tools/pallas_debug/*.py) is loaded by path and its main()
run with a spy on ``jax.experimental.pallas.pallas_call`` that forces
interpret mode and records every call's (args, out); ``jax.config.update``
is a no-op meanwhile (the tools set the platform and a compilation cache).
T2's accumulator is read before it is written, so its capture runs with
``InterpretParams(uninitialized_memory="zero")`` under ``jax.disable_jit``
(it jits its runs); the port defines that start as zeros.  Checked:

  inputs   the port's builders give the captured inputs bit for bit;
  outputs  the plain versions within rel 1e-5 of each JAX output's scale
           (T1 P3 also rel 3e-6 against float64; T5 bit-equal, P8 1e-6);
  T2       its matvec modes from a seeded acc0 against a float64 numpy
           run of the same recurrence (from zeros they are zero);
  library  each single PyTorch call the tools time beside T1 and T5
           computes the probe's function (T5 by the tool's own rule);
  wrappers CPU tensors take the plain version and leave ``.launches`` as
           it was, a meta tensor raises a ValueError naming CUDA;
  tools    each prints its JSON line with ``--cpu``, and exits non-zero
           without a card and without ``--cpu``.

The kernels themselves are held against the plain versions in
tests/test_torch_cuda.py, which needs a card.
"""
import contextlib
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas
from jax.experimental.pallas import tpu as pltpu

from swarm_simulator_tpu_torch.ops import nsfused_probe as npb
from swarm_simulator_tpu_torch.ops import row_patterns as rp
from swarm_simulator_tpu_torch.ops import thomas
from swarm_simulator_tpu_torch.ops import thomas_prim as tp
from swarm_simulator_tpu_torch.ops import thomas_probe as tq
from swarm_simulator_tpu_torch.tools import nsfused_probe as t1_tool
from swarm_simulator_tpu_torch.tools import row_patterns as t5_tool
from swarm_simulator_tpu_torch.tools import thomas_prim_bench as t2_tool
from swarm_simulator_tpu_torch.tools import thomas_probe as t3_tool

REPO = Path(__file__).resolve().parents[1]
T2_MODES = ("dma", "mv_sub", "mv_lane", "mv_mxu", "trans", "fwd", "dmag",
            "dmaq", "dma@4")
T2_BS, T2_MI, T2_REPS = 128, 5, 2
T3_BS, T3_MI, T3_R = 128, 4, 2
#: calls of each mode by the JAX T2 tool: one warm-up, three timed
T2_CALLS = 4


def capture(rel: str, argv: list, interpret, nojit: bool) -> list:
    """Run the JAX tool ``rel``'s main() with ``argv`` and return each
    pallas_call's (numpy args, numpy output), in call order."""
    calls = []
    orig, update = pallas.pallas_call, jax.config.update

    def spy(kernel, *a, **k):
        k["interpret"] = interpret
        f = orig(kernel, *a, **k)

        def run(*args):
            out = f(*args)
            calls.append(([np.asarray(x) for x in args], np.asarray(out)))
            return out
        return run

    spec = importlib.util.spec_from_file_location(
        "jax_" + Path(rel).stem, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    old_argv = sys.argv
    pallas.pallas_call = spy
    jax.config.update = lambda *a, **k: None
    sys.argv = [rel] + argv
    try:
        spec.loader.exec_module(mod)
        with jax.disable_jit() if nojit else contextlib.nullcontext():
            mod.main()
    finally:
        pallas.pallas_call, jax.config.update = orig, update
        sys.argv = old_argv
    return calls


def within(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() <= rtol * np.abs(want).max()


# ---- T2 ----

@pytest.fixture(scope="module")
def t2_calls():
    calls = capture("tools/pallas_debug/thomas_prim_bench.py",
                    ["--bs", str(T2_BS), "--mi", str(T2_MI), "--reps",
                     str(T2_REPS), "--interpret", "--modes",
                     ",".join(T2_MODES)],
                    pltpu.InterpretParams(uninitialized_memory="zero"),
                    nojit=True)
    assert len(calls) == T2_CALLS * len(T2_MODES)
    return {m: calls[T2_CALLS * i:T2_CALLS * (i + 1)]
            for i, m in enumerate(T2_MODES)}


@pytest.mark.parametrize("spec", T2_MODES)
def test_t2_plain_matches_pallas(t2_calls, spec):
    dinvs, koM, b = t2_tool.probe_inputs(T2_BS, T2_MI)
    mode, nbuf = tp.parse_mode(spec)
    for rep, (args, want) in enumerate(t2_calls[spec]):
        assert int(args[0][0]) == 0
        assert np.array_equal(args[1], dinvs) and np.array_equal(args[2], koM)
        # the JAX tool runs b + 1e-6 (rep) after its warm-up on b
        bb = b if rep == 0 else np.array(args[3])
        assert np.array_equal(args[3], bb)
        got = tp.thomas_prim(*(torch.from_numpy(a) for a in (dinvs, koM, bb)),
                             mode, nbuf, T2_REPS)
        assert got.shape == want.shape and np.isfinite(want).all()
        assert np.abs(got.numpy() - want).max() <= \
            1e-5 * max(np.abs(want).max(), 1e-30)
    if mode in ("dma", "dmaq", "dmag", "trans", "fwd"):
        assert np.abs(want[0]).max() > 0


def _f64_recurrence(dinv, koM, b, mode, reps, acc0):
    """The T2 recurrence in float64 numpy (bf16 rounding for mv_mxu)."""
    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16).to(torch.float64).numpy()

    acc = acc0.astype(np.float64)
    rung = dinv[0].astype(np.float64)
    for _ in range(reps):
        for k in range(b.shape[0]):
            A = rung[k]
            if mode == "mv_sub":
                acc[0] = acc[:, 0] @ A
            elif mode == "mv_lane":
                acc[:, 0] = A @ acc[0]
            elif mode == "mv_mxu":
                acc[0] = bf(acc[0]) @ bf(A)
            elif mode == "trans":
                acc = 0.5 * acc + A.T
            else:
                t = A @ acc[0]
                acc[0] = b[k] - t @ koM + 1e-30 * (t @ A)
    return acc[0]


@pytest.mark.parametrize("mode", ["mv_sub", "mv_lane", "mv_mxu", "trans",
                                  "fwd"])
def test_t2_seeded_start_matches_float64(mode):
    dinvs, koM, b = t2_tool.probe_inputs(T2_BS, T2_MI)
    acc0 = np.random.default_rng(1).standard_normal(
        (T2_BS, T2_BS)).astype(np.float32)
    got = tp.thomas_prim(*(torch.from_numpy(a) for a in (dinvs, koM, b)),
                         mode, 2, T2_REPS, acc0=torch.from_numpy(acc0))
    want = _f64_recurrence(dinvs, koM.astype(np.float64),
                           b.astype(np.float64), mode, T2_REPS, acc0)
    assert np.abs(want).max() > 0
    assert within(got[0].numpy(), want, 1e-5)
    assert not got[1:].any()


@pytest.mark.parametrize("grid", tp.GRIDS)
@pytest.mark.parametrize("bs", [640, 576, 2304])
def test_t2_plan_fits_and_owns_every_row_once(bs, grid):
    """T2's plans (ops/thomas_prim.prim_plan) at phase 14's widths for
    every mode it runs, on 132 SMs: "one" is one block of all rows;
    "ring" at most one block per SM, its rows whole row groups split as
    ops/thomas.ring_plan splits the chain's (groups of 3 at 576 and 2304,
    single rows at the probe's 640); the blocks own every row once; a
    slot holds a tile (dmag: of each of its nbuf blocks) on 128 bytes;
    every tile's copy starts and ends on 16 bytes; the layout
    csrc/thomas_prim.cu carves (the gathered partial rows only for the
    modes that exchange them, b's rows only for fwd) fits 227 KB."""
    sms = 132
    for spec in T2_MODES + ("dmag@4", "dmaq@4", "mv_sub@8"):
        mode, nbuf = tp.parse_mode(spec)
        plan = tp.prim_plan(bs, mode, nbuf, grid, sms)
        if grid == "one":
            assert (plan.blocks, plan.rows) == (1, bs)
        else:
            phi = tp.row_group(bs)
            assert phi == (3 if bs % 3 == 0 else 1)
            chain = thomas.ring_plan(bs, phi, 4, sms=sms)
            assert plan.rows == chain.groups * phi
            assert plan.blocks <= sms
        assert (plan.blocks - 1) * plan.rows < bs <= plan.blocks * plan.rows
        owner = np.full(bs, -1)
        for c in range(plan.blocks):
            r0, r1 = c * plan.rows, min((c + 1) * plan.rows, bs)
            assert r1 > r0 and (owner[r0:r1] == -1).all()
            owner[r0:r1] = c
            for a0 in range(r0, r1, plan.tile_rows):
                nr = min(plan.tile_rows, r1 - a0)
                for k in (0, 1, 34):
                    assert ((k * bs * bs + a0 * bs) * 4) % 16 == 0
                    assert (nr * bs * 4) % 16 == 0
        assert (owner >= 0).all()
        grp = nbuf if mode == "dmag" else 1
        assert plan.slots == (2 if mode in ("dmag", "dmaq") else nbuf)
        assert 1 <= plan.tile_rows <= plan.rows
        assert plan.slot_bytes % tp.SLOT_ALIGN == 0
        assert plan.slot_bytes >= grp * plan.tile_rows * bs * 4
        gather = mode in ("mv_sub", "mv_mxu", "fwd")
        assert plan.smem == (tp.BAR_BYTES + plan.slots * plan.slot_bytes
                             + 4 * (2 * bs + plan.tile_rows
                                    + gather * plan.blocks * plan.rows
                                    + (mode == "fwd") * plan.rows))
        assert plan.smem <= tp.SMEM_LIMIT


@pytest.mark.parametrize("bs, rows, tile_rows", [(48, 48, 7), (48, 6, 4),
                                                 (240, 6, 4)])
def test_t2_mxu_order_witness_is_the_plain_recurrence(bs, rows, tile_rows):
    """tools/t2_mxu_drift's witness of a grid's summation order (one
    block; 8 blocks added one after another; 40 blocks added by lanes and
    a butterfly) computes mv_mxu's recurrence: in float64 within 1e-12 of
    the plain version's scale, and its block sum within 1e-12 of a plain
    sum."""
    from swarm_simulator_tpu_torch.tools import t2_mxu_drift as drift

    dinv, koM, b, acc0 = drift.draw(bs, 3, 0, torch.device("cpu"))
    want = tp.thomas_prim_reference(dinv.double(), koM.double(), b.double(),
                                    "mv_mxu", 2, 2, acc0.double())[0]
    got = drift.order_witness(dinv.double(), acc0.double(), 2, rows,
                              tile_rows)
    assert thomas.rel_error(got, want) <= 1e-12
    P = torch.randn((-(-bs // rows), bs), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    assert thomas.rel_error(drift.sum_blocks(P), P.sum(0)) <= 1e-12


# ---- T3 ----

@pytest.fixture(scope="module")
def t3_calls():
    calls = capture("tools/pallas_debug/thomas_probe.py",
                    ["--bs", str(T3_BS), "--mi", str(T3_MI), "--rungs",
                     str(T3_R), "--interpret"], True, nojit=True)
    assert len(calls) == len(tq.STAGES)
    return dict(zip(tq.STAGES, calls))


@pytest.mark.parametrize("stage", tq.STAGES)
def test_t3_plain_matches_pallas(t3_calls, stage):
    dinvs, koM, b, dsym = t3_tool.probe_inputs(T3_BS, T3_MI, T3_R)
    args, want = t3_calls[stage]
    piv = dsym if stage == "full" else dinvs
    assert int(args[0][0]) == 1 % T3_R
    assert np.array_equal(args[1], piv)
    assert np.array_equal(args[2], koM) and np.array_equal(args[3], b)
    got = tq.thomas_probe(*(torch.from_numpy(a) for a in (piv, koM, b)),
                          stage, 1 % T3_R)
    assert got.shape == want.shape
    assert within(got.numpy(), want, 1e-5)


# ---- T1 ----

@pytest.fixture(scope="module")
def t1_calls():
    calls = capture("tools/pallas_debug/nsfused_probe.py", ["--interpret"],
                    True, nojit=False)
    # P4 runs once to warm up and once timed, on the same inputs
    assert len(calls) == 5
    return {1: calls[0], 2: calls[1], 3: calls[2], 4: calls[3]}


@pytest.mark.parametrize("probe", [1, 2, 3, 4])
def test_t1_plain_matches_pallas(t1_calls, probe):
    ins = t1_tool.probe_inputs()[probe]
    args, want = t1_calls[probe]
    if probe in (2, 4):          # the rung scalar first
        assert int(args[0][0]) == (1 if probe == 2 else 0)
        args = args[1:]
    assert len(args) == len(ins)
    assert all(np.array_equal(a, i) for a, i in zip(args, ins))
    t = [torch.from_numpy(a) for a in ins]
    fn = {1: lambda: npb.p1_reshape_combine(*t),
          2: lambda: npb.p2_tile_apply(*t, 1),
          3: lambda: npb.p3_split_pair_product(*t),
          # each of P4's iterations recomputes x from b, so one gives the
          # JAX kernel's result after fifty
          4: lambda: npb.p4_resident_thomas(*t, 0, 1)}[probe]
    got = fn().numpy()
    assert got.shape == want.shape
    assert within(got, want, 1e-5)
    if probe == 3:
        x, s = (a.astype(np.float64) for a in ins)
        ref = x @ s
        assert np.abs(got - ref).max() <= 3e-6 * max(np.abs(ref).max(), 1)


def _p4_through_chain(d6, ho, b, rho_idx):
    """P4 as the card runs it, in plain versions: the rung re-laid into
    K2's row order, then one iteration of the chain with P4's back
    substitution (each iteration recomputes the same x)."""
    return npb.p4_chain(npb.p4_relayout(d6, rho_idx), ho, b, 1)


@pytest.mark.parametrize("Mi", [4, 9])
def test_t1_p4_relayout_chain_matches_tile_form(Mi):
    """The re-layout and the flat chain give the tile-form sweeps' x
    (p4_resident_thomas_reference) on seeded inputs of the probe's scales,
    rung 1 of two, within 1e-5 of x's scale."""
    rng = np.random.default_rng(Mi)
    d6 = (rng.standard_normal((2, Mi, 3, 3, 192, 192)) * 0.1).astype(
        np.float32)
    ho = (rng.standard_normal((3, 3)) * 0.1).astype(np.float32)
    b = rng.standard_normal((Mi, 3, 192)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (d6, ho, b)]
    want = npb.p4_resident_thomas_reference(*t, 1, 1).numpy()
    got = _p4_through_chain(*t, 1).numpy()
    assert got.shape == want.shape
    assert within(got, want, 1e-5)
    m = npb.p4_relayout(t[0], 1).numpy()
    k, c, g, bb, f = 2, 17, 1, 101, 2
    assert m[k, 3 * c + g, 3 * bb + f] == d6[1, k, f, g, bb, c]


def test_t1_p4_relayout_chain_matches_pallas(t1_calls):
    """The same at the probe's full size (35 knots) against the JAX
    kernel's output after its fifty iterations, in interpret mode."""
    args, want = t1_calls[4]
    t = [torch.from_numpy(a) for a in args[1:]]
    got = _p4_through_chain(*t, int(args[0][0])).numpy()
    assert got.shape == want.shape
    assert within(got, want, 1e-5)


@pytest.mark.parametrize("which", ["none", "full ring", "most"])
def test_t1_p4_plan_fits_and_streams_or_holds_every_stage_once(which):
    """P4's plan at 0 resident knots, at the most beside a full ring and at
    the most beside two slots: 96 chain blocks of 2 row groups, the
    kernel's shared memory (ring, resident rows, vector, products, T rows)
    within 227 KB; each stage of a period streamed or held exactly once,
    the ring's stages in chain order, each knot's span read twice a
    period (the last knot once) and held exactly for the resident ones;
    one knot more than the most does not fit."""
    hmax = npb.p4_max_resident()
    full = max(h for h in range(hmax + 1)
               if npb.p4_plan(h).slots == thomas.MAX_SLOTS)
    h = {"none": 0, "full ring": full, "most": hmax}[which]
    assert (full, hmax) == (8, 14)
    plan = npb.p4_plan(h)
    bs, rows, Mi = 576, plan.groups * 3, npb.MI
    assert plan.groups == 2 and -(-192 // plan.groups) == 96
    assert plan.tile_rows == rows and plan.slots >= 2
    assert plan.smem == (thomas.BAR_BYTES + plan.slots * plan.slot_bytes
                         + h * rows * bs * 4 + 4 * (bs + rows + Mi * rows))
    assert plan.smem <= npb.SMEM_PER_BLOCK
    streamed, held = npb.p4_stage_split(h)
    assert sorted(streamed + held) == list(range(2 * Mi - 1))
    assert streamed == sorted(streamed) and len(held) == max(0, 2 * h - 1)

    def knot(s):
        return s if s < Mi else 2 * Mi - 2 - s

    assert sorted({knot(s) for s in held}) == list(range(Mi - h, Mi))
    reads = np.bincount([knot(s) for s in streamed + held], minlength=Mi)
    assert list(reads) == [2] * (Mi - 1) + [1]
    with pytest.raises(ValueError, match="two-slot ring"):
        npb.p4_plan(hmax + 1)


@pytest.mark.parametrize("sms", [132, 114, 48, 12])
def test_t1_p2_plan_covers_every_row_and_output_once(sms):
    """P2's clusters on cards of several SM counts: at most 8 blocks a
    cluster and 132 in all, one an SM where the card has SMs enough for
    the clusters a block's registers allow, every output column (all
    three g) in exactly one cluster, every (f, b) row in exactly one
    block of each cluster, a block's rows within the kernel's registers;
    on an H100 12 clusters of 8 blocks of 72 rows."""
    plan = npb.p2_plan(192, 3, sms)
    blocks = plan.tiles * plan.cluster
    assert 1 <= plan.cluster <= npb.P2_MAX_CLUSTER and blocks <= 132
    assert blocks <= max(sms, 6 * plan.tiles)
    cols = np.zeros(192, int)
    for t in range(plan.tiles):
        cols[t * plan.cols:(t + 1) * plan.cols] += 1
    assert (cols == 1).all()
    rows = np.zeros(3 * 192, int)
    for q in range(plan.cluster):
        rows[q * plan.rows:min((q + 1) * plan.rows, 576)] += 1
    assert (rows == 1).all()
    assert plan.rows <= npb.P2_LANES * npb.P2_STEPS
    assert plan.threads == 3 * plan.cols // 4 * npb.P2_LANES
    if sms == 132:
        assert (plan.tiles, plan.cluster, plan.rows) == (12, 8, 72)


def test_t1_p2_plan_refuses_ragged_columns():
    with pytest.raises(ValueError, match="tiles of 16"):
        npb.p2_plan(200, 3)


def test_launch_floor_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        npb.launch_floor(1, 32, 1, "cpu")
    assert npb.launch_floor.launches == 0


@pytest.mark.parametrize("probe", sorted(t1_tool.LIBRARY))
def test_t1_library_call_matches_plain(probe):
    ins = [torch.from_numpy(a) for a in t1_tool.probe_inputs((probe,))[probe]]
    extra = (1,) if probe == 2 else ()
    plain = {1: npb.p1_reshape_combine_reference,
             2: npb.p2_tile_apply_reference,
             3: npb.p3_split_pair_product_reference}[probe]
    want = plain(*ins, *extra)
    got = t1_tool.LIBRARY[probe](*ins, *extra)
    assert got.shape == want.shape
    if probe == 1:
        assert torch.equal(got, want)
    else:
        assert within(got.numpy(), want.numpy(), 1e-5)


# ---- T5 ----

@pytest.fixture(scope="module")
def t5_calls():
    calls = capture("tools/pallas_debug/mosaic_patterns.py", [], True,
                    nojit=True)
    assert len(calls) == len(rp.PATTERNS)
    return dict(zip(rp.PATTERNS, calls))


@pytest.mark.parametrize("name", list(rp.PATTERNS))
def test_t5_plain_matches_pallas(t5_calls, name):
    ins = rp.pattern_inputs()[name]
    args, want = t5_calls[name]
    assert len(args) == len(ins)
    assert all(np.array_equal(a, i.numpy()) for a, i in zip(args, ins))
    got = rp.row_pattern(name, *ins).numpy()
    assert got.shape == want.shape
    if name == rp.SUM_PATTERN:
        assert within(got, want, 1e-6)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", [n for n, p in rp.PATTERNS.items()
                                  if p.library])
def test_t5_library_call_matches_plain(name):
    ins = rp.pattern_inputs()[name]
    pat = rp.PATTERNS[name]
    r = t5_tool.check(name, pat.library(*ins), pat.plain(*ins),
                      t5_tool.LIB_RTOL)
    assert r[0], r


@pytest.mark.parametrize("stage", tq.STAGES + ("dma@knot", "mv@knot"))
@pytest.mark.parametrize("bs", [256, 576, 2304])
def test_t3_plan_fits_and_keeps_the_16_byte_rules(bs, stage):
    """T3's ring plan at bs 256 (the probe's shape), 576 and 2304 (64 and
    256 agents), Mi 71: one block per SM at most, covering every row of
    its split (the rung's flat rows for dma and mv, a knot's rows for the
    chain and @knot); it fits 227 KB with at least two slots as the kernel
    carves it (csrc/thomas_probe.cu: probe_floats); every tile's TMA copy
    (and mv's b row) starts and ends on 16 bytes; the coupling rows sit in
    shared memory at bs 256 and 576, koM^T also at 2304 beside a two-slot
    ring of 3-row tiles, while full's koM and koM^T (332 KB) go through
    L2 there."""
    Mi, sms = 71, 132
    st, knot = stage.split("@")[0], stage.endswith("@knot")
    flat = st in ("dma", "mv") and not knot
    plan = tq.probe_plan(bs, Mi, st, sms, knot)
    rows, nrow = plan.rows, Mi * bs if flat else bs
    assert plan.blocks <= sms and (plan.blocks - 1) * rows < nrow \
        <= plan.blocks * rows
    assert 2 <= plan.slots <= thomas.MAX_SLOTS
    assert plan.slot_bytes % 16 == 0
    assert plan.slot_bytes >= plan.tile_rows * bs * 4 + 15
    if flat:   # the whole span, or tiles past the chain's TILE_BYTES
        assert plan.tile_rows == rows or \
            plan.tile_rows * bs * 4 > thomas.TILE_BYTES
    else:
        assert plan.tile_rows == rows or \
            plan.tile_rows * bs * 4 <= thomas.TILE_BYTES
    chained = st in ("fwd", "full")
    assert plan.resident == (chained and (bs < 2304 or st == "fwd"))
    if chained and not plan.resident:
        assert rows <= tq.MAX_L2_ROWS
    if bs == 2304 and st == "fwd":
        assert (plan.tile_rows, plan.slots) == (3, 2)
    coup = rows * bs if plan.resident else 0
    floats = {"dma": 0,
              "mv": tq.span_knots(rows, bs, Mi) * bs if flat
              else plan.slots * bs,
              "fwd": bs + coup + tq.RED_FLOATS + rows,
              "full": 2 * bs + 2 * coup + tq.RED_FLOATS + rows
              + plan.blocks * rows + Mi * rows}[st]
    assert plan.smem == (thomas.BAR_BYTES + plan.slots * plan.slot_bytes
                         + 4 * floats)
    assert plan.smem <= thomas.SMEM_PER_BLOCK
    knots = {0} if flat else {0, 1, Mi - 1}
    for blk in range(plan.blocks):
        r0 = blk * rows
        r1 = min(r0 + rows, nrow)
        if flat:   # the b rows a span reads are those it has room for
            assert (r1 - 1) // bs - r0 // bs + 1 <= tq.span_knots(rows, bs,
                                                                   Mi)
        for a0 in range(r0, r1, plan.tile_rows):
            nr = min(plan.tile_rows, r1 - a0)
            for k in knots:
                a = (k * bs * bs + a0 * bs) * 4
                assert a % 16 == 0 and (nr * bs * 4) % 16 == 0
    assert (bs * 4) % 16 == 0   # mv's b rows, one a knot


@pytest.mark.parametrize("bs", [254, 2])
def test_t3_plan_refuses_rows_off_16_bytes(bs):
    with pytest.raises(ValueError, match="multiple of 4"):
        tq.probe_plan(bs, 4, "mv")


@pytest.mark.parametrize("M, grid", [(216, (32, 4)), (100, (32, 2)),
                                     (64, (32, 1)), (1, (32, 1))])
def test_t1_p3_plan_tiles_out_in_64_by_64_blocks(M, grid):
    """P3's launch at the probe's [M, 192] @ [192, 2048]: a block per
    64 x 64 tile of out (216 rows: 4 x 32 = 128 blocks, one wave on 132
    SMs), the M edge masked in the last row of tiles; its shared memory
    (the float32 panels, three bf16 planes of x and one of s, each row
    padded by 8) within 227 KB."""
    got, smem = npb.p3_plan(M, 192, 2048)
    assert got == grid
    assert smem == 2 * 64 * 192 * 4 + 2 * (3 * 64 * 200 + 192 * 72)
    assert smem <= npb.SMEM_PER_BLOCK


@pytest.mark.parametrize("K, N, match", [
    (192, 2016, "multiple of 64"), (192, 32, "multiple of 64"),
    (200, 2048, "multiple of 16"), (224, 2048, "shared memory")])
def test_t1_p3_plan_refuses_shapes_the_tiling_cannot_take(K, N, match):
    with pytest.raises(ValueError, match=match):
        npb.p3_plan(216, K, N)


# ---- wrappers ----

def _wrapper_calls():
    """(wrapper, a call of it on the given tensors' device) per kernel, on
    tiny inputs made from a seed."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    d, k, b = r(1, 3, 32, 32), r(32, 32), r(3, 32)
    x1, x3, s3 = r(216, 192), r(20, 32), r(32, 64)
    d6, y, ho, bt = r(2, 4, 3, 3, 192, 192), r(3, 192), r(3, 3), r(4, 3, 192)
    return [
        (tp.thomas_prim, lambda f: tp.thomas_prim(*map(f, (d, k, b)), "fwd",
                                                  2, 1)),
        (tq.thomas_probe, lambda f: tq.thomas_probe(*map(f, (d, k, b)),
                                                    "full", 0)),
        (npb.p1_reshape_combine, lambda f: npb.p1_reshape_combine(f(x1))),
        (npb.p2_tile_apply, lambda f: npb.p2_tile_apply(f(d6), f(y), 1)),
        (npb.p3_split_pair_product,
         lambda f: npb.p3_split_pair_product(f(x3), f(s3))),
        (npb.p4_resident_thomas,
         lambda f: npb.p4_resident_thomas(f(d6[:1]), f(ho), f(bt), 0, 1)),
        (rp.row_pattern, lambda f: rp.row_pattern(
            "P1b lane concat 2x[8,192] -> [8,384]", f(x1[:8, :192]))),
        (npb.p4_relayout, lambda f: npb.p4_relayout(f(d6), 1)),
        (npb.p4_resident_thomas,
         lambda f: npb.p4_chain(f(d6[0]).reshape(4, 576, 576), f(ho), f(bt),
                                1)),
    ]


@pytest.mark.parametrize("i", range(9))
def test_wrapper_runs_plain_version_only_on_cpu(i):
    wrapper, call = _wrapper_calls()[i]
    before = wrapper.launches
    out = call(lambda t: t)
    assert out.device.type == "cpu" and torch.isfinite(out).all()
    assert wrapper.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        call(lambda t: t.to("meta"))


# ---- tool entry points ----

TOOLS = {
    "thomas_prim_bench": (t2_tool, ["--bs", "32", "--mi", "3", "--reps",
                                    "1", "--modes", ",".join(T2_MODES)]),
    "thomas_probe": (t3_tool, ["--bs", "32", "--mi", "3"]),
    "nsfused_probe": (t1_tool, ["--probe", "1"]),
    "row_patterns": (t5_tool, []),
}


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_cpu_prints_json(capsys, name):
    mod, argv = TOOLS[name]
    assert mod.main(argv + ["--cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu"


def test_t3_ring_variant_recomputes_the_layout():
    """A study's variant of T3's plan carves shared memory as the plan
    does: the plan itself is its own variant, and a variant of another
    residency, tiling and depth matches a plan computed with them."""
    from swarm_simulator_tpu_torch.tools import t3_ring_study  # noqa: F401

    plan = tq.probe_plan(2304, 71, "fwd")
    assert tq.ring_variant(plan, 2304, 71, "fwd") == plan
    l2 = tq.ring_variant(plan, 2304, 71, "fwd", resident=False, tile_rows=5,
                         slots=4)
    assert l2.smem == plan.smem - 4 * plan.rows * 2304 \
        - 2 * plan.slot_bytes + 4 * thomas.slot_bytes(5, 2304, 4)
    assert l2.smem <= thomas.SMEM_PER_BLOCK
    knot = tq.probe_plan(576, 35, "mv", knot_spans=True)
    half = tq.ring_variant(knot, 576, 35, "mv", True, slots=4)
    assert knot.smem - half.smem == 4 * (knot.slot_bytes + 4 * 576)


def test_t3_ring_study_without_card_exits_nonzero(monkeypatch, capsys):
    from swarm_simulator_tpu_torch.tools import t3_ring_study

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t3_ring_study.main([]) != 0
    assert capsys.readouterr().out == ""


def test_t2_mxu_drift_without_card_exits_nonzero(monkeypatch, capsys):
    from swarm_simulator_tpu_torch.tools import t2_mxu_drift

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t2_mxu_drift.main([]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_without_card_exits_nonzero(monkeypatch, capsys, name):
    mod, argv = TOOLS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(argv) != 0
    assert capsys.readouterr().out == ""
