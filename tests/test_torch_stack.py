"""PyTorch port, the stack axis of the knot-state solve
(qp/nullspace.prepare_ns_stack, iterate_ns_stack, _dense_stack_chunk,
ops/nsfused.nsfused_stack) on the CPU, where the stacked kernel's plain
twin runs.  The 8-agent forest of tests/test_torch_jacobi.py in four
2-agent groups, in both KKT modes (banded: the stacked kernel's route;
dense: the batched dense chunk):

- the port's ``solve_ns_batched`` (float64) against the JAX package's
  vmapped one: x within 1e-6, equal iterations an entry, the entries
  stopping at different iterations, no per-entry ``_iterate_ns``, the
  preps ``prep_chunk`` at a time;
- ``prepare_ns_stack`` (3 entries, ``prep_chunk`` 2) bit-equal to
  ``prepare_ns`` on each entry, and within 1e-10 of the JAX package's
  ``lax.map``-chunked ``prepare_ns`` in float64;
- ``iterate_ns_stack`` bit-equal to ``_iterate_ns`` on each entry alone,
  in float64 and float32, cold and from returned states (init /
  return_state);
- an entry that stops early keeps its solo iterations and state, and is
  stepped no more, while the others run on; one host sync a chunk;
- an entry's result is the same alone, as a stack of one and in stacks
  of 3 and 4; a chunk leaves the frozen entries' rows as they were;
- ``jacobi_sweep`` prepares ``kkt_chunk`` groups at a time and iterates
  them as one stack; the stack's measuring tools exit 2 without a card;
- ``stack_fits`` on an H100 and ``stack_route``'s rule;
- the stacked kernel's cluster plan (``stack_plan``: blocks an entry,
  knots a partner, shared memory a block).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_jacobi import _port_data, groups  # noqa: E402,F401
from test_torch_seqbatch import one_thread  # noqa: E402,F401

from swarm_simulator_tpu.qp import nullspace as ns_j  # noqa: E402
from swarm_simulator_tpu_torch.ops import nsfused  # noqa: E402
from swarm_simulator_tpu_torch.parallel import mesh as mesh_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import admm as admm_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import nullspace as ns_t  # noqa: E402
from swarm_simulator_tpu_torch.utils import timing  # noqa: E402

MODES = ["banded", "dense"]
BANDED = dict(kkt_mode="banded", tighten=2e-3, max_iter=400)
#: a looser dual tolerance: the four groups stop at 350, 300, 250 and 300
#: iterations (in both modes)
STOPS = dict(BANDED, eps_dual_abs=0.1)


def _in(mode, base=BANDED, **kw):
    return dict(base, kkt_mode=mode, **kw)


@pytest.fixture
def spy(monkeypatch):
    """Record the running entries of each stack chunk (``stack``: an
    nsfused_stack launch; ``dense``: a _dense_stack_chunk), the entries of
    each prep chunk and the per-problem _iterate_ns calls."""
    calls = {"stack": [], "dense": [], "prep": [], "loop": 0}
    stack, dense = nsfused.nsfused_stack, ns_t._dense_stack_chunk
    loop, prep = ns_t._iterate_ns, ns_t._prepare_ns_impl

    def stack_spy(ops, active, *a, **kw):
        calls["stack"].append(list(active))
        return stack(ops, active, *a, **kw)

    def dense_spy(parts, ops, s, run, *a):
        calls["dense"].append(list(run))
        return dense(parts, ops, s, run, *a)

    def prep_spy(data, s):
        calls["prep"].append(data.lb.shape[0])
        return prep(data, s)

    def loop_spy(*a, **kw):
        calls["loop"] += 1
        return loop(*a, **kw)

    monkeypatch.setattr(nsfused, "nsfused_stack", stack_spy)
    monkeypatch.setattr(ns_t, "_dense_stack_chunk", dense_spy)
    monkeypatch.setattr(ns_t, "_prepare_ns_impl", prep_spy)
    monkeypatch.setattr(ns_t, "_iterate_ns", loop_spy)
    return calls


def _chunks(spy, mode):
    return spy["stack" if mode == "banded" else "dense"]


def _stacked(groups, dtype):
    """The groups' port QPData on the CPU in ``dtype``, stacked."""
    stacked = _port_data(groups[0]).to("cpu")
    return dataclasses.replace(stacked, **{
        f.name: getattr(stacked, f.name).to(dtype)
        for f in dataclasses.fields(stacked)
        if torch.is_floating_point(getattr(stacked, f.name))})


def _entries(groups, dtype, **kw):
    """The groups' port QPData on the CPU in ``dtype`` and their device
    preps of NSSettings(**kw), each alone."""
    stacked = _stacked(groups, dtype)
    s = ns_t.NSSettings(**kw)
    datas = [admm_t._tree_map(lambda a: a[i], stacked)
             for i in range(stacked.lb.shape[0])]
    return datas, [ns_t.prepare_ns(d, s) for d in datas], s


def _leaves(out):
    """The tensors of one (x, SolveInfo[, (w, z, y, rho_idx)])."""
    x, info = out[0], out[1]
    got = [x, *(torch.as_tensor(v) for v in info)]
    if len(out) > 2:
        w, z, y, rho = out[2]
        got += [w, *z, *y, torch.as_tensor(rho)]
    return got


def _bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for u, v in zip(la, lb):
        assert u.dtype == v.dtype and torch.equal(u, v)


@pytest.mark.parametrize("mode", MODES)
def test_solve_ns_batched_matches_jax(groups, spy, mode):
    """The float64 batched solve of the four groups, which stop at
    different iterations: each entry's iterations equal the JAX package's
    vmapped solve's, x within 1e-6; the chunks ran on the mode's stack
    route, none through a per-entry _iterate_ns, and the preps in chunks
    of ``prep_chunk``."""
    s = ns_j.NSSettings(**_in(mode, STOPS))
    xj, ij = ns_j.solve_ns_batched(jax.tree.map(jnp.asarray, groups[0]), s)
    x, info = ns_t.solve_ns_batched(_port_data(groups[0]),
                                    ns_t.NSSettings(**_in(mode, STOPS)),
                                    prep_chunk=3, device="cpu")
    assert info.iters.tolist() == np.asarray(ij.iters).tolist()
    assert len(set(info.iters.tolist())) > 1
    assert float(np.abs(x.numpy() - np.asarray(xj)).max()) < 1e-6
    assert _chunks(spy, mode) and spy["loop"] == 0
    assert spy["prep"] == [3, 1]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("mode", MODES)
def test_prepare_ns_stack_matches_alone_and_jax(groups, mode, dtype):
    """prepare_ns_stack of three entries in chunks of 2 (a chunk of two,
    then one of one): every leaf bit-equal to prepare_ns of the entry
    alone; in float64 within 1e-10 (relative to the leaf's scale) of the
    JAX package's prepare_ns mapped with lax.map(batch_size=2)."""
    stacked = admm_t._tree_map(lambda a: a[:3], _stacked(groups, dtype))
    s = ns_t.NSSettings(kkt_mode=mode)
    ops = ns_t.prepare_ns_stack(stacked, s, prep_chunk=2)
    assert len(ops) == 3
    for i, op in enumerate(ops):
        alone = ns_t.prepare_ns(admm_t._tree_map(lambda a: a[i], stacked), s)
        for f, a, b in zip(ns_t.NSOp._fields, op, alone):
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), f
    if dtype != torch.float64:
        return
    sj = ns_j.NSSettings(kkt_mode=mode)
    want = jax.jit(lambda d: jax.lax.map(lambda e: ns_j.prepare_ns(e, sj), d,
                                         batch_size=2))(
        jax.tree.map(lambda a: jnp.asarray(a[:3]), groups[0]))
    for f in ns_t.NSOp._fields:
        w = getattr(want, f)
        if w is None:
            assert getattr(ops[0], f) is None, f
            continue
        w = np.asarray(w)
        got = np.stack([getattr(op, f).numpy() for op in ops])
        if f == "ladder":
            w = w[0]
            got = got[0]
        assert np.abs(got - w).max() <= 1e-10 * max(np.abs(w).max(), 1e-30), f


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "init"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("mode", MODES)
def test_stack_bit_equal_to_loop(groups, mode, dtype, warm, spy):
    """iterate_ns_stack against _iterate_ns on each entry alone, bit for
    bit: x, SolveInfo and the returned state; with ``init``, a second
    solve from the first one's returned states."""
    datas, ops, s = _entries(groups, dtype, **_in(mode, max_iter=100))
    inits = None
    if warm:
        first = ns_t.iterate_ns_stack(datas, ops, s, return_state=True)
        inits = [o[2] for o in first]
        s = dataclasses.replace(s, max_iter=100, tighten=1e-3)
    n_loop = spy["loop"]
    got = ns_t.iterate_ns_stack(datas, ops, s, inits=inits,
                                return_state=True)
    assert _chunks(spy, mode) and spy["loop"] == n_loop
    for i, (d, op) in enumerate(zip(datas, ops)):
        _bit_equal(got[i], ns_t._iterate_ns(
            d, op, s, init=None if inits is None else inits[i],
            return_state=True))
    plain = ns_t.iterate_ns_stack(datas, ops, s, inits=inits)
    for a, b in zip(plain, got):
        assert len(a) == 2
        _bit_equal(a, b[:2])


@pytest.mark.parametrize("mode", MODES)
def test_stopped_entry_is_frozen(groups, spy, mode):
    """The groups stop at different iterations: each keeps its solo
    iterations and state, is stepped in one chunk a check_every of its
    iterations and, once stopped, in no later chunk while the others run
    on; the loop syncs with the host once a chunk."""
    datas, ops, s = _entries(groups, torch.float64, **_in(mode, STOPS))
    with timing.recording() as rec:
        got = ns_t.iterate_ns_stack(datas, ops, s, return_state=True)
    iters = [o[1].iters for o in got]
    chunks = _chunks(spy, mode)
    assert rec.counters["solve.syncs"] == len(chunks) \
        == max(iters) // s.check_every
    first = int(np.argmin(iters))
    assert iters[first] < max(iters)
    for i, it in enumerate(iters):
        assert sum(i in a for a in chunks) == it // s.check_every
    assert chunks[0] == [0, 1, 2, 3]
    assert first not in chunks[-1]
    for i, (d, op) in enumerate(zip(datas, ops)):
        _bit_equal(got[i], ns_t._iterate_ns(d, op, s, return_state=True))


def _chunk_inputs(datas, ops, s, mode):
    """The stack's chunk ``fn(run, rho, w, z, y)`` on the mode's route and
    its cold state as [L, ...] tensors."""
    colds = [ns_t._cold_state(d, op, s) for d, op in zip(datas, ops)]
    w, z, y = ns_t.stack_states([c[3] for c in colds])
    if mode == "banded":
        sops = nsfused.stack_operands([nsfused.build_operands(d, op, *c[:3])
                                       for d, op, c in zip(datas, ops,
                                                           colds)])

        def fn(run, rho, w, z, y):
            return nsfused.nsfused_stack(sops, run, rho, s.sigma, s.alpha,
                                         w, z, y, 7)
    else:
        parts = ns_t.stack_parts(datas, ops, colds)
        s7 = dataclasses.replace(s, check_every=7)

        def fn(run, rho, w, z, y):
            return ns_t._dense_stack_chunk(parts, ops, s7, run, rho, w, z, y)
    return fn, (w, z, y)


def _rows(state, i):
    w, z, y = ns_t.entry_state(state, i)
    return (w, *z, *y)


@pytest.mark.parametrize("mode", MODES)
def test_entry_alone_equals_entry_in_stack(groups, mode):
    """An entry's solve is the same alone, as a stack of one and in
    stacks of 3 and 4, bit for bit; so is one chunk of it (each entry on
    its own rung) in the whole stack and alone, and the chunk leaves the
    frozen entry's rows as they were."""
    datas, ops, s = _entries(groups, torch.float32, **_in(mode,
                                                          max_iter=100))
    alone = ns_t._iterate_ns(datas[2], ops[2], s, return_state=True)
    for pick in ([2], [0, 2, 3], [0, 1, 2, 3]):
        got = ns_t.iterate_ns_stack([datas[i] for i in pick],
                                    [ops[i] for i in pick], s,
                                    return_state=True)
        _bit_equal(got[pick.index(2)], alone)

    rungs = [3, 1, 4, 1]
    fn, state = _chunk_inputs(datas, ops, s, mode)
    out = fn([0, 2, 3], rungs, *state)
    one_fn, one_state = _chunk_inputs(datas[2:3], ops[2:3], s, mode)
    one = one_fn([0], rungs[2:3], *one_state)
    for a, b in zip(_rows(out, 1), _rows(state, 1)):
        assert torch.equal(a, b)
    for a, b in zip(_rows(out, 2), _rows(one, 0)):
        assert torch.equal(a, b)
    assert not torch.equal(out[0][2], state[0][2])


@pytest.mark.parametrize("mode", MODES)
def test_sweep_prepares_in_chunks_and_iterates_the_stack(groups, spy, mode):
    """The knot-state jacobi_sweep prepares its groups ``kkt_chunk`` at a
    time and iterates them as one stack on the mode's route, no group
    through a per-entry _iterate_ns."""
    stacked, dummy = groups
    s = ns_t.NSSettings(**_in(mode, max_iter=50))
    mesh_t.jacobi_sweep(_port_data(stacked), dummy, s, rounds=2,
                        kkt_chunk=3, device="cpu")
    assert spy["prep"] == [3, 1]
    assert len(_chunks(spy, mode)) == 2 and spy["loop"] == 0


@pytest.mark.parametrize("tool, argv", [
    ("profile_solve", ["--stack", "dense"]),
    ("prep_batch_study", [])])
def test_stack_tools_without_a_card_exit_2(monkeypatch, tool, argv):
    """profile_solve --stack and prep_batch_study measure the card: without
    one they exit 2."""
    from importlib import import_module

    mod = import_module(f"swarm_simulator_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [tool, *argv])
    assert mod.main(*([argv] if tool == "prep_batch_study" else [])) == 2


def test_stack_wrapper_refuses(groups):
    """No active entry, and state on a device that is neither the CPU nor
    a card (the kernel's checks run), raise ValueError."""
    datas, ops, s = _entries(groups, torch.float32, **BANDED)
    fn, (w, z, y) = _chunk_inputs(datas, ops, s, "banded")
    prep = [ns_t.cold_chunk_inputs(d, op, s) for d, op in zip(datas, ops)]
    sops = nsfused.stack_operands([p[0] for p in prep])
    with pytest.raises(ValueError, match="no active entry"):
        nsfused.nsfused_stack(sops, [], [0] * 4, s.sigma, s.alpha, w, z, y,
                              1)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        nsfused.nsfused_stack(sops, [0], [0] * 4, s.sigma, s.alpha,
                              w.to("meta"), z, y, 1)
    with pytest.raises(ValueError, match="dims"):
        nsfused.stack_operands([prep[0][0], prep[1][0]._replace(
            dims=dict(prep[1][0].dims, P=1))])


@pytest.mark.parametrize("B, fits", [(1, True), (2, True), (4, True),
                                     (8, False), (64, False)])
def test_stack_fits_on_h100(B, fits):
    """At M = 36 a group of 4 (bs 36, a 181,440-byte rung) fits a block's
    232,448 bytes with its vectors; 8 (725,760 bytes) and 64 do not."""
    assert nsfused.stack_fits(B, 36, 250, nsfused.H100) is fits
    assert (nsfused.stack_smem_bytes(B, 36) <= nsfused.H100.smem_optin) \
        is fits
    assert nsfused.rung_floats(36, 4) * 4 == 181440


@pytest.mark.parametrize("B, P, plan", [
    (1, 63, (5, 74640)),
    (2, 125, (5, 145712)),
    (4, 246, (6, 225376)),
    (4, 1000, None),
    (8, 250, None)], ids=["1", "2", "4", "4-wide", "8"])
def test_stack_plan_on_h100(B, P, plan):
    """The stacked kernel's cluster plan at M = 36 on an H100: the chain
    block and the fewest partners (from 4) whose shared memory holds their
    knots' columns of the state: 4 for a group of 1 or 2, 5 (7 knots each)
    for a 64-agent group of 4 (246 pairs); none for a 256-agent group of
    4 (~1000 pairs: no partner holds its columns even at 7) or a group of
    8 (its rung does not fit a block).  Every block within the card's
    232,448 bytes; the chain block's bytes are its barrier, the rung, rhs
    and the Thomas rows, two vectors, Ho and two slots of a stage's rows."""
    got = nsfused.stack_plan(B, 36, P, nsfused.H100)
    assert got == (None if plan is None else nsfused.StackPlan(*plan))
    assert nsfused.stack_fits(B, 36, P, nsfused.H100) is (plan is not None)
    if plan is None:
        return
    # a group of 4: barrier, rung, rhs, T rows, two vectors, Ho, two stage
    # slots
    assert nsfused.stack_smem_bytes(4, 36) == (16 + 181440 + 2 * 10080
                                               + 2 * 288 + 2448 + 2 * 10368)
    part = nsfused.stack_partner_bytes(B, 36, P, got.cluster)
    assert got.smem == max(nsfused.stack_smem_bytes(B, 36), part)
    assert got.smem <= nsfused.H100.smem_optin
    kq = nsfused.stack_partner_knots(36, got.cluster)
    assert (got.cluster - 2) * kq < 35 <= (got.cluster - 1) * kq


def test_stack_plan_adds_partners_to_fit():
    """Where 4 partners cannot hold their columns, the plan takes more
    (up to 7), and refuses when 7 cannot or the rung does not fit; a path
    of few knots takes fewer partners, each with a knot."""
    def lim(n):
        return nsfused.CardLimits(sms=132, smem_optin=n)

    assert nsfused.stack_plan(2, 36, 125, lim(110000)) == nsfused.StackPlan(
        7, 103200)
    assert nsfused.stack_plan(2, 36, 125, lim(100000)) == nsfused.StackPlan(
        8, 89024)
    assert nsfused.stack_plan(2, 36, 125, lim(85000)) is None
    assert nsfused.stack_plan(4, 36, 246, lim(200000)) is None  # the rung
    # no limit: 4 partners; Mi = 2 knots: 2 partners of one knot each
    assert nsfused.stack_plan(4, 36, 246).cluster == 5
    assert nsfused.stack_plan(1, 3, 10).cluster == 3
    assert nsfused.stack_partner_knots(3, 3) == 1


@pytest.mark.parametrize("change, route", [
    ({}, "stack"),
    ({"kkt_mode": "dense"}, "dense"),
    ({"kkt_refine": 1}, "loop"),
    ({"thomas_kernel": True}, "loop"),
    ({"aa_depth": 3}, "loop")],
    ids=["banded", "dense", "refine", "thomas_kernel", "aa_depth"])
def test_stack_route(groups, spy, change, route):
    """Banded refine-0 chunks take the stack kernel's route, dense
    refine-0 chunks the dense stack; kkt_refine, thomas_kernel and
    aa_depth take _iterate_ns on each entry; so do entries that differ in
    shape or KKT mode, and banded entries that do not fit a cluster (a
    card with less shared memory).  With no card's limits (a CPU stack)
    the settings and shapes alone decide."""
    datas, ops, s = _entries(groups, torch.float64,
                             **dict(BANDED, max_iter=50, **change))
    assert ns_t.stack_route(s, datas, ops, nsfused.H100) == route
    assert ns_t.stack_route(s, datas, ops) == route
    small = nsfused.CardLimits(sms=132, smem_optin=1024)
    assert ns_t.stack_route(s, datas, ops, small) == (
        "dense" if route == "dense" else "loop")
    short = dataclasses.replace(datas[1], pair_n=datas[1].pair_n[:-1])
    for limits in (nsfused.H100, None):
        assert ns_t.stack_route(s, [datas[0], short], ops[:2],
                                limits) == "loop"
    other = ns_t.prepare_ns(datas[1], dataclasses.replace(
        s, kkt_mode="banded" if s.kkt_mode == "dense" else "dense"))
    assert ns_t.stack_route(s, datas[:2], [ops[0], other]) == "loop"
    ns_t.iterate_ns_stack(datas, ops, s)
    if route == "loop":
        assert not spy["stack"] and not spy["dense"]
        assert spy["loop"] == len(datas)
    else:
        assert _chunks(spy, route if route == "dense" else "banded")
        assert spy["loop"] == 0
