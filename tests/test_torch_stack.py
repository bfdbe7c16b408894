"""PyTorch port, the stack axis of the knot-state solve
(qp/nullspace.iterate_ns_stack, ops/nsfused.nsfused_stack) on the CPU,
where the stacked kernel's plain twin runs.  The 8-agent forest of
tests/test_torch_jacobi.py in four 2-agent groups:

- the port's ``solve_ns_batched`` (banded, float64) against the JAX
  package's vmapped one: x within 1e-6, equal iterations an entry;
- ``iterate_ns_stack`` bit-equal to ``_iterate_ns`` on each entry alone,
  in float64 and float32, cold and from returned states (init /
  return_state);
- an entry that stops early keeps its solo iterations and state, and is
  launched no more, while the others run on;
- an entry's result is the same alone or in a stack;
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
from swarm_simulator_tpu_torch.qp import admm as admm_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import nullspace as ns_t  # noqa: E402

BANDED = dict(kkt_mode="banded", tighten=2e-3, max_iter=400)
#: a looser dual tolerance: the four groups stop at 350, 300, 250 and 300
#: iterations
STOPS = dict(BANDED, eps_dual_abs=0.1)


@pytest.fixture
def spy(monkeypatch):
    """Record the active entries of each nsfused_stack call and count the
    per-problem _iterate_ns calls."""
    calls = {"stack": [], "loop": 0}
    stack, loop = nsfused.nsfused_stack, ns_t._iterate_ns

    def stack_spy(ops, active, *a, **kw):
        calls["stack"].append(list(active))
        return stack(ops, active, *a, **kw)

    def loop_spy(*a, **kw):
        calls["loop"] += 1
        return loop(*a, **kw)

    monkeypatch.setattr(nsfused, "nsfused_stack", stack_spy)
    monkeypatch.setattr(ns_t, "_iterate_ns", loop_spy)
    return calls


def _entries(groups, dtype, **kw):
    """The groups' port QPData on the CPU in ``dtype`` and their device
    preps of NSSettings(**kw)."""
    stacked = _port_data(groups[0]).to("cpu")
    stacked = dataclasses.replace(stacked, **{
        f.name: getattr(stacked, f.name).to(dtype)
        for f in dataclasses.fields(stacked)
        if torch.is_floating_point(getattr(stacked, f.name))})
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


def test_solve_ns_batched_matches_jax(groups, spy):
    """The banded float64 batched solve of the four groups, which stop at
    different iterations: each entry's iterations equal the JAX package's
    vmapped solve's, x within 1e-6; the chunks ran as stack launches."""
    s = ns_j.NSSettings(**STOPS)
    xj, ij = ns_j.solve_ns_batched(jax.tree.map(jnp.asarray, groups[0]), s)
    x, info = ns_t.solve_ns_batched(_port_data(groups[0]),
                                    ns_t.NSSettings(**STOPS), device="cpu")
    assert info.iters.tolist() == np.asarray(ij.iters).tolist()
    assert len(set(info.iters.tolist())) > 1
    assert float(np.abs(x.numpy() - np.asarray(xj)).max()) < 1e-6
    assert spy["stack"] and spy["loop"] == 0


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "init"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_stack_bit_equal_to_loop(groups, dtype, warm, spy):
    """iterate_ns_stack against _iterate_ns on each entry alone, bit for
    bit: x, SolveInfo and the returned state; with ``init``, a second
    solve from the first one's returned states."""
    datas, ops, s = _entries(groups, dtype, **dict(BANDED, max_iter=100))
    inits = None
    if warm:
        first = ns_t.iterate_ns_stack(datas, ops, s, return_state=True)
        inits = [o[2] for o in first]
        s = dataclasses.replace(s, max_iter=100, tighten=1e-3)
    n_loop = spy["loop"]
    got = ns_t.iterate_ns_stack(datas, ops, s, inits=inits,
                                return_state=True)
    assert spy["stack"] and spy["loop"] == n_loop
    for i, (d, op) in enumerate(zip(datas, ops)):
        _bit_equal(got[i], ns_t._iterate_ns(
            d, op, s, init=None if inits is None else inits[i],
            return_state=True))
    plain = ns_t.iterate_ns_stack(datas, ops, s, inits=inits)
    for a, b in zip(plain, got):
        assert len(a) == 2
        _bit_equal(a, b[:2])


def test_stopped_entry_is_frozen(groups, spy):
    """The groups stop at different iterations: each keeps its solo
    iterations and state, is launched once a check_every of its
    iterations and, once stopped, in no later launch while the others run
    on."""
    datas, ops, s = _entries(groups, torch.float64, **STOPS)
    got = ns_t.iterate_ns_stack(datas, ops, s, return_state=True)
    iters = [o[1].iters for o in got]
    first = int(np.argmin(iters))
    assert iters[first] < max(iters)
    for i, it in enumerate(iters):
        assert sum(i in a for a in spy["stack"]) == it // s.check_every
    assert spy["stack"][0] == [0, 1, 2, 3]
    assert first not in spy["stack"][-1]
    for i, (d, op) in enumerate(zip(datas, ops)):
        _bit_equal(got[i], ns_t._iterate_ns(d, op, s, return_state=True))


def test_entry_alone_equals_entry_in_stack(groups):
    """An entry's solve and one stack chunk of it are the same in the whole
    stack and alone; the frozen entries' states are passed through."""
    datas, ops, s = _entries(groups, torch.float32,
                             **dict(BANDED, max_iter=100))
    whole = ns_t.iterate_ns_stack(datas, ops, s, return_state=True)
    alone = ns_t.iterate_ns_stack(datas[2:3], ops[2:3], s,
                                  return_state=True)
    _bit_equal(whole[2], alone[0])

    prep = [ns_t.cold_chunk_inputs(d, op, s) for d, op in zip(datas, ops)]
    sops = nsfused.stack_operands([p[0] for p in prep])
    w, z, y = (list(v) for v in zip(*(p[1] for p in prep)))
    rungs = [3, 1, 4, 1]
    out = nsfused.nsfused_stack(sops, [0, 2, 3], rungs, s.sigma, s.alpha,
                                w, z, y, 7)
    one = nsfused.nsfused_stack(nsfused.stack_operands([prep[2][0]]), [0],
                                rungs[2:3], s.sigma, s.alpha, w[2:3],
                                z[2:3], y[2:3], 7)
    assert out[0][1] is w[1] and out[1][1] is z[1] and out[2][1] is y[1]
    for a, b in zip((out[0][2], *out[1][2], *out[2][2]),
                    (one[0][0], *one[1][0], *one[2][0])):
        assert torch.equal(a, b)
    ref = nsfused.nsfused_chunk_reference(prep[3][0], 1, s.sigma, s.alpha,
                                          w[3], z[3], y[3], 7)
    for a, b in zip((out[0][3], *out[1][3], *out[2][3]),
                    (ref[0], *ref[1], *ref[2])):
        assert torch.equal(a, b)


def test_stack_wrapper_refuses(groups):
    """No active entry, and state on a device that is neither the CPU nor
    a card (the kernel's checks run), raise ValueError."""
    datas, ops, s = _entries(groups, torch.float32, **BANDED)
    prep = [ns_t.cold_chunk_inputs(d, op, s) for d, op in zip(datas, ops)]
    sops = nsfused.stack_operands([p[0] for p in prep])
    w, z, y = (list(v) for v in zip(*(p[1] for p in prep)))
    with pytest.raises(ValueError, match="no active entry"):
        nsfused.nsfused_stack(sops, [], [0] * 4, s.sigma, s.alpha, w, z, y,
                              1)
    meta = [t.to("meta") for t in w]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        nsfused.nsfused_stack(sops, [0], [0] * 4, s.sigma, s.alpha, meta, z,
                              y, 1)
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
    ({"kkt_mode": "dense"}, "loop"),
    ({"kkt_refine": 1}, "loop"),
    ({"thomas_kernel": True}, "loop"),
    ({"aa_depth": 3}, "loop")],
    ids=["banded", "dense", "refine", "thomas_kernel", "aa_depth"])
def test_stack_route(groups, spy, change, route):
    """Banded refine-0 chunks take the stack; dense mode, kkt_refine,
    thomas_kernel and aa_depth take _iterate_ns on each entry; so do
    entries that do not fit a block (a card with less shared memory) or
    that differ in shape.  With no card's limits (a CPU stack) the
    settings and shapes alone decide."""
    datas, ops, s = _entries(groups, torch.float64,
                             **dict(BANDED, max_iter=50, **change))
    assert ns_t.stack_route(s, datas, ops, nsfused.H100) == route
    assert ns_t.stack_route(s, datas, ops) == route
    small = nsfused.CardLimits(sms=132, smem_optin=1024)
    assert ns_t.stack_route(s, datas, ops, small) == "loop"
    short = dataclasses.replace(datas[1], pair_n=datas[1].pair_n[:-1])
    for limits in (nsfused.H100, None):
        assert ns_t.stack_route(s, [datas[0], short], ops[:2],
                                limits) == "loop"
    ns_t.iterate_ns_stack(datas, ops, s)
    if route == "stack":
        assert spy["stack"] and spy["loop"] == 0
    else:
        assert not spy["stack"] and spy["loop"] == len(datas)
