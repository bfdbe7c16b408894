"""PyTorch port, the recorder of utils/timing on the Monte-Carlo path.

A tiny ``parallel/scenarios.run_monte_carlo`` (4 agents, 2 maps, two
Jacobi groups of 2 in two rounds, on the CPU) in both KKT modes of the
stacked ADMM (the dense inverse; cg with the adaptive rho ladder):
- the plans are bit for bit the same with the recorder on and off, and
  off nothing reaches a recorder;
- on, every span and counter of the path is recorded, the prep's on the
  pool's threads and the rest on the caller's, nested as the code nests
  them;
- ``admm.steps`` and ``solve.syncs`` match the loop's checks, rounds and
  readbacks, and cover each stack's iterations;
- ``stack.bytes`` is the bytes of the stack's operands, worked out again
  from the tensors themselves;
and the recorder loses no span or count when many threads record at
once.
"""
import sys
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_seqbatch import one_thread  # noqa: E402,F401

import swarm_simulator_tpu_torch as port  # noqa: E402
from swarm_simulator_tpu_torch.io import mission_json  # noqa: E402
from swarm_simulator_tpu_torch.parallel import scenarios  # noqa: E402
from swarm_simulator_tpu_torch.qp import admm  # noqa: E402
from swarm_simulator_tpu_torch.utils import timing  # noqa: E402

MODES = ["dense", "cg"]
WORKER = {"mc.prep_map", "prep.esdf", "prep.search", "prep.corridor"}
CALLER = {"mc.forest", "mc.prep", "mc.assemble", "sweep.prepare",
          "sweep.round", "admm.check", "admm.sync", "mc.readback"}
COUNTERS = {"admm.steps", "solve.syncs", "stack.bytes"}
#: the dense inverses' counters (qp/admm._block_tridiagonal_inverse)
DENSE_COUNTERS = {"kkt.dense_inverses", "kkt.not_pd"}


def _settings(kkt: str) -> admm.ADMMSettings:
    return admm.ADMMSettings(max_iter=500, eps_abs=2e-4, eps_rel=2e-4,
                             eps_dual_abs=1.5, kkt_solver=kkt,
                             adaptive_rho=kkt == "cg")


def _run(kkt: str):
    mission = mission_json.swap_mission(4, span=4.0, z=1.0, radius=0.12)
    param = port.Param(world_z_min=0.0, sequential=True, batch_size=2,
                       batch_iter=-1, iteration=2, grid_z_res=1.0)
    return scenarios.run_monte_carlo(
        mission, param, n_scenarios=2, seed0=5,
        forest_kwargs={"obs_num": 4}, settings=_settings(kkt),
        device="cpu")


@pytest.fixture(scope="module", params=MODES)
def runs(request, one_thread):  # noqa: F811
    """(mode, the plans off, what reached a recorder meanwhile, the plans
    on, the recorder, the operands each stack's _prepare_stack and ladders
    built)."""
    kkt = request.param
    reached = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timing.Recorder, "add",
                   lambda self, *a: reached.append(a))
        mp.setattr(timing.Recorder, "count",
                   lambda self, *a: reached.append(a))
        off = _run(kkt)
    ops = {"prepared": [], "ladders": []}
    prepare, spd_inv = admm._prepare_stack, admm._spd_inv

    def spy_prepare(data, s, chunk):
        out = prepare(data, s, chunk)
        ops["prepared"].append((data, out))
        return out

    def spy_inv(a):
        out = spd_inv(a)
        if a.dim() == 4:          # the ladder's bases [L, R, D, D]
            ops["ladders"].append((a, out))
        return out

    with pytest.MonkeyPatch.context() as mp, timing.recording() as rec:
        mp.setattr(admm, "_prepare_stack", spy_prepare)
        mp.setattr(admm, "_spd_inv", spy_inv)
        on = _run(kkt)
    return kkt, off, reached, on, rec, ops


def _inside(inner, outer) -> bool:
    return outer[2] <= inner[2] and inner[3] <= outer[3]


def test_plans_equal_with_the_recorder_on_and_off(runs):
    _, off, reached, on, _, _ = runs
    assert not reached
    assert all(sc.plan is not None and sc.plan.ctrl is not None
               for sc in off)
    for a, b in zip(off, on):
        assert np.array_equal(a.plan.ctrl, b.plan.ctrl)
        assert np.array_equal(a.plan.coef, b.plan.coef)
    assert timing.span("x") is timing.span("y", a=1)


def test_every_span_and_counter_on_its_thread_and_nested(runs):
    kkt, _, _, _, rec, ops = runs
    me = threading.get_ident()
    names = Counter(s[0] for s in rec.spans)
    assert set(names) == WORKER | CALLER
    if kkt == "dense":
        assert set(rec.counters) == COUNTERS | DENSE_COUNTERS
        assert rec.counters["kkt.dense_inverses"] == sum(
            data.lb.shape[0] for data, _ in ops["prepared"])
        assert rec.counters["kkt.not_pd"] == 0
    else:
        assert set(rec.counters) == COUNTERS
    for name, ident, t0, t1, attrs in rec.spans:
        assert t0 <= t1
        assert (ident != me) == (name in WORKER), name
    by = {n: [s for s in rec.spans if s[0] == n] for n in names}
    assert names["mc.prep_map"] == names["prep.search"] == 2
    prep = by["mc.prep"][0]
    for s in by["mc.prep_map"]:
        assert s[4]["wait_s"] >= 0 and _inside(s, prep)
    for stage in ("prep.esdf", "prep.search", "prep.corridor"):
        for s in by[stage]:
            assert any(_inside(s, m) and s[1] == m[1]
                       for m in by["mc.prep_map"])
    assert by["mc.forest"][0][3] <= prep[2]
    assert [s[4]["round"] for s in by["sweep.round"]] == \
        [0, 1] * names["mc.readback"]
    for inner, outer in (("admm.sync", "admm.check"),
                         ("admm.check", "sweep.round")):
        for s in by[inner]:
            assert sum(_inside(s, o) for o in by[outer]) == 1, inner
    for p, r in zip(by["sweep.prepare"], by["sweep.round"][::2]):
        assert p[3] <= r[2]
    for a, p, b in zip(by["mc.assemble"], by["sweep.prepare"],
                       by["mc.readback"]):
        assert prep[3] <= a[2] <= a[3] <= p[2] <= p[3] <= b[2]


def test_steps_and_syncs_match_the_checks(runs):
    kkt, _, _, on, rec, _ = runs
    every = _settings(kkt).check_every
    spans = sorted(rec.spans, key=lambda s: s[2])
    rounds = [s for s in spans if s[0] == "sweep.round"]
    checks = [[c for c in spans if c[0] == "admm.check" and _inside(c, r)]
              for r in rounds]
    readbacks = [s for s in spans if s[0] == "mc.readback"]
    # each round's loop: its checks that ran steps, and one more sync at
    # the head of the pass that ends it
    ran = sum(len(c) - 1 for c in checks)
    assert rec.counters["admm.steps"] == every * ran
    assert rec.counters["solve.syncs"] == \
        sum(len(c) for c in checks) + 2 * len(readbacks)
    # each stack (solved in the order of its segment count) steps at
    # least the most iterations any of its maps ran
    stacks = {}
    for sc in on:
        info = sc.plan.solver_info
        stacks.setdefault(info["M"], []).append(max(info["iters"]))
    assert len(stacks) == len(readbacks)
    start = -np.inf
    for b, M in zip(readbacks, sorted(stacks)):
        mine = [c for r, c in zip(rounds, checks) if start <= r[2]
                and r[3] <= b[2]]
        assert len(mine) == 2
        assert every * sum(len(c) - 1 for c in mine) >= max(stacks[M]) > 0
        start = b[3]


def _nbytes(*trees, seen=None) -> int:
    """The bytes of the tensors in ``trees``, a tensor that two leaves
    hold (a scaled problem keeps its problem's integer leaves) once."""
    seen = set() if seen is None else seen
    total = 0
    for tree in trees:
        if isinstance(tree, torch.Tensor):
            if tree.data_ptr() not in seen:
                seen.add(tree.data_ptr())
                total += tree.nbytes
        elif tree is None:
            continue
        elif hasattr(tree, "__dataclass_fields__"):
            total += _nbytes(*(getattr(tree, f)
                               for f in tree.__dataclass_fields__),
                             seen=seen)
        else:
            total += _nbytes(*tree, seen=seen)
    return total


def test_stack_bytes_are_the_operands(runs):
    kkt, _, _, _, rec, ops = runs
    want = sum(_nbytes(data, *out) for data, out in ops["prepared"])
    ladders = ops["ladders"]
    if kkt == "cg":
        # the ladder counts once a stack, at its first round
        assert len(ladders) == 2 * len(ops["prepared"])
        want += sum(_nbytes(*ladder) for ladder in ladders[::2])
    else:
        assert not ladders
    assert rec.counters["stack.bytes"] == want > 0


def test_many_threads_lose_no_span_or_count():
    threads, each = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timing.recording() as rec:
            def work():
                for i in range(each):
                    with timing.span("s", i=i):
                        timing.count("n")
                    timing.add_span("t", 0.0, 1.0)
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
        got = rec.drain()
    finally:
        sys.setswitchinterval(old)
    assert got["counters"] == {"n": threads * each}
    assert Counter(s[0] for s in got["spans"]) == {"s": threads * each,
                                                   "t": threads * each}
    assert rec.drain() == {"spans": [], "counters": {}}
    assert not timing.active()
