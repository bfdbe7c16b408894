"""The plan entry (swarmbench/program.py) on the CPU at a tiny size: its
spans against the plan's own StageTimes, the module attributes it wraps
put back, the time-scale undo of what the reference reads, and K1's
roofline counting the work that chip_smoke.py counts."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from _tiny import tiny
from swarmbench import program, roofline


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    """One request of the tiny forest64_joint cell, planned under
    Program.traced with a spy on the joint solve's arguments."""
    from swarm_simulator_tpu_torch.qp import nullspace

    man = tiny(tmp_path_factory.mktemp("plan"), "forest64_joint")
    prog = program.Program(man.config("tiny"), torch.device("cpu"))
    seen = []
    orig = nullspace.solve_ns_phases

    def spy(data, phases, *a, **kw):
        seen.append((data, phases, kw["op"]))
        return orig(data, phases, *a, **kw)

    nullspace.solve_ns_phases = spy
    try:
        with prog.traced():
            (sc,) = prog.plan(0, 1)
    finally:
        nullspace.solve_ns_phases = orig
    return prog, sc, seen


def test_the_spans_agree_with_the_plans_stage_times(planned):
    prog, sc, _ = planned
    assert program.planned(sc), sc.error
    span = {k: sum(b - a for name, a, b in prog.spans if name == k)
            for k in ("search", "corridor", "ns_prep", "ns_solve")}
    t = sc.times
    pairs = [(span["search"], t["esdf"] + t["init_traj"]),
             (span["corridor"], t["corridor"]),
             # on the CPU the inventory's upload is a view
             (span["ns_prep"], t["extra"]["ns_prep"]),
             (span["ns_solve"], sc.plan.solver_info["solve_s"])]
    for got, want in pairs:
        assert abs(got - want) < 1e-3, (got, want)
    assert t["check_every"] == [50, 50, 50]
    assert t["solve_s"] == sc.plan.solver_info["solve_s"]
    assert {name for name, _, _ in prog.spans} == {
        "forest", "plan", "search", "corridor", "ns_prep", "ns_solve"}


def test_traced_puts_back_what_it_wraps(tmp_path):
    from swarm_simulator_tpu_torch import pipeline
    from swarm_simulator_tpu_torch.parallel import scenarios
    from swarm_simulator_tpu_torch.qp import nullspace

    attrs = [(pipeline, "ESDF"), (pipeline, "plan_initial_trajectories"),
             (pipeline, "build_corridors"), (nullspace, "prepare_ns_np"),
             (nullspace, "solve_ns_phases"),
             (scenarios, "prep_scenarios"), (scenarios, "solve_scenarios")]
    before = [getattr(m, a) for m, a in attrs]
    for config in ("forest64_joint", "forest64_mc"):
        man = tiny(tmp_path / config, config)
        prog = program.Program(man.config("tiny"), torch.device("cpu"))
        with pytest.raises(RuntimeError), prog.traced():
            assert [getattr(m, a) for m, a in attrs] != before
            raise RuntimeError("a run that fails inside")
        assert [getattr(m, a) for m, a in attrs] == before


def test_the_time_scale_undo_round_trips_a_plan(planned):
    """keep() hands the reference the solve's own plan: a plan scaled by
    pipeline.plan's time scaling, scaled back, is the solve's."""
    from swarm_simulator_tpu_torch.qp import convert, timescale

    _, sc, _ = planned
    sc = dataclasses.replace(sc, plan=copy.copy(sc.plan),
                             times=copy.deepcopy(sc.times))
    p = sc.plan
    ctrl, n = np.asarray(p.ctrl), p.coef.shape[2] - 1
    T = np.asarray(p.T) / sc.times["extra"]["time_scale"]
    solved = convert.ctrl_to_coef(ctrl, T, n)
    for scale in (1.0, 1.1 ** 3, 1.1 ** 11):
        coef, Ts = timescale.apply_time_scale(solved, T, scale, n)
        p.coef, p.T = coef, Ts
        sc.times["extra"]["time_scale"] = scale
        kept = program.keep(sc)
        assert kept["time_scale"] == scale
        np.testing.assert_allclose(kept["plan"]["T"], T, rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(kept["plan"]["coef"], solved,
                                   rtol=1e-12, atol=1e-12)
        assert kept["plan"]["ctrl"] is not None


def test_k1_roofline_counts_chip_smokes_work(planned):
    """roofline.k1_chunk from the request's recorded shape against
    chip_smoke.chunk_work on the operands K1 is launched with."""
    import chip_smoke
    from swarm_simulator_tpu_torch.qp import nullspace

    prog, sc, seen = planned
    data, phases, op = seen[0]
    data = data.to("cpu")
    ops, cold = nullspace.cold_chunk_inputs(data, op, phases[0])
    assert all(t.element_size() == 4 for t in (cold[0], *cold[1]))
    nbytes, flops = chip_smoke.chunk_work(ops, cold)
    s = prog.shape(sc)
    assert s["check_every"] == [chip_smoke.N_INNER] * 3
    assert roofline.k1_chunk(s["qn"], s["M"], s["pairs"], s["phi"],
                             s["n"], chip_smoke.N_INNER) == (nbytes, flops)


def test_the_roofline_reader(tmp_path):
    """k1_roofline_pct.plan from a synthetic record: the counter's
    launches at their shapes' bound over K1's traced seconds, the stacked
    kernel left out; nothing without a launch or a trace."""
    from swarmbench.manifest import Manifest

    read = Manifest().reader("k1_roofline_pct.plan")
    shape = {"qn": 64, "M": 36, "pairs": 2016, "phi": 3, "n": 5,
             "check_every": [50, 50, 50]}
    one = roofline.bound_s(*roofline.k1_chunk(64, 36, 2016, 3, 5, 50))
    rec = {"batches": [{"k1_launches": 18, "shapes": [shape]},
                       {"k1_launches": 0, "shapes": [None]}],
           "trace": {"by_name": {"nsfused_kernel(Params)": [18, 0.2],
                                 "nsfused_stack_kernel(Params)": [4, 9.0],
                                 "gemm": [3, 1.0]}}}
    assert read(rec) == pytest.approx(100 * 18 * one / 0.2)
    assert roofline.k1_in_trace(rec["trace"]) == (18, 0.2)
    assert read({"batches": rec["batches"], "trace": {}}) is None
    assert read({"batches": [{"k1_launches": 0, "shapes": [shape]}],
                 "trace": rec["trace"]}) is None
