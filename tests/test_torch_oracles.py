"""PyTorch port, the host oracles: the same inputs through both packages.

The port keeps the JAX package's host float64 oracles as numpy/scipy code
of its own (``qp/ipm``, ``qp/activeset``, ``assemble.relax_thin_knot_rows``)
and builds on them the gate's objective criterion (``eval/gate``:
``batch0_objective``, ``oracle_batch``, ``ipm_best_response_batch0``),
``exact_polish`` in ``qp/joint.solve_trajectories`` and
``joint.rescue_box_batches``.  The arithmetic is the JAX package's in the
same order, so on one CPU the two agree bit for bit wherever the inputs
are the same bits; most cases below hold their stated tolerance with
equality.

Problems: tests/test_qp.py's straight-line problem (the full-space IPM
only runs there: ~60 s on a forest batch), the in-repo 8-agent perimeter
forest of tests/test_torch_host.py (seed 1, 6 obstacles) in float64 with
sequential batches of 4, and tests/test_activeset.py's zero-width shared
face, whose barrier guess has equality candidates only.
"""
import copy
import dataclasses
import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

import swarm_simulator_tpu as sj
import swarm_simulator_tpu_torch as st
from swarm_simulator_tpu.qp import activeset as as_j
from swarm_simulator_tpu.qp import admm as admm_j
from swarm_simulator_tpu.qp import assemble as asm_j
from swarm_simulator_tpu.qp import ipm as ipm_j
from swarm_simulator_tpu.qp import joint as joint_j
from swarm_simulator_tpu_torch.core import types as types_t
from swarm_simulator_tpu_torch.eval import gate as gate_t
from swarm_simulator_tpu_torch.parallel import seqbatch as seqbatch_t
from swarm_simulator_tpu_torch.qp import activeset as as_t
from swarm_simulator_tpu_torch.qp import assemble as asm_t
from swarm_simulator_tpu_torch.qp import ipm as ipm_t
from swarm_simulator_tpu_torch.qp import joint as joint_t

sys.path[:0] = [str(Path(__file__).parent),
                str(Path(__file__).resolve().parents[1])]

import bench  # noqa: E402
from test_qp import _tiny_problem  # noqa: E402
from test_torch_seqbatch import one_thread  # noqa: E402,F401

#: the sequential batches of 4 the gate's oracle picks its batch from
BATCHES = dict(sequential=True, batch_size=4, batch_iter=-1)


def _port(obj):
    """A JAX package Param / Mission / PlanResult as the port's type (the
    two packages' dataclasses have the same fields); arrays copied."""
    cls = getattr(types_t, type(obj).__name__)
    return cls(**{f.name: copy.deepcopy(getattr(obj, f.name))
                  for f in dataclasses.fields(obj)})


def _tiny_batch(n_agents, M):
    """tests/test_qp._tiny_problem's batch of every agent in both packages:
    (JAX QPData, port QPData)."""
    plan, mission, param = _tiny_problem(n_agents=n_agents, M=M)
    dummy = asm_j.build_dummy(plan.init_traj, param.n)
    agents = np.arange(n_agents)
    return (asm_j.assemble_batch(plan, mission, param, agents, dummy,
                                 device=False),
            asm_t.assemble_batch(_port(plan), _port(mission), _port(param),
                                 agents, dummy))


def _forest(pkg):
    """The 8-agent perimeter forest (tests/test_torch_host.py's
    perimeter8_f32 problem built in float64) up to its corridors:
    (plan, mission, param), param with sequential batches of 4."""
    mj = __import__(f"{pkg.__name__}.io.mission_json", fromlist=["x"])
    forest = __import__(f"{pkg.__name__}.world.forest", fromlist=["x"])
    esdf_m = __import__(f"{pkg.__name__}.world.esdf", fromlist=["x"])
    search = __import__(f"{pkg.__name__}.search.planner", fromlist=["x"])
    corr = __import__(f"{pkg.__name__}.corridor.times", fromlist=["x"])
    param = pkg.Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                      solver="nullspace", solver_dtype="float64", **BATCHES)
    mission = mj.perimeter_swap_mission(n_agents=8, half=4.0, z=1.0,
                                        radius=0.15)
    world = forest.generate_forest(
        mission, world_min=param.world_min, world_max=param.world_max,
        obs_num=6, r_min=0.3, r_max=0.3, h_min=0.0, h_max=2.5, margin=0.5,
        seed=1)
    esdf = esdf_m.ESDF(world, max_dist=param.esdf_max_dist)
    plan = search.plan_initial_trajectories(esdf, mission, param)
    corr.build_corridors(esdf, plan, mission.radius, param)
    return plan, mission, param


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """One BLAS thread for the oracles' dense factorizations: in tier-1's
    six workers a multi-threaded OpenBLAS a worker took this file's IPM
    tests 59-132 s each; on one thread they take 1-3 s."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:     # the BLAS default then
        yield
        return
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture(scope="module")
def forest():
    """Both packages' 8-agent forest, batch 0's QP of each (the fixed
    agents at the initTraj dummy), and the JAX reduced IPM's optimum of
    that batch."""
    fj, ft = _forest(sj), _forest(st)
    (plan_j, mission_j, param_j), (plan_t, mission_t, param_t) = fj, ft
    batches, _ = seqbatch_t.make_batches(mission_t.qn, param_t)
    dummy = asm_j.build_dummy(plan_j.init_traj, param_j.n)
    data_j = asm_j.assemble_batch(plan_j, mission_j, param_j, batches[0],
                                  dummy, device=False)
    data_t = asm_t.assemble_batch(plan_t, mission_t, param_t, batches[0],
                                  dummy)
    return dict(jax=fj, port=ft, data_j=data_j, data_t=data_t,
                res_j=ipm_j.solve_ipm_reduced(data_j))


@pytest.fixture(scope="module")
def port_plan(forest):
    """The port's plan of the forest (host prep, the production phases),
    float64 on the CPU."""
    plan, mission, param = forest["port"]
    return joint_t.solve_trajectories(copy.deepcopy(plan), mission, param,
                                      device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_relax_thin_knot_rows_bit_equal(seed):
    """Seeded bounds whose duplicated knot rows are zero-width, thin
    (< 2 KNOT_FACE_GUARD) or wide: the same relaxed bounds, bit for
    bit."""
    rng = np.random.default_rng(seed)
    B, M, n = 3, 5, 5
    npp = n + 1
    lb = rng.uniform(-2.0, 0.0, size=(B, 3, M, npp))
    ub = lb + rng.uniform(0.5, 2.0, size=lb.shape)
    # knot m: (m-1, n) and (m, 0); widths 0, 1e-3 (thin), wide
    width = rng.choice([0.0, 1e-3, 0.3], size=(B, 3, M - 1))
    lb[:, :, 1:, 0] = lb[:, :, :-1, n]
    ub[:, :, :-1, n] = lb[:, :, :-1, n] + width
    ub[:, :, 1:, 0] = ub[:, :, :-1, n] + rng.uniform(0.0, 1.0, width.shape)
    lb, ub = lb.reshape(B, 3, M * npp), ub.reshape(B, 3, M * npp)
    got = asm_t.relax_thin_knot_rows(lb, ub, n)
    want = asm_j.relax_thin_knot_rows(lb, ub, n)
    assert (width < 2 * asm_t.KNOT_FACE_GUARD).any() and (width > 0.1).any()
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert not np.array_equal(got[0], lb)


@pytest.mark.parametrize("n_agents,M", [(2, 3), (3, 4)])
def test_full_space_ipm_bit_equal_on_tiny_problem(n_agents, M):
    """build_flat, solve_ipm and verify_optimal on the straight-line
    problem: the same arrays and iterates, bit for bit (no operation
    changed order), and the same KKT residuals."""
    data_j, data_t = _tiny_batch(n_agents, M)
    for a, b in zip(ipm_j.build_flat(data_j), ipm_t.build_flat(data_t)):
        a = a.toarray() if hasattr(a, "toarray") else a
        b = b.toarray() if hasattr(b, "toarray") else b
        assert a.shape == b.shape and np.array_equal(a, b)
    rj, rt = ipm_j.solve_ipm(data_j), ipm_t.solve_ipm(data_t)
    assert rt.iters == rj.iters and rt.mu == rj.mu
    for k in ("x", "y", "lam", "s"):
        assert np.array_equal(getattr(rt, k), getattr(rj, k)), k
    assert (rt.r_dual, rt.r_eq, rt.r_ineq) == (rj.r_dual, rj.r_eq, rj.r_ineq)
    assert (ipm_t.verify_optimal(data_t, rt)
            == ipm_j.verify_optimal(data_j, rj))


def test_reduced_ipm_on_forest_batch(forest):
    """solve_ipm_reduced on batch 0 of the 8-agent forest: x and the
    objective within 1e-10 of max(1, |value|) of the JAX package's, and
    both pass verify_optimal at 1e-5."""
    rj = forest["res_j"]
    rt = ipm_t.solve_ipm_reduced(forest["data_t"])
    assert rt.iters == rj.iters
    assert np.abs(rt.x - rj.x).max() <= 1e-10 * max(1.0, np.abs(rj.x).max())
    Q = ipm_j.build_flat(forest["data_j"])[0]
    obj_j = 0.5 * rj.x.reshape(-1) @ Q @ rj.x.reshape(-1)
    obj_t = 0.5 * rt.x.reshape(-1) @ Q @ rt.x.reshape(-1)
    assert abs(obj_t - obj_j) <= 1e-10 * max(1.0, abs(obj_j))
    ipm_j.verify_optimal(forest["data_j"], rj, tol=1e-5)
    ipm_t.verify_optimal(forest["data_t"], rt, tol=1e-5)


def test_polish_on_forest_batch(forest):
    """activeset.polish of batch 0 from the IPM optimum plus seeded noise
    (3e-2 m: two passes): x within 1e-9 of the JAX package's, the same
    accepted / kkt_optimal / passes / n_active, and the certified point on
    the IPM optimum (within its 1e-9 barrier tolerance's reach)."""
    rng = np.random.default_rng(1)
    x0 = forest["res_j"].x + 3e-2 * rng.normal(size=forest["res_j"].x.shape)
    xj, ij = as_j.polish(forest["data_j"], x0)
    xt, it = as_t.polish(forest["data_t"], x0)
    for k in ("accepted", "kkt_optimal", "passes", "n_active"):
        assert it[k] == ij[k], k
    assert it["accepted"] and it["kkt_optimal"] and it["passes"] > 1
    assert np.abs(xt - xj).max() <= 1e-9
    assert np.abs(xt - forest["res_j"].x).max() < 1e-4


def test_polish_equality_only_candidates_warns_nothing():
    """tests/test_activeset.py's zero-width shared face from its ADMM
    point: every candidate row of the barrier guess is the knot's
    equality (the JAX package divides by the empty inequality count there
    and warns).  The port's polish raises no warning under
    simplefilter("error") and lands on the JAX package's x within 1e-9,
    both accepted, the knot on y = 0."""
    plan, mission, param = _tiny_problem(n_agents=1, M=4)
    mission.start[0, :3] = (-1.0, -0.8, 0.5)
    mission.goal[0, :3] = (1.0, 0.8, 0.5)
    L = plan.init_traj.shape[1]
    for k in range(3):
        plan.init_traj[0, :, k] = np.linspace(
            mission.start[0, k], mission.goal[0, k], L)
    plan.seg_boxes[0, :2, 1] = -5.0
    plan.seg_boxes[0, :2, 4] = 0.0
    plan.seg_boxes[0, 2:, 1] = 0.0
    plan.seg_boxes[0, 2:, 4] = 5.0
    dummy = asm_j.build_dummy(plan.init_traj, param.n)
    data_j = asm_j.assemble_batch(plan, mission, param, np.array([0]),
                                  dummy, device=False)
    data_t = asm_t.assemble_batch(_port(plan), _port(mission), _port(param),
                                  np.array([0]), dummy)
    x_admm, _ = admm_j.solve_qp(data_j, admm_j.ADMMSettings(
        max_iter=4000, eps_abs=1e-7, eps_rel=1e-7))
    x_admm = np.asarray(x_admm, np.float64)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        xj, ij = as_j.polish(data_j, x_admm)
    assert any(issubclass(w.category, RuntimeWarning) for w in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        xt, it = as_t.polish(data_t, x_admm)
    assert ij["accepted"] and it["accepted"]
    assert it["kkt_optimal"] == ij["kkt_optimal"]
    assert np.abs(xt - xj).max() <= 1e-9
    npp = param.n + 1
    xs = xt.transpose(0, 2, 1).reshape(1, plan.M, npp, 3)
    assert abs(xs[0, 1, npp - 1, 1]) < 1e-9 and abs(xs[0, 2, 0, 1]) < 1e-9


def test_oracle_gate_matches_bench(forest, port_plan):
    """The port's plan of the forest graded by the port's oracle gate and
    by bench.py's on the same control points: batch0_objective and
    ipm_best_response_batch0 of the rotated batch within 1e-9 relative,
    and the same verdict at obj_tol 1.25 and at a tolerance the margin
    exceeds."""
    plan_j, mission_j, param_j = forest["jax"]
    _, mission, param = forest["port"]
    ctrl = port_plan.ctrl
    b_idx = gate_t.oracle_batch(1, 2)
    assert b_idx == bench.oracle_batch(1, 2) == 1
    ob_t, _ = gate_t.batch0_objective(ctrl, port_plan, mission, param, b_idx)
    ob_j, _ = bench.batch0_objective(ctrl, plan_j, mission_j, param_j, b_idx)
    ref_t, _ = gate_t.ipm_best_response_batch0(port_plan, mission, param,
                                               ctrl, b_idx)
    ref_j, _ = bench.ipm_best_response_batch0(plan_j, mission_j, param_j,
                                              ctrl, b_idx)
    assert abs(ob_t - ob_j) <= 1e-9 * abs(ob_j)
    assert abs(ref_t - ref_j) <= 1e-9 * abs(ref_j)
    margin = ob_t / ref_t
    assert 1.0 < margin < 1.25
    for tol in (1.25, 0.5 * (1.0 + margin)):
        ok_t, m_t = gate_t.gate_quality(ctrl, port_plan, mission, param,
                                        ref_t, ob_t, obj_tol=tol,
                                        device="cpu")
        ok_j, m_j = bench.gate_quality(ctrl, plan_j, mission_j, param_j,
                                       ref_j, ob_j, obj_tol=tol)
        assert ok_t == ok_j == (tol == 1.25), (tol, m_t)
        assert m_t["obj_b0"] == ob_t and m_t["obj_ref"] == ref_t


@pytest.mark.parametrize("iteration", [1, 2])
def test_exact_polish_matches_jax(forest, iteration):
    """solve_trajectories(..., exact_polish=True) on the forest, float64 on
    the CPU: control points within 1e-6 of the JAX package's; the last
    round's polish info equals JAX's exact_polish info in accepted and
    n_active, and exact_polish_rounds keeps one entry per round."""
    plan_j, mission_j, param_j = forest["jax"]
    plan_t, mission_t, param_t = forest["port"]
    rj = joint_j.solve_trajectories(
        copy.deepcopy(plan_j), mission_j,
        dataclasses.replace(param_j, iteration=iteration), exact_polish=True)
    rt = joint_t.solve_trajectories(
        copy.deepcopy(plan_t), mission_t,
        dataclasses.replace(param_t, iteration=iteration), exact_polish=True,
        device="cpu")
    assert np.abs(rt.ctrl - rj.ctrl).max() <= 1e-6
    got, want = rt.solver_info["exact_polish"], rj.solver_info["exact_polish"]
    assert got.keys() == want.keys()
    assert got["accepted"] == want["accepted"]
    assert got["n_active"] == want["n_active"]
    rounds = rt.solver_info["exact_polish_rounds"]
    assert len(rounds) == iteration and rounds[-1] is got
    assert all(r["accepted"] for r in rounds)
    assert all(r["obj_out"] <= r["obj_in"] + 1e-9 for r in rounds)


def test_rescue_box_batches_matches_jax(forest, port_plan):
    """One control point of agent 5 pushed 5e-3 out of its box: both
    packages rescue the same batch (agents 4-7) and return control points
    within 1e-8; the rescued plan is back inside its boxes (1e-3)."""
    plan_j, mission_j, param_j = forest["jax"]
    _, mission, param = forest["port"]
    ctrl = port_plan.ctrl.copy()
    ctrl[5, 3, 2, 0] = port_plan.seg_boxes[5, 3, 3] + 5e-3
    out_t, bad_t = joint_t.rescue_box_batches(port_plan, mission, param,
                                              ctrl)
    out_j, bad_j = joint_j.rescue_box_batches(plan_j, mission_j, param_j,
                                              ctrl)
    assert bad_t == bad_j == [1]
    assert np.abs(out_t - out_j).max() <= 1e-8
    boxes = port_plan.seg_boxes
    viol = np.maximum(boxes[:, :, None, :3] - out_t,
                      out_t - boxes[:, :, None, 3:]).max()
    assert viol < 1e-3
    assert np.array_equal(out_t[:4], ctrl[:4])


def test_cli_exact_polish_prints_its_info(tmp_path, capsys):
    """``cli.plan --solver nullspace --exact-polish --device cpu`` on the
    4-agent perimeter swap: exit 0, one line of polish info (accepted,
    kkt_optimal, passes, n_active) after the metrics, and the same info
    under --json."""
    from swarm_simulator_tpu_torch.cli.plan import main
    from swarm_simulator_tpu_torch.io.mission_json import \
        perimeter_swap_mission

    m = perimeter_swap_mission(4)
    doc = {"quadrotors": {}, "agents": []}
    for qi, name in enumerate(m.names):
        doc["quadrotors"][name] = {"max_vel": m.max_vel[qi].tolist(),
                                   "max_acc": m.max_acc[qi].tolist()}
        doc["agents"].append({"name": name, "start": m.start[qi].tolist(),
                              "goal": m.goal[qi].tolist(),
                              "radius": float(m.radius[qi]),
                              "speed": float(m.speed[qi])})
    path = tmp_path / "mission.json"
    path.write_text(json.dumps(doc))
    args = ["--mission", str(path), "--solver", "nullspace",
            "--exact-polish", "--dtype", "float64", "--device", "cpu"]
    assert main(args) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "RESULT: collision-free"
    assert lines[-2].startswith("exact polish round 0: accepted=True "
                                "kkt_optimal=")
    for word in ("passes=", "n_active="):
        assert word in lines[-2]
    assert main([*args, "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (info,) = out["exact_polish"]
    assert info["accepted"] is True and info["n_active"] >= 0
