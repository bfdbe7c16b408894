"""PyTorch port, corridor-refresh replans and device-prep cold plans: the
8-agent forest of tests/test_torch_pipeline.py planned in float64 on the
CPU by both packages, with ``iteration=2`` under each ``replan_prep`` and
with ``cold_prep="device"``.  Both must take the same iterations and
replan rounds and give control points within 1e-6 (of max(1, max|ctrl|)),
the tolerance of the cold slice's parity test."""
import numpy as np
import pytest

import swarm_simulator_tpu as sj
import swarm_simulator_tpu_torch as st
from swarm_simulator_tpu.io.mission_json import \
    perimeter_swap_mission as mission_j
from swarm_simulator_tpu.world.forest import generate_forest as forest_j
from swarm_simulator_tpu_torch.eval.gate import gate_quality as gate_t
from swarm_simulator_tpu_torch.io.mission_json import \
    perimeter_swap_mission as mission_t
from swarm_simulator_tpu_torch.qp import joint as joint_t
from swarm_simulator_tpu_torch.world.forest import generate_forest as forest_t

KW = dict(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
          solver="nullspace", solver_dtype="float64")
# forest seed 1: build_rsfc finds a separating plane for every pair of
# the cold solution, so each iteration=2 plan runs one replan round
FOREST = dict(obs_num=6, r_min=0.3, r_max=0.3, h_min=0.0, h_max=2.5,
              margin=0.5, seed=1)
MODES = {
    "replan_device": dict(iteration=2, replan_prep="device"),
    "replan_fresh": dict(iteration=2, replan_prep="fresh"),
    "replan_stale": dict(iteration=2, replan_prep="stale"),
    "cold_device": dict(cold_prep="device"),
}


def _plan(pkg, mission_fn, forest_fn, **change):
    param = pkg.Param(**KW, **change)
    mission = mission_fn(8, half=4.0, z=1.0, radius=0.15)
    world = forest_fn(mission, world_min=param.world_min,
                      world_max=param.world_max, **FOREST)
    kw = {"device": "cpu"} if pkg is st else {}
    result, _ = pkg.plan(mission, param, world, **kw)
    return result, mission, param


@pytest.fixture(scope="module", params=list(MODES))
def both(request):
    change = MODES[request.param]
    return (request.param,
            _plan(sj, mission_j, forest_j, **change),
            _plan(st, mission_t, forest_t, **change))


def test_replan_and_device_prep_match_jax_float64(both):
    mode, (rj, _, _), (rt, mt, pt) = both
    ij, it = rj.solver_info, rt.solver_info
    assert it["iters"] == ij["iters"]
    assert it["replan_rounds"] == ij["replan_rounds"]
    assert it["replan_rounds"] == (1 if mode.startswith("replan") else 0)
    if mode.startswith("replan"):
        assert it["replan_prep"] == mode.split("_")[1]
        assert len(it["replan_prep_s"]) == len(it["replan_solve_s"]) == 1
    scale = max(1.0, np.abs(rj.ctrl).max())
    assert np.abs(rt.ctrl - rj.ctrl).max() <= 1e-6 * scale
    ok, m = gate_t(rt.ctrl, rt, mt, pt, device="cpu")
    # a stale inventory under a full RSFC refresh leaves the boxes violated
    # in both packages (the JAX package's refresh_ns_op_np says so): that
    # mode is held to parity only
    assert ok or mode == "replan_stale", m


def test_replan_budgets_reach_the_replan_round():
    """pipeline.plan hands Param.replan_budgets to the replan round: a
    (50, 0, 0) schedule stops the round after one 50-iteration chunk,
    whatever the cold round took.  On the CPU replan_prep resolves to
    "fresh"."""
    result, _, _ = _plan(st, mission_t, forest_t, iteration=2,
                         replan_budgets=(50, 0, 0))
    info = result.solver_info
    assert info["replan_prep"] == "fresh"
    assert info["replan_rounds"] == 1
    assert info["replan_iters"] == [50] == info["iters"]


def test_replan_polish_runs_on_the_round_operator():
    """Param.replan_polish adds warm extensions after the replan round:
    the last solve is then an escalation schedule, one 50-iteration
    chunk at least in each of its three phases."""
    result, _, _ = _plan(st, mission_t, forest_t, iteration=2,
                         replan_budgets=(50, 0, 0), replan_polish=1)
    info = result.solver_info
    assert info["replan_rounds"] == 1
    assert 150 <= info["replan_iters"][0] <= sum(joint_t.ESCALATION_BUDGETS)


@pytest.mark.parametrize("kw, match", [
    ({"cold_prep": "device", "replan_prep": "stale"}, "stale"),
    ({"replan_prep": "warm"}, "replan_prep"),
    ({"cold_prep": "gpu"}, "cold_prep")])
def test_joint_rejects_bad_prep_modes(kw, match):
    param = st.Param(**KW)
    with pytest.raises(ValueError, match=match):
        joint_t.solve_trajectories(None, mission_t(4), param,
                                   device="cpu", **kw)
