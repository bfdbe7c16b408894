"""PyTorch port, the slice as a whole: plan + evaluate against the JAX
package on the same 8-agent forest, in float64 on the CPU, the admm
solver and the flat corridors on a 4-agent swap, and no module of the
port raising NotImplementedError for a part of the JAX package."""
import sys
from pathlib import Path

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
from swarm_simulator_tpu_torch.world.forest import generate_forest as forest_t

sys.path[:0] = [str(Path(__file__).parent),
                str(Path(__file__).resolve().parents[1])]

import bench  # noqa: E402
from test_torch_seqbatch import one_thread  # noqa: E402,F401

KW = dict(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
          solver="nullspace", solver_dtype="float64")
FOREST = dict(obs_num=6, r_min=0.3, r_max=0.3, h_min=0.0, h_max=2.5,
              margin=0.5, seed=1)



@pytest.fixture(scope="module")
def both():
    out = {}
    for pkg, mission_fn, forest_fn in ((sj, mission_j, forest_j),
                                       (st, mission_t, forest_t)):
        param = pkg.Param(**KW)
        mission = mission_fn(8, half=4.0, z=1.0, radius=0.15)
        world = forest_fn(mission, world_min=param.world_min,
                          world_max=param.world_max, **FOREST)
        kw = {"device": "cpu"} if pkg is st else {}
        result, times = pkg.plan(mission, param, world, **kw)
        out[pkg.__name__] = (result, times, mission, param)
    return out["swarm_simulator_tpu"], out["swarm_simulator_tpu_torch"]


def test_plan_matches_jax_float64(both):
    (rj, _, _, _), (rt, tt, _, _) = both
    assert rt.solver_info["mode"] == "joint-nullspace"
    assert rt.solver_info["device"] == "cpu"
    assert rt.solver_info["iters"] == rj.solver_info["iters"]
    scale = max(1.0, np.abs(rj.ctrl).max())
    assert np.abs(rt.ctrl - rj.ctrl).max() <= 1e-6 * scale
    np.testing.assert_allclose(rt.coef, rj.coef, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(rt.T, rj.T)
    assert tt.extra["ns_prep"] > 0


def test_evaluate_and_gate_match_jax(both):
    (rj, _, mj, pj), (rt, _, mt, pt) = both
    ej = sj.evaluate(rj, mj, pj)
    et = st.evaluate(rt, mt, pt)
    assert ej.keys() == et.keys()
    for k in ej:
        assert abs(et[k] - ej[k]) <= 1e-6 * max(1.0, abs(ej[k])), k
    ok_j, m_j = bench.gate_quality(rj.ctrl, rj, mj, pj)
    ok_t, m_t = gate_t(rt.ctrl, rt, mt, pt, device="cpu")
    assert ok_t == ok_j
    assert ok_t, m_t
    for k in m_j:
        assert abs(float(m_t[k]) - float(m_j[k])) <= 1e-6, k


@pytest.mark.parametrize("change", [
    {"solver": "admm"}, {"corridor_mode": "flat"}])
def test_plan_rejects_unported_modes(change):
    """The two modes this test once held to NotImplementedError are ported
    (the sequential-batch ADMM and the flat corridors): the port's plan()
    of the 4-agent swap matches the JAX package's, the same iters and
    every evaluate() metric within 1e-6 of max(1, |value|)."""
    out = []
    for pkg, mission_fn in ((sj, mission_j), (st, mission_t)):
        param = pkg.Param(**{**KW, **change})
        kw = {"device": "cpu"} if pkg is st else {}
        result, _ = pkg.plan(mission_fn(4), param, **kw)
        out.append((result, pkg.evaluate(result, mission_fn(4), param,
                                         **kw)))
    (rj, ej), (rt, et) = out
    assert rt.solver_info["iters"] == rj.solver_info["iters"]
    assert ej.keys() == et.keys()
    for k in ej:
        assert abs(et[k] - ej[k]) <= 1e-6 * max(1.0, abs(ej[k])), k


def test_no_module_raises_not_implemented_for_a_roadmap_item():
    """Every part of the JAX package has its counterpart: no module of the
    port raises NotImplementedError, and none cites a ROADMAP item as left
    out."""
    import re

    root = Path(__file__).resolve().parents[1] / "swarm_simulator_tpu_torch"
    for src in sorted(root.rglob("*.py")):
        text = src.read_text()
        assert "NotImplementedError" not in text, src
        assert not re.search(r"ROADMAP queue 1,\s+item \d+", text), src
