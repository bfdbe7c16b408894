"""PyTorch port, the slice as a whole: plan + evaluate against the JAX
package on the same 8-agent forest, in float64 on the CPU, the admm
solver and the flat corridors on a 4-agent swap, and each ROADMAP item
that the port's NotImplementedError messages cite names what they leave
out."""
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


#: the port's citations of ROADMAP queue 1 items: (source, the cited
#: item's number, a word the item's text holds)
CITED = [("qp/joint.py", 4, "solve_ns_phases"),
         ("qp/nullspace_shard.py", 4, "solve_ns_phases"),
         ("parallel/distributed.py", 7, "stack_across_processes"),
         ("cli/plan.py", 6, "qp/scp")]


@pytest.mark.parametrize("source,item,word", CITED)
def test_roadmap_citations_name_their_items(source, item, word):
    """Each "ROADMAP queue 1, item N" the port cites is an item of
    ROADMAP.md's queue 1 that names what the citing code leaves out, and
    the source cites no other item."""
    import re

    root = Path(__file__).resolve().parents[1]
    text = (root / "ROADMAP.md").read_text()
    queue = text[text.index("### 1. "):text.index("### 2. ")]
    items = dict(re.findall(r"^(\d+)\. (.*?)(?=^\d+\. |\Z)", queue,
                            re.M | re.S))
    assert word in items[str(item)]
    src = (root / "swarm_simulator_tpu_torch" / source).read_text()
    cited = set(re.findall(r"ROADMAP queue 1,\s+item (\d+)", src))
    assert str(item) in cited
    assert cited <= {str(i) for s, i, _ in CITED if s == source}
