"""PyTorch port, the sequential-batch path end to end: ``plan()`` +
``evaluate()`` through the JAX package (x64 on the CPU) and the port
(float64, ``device="cpu"``) on tests/test_pipeline.py's problems: the
2-agent sequential swap, the 8-agent Jacobi swap and the flat corridors
here, the 8-agent forest with ``Param()``'s defaults (one joint batch,
dense KKT) in tests/test_torch_seqbatch_forest.py.  The same knot times
and iters, coef within 1e-6, every metric within 1e-6, and
tests/test_pipeline.py's acceptance on the port's plan.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import swarm_simulator_tpu as sj
import swarm_simulator_tpu_torch as st

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_seqbatch import one_thread  # noqa: E402,F401

RTOL = 1e-6



def _close(got, want):
    return float(np.abs(got - want).max()) <= RTOL * max(
        1.0, float(np.abs(want).max()))


# plan() + evaluate() through both packages: tests/test_pipeline.py's
# problems, as (mission kwargs, forest seed or None, Param overrides)
PLANS = {
    "swap2-sequential": (dict(n_agents=2, z=0.5, span=1.0, radius=0.25),
                         None, dict(sequential=True, batch_size=1,
                                    batch_iter=-1)),
    "swap8-jacobi": (dict(n_agents=8, z=1.0, span=4.0, radius=0.12), None,
                     dict(sequential=True, batch_size=2, batch_iter=-1,
                          iteration=2, parallel_mode="jacobi")),
    "forest8-default": (dict(n_agents=8, z=1.0, span=4.0, radius=0.12), 7,
                        dict()),
    "swap2-flat": (dict(n_agents=2, z=0.5, span=1.0, radius=0.25), None,
                   dict(corridor_mode="flat")),
}


@pytest.mark.parametrize("name", [k for k in PLANS if k != "forest8-default"])
def test_plan_and_evaluate_match_jax(name):
    check_plan(name)


def check_plan(name):
    """The port's plan() on the CPU against the JAX package's: the same
    knot times and iters, coef within 1e-6, every evaluate() metric within
    1e-6 (of max(1, |value|)), and tests/test_pipeline.py's acceptance."""
    from swarm_simulator_tpu.io.mission_json import swap_mission as sm_j
    from swarm_simulator_tpu.world.forest import generate_forest as gf_j
    from swarm_simulator_tpu_torch.io.mission_json import \
        swap_mission as sm_t
    from swarm_simulator_tpu_torch.world.forest import \
        generate_forest as gf_t

    mkw, seed, over = PLANS[name]
    out = []
    for pkg, sm, gf in ((sj, sm_j, gf_j), (st, sm_t, gf_t)):
        param = pkg.Param(world_z_min=0.0, solver_dtype="float64",
                          grid_xy_res=0.5, grid_z_res=0.5, **over)
        mission = sm(**mkw)
        world = None if seed is None else gf(
            mission, world_min=param.world_min, world_max=param.world_max,
            resolution=param.world_resolution, obs_num=6, r_min=0.3,
            r_max=0.3, h_min=1.0, h_max=2.5, margin=0.5, seed=seed)
        kw = {"device": "cpu"} if pkg is st else {}
        result, _ = pkg.plan(mission, param, world, search_backend="python",
                             **kw)
        out.append((result, pkg.evaluate(result, mission, param, **kw)))
    (rj, ej), (rt, et) = out
    assert rt.solver_info["device"] == "cpu"
    assert rt.solver_info["mode"] == rj.solver_info["mode"]
    assert rt.solver_info["iters"] == rj.solver_info["iters"]
    np.testing.assert_array_equal(rt.T, rj.T)
    assert _close(rt.coef, rj.coef)
    assert ej.keys() == et.keys()
    for k in ej:
        assert abs(et[k] - ej[k]) <= RTOL * max(1.0, abs(ej[k])), k
    assert et["min_safety_ratio"] >= 1.0 - 1e-3
    assert et["knot_continuity_err"] < 1e-3
    assert max(et["start_err"], et["goal_err"]) < 1e-3
    assert et["dynamic_violation"] < 1e-2
