"""PyTorch port, Monte-Carlo scenario batching (parallel/scenarios),
against the JAX package on the CPU in float64.

- ``quantize_M``, ``pad_plan_segments``, ``pair_pad_bound`` and
  ``_assemble_scenario``: bit-equal;
- ``run_monte_carlo`` two-phase and ``pipeline=2`` on the CPU config of
  tests/test_scenarios.py (the 4-agent swap, 3 forest scenarios, batches
  of 2, two Jacobi rounds; 300 iterations a round): every scenario's
  coefficients within 1e-6 of the JAX package's, and the same error
  strings (a scenario whose start leaves the world fails its prep in
  both);
- a scenario planned alone equals the same scenario stacked with three
  others (every stacked problem stops on its own residuals);
- without a card and without ``device`` it raises.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_seqbatch import one_thread  # noqa: E402,F401

from swarm_simulator_tpu.core.types import Param as ParamJ  # noqa: E402
from swarm_simulator_tpu.io.mission_json import \
    swap_mission as swap_j  # noqa: E402
from swarm_simulator_tpu.parallel import scenarios as sc_j  # noqa: E402
from swarm_simulator_tpu_torch.core.types import Param as ParamT  # noqa: E402
from swarm_simulator_tpu_torch.io.mission_json import \
    swap_mission as swap_t  # noqa: E402
from swarm_simulator_tpu_torch.parallel import scenarios as sc_t  # noqa: E402

PARAM = dict(world_z_min=0.0, solver_dtype="float64", grid_xy_res=0.5,
             grid_z_res=0.5, sequential=True, batch_size=2, batch_iter=-1,
             iteration=2, time_scale=False, solver_max_iter=300)
RUN = dict(n_scenarios=3, seed0=100,
           forest_kwargs=dict(obs_num=3, h_min=1.0, h_max=2.0))


def _mission(swap):
    return swap(4, z=1.0, span=3.0, radius=0.15)


def _prepped(pkg, param_cls, swap, seed=7):
    """One forest scenario through a package's prep."""
    from importlib import import_module

    forest = import_module(f"{pkg}.world.forest")
    param = param_cls(**PARAM)
    mission = _mission(swap)
    world = forest.generate_forest(mission, world_min=param.world_min,
                                   world_max=param.world_max, obs_num=3,
                                   h_min=1.0, h_max=2.0, margin=0.5,
                                   seed=seed)
    mod = sc_j if pkg == "swarm_simulator_tpu" else sc_t
    (sc,) = mod.prep_scenarios([mod.Scenario(mission=mission, world=world)],
                               param)
    return sc, param


def test_bucketing_and_assembly_bit_equal():
    assert [sc_t.quantize_M(m) for m in (1, 8, 33, 40, 41)] == \
        [sc_j.quantize_M(m) for m in (1, 8, 33, 40, 41)]
    for qn, bs in ((4, 2), (8, 4), (64, 4), (7, 3)):
        pj = dataclasses.replace(ParamJ(**PARAM), batch_size=bs)
        pt = dataclasses.replace(ParamT(**PARAM), batch_size=bs)
        assert sc_t.pair_pad_bound(qn, pt) == sc_j.pair_pad_bound(qn, pj)
    scj, pj = _prepped("swarm_simulator_tpu", ParamJ, swap_j)
    sct, pt = _prepped("swarm_simulator_tpu_torch", ParamT, swap_t)
    M = sc_j.quantize_M(scj.plan.M + 1)
    sc_j.pad_plan_segments(scj.plan, M)
    sc_t.pad_plan_segments(sct.plan, M)
    for f in ("init_traj", "T", "seg_boxes", "pair_normals"):
        assert np.array_equal(getattr(sct.plan, f), getattr(scj.plan, f)), f
    from swarm_simulator_tpu.parallel import seqbatch as sb_j
    batches, bi = sb_j.make_batches(4, pj)
    pad = sc_j.pair_pad_bound(4, pj)
    (dj, mj) = sc_j._assemble_scenario(scj, pj, bi, batches, pad)
    (dt, mt) = sc_t._assemble_scenario(sct, pt, bi, batches, pad)
    assert np.array_equal(mt, mj)
    for f in dataclasses.fields(dt):
        a, b = getattr(dt, f.name), getattr(dj, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert np.array_equal(np.asarray(a), np.asarray(b)), f.name


def _bad_scenario(mod, swap, param):
    """A scenario whose first agent starts outside the world."""
    from importlib import import_module

    voxel = import_module(mod.__name__.replace("parallel.scenarios",
                                               "world.voxel"))
    m = _mission(swap)
    start = m.start.copy()
    start[0, 0] = 50.0
    m = dataclasses.replace(m, start=start)
    world = voxel.OccupancyGrid.empty(param.world_min, param.world_max,
                                      param.world_resolution)
    return mod.Scenario(mission=m, world=world)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for pipe in (None, 2):
        rj = sc_j.run_monte_carlo(_mission(swap_j), ParamJ(**PARAM),
                                  pipeline=pipe, **RUN)
        rt = sc_t.run_monte_carlo(_mission(swap_t), ParamT(**PARAM),
                                  pipeline=pipe, device="cpu", **RUN)
        out[pipe] = (rj, rt)
    return out


@pytest.mark.parametrize("pipe", [None, 2], ids=["two-phase", "pipeline"])
def test_run_monte_carlo_matches_jax(runs, pipe):
    rj, rt = runs[pipe]
    mode = ("scenario-batched-device" if pipe is None
            else "scenario-pipelined-device")
    n_checked = 0
    for a, b in zip(rj, rt):
        assert a.error == b.error
        if a.error is not None:
            continue
        assert b.plan.solver_info["mode"] == mode
        assert b.plan.M == a.plan.M
        assert np.abs(b.plan.coef - np.asarray(a.plan.coef)).max() < 1e-6
        n_checked += 1
    assert n_checked == 3
    # the pipelined path lands where the two-phase path does
    for a, b in zip(runs[None][1], rt):
        assert np.abs(a.plan.coef - b.plan.coef).max() < 1e-6


def test_prep_error_strings_match_jax():
    pj, pt = ParamJ(**PARAM), ParamT(**PARAM)
    (scj,) = sc_j.prep_scenarios([_bad_scenario(sc_j, swap_j, pj)], pj)
    (sct,) = sc_t.prep_scenarios([_bad_scenario(sc_t, swap_t, pt)], pt)
    assert scj.error is not None and sct.error == scj.error
    assert sct.plan is None
    sc_t.solve_scenarios([sct], pt, device="cpu")   # nothing to solve
    assert sct.plan is None


def test_scenario_alone_equals_stacked():
    """Four forests (obs_num 8: the third takes another path and 6x the
    iterations of the others) stacked, and the third planned alone."""
    kw = dict(forest_kwargs=dict(obs_num=8, h_min=1.0, h_max=2.0))
    stacked = sc_t.run_monte_carlo(_mission(swap_t), ParamT(**PARAM),
                                   n_scenarios=4, seed0=100, device="cpu",
                                   **kw)
    (alone,) = sc_t.run_monte_carlo(_mission(swap_t), ParamT(**PARAM),
                                    n_scenarios=1, seed0=102, device="cpu",
                                    **kw)
    assert stacked[2].plan.solver_info["stack"] == 4
    assert alone.plan.solver_info["stack"] == 1
    iters = [sc.plan.solver_info["iters"] for sc in stacked]
    assert iters[2] != iters[0]
    assert alone.plan.solver_info["iters"] == iters[2]
    assert np.abs(alone.plan.coef - stacked[2].plan.coef).max() < 1e-12


def test_run_monte_carlo_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sc_t.run_monte_carlo(_mission(swap_t), ParamT(**PARAM),
                             n_scenarios=1)


def test_collisions_by_group_splits_the_pairs(runs):
    """tools/monte_carlo's per-pair breakdown against eval/safety's ratio
    of each pair alone, grouped by agent // batch_size."""
    import torch as _torch

    import swarm_simulator_tpu_torch as port
    from swarm_simulator_tpu_torch.eval import sample, safety
    from swarm_simulator_tpu_torch.tools.monte_carlo import \
        collisions_by_group

    param, mission = ParamT(**PARAM), _mission(swap_t)
    cpu = _torch.device("cpu")
    for sc in runs[None][1]:
        got = collisions_by_group(sc.plan, mission, param, cpu)
        ts = sample.sample_times(sc.plan.T, 0.1)
        pos = sample.sample_trajectories(
            sc.plan.coef, np.asarray(sc.plan.T), ts, n=param.n,
            device="cpu").numpy()[:, :, 0]
        want = {"same_group": [], "cross_group": []}
        for i in range(mission.qn):
            for j in range(i + 1, mission.qn):
                r = safety.safety_margin_ratio(
                    pos[[i, j]], mission.radius[[i, j]],
                    downwash=param.downwash, device="cpu")
                same = i // param.batch_size == j // param.batch_size
                want["same_group" if same else "cross_group"].append(r)
        for kind, rs in want.items():
            assert got[kind] == {"pairs_below_1": sum(r < 1 for r in rs),
                                 "min_ratio": round(min(rs), 4)}, kind
        m = port.evaluate(sc.plan, mission, param, device="cpu")
        assert min(g["min_ratio"] for g in got.values()) == \
            round(m["min_safety_ratio"], 4)
