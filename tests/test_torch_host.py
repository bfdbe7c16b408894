"""PyTorch port, host layer: the same inputs through both packages.

The host pipeline (forest, native EDT, ECBS, SFC/RSFC corridors, joint QP
assembly) is numpy/C++ in both packages, so its outputs must be
BIT-equal; the host-f64 banded-KKT prep runs the same float64 algorithm
and must agree to 1e-12 relative.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import swarm_simulator_tpu as sj
import swarm_simulator_tpu_torch as st
from swarm_simulator_tpu.corridor.times import build_corridors as corr_j
from swarm_simulator_tpu.io import mission_json as mj
from swarm_simulator_tpu.qp import joint as joint_j
from swarm_simulator_tpu.qp import nullspace as ns_j
from swarm_simulator_tpu.search.planner import \
    plan_initial_trajectories as search_j
from swarm_simulator_tpu.world.esdf import ESDF as ESDF_j
from swarm_simulator_tpu.world.forest import generate_forest as forest_j
from swarm_simulator_tpu_torch.corridor.times import \
    build_corridors as corr_t
from swarm_simulator_tpu_torch.io import mission_json as mt
from swarm_simulator_tpu_torch.qp import interop
from swarm_simulator_tpu_torch.qp import joint as joint_t
from swarm_simulator_tpu_torch.qp import nullspace as ns_t
from swarm_simulator_tpu_torch.search.planner import \
    plan_initial_trajectories as search_t
from swarm_simulator_tpu_torch.world.esdf import ESDF as ESDF_t
from swarm_simulator_tpu_torch.world.forest import generate_forest as forest_t

REPO = Path(__file__).resolve().parents[1]

#: two small forest problems: (mission builder name, kwargs, forest seed,
#: obstacle count, solver dtype)
PROBLEMS = {
    "perimeter8_f32": ("perimeter_swap_mission",
                       dict(n_agents=8, half=4.0, z=1.0, radius=0.15), 1, 6,
                       "float32"),
    "swap8_f64": ("swap_mission",
                  dict(n_agents=8, z=1.0, span=4.0, radius=0.12), 7, 6,
                  "float64"),
}


def _build(pkg, name):
    """(plan, mission, param, world, esdf, data) through one package."""
    builder, kw, seed, obs, dtype = PROBLEMS[name]
    jax_side = pkg is sj
    mission = getattr(mj if jax_side else mt, builder)(**kw)
    param = pkg.Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                      solver="nullspace", solver_dtype=dtype)
    world = (forest_j if jax_side else forest_t)(
        mission, world_min=param.world_min, world_max=param.world_max,
        obs_num=obs, r_min=0.3, r_max=0.3, h_min=0.0, h_max=2.5,
        margin=0.5, seed=seed)
    esdf = (ESDF_j if jax_side else ESDF_t)(world,
                                            max_dist=param.esdf_max_dist)
    plan = (search_j if jax_side else search_t)(esdf, mission, param)
    (corr_j if jax_side else corr_t)(esdf, plan, mission.radius, param)
    data, _ = (joint_j if jax_side else joint_t).assemble_joint(
        plan, mission, param)
    return plan, mission, param, world, esdf, data


@pytest.fixture(scope="module")
def problems():
    return {name: (_build(sj, name), _build(st, name)) for name in PROBLEMS}


def test_import_leaves_no_jax():
    code = ("import sys, swarm_simulator_tpu_torch\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'swarm_simulator_tpu.')) or "
            "m == 'swarm_simulator_tpu')\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "", out.stdout


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_host_pipeline_bit_equal(problems, name):
    (pj, _, _, wj, ej, _), (pt, _, _, wt, et, _) = problems[name]
    assert np.array_equal(wj.occ, wt.occ)
    assert np.array_equal(ej.dist, et.dist)
    for field in ("init_traj", "T", "seg_boxes", "pair_idx",
                  "pair_normals"):
        a, b = np.asarray(getattr(pj, field)), np.asarray(getattr(pt, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_qpdata_bit_equal(problems, name):
    import dataclasses

    (_, _, _, _, _, dj), (_, _, _, _, _, dt) = problems[name]
    for f in dataclasses.fields(dt):
        a, b = np.asarray(getattr(dj, f.name)), np.asarray(getattr(dt, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert np.array_equal(a, b), f.name


@pytest.mark.parametrize("name", ["swap8_f64"])
def test_prepare_ns_np_matches(problems, name):
    (_, _, _, _, _, dj), (_, _, _, _, _, dt) = problems[name]
    op_j = ns_j.prepare_ns_np(dj, joint_j.production_settings())
    op_t = ns_t.prepare_ns_np(dt, joint_t.production_settings())
    assert op_t.Kinvs is None and op_j.Kinvs is None  # banded
    for k in (k for k in ns_t.NSOp._fields if k != "Kinvs"):
        a = np.asarray(getattr(op_j, k), np.float64)
        b = np.asarray(getattr(op_t, k), np.float64)
        assert a.shape == b.shape, k
        scale = max(1e-300, np.abs(a).max())
        assert np.abs(a - b).max() <= 1e-12 * scale, k


def test_interop_undoes_grouped_pivots(problems):
    """The JAX fused-kernel layout [R, Mi, phi, B3, GW] comes back flat and
    equal to the flat host prep of the same problem."""
    import dataclasses

    (_, _, _, _, _, dj), _ = problems["perimeter8_f32"]
    s = dataclasses.replace(joint_j.production_settings(), n_rungs=2)
    op_flat = ns_j.prepare_ns_np(dj, s)
    op_grp = ns_j.prepare_ns_np(dj, dataclasses.replace(s, fused_chunk=True))
    assert np.asarray(op_grp.Dinvs).ndim == 5
    data_t, op_t = interop.from_numpy(dj, op_grp, device="cpu")
    assert np.array_equal(op_t.Dinvs.numpy(), np.asarray(op_flat.Dinvs))
    for k in ("N", "x_pin", "g", "Kos", "ladder"):
        assert np.array_equal(getattr(op_t, k).numpy(),
                              np.asarray(getattr(op_flat, k))), k
    assert np.array_equal(data_t.pair_n.numpy(), np.asarray(dj.pair_n))
    assert data_t.pair_bi.dtype == data_t.pair_bj.dtype
