"""PyTorch port on a CUDA card: the fused ADMM chunk kernel against its
plain twin, and the planning path through the kernel.

These tests import torch and the port only (no jax), so they also run on
a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Without a card they skip: the kernel has no CPU mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

import swarm_simulator_tpu_torch as st
from swarm_simulator_tpu_torch.corridor.times import build_corridors
from swarm_simulator_tpu_torch.io.mission_json import perimeter_swap_mission
from swarm_simulator_tpu_torch.ops import nsfused
from swarm_simulator_tpu_torch.qp import joint
from swarm_simulator_tpu_torch.qp import nullspace as ns
from swarm_simulator_tpu_torch.search.planner import plan_initial_trajectories
from swarm_simulator_tpu_torch.world.esdf import ESDF
from swarm_simulator_tpu_torch.world.forest import generate_forest

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA card (the kernel has no CPU mode)"),
]

N_INNER = 50


def _forest(n_agents=8, seed=1):
    param = st.Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                     solver="nullspace", solver_dtype="float32")
    mission = perimeter_swap_mission(n_agents, half=4.0, z=1.0, radius=0.15)
    world = generate_forest(mission, world_min=param.world_min,
                            world_max=param.world_max, obs_num=6, r_min=0.3,
                            r_max=0.3, h_min=0.0, h_max=2.5, margin=0.5,
                            seed=seed)
    return mission, param, world


def _chunk_setups():
    mission, param, world = _forest()
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)
    s = joint.production_phases()[0]
    data, _ = joint.assemble_joint(plan, mission, param)
    op = ns.prepare_ns_np(data, s)
    dev = torch.device("cuda")
    out = {}
    for dtype in (torch.float32, torch.float64):
        d = data.to(dev)
        d = dataclasses.replace(d, **{
            f.name: getattr(d, f.name).to(dtype)
            for f in dataclasses.fields(d)
            if torch.is_floating_point(getattr(d, f.name))})
        o = ns.NSOp(*(v.to(dtype) for v in op.to(dev)))
        out[dtype] = ns.cold_chunk_inputs(d, o, s)
    return s, out


def test_kernel_matches_twin_on_cuda():
    """One chunk per rung from the cold state: the kernel is as accurate
    as the plain float32 twin, both judged against a float64 twin, on
    every part of the state (nsfused.twin_gap_use)."""
    s, setups = _chunk_setups()
    ops32, st32 = setups[torch.float32]
    ops64, st64 = setups[torch.float64]
    k64, t64 = [], []
    for r in range(ops32.dinv.shape[0]):
        before = nsfused.nsfused_chunk.launches
        kern = nsfused.nsfused_chunk(ops32, r, s.sigma, s.alpha, *st32,
                                     n_inner=N_INNER)
        assert nsfused.nsfused_chunk.launches == before + 1
        twin32 = nsfused.nsfused_chunk_reference(ops32, r, s.sigma, s.alpha,
                                                 *st32, n_inner=N_INNER)
        twin64 = nsfused.nsfused_chunk_reference(ops64, r, s.sigma, s.alpha,
                                                 *st64, n_inner=N_INNER)
        assert all(torch.isfinite(t).all()
                   for t in (kern[0], *kern[1], *kern[2]))
        k64.append(nsfused.state_errors(kern, twin64))
        t64.append(nsfused.state_errors(twin32, twin64))
    use = nsfused.twin_gap_use(k64, t64)
    assert max(use.values()) <= 1.0, use


def test_plan_launches_kernel_not_twin_on_cuda():
    mission, param, world = _forest()
    nsfused.nsfused_chunk.launches = 0
    nsfused.nsfused_chunk_reference.cuda_calls = 0
    result, _ = st.plan(mission, param, world, device="cuda")
    chunks = result.solver_info["iters"][0] // N_INNER
    assert nsfused.nsfused_chunk.launches == chunks > 0
    assert nsfused.nsfused_chunk_reference.cuda_calls == 0
    assert np.isfinite(result.ctrl).all()
    metrics = st.evaluate(result, mission, param, device="cuda")
    assert metrics["min_safety_ratio"] >= 1.0
