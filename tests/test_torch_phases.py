"""PyTorch port, the knot-state solver's dense KKT mode and its per-phase
loop, against the JAX package on the CPU in float64.

- ``NSSettings()`` defaults to the dense KKT mode in both packages;
- the dense preps (``prepare_ns_np`` in host float64, ``prepare_ns`` on
  the device) give the JAX package's rung inverses (1e-10);
- ``solve_ns``, ``solve_single_ns`` and ``solve_ns_batched`` on a stack of
  two 4-agent batch QPs of an 8-agent forest: the same iterations, x
  within 1e-8;
- ``solve_ns_phases`` in both KKT modes on a schedule tuple and on a
  per-phase tuple (the restore phase with another tighten), the returned
  state fed back as ``init``: the same total iterations, x and the state
  within 1e-8;
- ``joint.solve_trajectories`` of the 8-agent forest with per-phase
  phases: ctrl within 1e-6;
- the sharded solve's per-phase loop on one gloo rank against the JAX
  sharded solve on one device;
- ``aa_depth`` > 0 raises, naming ROADMAP queue 1 item 4.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_seqbatch import one_thread  # noqa: E402,F401

import swarm_simulator_tpu as sj  # noqa: E402
from swarm_simulator_tpu.qp import assemble as asm_j  # noqa: E402
from swarm_simulator_tpu.qp import joint as joint_j  # noqa: E402
from swarm_simulator_tpu.qp import nullspace as ns_j  # noqa: E402
from swarm_simulator_tpu.qp import nullspace_shard as sh_j  # noqa: E402
import swarm_simulator_tpu_torch as st  # noqa: E402
from swarm_simulator_tpu_torch.parallel import distributed as pd  # noqa: E402
from swarm_simulator_tpu_torch.qp import assemble as asm_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import interop  # noqa: E402
from swarm_simulator_tpu_torch.qp import joint as joint_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import nullspace as ns_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import nullspace_shard as sh_t  # noqa: E402


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _port_settings(s):
    return ns_t.NSSettings(**{f.name: getattr(s, f.name)
                              for f in dataclasses.fields(ns_t.NSSettings)})


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _port_data(data):
    return asm_t.QPData(**{f.name: getattr(data, f.name)
                           for f in dataclasses.fields(asm_t.QPData)})


@pytest.fixture(scope="module")
def forest():
    """The 8-agent forest (seed 1, a 4 m square, M = 18) through the JAX
    package's host pipeline, float64: (plan, mission, param, joint QP,
    stack of the two 4-agent batch QPs padded to one pair count)."""
    from swarm_simulator_tpu.corridor.times import build_corridors
    from swarm_simulator_tpu.io.mission_json import perimeter_swap_mission
    from swarm_simulator_tpu.search.planner import plan_initial_trajectories
    from swarm_simulator_tpu.world.esdf import ESDF
    from swarm_simulator_tpu.world.forest import generate_forest

    param = sj.Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                     solver="nullspace", solver_dtype="float64")
    mission = perimeter_swap_mission(8, half=2.0, z=1.0, radius=0.15)
    world = generate_forest(mission, world_min=param.world_min,
                            world_max=param.world_max, obs_num=6,
                            r_min=0.3, r_max=0.3, h_min=0.0, h_max=2.5,
                            margin=0.5, seed=1)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)
    joint_data, _ = joint_j.assemble_joint(plan, mission, param)
    dummy = asm_j.build_dummy(plan.init_traj, param.n, plan.M)
    batches = [np.arange(4), np.arange(4, 8)]
    pad = max(int(np.isin(np.asarray(plan.pair_idx), b).any(axis=1).sum())
              for b in batches)
    datas = [_numpy(asm_j.assemble_batch(plan, mission, param, b, dummy,
                                         pad, device=False))
             for b in batches]
    stack = jax.tree.map(lambda *xs: np.stack(xs), *datas)
    return plan, mission, param, _numpy(joint_data), stack


def _batch(stack, i):
    return jax.tree.map(lambda a: a[i], stack)


def test_nssettings_defaults_to_dense():
    assert ns_t.NSSettings().kkt_mode == ns_j.NSSettings().kkt_mode \
        == "dense"
    assert joint_t.production_settings().kkt_mode == "banded"


@pytest.mark.parametrize("prep", ["host", "device"])
def test_dense_prep_matches_jax(forest, prep):
    """The dense rung inventory K(rho)^-1 [R, 3B nw, 3B nw] and the other
    leaves of a 4-agent batch QP, host float64 (bit-for-bit math of
    the JAX host prep) and device prep (LU inverse plus one Newton
    step)."""
    data = _batch(forest[4], 0)
    s = ns_j.NSSettings()
    if prep == "host":
        want = ns_j.prepare_ns_np(data, s)
        got = ns_t.prepare_ns_np(_port_data(data), _port_settings(s))
    else:
        want = jax.jit(ns_j.prepare_ns, static_argnums=1)(
            jax.tree.map(jnp.asarray, data), s)
        got = ns_t.prepare_ns(_port_data(data).to("cpu"), _port_settings(s))
    assert got.Dinvs is None and got.Kos is None
    assert got.Kinvs.shape == np.asarray(want.Kinvs).shape
    for k in ("Kinvs", "N", "x_pin", "g", "F0", "FT", "c_s", "ladder"):
        a = getattr(got, k)
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        assert _rel(a, getattr(want, k)) < 1e-10, k


SOLVE_S = ns_j.NSSettings(max_iter=600, tighten=2e-3)


@pytest.fixture(scope="module")
def batched_jax(forest):
    stack = forest[4]
    xj, ij = ns_j.solve_ns_batched(jax.tree.map(jnp.asarray, stack),
                                   SOLVE_S)
    return np.asarray(xj), np.asarray(ij.iters)


@pytest.mark.parametrize("entry", ["solve_ns", "solve_single_ns",
                                   "solve_ns_batched"])
def test_solve_entry_points_match_jax(forest, batched_jax, entry):
    """The dense-default solves of the two batch QPs: the JAX package's
    solve_ns_batched iterations, x within 1e-8 (solve_ns returns x
    only, as in the JAX package)."""
    stack = _port_data(forest[4])
    s = _port_settings(SOLVE_S)
    xj, itj = batched_jax
    if entry == "solve_ns_batched":
        x, info = ns_t.solve_ns_batched(stack, s, device="cpu")
        assert info.iters.tolist() == itj.tolist()
        assert _rel(x.numpy(), xj) < 1e-8
        return
    for i in range(2):
        one = _port_data(_batch(forest[4], i))
        if entry == "solve_ns":
            x = ns_t.solve_ns(one, s, device="cpu")
        else:
            x, info = ns_t.solve_single_ns(one, s, device="cpu")
            assert info.iters == itj[i]
        assert _rel(x.numpy(), xj[i]) < 1e-8


def _phases(kind, mode):
    base = dataclasses.replace(joint_j.production_settings(),
                               kkt_mode=mode, fused_chunk=False,
                               fused_pair_split=3)
    ph = joint_j.production_phases((100, 200, 100), base=base, fused=False)
    if kind == "per-phase":
        # the restore phase tightens less: not schedule-compatible
        ph = ph[:2] + (dataclasses.replace(ph[2], tighten=1e-3),)
    return ph


@pytest.mark.parametrize("mode", ["banded", "dense"])
@pytest.mark.parametrize("kind", ["schedule", "per-phase"])
def test_solve_ns_phases_matches_jax(forest, kind, mode):
    """A phased solve of the first 4-agent batch QP from its host f64
    operator, then the same phases again from the returned state (the
    state-warm replan): both packages' total iterations equal, x and
    every part of the state within 1e-8."""
    data = _batch(forest[4], 0)
    ph = _phases(kind, mode)
    assert (ns_t.schedule_arrays(tuple(_port_settings(p) for p in ph))
            is None) == (kind == "per-phase")
    op = ns_j.prepare_ns_np(data, ph[0])
    dj, oj = jax.tree.map(jnp.asarray, data), jax.tree.map(jnp.asarray, op)
    ph_t = tuple(_port_settings(p) for p in ph)
    _, op_t = interop.from_numpy(data, op, device="cpu")
    solve_j = jax.jit(ns_j.solve_ns_phases,
                      static_argnames=("phases", "return_state"))
    init_j = init_t = None
    for _ in range(2):
        xj, ij, init_j = solve_j(dj, phases=ph, return_state=True, op=oj,
                                 init=init_j)
        xt, it, init_t = ns_t.solve_ns_phases(_port_data(data), ph_t,
                                              return_state=True, op=op_t,
                                              init=init_t, device="cpu")
        assert it.iters == int(ij.iters)
        assert _rel(xt.numpy(), xj) < 1e-8
        wj, zj, yj, rj = init_j
        wt, zt, yt, rt = init_t
        assert int(rt) == int(rj)
        for a, b in ((wt, wj), (zt.box, zj.box), (zt.pair, zj.pair),
                     (yt.box, yj.box), (yt.pair, yj.pair)):
            assert _rel(a.numpy(), b) < 1e-8


def test_joint_per_phase_matches_jax(forest):
    """joint.solve_trajectories of the 8-agent forest with per-phase
    phases (a restore phase with another tighten): ctrl within 1e-6 of
    the JAX package's (its _solve_phases_jit fallback)."""
    plan, mission, param = forest[:3]
    ph = _phases("per-phase", "banded")
    rj = joint_j.solve_trajectories(dataclasses.replace(plan), mission,
                                    param, phases=ph)
    plan_t = st.PlanResult(**{f.name: getattr(plan, f.name) for f in
                              dataclasses.fields(st.PlanResult)})
    param_t = st.Param(**{f.name: getattr(param, f.name)
                          for f in dataclasses.fields(st.Param)})
    mission_t = st.Mission(**{f.name: getattr(mission, f.name)
                              for f in dataclasses.fields(st.Mission)})
    rt = joint_t.solve_trajectories(
        plan_t, mission_t, param_t,
        phases=tuple(_port_settings(p) for p in ph), device="cpu")
    assert rt.solver_info["iters"] == rj.solver_info["iters"]
    assert np.abs(rt.ctrl - np.asarray(rj.ctrl)).max() < 1e-6


def test_sharded_per_phase_matches_jax(forest):
    """The sharded solve's per-phase loop (chunk mode) on one gloo rank
    against the JAX sharded solve on a one-device mesh: the same total
    iterations, x within 1e-10."""
    data = forest[3]
    ph = _phases("per-phase", "banded")
    op = ns_j.prepare_ns_np(data, ph[0])
    mesh = Mesh(np.array(jax.devices()[:1]), ("kkt",))
    xj, ij = sh_j.solve_ns_phases_sharded(data, ph, op, mesh)
    op_t = ns_t.NSOp(**{k: None if getattr(op, k, None) is None
                        else np.asarray(getattr(op, k))
                        for k in ns_t.NSOp._fields})
    x, iters, _, _, _ = pd.run_ranks(
        sh_t.rank_solve, 1, _port_data(data),
        tuple(_port_settings(p) for p in ph), op_t, "chunk",
        backend="gloo")
    assert iters == int(ij.iters)
    assert _rel(x, np.asarray(xj)) < 1e-10
    with pytest.raises(ValueError, match="kkt_mode"):
        sh_t._check_phases((ns_t.NSSettings(),), "chunk")


def test_aa_depth_raises_naming_its_item(forest):
    data = _port_data(_batch(forest[4], 0))
    s = ns_t.NSSettings(aa_depth=1, max_iter=50)
    with pytest.raises(NotImplementedError,
                       match=r"aa_depth.*ROADMAP queue 1, item 4"):
        ns_t.solve_ns(data, s, device="cpu")
    assert ns_t.schedule_arrays((s, s)) is None
