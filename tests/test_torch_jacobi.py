"""PyTorch port, the Jacobi sweep of sequential batch planning
(parallel/mesh.jacobi_sweep) and the ADMM warm state it carries, against
the JAX package on the CPU in float64.

- ``admm._iterate``'s ``init``/``return_state``: a solve, then a second
  one from its returned (x, z, y), equal to the JAX package's (the port
  keeps z and y as one flat vector a problem);
- ``jacobi_sweep`` on the four 2-agent groups of an 8-agent forest, as
  tests/test_parallel.py's cases: the ADMM branch with rounds=2, with an
  iters_schedule and with carry_state, and its ValueErrors; the
  knot-state branch in banded mode (the fused chunk's plain twin on the
  CPU) and in dense mode with a tighten_schedule: ctrl within 1e-6 and
  the last round's iterations equal;
- a two-round knot-state sweep equals two one-round sweeps (bit for bit);
- without a card and without ``device`` it raises, and
  tools/jacobi_f32_study exits 2.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_seqbatch import one_thread  # noqa: E402,F401

import swarm_simulator_tpu as sj  # noqa: E402
from swarm_simulator_tpu.parallel import mesh as mesh_j  # noqa: E402
from swarm_simulator_tpu.qp import admm as admm_j  # noqa: E402
from swarm_simulator_tpu.qp import assemble as asm_j  # noqa: E402
from swarm_simulator_tpu.qp import nullspace as ns_j  # noqa: E402
from swarm_simulator_tpu_torch.parallel import mesh as mesh_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import admm as admm_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import assemble as asm_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import nullspace as ns_t  # noqa: E402


def _port_data(data):
    return asm_t.QPData(**{f.name: np.asarray(getattr(data, f.name))
                           for f in dataclasses.fields(asm_t.QPData)})


def _port_settings(s):
    cls = (ns_t.NSSettings if isinstance(s, ns_j.NSSettings)
           else admm_t.ADMMSettings)
    return cls(**{f.name: getattr(s, f.name)
                  for f in dataclasses.fields(cls)})


@pytest.fixture(scope="module")
def groups():
    """The 8-agent forest (seed 1, a 4 m square) in four 2-agent groups
    padded to one pair count, float64 host leaves, and its dummy."""
    from swarm_simulator_tpu.corridor.times import build_corridors
    from swarm_simulator_tpu.io.mission_json import perimeter_swap_mission
    from swarm_simulator_tpu.search.planner import plan_initial_trajectories
    from swarm_simulator_tpu.world.esdf import ESDF
    from swarm_simulator_tpu.world.forest import generate_forest

    param = sj.Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                     solver_dtype="float64", sequential=True, batch_size=2,
                     batch_iter=-1)
    mission = perimeter_swap_mission(8, half=2.0, z=1.0, radius=0.15)
    world = generate_forest(mission, world_min=param.world_min,
                            world_max=param.world_max, obs_num=6,
                            r_min=0.3, r_max=0.3, h_min=0.0, h_max=2.5,
                            margin=0.5, seed=1)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)
    dummy = asm_j.build_dummy(plan.init_traj, param.n, plan.M)
    batches = [np.arange(i, i + 2) for i in range(0, 8, 2)]
    pad = max(int(np.isin(np.asarray(plan.pair_idx), b).any(axis=1).sum())
              for b in batches)
    datas = [jax.tree.map(np.asarray, asm_j.assemble_batch(
        plan, mission, param, b, dummy, pad, device=False))
        for b in batches]
    return jax.tree.map(lambda *xs: np.stack(xs), *datas), dummy


ADMM_S = admm_j.ADMMSettings(max_iter=400, eps_abs=1e-6, eps_rel=1e-6)


@pytest.mark.parametrize("kkt", ["dense", "cg"])
def test_iterate_warm_state_matches_jax(groups, kkt):
    """One group's solve to 100 iterations, then 200 more from the state
    it returned: the iterations, x and the state (x, z, y) equal the JAX
    package's, z and y flattened eq, box, pair rows end to end."""
    data = jax.tree.map(lambda a: a[0], groups[0])
    s = dataclasses.replace(ADMM_S, kkt_solver=kkt, adaptive_rho=True)
    dj = jax.tree.map(jnp.asarray, data)
    sdj, scj, opj = jax.jit(admm_j._prepare, static_argnums=1)(dj, s)
    iterate_j = jax.jit(admm_j._iterate, static_argnums=4,
                        static_argnames="return_state")
    dt = admm_t._tree_map(lambda a: a[None], _port_data(data).to("cpu"))
    s_t = _port_settings(s)
    prep_t = admm_t._prepare(dt, s_t)
    st_j = st_t = None
    for mi in (100, 200):
        s_r = dataclasses.replace(s, max_iter=mi)
        xj, ij, st_j = iterate_j(dj, sdj, scj, opj, s_r, init=st_j,
                                 return_state=True)
        xt, it, st_t = admm_t._iterate(dt, *prep_t, _port_settings(s_r),
                                       init=st_t, return_state=True)
        assert int(it.iters[0]) == int(ij.iters)
        want = (st_j[0], *(np.concatenate([np.ravel(v) for v in c])
                           for c in st_j[1:]))
        for a, b in zip((xt[0], *(v[0] for v in st_t)), (xj, *want)):
            a = a.numpy().ravel()
            b = np.asarray(b).ravel()
            assert np.abs(a - b).max() <= 1e-9 * max(1.0, np.abs(b).max())


def _sweep_both(groups, settings, **kw):
    stacked, dummy = groups
    cj, ij = mesh_j.jacobi_sweep(jax.tree.map(jnp.asarray, stacked),
                                 jnp.asarray(dummy), settings, **kw)
    ct, it = mesh_t.jacobi_sweep(_port_data(stacked), dummy,
                                 _port_settings(settings), device="cpu",
                                 **kw)
    return np.asarray(cj), np.asarray(ij.iters), ct.numpy(), it.iters


@pytest.mark.parametrize("kw", [
    dict(rounds=2),
    dict(rounds=2, iters_schedule=(400, 200)),
    dict(rounds=2, iters_schedule=(400, 200), carry_state=True)],
    ids=["rounds", "iters_schedule", "carry_state"])
def test_admm_branch_matches_jax(groups, kw):
    cj, itj, ct, itt = _sweep_both(groups, ADMM_S, **kw)
    assert itt.tolist() == itj.tolist()
    assert np.abs(ct - cj).max() < 1e-6


def test_admm_branch_value_errors(groups):
    stacked, dummy = groups
    data, s = _port_data(stacked), _port_settings(ADMM_S)
    for kw, word in ((dict(iters_schedule=(100,)), "iters_schedule"),
                     (dict(carry_state=True), "carry_state"),
                     (dict(iters_schedule=(100, 100),
                           tighten_schedule=(1e-3, 1e-3)),
                      "tighten_schedule")):
        with pytest.raises(ValueError, match=word):
            mesh_t.jacobi_sweep(data, dummy, s, rounds=2, device="cpu",
                                **kw)
        with pytest.raises(ValueError, match=word):
            mesh_j.jacobi_sweep(jax.tree.map(jnp.asarray, stacked),
                                jnp.asarray(dummy), ADMM_S, rounds=2, **kw)


@pytest.mark.parametrize("mode", ["banded", "dense"])
def test_knot_state_branch_matches_jax(groups, mode):
    """Two rounds of 200 and 100 iterations at tighten 2e-3 then 1e-3,
    each group's knot-state (w, z, y, rho_idx) carried across."""
    s = ns_j.NSSettings(kkt_mode=mode, tighten=2e-3, warm_start="x0")
    cj, itj, ct, itt = _sweep_both(
        groups, s, rounds=2, iters_schedule=(200, 100),
        tighten_schedule=(2e-3, 1e-3), carry_state=True)
    assert itt.tolist() == itj.tolist()
    assert np.abs(ct - cj).max() < 1e-6


@pytest.mark.parametrize("mode", ["banded", "dense"])
def test_two_rounds_equal_two_one_round_sweeps(groups, mode):
    """A two-round knot-state sweep without carried state equals a
    one-round sweep from the first round's control points, bit for bit
    (tools/jacobi_f32_study runs the sweep so, round by round)."""
    stacked, dummy = groups
    data = _port_data(stacked)
    s = ns_t.NSSettings(kkt_mode=mode, tighten=2e-3, max_iter=50)
    two, _ = mesh_t.jacobi_sweep(data, dummy, s, rounds=2, device="cpu")
    one, _ = mesh_t.jacobi_sweep(data, dummy, s, rounds=1, device="cpu")
    again, _ = mesh_t.jacobi_sweep(data, one.numpy(), s, rounds=1,
                                   device="cpu")
    assert not torch.equal(one, two)
    assert torch.equal(again, two)


def test_jacobi_f32_study_without_a_card_exits_2(monkeypatch):
    from swarm_simulator_tpu_torch.tools import jacobi_f32_study

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert jacobi_f32_study.main([]) == 2


def test_sweep_without_a_card_raises(groups, monkeypatch):
    stacked, dummy = groups
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_t.jacobi_sweep(_port_data(stacked), dummy,
                            _port_settings(ADMM_S))


def forest64_sweep(pkg, mode: str, dtype: str, rounds: int = 2) -> dict:
    """The 64-agent forest of chip_smoke.py (seed 0, 20 obstacles) in 16
    groups of 4 through one package's knot-state jacobi_sweep (tighten
    2e-3, ``rounds`` rounds, on the CPU): the last round's iterations and
    the evaluate() metrics of the plan time-scaled as plan() scales it."""
    from importlib import import_module

    name = pkg.__name__
    mj = import_module(f"{name}.io.mission_json")
    forest = import_module(f"{name}.world.forest")
    esdf_m = import_module(f"{name}.world.esdf")
    planner = import_module(f"{name}.search.planner")
    times = import_module(f"{name}.corridor.times")
    asm = import_module(f"{name}.qp.assemble")
    ns = import_module(f"{name}.qp.nullspace")
    conv = import_module(f"{name}.qp.convert")
    tsc = import_module(f"{name}.qp.timescale")
    mesh = import_module(f"{name}.parallel.mesh")
    sb = import_module(f"{name}.parallel.seqbatch")

    param = pkg.Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                      solver_dtype=dtype)
    mission = mj.perimeter_swap_mission(64, half=4.0, z=1.0, radius=0.15)
    world = forest.generate_forest(mission, world_min=param.world_min,
                                   world_max=param.world_max, obs_num=20,
                                   r_min=0.3, r_max=0.3, h_min=0.0,
                                   h_max=2.5, margin=0.5, seed=0)
    esdf = esdf_m.ESDF(world, max_dist=param.esdf_max_dist)
    plan = planner.plan_initial_trajectories(esdf, mission, param)
    times.build_corridors(esdf, plan, mission.radius, param)
    batches, _ = sb.make_batches(64, dataclasses.replace(
        param, sequential=True, batch_size=4, batch_iter=-1))
    dummy = asm.build_dummy(plan.init_traj, param.n, plan.M)
    pairs = np.asarray(plan.pair_idx)
    pad = max(int(np.isin(pairs, b).any(axis=1).sum()) for b in batches)
    kw = {} if name == "swarm_simulator_tpu_torch" else dict(device=False)
    datas = [asm.assemble_batch(plan, mission, param, b, dummy, pad, **kw)
             for b in batches]
    stacked = sb._stack_qpdata(datas)
    s = ns.NSSettings(kkt_mode=mode, tighten=2e-3)
    if name == "swarm_simulator_tpu_torch":
        ctrl, info = mesh.jacobi_sweep(stacked, dummy.astype(dtype), s,
                                       rounds=rounds, device="cpu")
    else:
        stacked = jax.tree.map(jnp.asarray, stacked)
        ctrl, info = mesh.jacobi_sweep(
            stacked, jnp.asarray(dummy, stacked.lb.dtype), s, rounds=rounds)
    ctrl = np.asarray(ctrl, np.float64)
    plan.coef = conv.ctrl_to_coef(ctrl, plan.T, param.n)
    scale = tsc.compute_time_scale(plan.coef, plan.T, mission.max_vel,
                                   mission.max_acc, param.n, param.phi)
    plan.coef, plan.T = tsc.apply_time_scale(plan.coef, plan.T, scale,
                                             param.n)
    kw = {"device": "cpu"} if name == "swarm_simulator_tpu_torch" else {}
    metrics = pkg.evaluate(plan, mission, param, **kw)
    return dict(package=name, mode=mode, dtype=dtype, rounds=rounds,
                iters=np.asarray(info.iters).tolist(),
                metrics={k: float(v) for k, v in metrics.items()})


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="The 64-agent forest's knot-state Jacobi sweep (16 "
        "groups of 4, two rounds) through one package on the CPU: its "
        "evaluate() metrics as JSON (the values chip_smoke.py phase 20 "
        "prints beside the port's plans on the card).")
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--mode", choices=("banded", "dense"), default="banded")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    if args.package == "jax":
        # as the JAX package's CLI (cli/plan.py): x64 only for float64
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", args.dtype == "float64")
    import swarm_simulator_tpu_torch as st

    print(json.dumps(forest64_sweep(sj if args.package == "jax" else st,
                                    args.mode, args.dtype)))
