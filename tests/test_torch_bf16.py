"""PyTorch port, K2's bf16 pivot mode (NSSettings.precond_dtype="bfloat16").

The same inputs, made in-repo from a numpy seed, go through the JAX
package and the port on the CPU:
- the plain twin of K2 on bf16 pivots against the Pallas kernel in
  interpret mode fed the same ``ml_dtypes`` inventory (rel 1e-5 of the
  solution's scale: both widen each pivot to float32 at the product and
  sum in float32, in another order);
- the host prep's bf16 inventory bit-equal to the JAX package's (both
  round f64 -> the problem dtype -> bf16 to nearest even), carried
  across by ``interop.from_numpy``;
- the device prep's bf16 inventory within one bf16 ulp of JAX's;
- the guards (bf16 needs kkt_refine >= 1; the fused chunk refuses it);
- the refine-1 solve on bf16 pivots against JAX's in interpret mode, and
  against the port's own float32-pivot solve (JAX's pin,
  tests/test_nullspace.py:438-445);
- on the production ladder, the bf16 solve of both packages far from
  their float32 ones (the mode misses that pin there, in JAX too).
The CUDA kernel itself is held against the twin in
tests/test_torch_cuda.py, which needs a card.

Run as a script (``PYTHONPATH=. python tests/test_torch_bf16.py``), the
file prints the same comparison on the 64-agent forest's refine-1
problem that chip_smoke.py's phase 11 solves (witness_forest64), as JSON.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

# the tests' own modules, and the repository root when run as a script
sys.path[:0] = [str(Path(__file__).parent), str(Path(__file__).parents[1])]

from test_nullspace import _data as _data_j  # noqa: E402

import swarm_simulator_tpu.ops.pallas_thomas as pt  # noqa: E402
from swarm_simulator_tpu.qp import nullspace as ns_j  # noqa: E402
from swarm_simulator_tpu_torch.ops import nsfused, thomas  # noqa: E402
from swarm_simulator_tpu_torch.qp import interop  # noqa: E402
from swarm_simulator_tpu_torch.qp import nullspace as ns_t  # noqa: E402

B, K3, PHI, M = 3, 3, 3, 5
BS = B * K3 * PHI


def _f32(data):
    """The JAX test's float32 cast of a host QPData."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        if np.asarray(a).dtype == np.float64 else np.asarray(a), data)


def _settings():
    """(JAX s32, JAX s16, port s32, port s16): the refine-1 single-phase
    settings of tests/test_nullspace.py:398-406 (300 iterations, eps 0)."""
    s32 = ns_j.NSSettings(kkt_mode="banded", max_iter=300, check_every=50,
                          thomas_kernel=True, kkt_refine=1, eps_abs=0.0,
                          eps_rel=0.0, eps_dual_abs=0.0)
    s16 = dataclasses.replace(s32, precond_dtype="bfloat16")
    port = [ns_t.NSSettings(**{f.name: getattr(s, f.name)
                               for f in dataclasses.fields(ns_t.NSSettings)})
            for s in (s32, s16)]
    return (s32, s16, *port)


@pytest.fixture(scope="module")
def problem():
    data, _ = _data_j(n_agents=B, M=M)
    return _f32(data)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("rho_idx", [0, 1, 2])
def test_twin_matches_pallas_kernel_bf16_interpret(rho_idx):
    """Symmetric bf16 pivots (the host prep's are exactly symmetric: the
    Pallas kernel computes v Dinv, the port Dinv v) through both."""
    data, _ = _data_j(n_agents=B, M=M)
    op = ns_j.prepare_ns_np(jax.tree.map(np.asarray, data),
                            ns_j.NSSettings(kkt_mode="banded", n_rungs=3))
    d16 = np.asarray(op.Dinvs, np.float32).astype(ml_dtypes.bfloat16)
    assert np.array_equal(d16, np.swapaxes(d16, -1, -2))
    ho = np.asarray(op.Kos, np.float32)
    koM = jnp.asarray(np.kron(np.eye(B * K3), ho[0]), jnp.float32)
    b = np.random.default_rng(0).standard_normal((M - 1, BS)).astype(
        np.float32)
    want = np.asarray(pt.thomas_solve_pallas(
        jnp.asarray(d16), koM, koM.T, jnp.asarray(b), jnp.int32(rho_idx),
        interpret=True))
    dinv_t = torch.from_numpy(d16.view(np.uint16)).view(torch.bfloat16)
    got = thomas.thomas_solve_reference(dinv_t, torch.tensor(ho),
                                        torch.tensor(b), rho_idx)
    assert got.dtype == torch.float32 and got.shape == (M - 1, BS)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    # the wrapper takes the twin for CPU tensors, bf16 pivots included
    launches = (thomas.thomas_solve.launches,
                thomas.thomas_solve.launches_bf16)
    out = thomas.thomas_solve(dinv_t, torch.tensor(ho), torch.tensor(b),
                              rho_idx)
    assert torch.equal(out, got)
    assert launches == (thomas.thomas_solve.launches,
                        thomas.thomas_solve.launches_bf16)


def test_host_prep_bf16_bit_equal(problem):
    """prepare_ns_np(s16) of both packages: the same bf16 bits, the JAX
    inventory carried across by interop.from_numpy (its 128-lane padding
    stripped)."""
    _, s16_j, _, s16_t = _settings()
    op_j = ns_j.prepare_ns_np(problem, s16_j)
    assert np.asarray(op_j.Dinvs).dtype == ml_dtypes.bfloat16
    _, op_jt = interop.from_numpy(problem, op_j, device="cpu")
    op_t = ns_t.prepare_ns_np(problem, s16_t)
    assert op_t.Dinvs.dtype == op_jt.Dinvs.dtype == torch.bfloat16
    assert tuple(op_t.Dinvs.shape) == (s16_t.n_rungs, M - 1, BS, BS)
    assert np.array_equal(_bits(op_t.Dinvs), _bits(op_jt.Dinvs))
    # the other leaves stay in the problem dtype, and .to() moves them all
    moved = op_t.to("cpu")
    assert moved.N.dtype == torch.float32
    assert moved.Dinvs.dtype == torch.bfloat16


def _within_one_ulp(a: np.ndarray, b: np.ndarray) -> bool:
    """|a - b| at most one bf16 ulp of the larger magnitude (8 significant
    bits: an ulp is 2^(e - 7) for |x| in [2^e, 2^(e+1))), or, on entries
    the float32 chains leave near zero (where an ulp is tiny), at most
    2^-17 (64 float32 eps) of their pivot block's largest entry."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    big = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 7)
    floor = 2.0 ** -17 * big.max(axis=(-1, -2), keepdims=True)
    return bool(np.all(np.abs(a - b) <= np.maximum(ulp, floor)))


def test_device_prep_bf16_within_one_ulp(problem):
    """prepare_ns(s16) on the CPU against JAX's prepare_ns with the same
    settings, float32 data: each bf16 pivot within one bf16 ulp (the two
    float32 Schur chains differ in round-off, and a rounding to bf16 near a
    tie can land one ulp apart)."""
    _, s16_j, _, s16_t = _settings()
    want = ns_j.prepare_ns(jax.tree.map(jnp.asarray, problem), s16_j)
    assert want.Dinvs.dtype == jnp.bfloat16
    want = np.asarray(want.Dinvs[..., :BS, :BS]).astype(np.float32)
    data_t, _ = interop.from_numpy(
        problem, ns_j.prepare_ns_np(problem, ns_j.NSSettings(
            kkt_mode="banded")), device="cpu")
    got = ns_t.prepare_ns(data_t, s16_t).Dinvs
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _within_one_ulp(got.float().numpy(), want)


def test_guards(problem):
    """bf16 pivots need kkt_refine >= 1 at either prep; the fused chunk
    (K1) and the sharded sweeps refuse a bf16 inventory."""
    from swarm_simulator_tpu_torch.qp import nullspace_shard as shard

    _, _, _, s16 = _settings()
    s16_0 = dataclasses.replace(s16, kkt_refine=0)
    with pytest.raises(ValueError, match="kkt_refine"):
        ns_t.prepare_ns_np(problem, s16_0)
    data_t, _ = interop.from_numpy(
        problem, ns_j.prepare_ns_np(problem, ns_j.NSSettings(
            kkt_mode="banded", n_rungs=2)), device="cpu")
    with pytest.raises(ValueError, match="kkt_refine"):
        ns_t.prepare_ns(data_t, s16_0)
    with pytest.raises(ValueError, match="precond_dtype"):
        ns_t.prepare_ns_np(problem, dataclasses.replace(
            s16, precond_dtype="float16"))
    op16 = ns_t.prepare_ns_np(problem, s16).to("cpu")
    with pytest.raises(ValueError, match="bf16 pivot inventory"):
        ns_t.cold_chunk_inputs(data_t, op16, s16_0)
    # a kkt_refine=0 solve reaches the fused chunk and refuses there
    sched = ns_t.schedule_arrays((s16_0,))
    with pytest.raises(ValueError, match="bf16 pivot inventory"):
        ns_t.solve_ns_schedule(data_t, op16, *sched)
    ops32, cold = ns_t.cold_chunk_inputs(
        data_t, ns_t.prepare_ns_np(problem, _settings()[2]).to("cpu"), s16_0)
    ops16 = ops32._replace(op=op16)
    with pytest.raises(ValueError, match="bf16 pivot inventory"):
        nsfused.nsfused_chunk(ops16, 0, s16.sigma, s16.alpha, *cold,
                              n_inner=1)
    with pytest.raises(ValueError, match="float32"):
        shard.place(problem, op16, group=None)


@pytest.fixture(scope="module")
def solves(problem):
    """The refine-1 solve of both packages on float32 and bf16 pivots:
    {(package, dtype): (x [B, 3, D] float64, iters, r_prim, obj)}."""
    s32_j, s16_j, s32_t, s16_t = _settings()
    out = {}
    orig = pt.thomas_solve_pallas
    pt.thomas_solve_pallas = lambda *a, **k: orig(*a, interpret=True, **k)
    try:
        for key, s in (("float32", s32_j), ("bfloat16", s16_j)):
            op = ns_j.prepare_ns_np(problem, s)
            x, info = jax.jit(
                lambda d, o, s=s: ns_j.solve_ns_phases(d, (s,), op=o))(
                    jax.tree.map(jnp.asarray, problem), jax.device_put(op))
            out["jax", key] = (np.asarray(x, np.float64), int(info.iters),
                               float(info.r_prim), float(info.obj))
    finally:
        pt.thomas_solve_pallas = orig
    data_t, _ = interop.from_numpy(
        problem, ns_j.prepare_ns_np(problem, s32_j), device="cpu")
    for key, s in (("float32", s32_t), ("bfloat16", s16_t)):
        op = ns_t.prepare_ns_np(problem, s).to("cpu")
        x, info = ns_t.solve_ns_schedule(data_t, op,
                                         *ns_t.schedule_arrays((s,)))
        out["port", key] = (x.double().numpy(), int(info.iters),
                            float(info.r_prim), float(info.obj))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_refine_solve_matches_jax(solves, dtype):
    """Same iterations, objective within 1e-3 relative, x within 1e-3 of
    its scale (300 float32 iterations of an ill-conditioned toy, sums in
    another order in each package)."""
    xj, itj, _, oj = solves["jax", dtype]
    xt, itt, _, ot = solves["port", dtype]
    assert itt == itj == 300
    assert abs(ot - oj) <= 1e-3 * abs(oj)
    assert np.abs(xt - xj).max() <= 1e-3 * np.abs(xj).max()


def test_bf16_refine_solve_meets_jax_pin(solves):
    """The port's bf16-pivot solve against its own float32-pivot solve:
    r_prim below 2x + 1e-6, objective within 5% (JAX's pin,
    tests/test_nullspace.py:438-445; ~3% on this toy)."""
    _, _, rp32, o32 = solves["port", "float32"]
    _, _, rp16, o16 = solves["port", "bfloat16"]
    assert rp16 < 2.0 * rp32 + 1e-6, (rp16, rp32)
    assert abs(o16 - o32) / max(abs(o32), 1e-9) < 5e-2, (o16, o32)


def ladder_objectives(data, phases_t) -> dict:
    """The port's phases ``phases_t`` (refine 1) and their JAX twins
    (banded, the Pallas Thomas kernel in interpret mode) on host QPData
    ``data``, on float32 and on bf16 pivots of JAX's device prep, carried
    across so that both packages solve from the same pivots:
    {bf16: (JAX objective, port objective, iterations)}."""
    data_j = jax.tree.map(jnp.asarray, data)
    out = {}
    orig = pt.thomas_solve_pallas
    pt.thomas_solve_pallas = lambda *a, **k: orig(*a, interpret=True, **k)
    try:
        for bf16 in (False, True):
            ph_t = tuple(dataclasses.replace(
                p, precond_dtype="bfloat16" if bf16 else "float32")
                for p in phases_t)
            assert all(p.kkt_refine == 1 and p.kkt_mode == "banded"
                       for p in ph_t)
            ph_j = tuple(ns_j.NSSettings(**{
                **{f.name: getattr(p, f.name)
                   for f in dataclasses.fields(p)},
                "thomas_kernel": True}) for p in ph_t)
            op_j = jax.jit(lambda d: ns_j.prepare_ns(d, ph_j[0]))(data_j)
            _, info = jax.jit(
                lambda d, o: ns_j.solve_ns_phases(d, ph_j, op=o))(data_j,
                                                                   op_j)
            data_t, op_t = interop.from_numpy(data, jax.device_get(op_j),
                                              device="cpu")
            assert op_t.Dinvs.dtype == (torch.bfloat16 if bf16
                                        else torch.float32)
            _, info_t = ns_t.solve_ns_schedule(
                data_t, op_t, *ns_t.schedule_arrays(ph_t))
            out[bf16] = (float(info.obj), float(info_t.obj),
                         int(info_t.iters))
    finally:
        pt.thomas_solve_pallas = orig
    return out


def test_bf16_on_production_ladder_fails_in_both_packages():
    """The first phase (200 iterations, rho from 3e-5 fenced at 1e-3) of
    the budget256 study's full-budget arm at refine 1 on a 4-agent scatter
    problem built by the JAX package: on bf16 pivots each package's
    objective ends over 10x its float32 one (the inventory preconditions
    this ladder too poorly for one PCG step), so the bf16 mode misses the
    toy's 5% bound in the reference too."""
    from swarm_simulator_tpu.corridor.times import build_corridors
    from swarm_simulator_tpu.io.mission_json import scatter_mission
    from swarm_simulator_tpu.qp import assemble
    from swarm_simulator_tpu.search.planner import plan_initial_trajectories
    from swarm_simulator_tpu.world.esdf import ESDF
    from swarm_simulator_tpu.world.voxel import OccupancyGrid
    from swarm_simulator_tpu_torch.tools import budget256_study as bud
    import swarm_simulator_tpu as sst

    n = 4
    mission = scatter_mission(n, half=9.5, z=1.0, seed=7)
    param = sst.Param(world_x_min=-10, world_x_max=10, world_y_min=-10,
                      world_y_max=10, world_z_min=0.3, world_z_max=2.5,
                      grid_xy_res=0.5, grid_z_res=1.0, solver_dtype="float32")
    esdf = ESDF(OccupancyGrid.empty(param.world_min, param.world_max,
                                    param.world_resolution),
                max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)
    data = assemble.assemble_batch(
        plan, mission, param, np.arange(n),
        assemble.build_dummy(plan.init_traj, param.n), device=False)
    objs = ladder_objectives(
        data, bud.phases(bud.base_settings(1, False), bud.ARMS[0])[:1])
    (j32, t32, it32), (j16, t16, it16) = objs[False], objs[True]
    assert it32 == it16 == bud.ARMS[0][0]
    assert np.isfinite([j32, t32]).all() and min(j32, t32) > 0, objs
    assert j16 > 10 * j32 and t16 > 10 * t32, objs


def witness_forest64() -> dict:
    """The refine-1 production phases on the 64-agent forest's cold
    problem (seed 0, built by the port's host pipeline exactly as
    chip_smoke.py's phase 11 builds it; ``data`` is its digest there), in
    both packages on float32 and bf16 pivots (see ladder_objectives)."""
    import time

    import chip_smoke
    from swarm_simulator_tpu.qp import assemble as assemble_j
    from swarm_simulator_tpu_torch.qp import joint as joint_t

    plan, mission, param, _ = chip_smoke.build_problem(chip_smoke.SEED)
    data_t, _ = joint_t.assemble_joint(plan, mission, param)
    data = assemble_j.QPData(**{f.name: getattr(data_t, f.name)
                                for f in dataclasses.fields(data_t)})
    t0 = time.perf_counter()
    objs = ladder_objectives(data, joint_t.production_phases(kkt_refine=1))
    return {"agents": mission.qn, "data": chip_smoke.digest(data_t),
            "budgets": list(joint_t.PRODUCTION_BUDGETS),
            **{("bfloat16" if k else "float32"): dict(jax=j, port=t, iters=i)
               for k, (j, t, i) in objs.items()},
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    # python tests/test_torch_bf16.py: the 64-agent witness above, as JSON
    import json

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print(json.dumps(witness_forest64()))
