"""PyTorch port, the big-swarm route's host pieces on the CPU.

- The port's numpy RSFC chain (corridor/rsfc._pair_planes_numpy, its
  only form) against the JAX package's jitted ``pair_separating_planes``
  (x64, CPU) within 1e-12, and both packages' ``build_rsfc`` above the
  JAX package's 200,000 pair-segment threshold (64 synthetic agents x
  101 knots is 201,600), where JAX takes its jitted form.
- The torch form (corridor/rsfc.pair_separating_planes, float64 on the
  CPU) against the JAX package's jitted form under x64 within 1e-12, and
  both packages' ``build_rsfc`` just above the threshold (100 agents, M =
  41: 202,950 pair-segments), where both take their large-swarm forms,
  within 1e-12, the port's through the torch form; both raise the same
  "collide" error on a colliding pair.
- The device-prep route's phases: refine-1 phases and their warm polish
  extensions keep kkt_refine and precond_dtype.
- The budget256 tool's arm on a small scatter problem, bf16 pivots, on
  the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swarm_simulator_tpu.corridor import rsfc as rsfc_j
from swarm_simulator_tpu_torch.corridor import rsfc as rsfc_t
from swarm_simulator_tpu_torch.qp import joint as joint_t


def _trajectories(n_agents: int, knots: int, seed: int) -> np.ndarray:
    """Seeded random walks [N, knots, 3] in a 20 x 20 x 2 m box: distinct
    start points and small steps, so no relative path meets the origin."""
    rng = np.random.default_rng(seed)
    start = np.stack([rng.permutation(np.linspace(-9.5, 9.5, n_agents)),
                      rng.permutation(np.linspace(-9.5, 9.5, n_agents)),
                      rng.uniform(0.5, 2.0, n_agents)], axis=1)
    steps = 0.05 * rng.standard_normal((n_agents, knots - 1, 3))
    return np.concatenate([start[:, None], start[:, None]
                           + np.cumsum(steps, axis=1)], axis=1)


@pytest.mark.parametrize("downwash", [1.0, 2.0])
def test_torch_rsfc_form_matches_jax(downwash):
    traj = _trajectories(20, 31, seed=3)
    iu, ju = np.triu_indices(20, k=1)
    pair_idx = np.stack([iu, ju], axis=1).astype(np.int32)
    with jax.enable_x64(True):
        nj, dj = rsfc_j.pair_separating_planes(
            jnp.asarray(traj), jnp.asarray(pair_idx), downwash=downwash)
    nt, dt = rsfc_t._pair_planes_numpy(traj, pair_idx, downwash)
    assert nt.dtype == dt.dtype == np.float64
    assert np.abs(nt - np.asarray(nj)).max() <= 1e-12
    assert np.abs(dt - np.asarray(dj)).max() <= 1e-12 * np.abs(dj).max()


def test_build_rsfc_above_threshold_matches_jax():
    traj = _trajectories(64, 101, seed=5)
    assert 64 * 63 // 2 * 100 > 200_000     # JAX takes its jitted form
    pj, nj = rsfc_j.build_rsfc(traj, 2.0)
    pt, nt = rsfc_t.build_rsfc(traj, 2.0)
    assert np.array_equal(pj, pt) and pt.dtype == np.int32
    assert np.abs(nt - nj).max() <= 1e-12


@pytest.mark.parametrize("downwash", [1.0, 2.0])
def test_torch_pair_separating_planes_matches_jax(downwash):
    import torch

    traj = _trajectories(20, 31, seed=3)
    iu, ju = np.triu_indices(20, k=1)
    pair_idx = np.stack([iu, ju], axis=1).astype(np.int32)
    with jax.enable_x64(True):
        nj, dj = rsfc_j.pair_separating_planes(
            jnp.asarray(traj), jnp.asarray(pair_idx), downwash=downwash)
    nt, dt = rsfc_t.pair_separating_planes(
        torch.as_tensor(traj), torch.as_tensor(pair_idx), downwash=downwash)
    assert nt.dtype == dt.dtype == torch.float64
    assert np.abs(nt.numpy() - np.asarray(nj)).max() <= 1e-12
    assert np.abs(dt.numpy() - np.asarray(dj)).max() <= \
        1e-12 * np.abs(dj).max()


def test_build_rsfc_just_above_threshold_takes_the_torch_form(monkeypatch):
    traj = _trajectories(100, 42, seed=7)
    n_seg = 100 * 99 // 2 * 41
    assert rsfc_t.LARGE_PAIR_SEGMENTS == 200_000 < n_seg
    calls = []
    form = rsfc_t.pair_separating_planes
    monkeypatch.setattr(rsfc_t, "pair_separating_planes",
                        lambda *a, **k: calls.append(1) or form(*a, **k))
    pj, nj = rsfc_j.build_rsfc(traj, 2.0)
    pt, nt = rsfc_t.build_rsfc(traj, 2.0, device="cpu")
    assert calls == [1]
    assert np.array_equal(pj, pt) and pt.dtype == np.int32
    assert nt.dtype == np.float64
    assert np.abs(nt - nj).max() <= 1e-12
    # agents 3 and 7 meet at knot 10: no separating plane
    traj[7, 10] = traj[3, 10]
    for mod in (rsfc_j, rsfc_t):
        with pytest.raises(ValueError, match="agents 3 and 7 collide"):
            mod.build_rsfc(traj, 2.0)


def test_device_route_phases_keep_refine_and_precond():
    base = dataclasses.replace(joint_t.production_settings(),
                               precond_dtype="bfloat16")
    phases = joint_t.production_phases(base=base, kkt_refine=1)
    assert all(p.kkt_refine == 1 and p.precond_dtype == "bfloat16"
               for p in phases)
    polish = joint_t.escalation_phases(phases)
    assert [p.max_iter for p in polish] == list(joint_t.ESCALATION_BUDGETS)
    assert all(p.kkt_refine == 1 and p.precond_dtype == "bfloat16"
               and p.warm_start == "x0" for p in polish)
    assert joint_t.polish_rounds_for_swarm(256) == 4
    assert joint_t.polish_rounds_for_swarm(64) == 0


def test_budget_tool_arm_bf16_on_cpu():
    """One short arm of tools/budget256_study on a 4-agent scatter problem
    with bf16 pivots: every KKT solve through the Thomas twin, the
    solution finite and its checks reported."""
    import torch

    from swarm_simulator_tpu_torch.tools import budget256_study as bud

    plan, mission, param, data = bud.build_problem(4)
    base = bud.base_settings(refine=1, bf16=True)
    dev = torch.device("cpu")
    data_dev = data.to(dev)
    op = bud.prepare(data_dev, base)
    assert op.Dinvs.dtype == torch.bfloat16
    r = bud.run_arm(data_dev, op, base, (50, 50, 50), plan, mission, param,
                    data, dev)
    assert 0 < r["iters"] <= 150
    assert np.isfinite([r["ratio"], r["box_viol"], r["cont"], r["obj"]]).all()
    assert r["cont"] < 1e-6      # continuity holds by construction
