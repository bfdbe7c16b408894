"""PyTorch port, the scenario axis across ranks (parallel/mesh's grid,
parallel/distributed's scenario_shard, tools/dryrun_multichip's parts 2
and 3), on gloo ranks on the CPU.

- ``distributed.scenario_shard`` equals the JAX package's for 1-17
  scenarios over 1-8 processes, and ``mesh.factor`` gives the (scenario,
  batch) shape of the JAX package's ``make_mesh`` over the conftest's
  first 1-8 virtual devices, with and without one axis given;
- the (scenario, batch) Jacobi sweep (``mesh.grid_sweep``, ADMM with the
  cg KKT, two rounds of (50, 25) iterations carrying the state, as
  dryrun_multichip's part 2) of copies of an in-repo 8-agent forest's four
  2-agent groups, float64: on 2 gloo ranks as a (1, 2) grid over two
  copies and on 4 as a (2, 2) grid over three (rows of 2 and 1 copies),
  each rank holding only its rows (``mesh.shard_stacked``), equal to the
  one-process ``stacked_sweep`` of the whole stack to 1e-12 of the
  control points' scale (each group stops on its own residuals, but
  batched products over another stack size round differently: 7.4e-13
  m here), and on one rank as a (1, 1) grid bit for bit;
- the scenario-replicated joint solves (part 3, 2 gloo ranks, the 8-agent
  joint QP, banded at max_iter 20): each equal to ``solve_single_ns`` of
  the same QP, bit for bit.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_jacobi import _port_data, groups  # noqa: E402,F401
from test_torch_phases import forest  # noqa: E402,F401
from test_torch_seqbatch import one_thread  # noqa: E402,F401

from swarm_simulator_tpu.parallel import distributed as dist_j  # noqa: E402
from swarm_simulator_tpu.parallel import mesh as mesh_j  # noqa: E402
from swarm_simulator_tpu_torch.parallel import distributed as pd  # noqa: E402
from swarm_simulator_tpu_torch.parallel import mesh as mesh_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import nullspace as ns_t  # noqa: E402
from swarm_simulator_tpu_torch.tools import \
    dryrun_multichip as dry  # noqa: E402


def test_scenario_shard_matches_jax():
    for nproc in range(1, 9):
        for n in range(0, 18):
            for pid in range(nproc):
                assert np.array_equal(
                    pd.scenario_shard(n, pid, nproc),
                    dist_j.scenario_shard(n, pid, nproc))
    assert np.array_equal(pd.scenario_shard(5), np.arange(5))


def test_factor_matches_jax_make_mesh():
    devs = jax.devices()
    assert len(devs) == 8
    for n in range(1, 9):
        for kw in ({}, {"n_scenario": 1}, {"n_batch": 1},
                   {"n_batch": 2 if n % 2 == 0 else 1}):
            m = mesh_j.make_mesh(devices=devs[:n], **kw)
            assert mesh_t.factor(n, **kw) == m.devices.shape
            assert m.axis_names == ("scenario", "batch")


def _sweep_case(groups):
    stacked, dummy = groups
    data = _port_data(stacked)
    kw = dict(iters_schedule=dry.SWEEP_ITERS, carry_state=True)
    return data, dummy, kw, dry.sweep_settings()


@pytest.mark.parametrize("ranks,shape,n_scen", [(1, (1, 1), 2),
                                                (2, (1, 2), 2),
                                                (4, (2, 2), 3)])
def test_grid_sweep_matches_one_process(groups, ranks, shape,  # noqa: F811
                                        n_scen):
    data, dummy, kw, settings = _sweep_case(groups)
    got, grid_shape, iters, _ = pd.run_ranks(
        dry.sweep_rank, ranks, dry.stack_share, (data, dummy), n_scen,
        settings, dry.SWEEP_ROUNDS, kw, shape, backend="gloo")
    assert grid_shape == shape
    stacked, scen, dm = dry.copies(data.to("cpu"), dummy, n_scen)
    want, info = mesh_t.stacked_sweep(stacked, scen, dm, settings,
                                      dry.SWEEP_ROUNDS, **kw)
    assert got.shape == tuple(want.shape)
    want = want.numpy()
    if ranks == 1:
        assert np.array_equal(got, want)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert iters <= int(info.iters.max())


def test_replicated_joint_solves(forest):  # noqa: F811
    data = _port_data(forest[3])
    s = ns_t.NSSettings(**dry.REPLICA_SETTINGS)
    xs, iters, _ = pd.run_ranks(dry.replica_rank, 2, data, s,
                                backend="gloo")
    x, info = ns_t.solve_single_ns(data, s, device="cpu")
    assert xs.shape == (2,) + tuple(x.shape)
    assert iters == int(info.iters)
    for r in range(2):
        assert np.array_equal(xs[r], x.double().numpy())
