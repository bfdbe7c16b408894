"""PyTorch port, the chunk-level Anderson acceleration of the knot-state
solver (``NSSettings.aa_depth``), against the JAX package on the CPU in
float64.

- tests/test_nullspace.py's 3-agent problem (check_every 10 and tolerances
  of 1e-8, so that the acceleration takes effect before the residuals
  converge) and the joint QP of an in-repo 8-agent forest (the production
  phases at a third of their budgets, check_every 50) through both
  packages' ``solve_ns_phases`` with aa_depth 3 and 5 (per-phase loop,
  host-f64 operator): the same total iterations, x within 1e-8 of its
  scale (tests/test_torch_phases.py's per-phase tolerance);
- a schedule with aa_depth raises ValueError, as in the JAX package,
  and an aa_depth phase tuple is not schedule-compatible;
- the accelerated solution within 1e-4 of the plain loop's (the JAX
  package's own test_aa_depth_converges_tiny), in fewer iterations.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from test_nullspace import _data  # noqa: E402
from test_torch_phases import (  # noqa: E402,F401
    _numpy, _port_data, _port_settings, _rel, forest)
from test_torch_seqbatch import one_thread  # noqa: E402,F401

from swarm_simulator_tpu.qp import joint as joint_j  # noqa: E402
from swarm_simulator_tpu.qp import nullspace as ns_j  # noqa: E402
from swarm_simulator_tpu_torch.qp import interop  # noqa: E402
from swarm_simulator_tpu_torch.qp import nullspace as ns_t  # noqa: E402

#: the 8-agent joint problem's phases: the production shape at a third of
#: its budgets, check_every 50 (the JAX study's arm)
FOREST_BUDGETS = (100, 200, 50)


def _tiny():
    data, _ = _data(n_agents=3, M=5)
    s = ns_j.NSSettings(kkt_mode="banded", max_iter=300, check_every=10,
                        eps_abs=1e-8, eps_rel=1e-8)
    return _numpy(data), (s,)


def _joint(forest):
    ph = joint_j.production_phases(FOREST_BUDGETS, fused=False)
    return forest[3], ph


def _solve_both(data, phases):
    op = ns_j.prepare_ns_np(data, phases[0])
    xj, ij = jax.jit(ns_j.solve_ns_phases, static_argnames=("phases",))(
        jax.tree.map(jnp.asarray, data), phases=phases,
        op=jax.tree.map(jnp.asarray, op))
    _, op_t = interop.from_numpy(data, op, device="cpu")
    xt, it = ns_t.solve_ns_phases(_port_data(data),
                                  tuple(_port_settings(p) for p in phases),
                                  op=op_t, device="cpu")
    return (np.asarray(xj), int(ij.iters)), (xt.numpy(), int(it.iters))


@pytest.mark.parametrize("depth", [3, 5])
@pytest.mark.parametrize("problem", ["3-agent", "8-agent forest"])
def test_aa_matches_jax(forest, problem, depth):
    data, ph = _tiny() if problem == "3-agent" else _joint(forest)
    ph = tuple(dataclasses.replace(p, aa_depth=depth) for p in ph)
    (xj, nj), (xt, nt) = _solve_both(data, ph)
    assert nt == nj
    assert _rel(xt, xj) < 1e-8


def test_aa_in_schedule_mode_raises():
    data, (s,) = _tiny()
    s = dataclasses.replace(_port_settings(s), aa_depth=3)
    assert ns_t.schedule_arrays((s, s)) is None
    op = ns_t.prepare_ns_np(_port_data(data), s)
    _, op_t = interop.from_numpy(data, op, device="cpu")
    d = _port_data(data).to("cpu")
    with pytest.raises(ValueError, match="schedule mode does not support "
                       "aa_depth"):
        ns_t.solve_ns_schedule(d, op_t, s, [300], [0], [s.n_rungs - 1])


def test_aa_reaches_the_plain_solution():
    data, (s,) = _tiny()
    s = _port_settings(s)
    op = ns_t.prepare_ns_np(_port_data(data), s)
    _, op_t = interop.from_numpy(data, op, device="cpu")

    def solve(s):
        x, info = ns_t.solve_ns_phases(_port_data(data), (s,), op=op_t,
                                       device="cpu")
        return x.numpy(), info.iters

    x0, n0 = solve(s)
    x1, n1 = solve(dataclasses.replace(s, aa_depth=3))
    assert np.abs(x0 - x1).max() < 1e-4
    assert n1 < n0
