"""PyTorch port, the fused ADMM chunk (ops/nsfused) and its solver loop.

The plain twin ``nsfused_chunk_reference`` is held against the JAX
package: against its Pallas TPU kernel run in interpret mode (float32,
the 5e-5 tolerance tests/test_nullspace.py holds that kernel to) and
against its XLA scan path (float64, 1e-9).  The CUDA kernel itself is
compared with the twin in tests/test_torch_cuda.py, which needs a card.
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

from test_qp import _tiny_problem  # noqa: E402

from swarm_simulator_tpu.ops import pallas_nsfused  # noqa: E402
from swarm_simulator_tpu.qp import admm as admm_j  # noqa: E402
from swarm_simulator_tpu.qp import assemble as asm_j  # noqa: E402
from swarm_simulator_tpu.qp import nullspace as ns_j  # noqa: E402
from swarm_simulator_tpu_torch.ops import nsfused  # noqa: E402
from swarm_simulator_tpu_torch.qp import interop  # noqa: E402
from swarm_simulator_tpu_torch.qp import nullspace as ns_t  # noqa: E402

N_INNER = 50


def _data(M, dtype):
    """8 agents (3B a multiple of 8, which the Pallas kernel needs) on the
    straight-line test problem, host numpy leaves in ``dtype``."""
    plan, mission, param = _tiny_problem(n_agents=8, M=M)
    dummy = asm_j.build_dummy(plan.init_traj, param.n)
    data = asm_j.assemble_batch(plan, mission, param, np.arange(8), dummy,
                                device=False)
    return jax.tree.map(
        lambda a: np.asarray(a, dtype)
        if np.asarray(a).dtype == np.float64 else np.asarray(a), data)


def _settings(**kw):
    return ns_j.NSSettings(kkt_mode="banded", tighten=2e-3, **kw)


def _port_settings(s):
    return ns_t.NSSettings(**{f.name: getattr(s, f.name)
                              for f in dataclasses.fields(ns_t.NSSettings)})


def _cold_state_jax(data, op, s):
    dj = jax.tree.map(jnp.asarray, data)
    oj = jax.tree.map(jnp.asarray, op)
    pop = admm_j._pair_op(dj)
    l, u = ns_j._bounds(dj, s.tighten)
    w = ns_j._w_from_x(oj, dj.x0, 3)
    z = jax.tree.map(jnp.clip, ns_j._A_x(dj, ns_j._x_of(oj, w), pop), l, u)
    y = jax.tree.map(jnp.zeros_like, z)
    return dj, oj, pop, l, u, (w, z, y)


def _port_chunk(data, op, s, state, rho_idx, n_inner=N_INNER):
    """One twin chunk on the port from the same (numpy) state."""
    data_t, op_t = interop.from_numpy(data, op, device="cpu")
    pop = ns_t._pair_op(data_t)
    l, u = ns_t._bounds(data_t, s.tighten)
    w, z, y = state
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    z = ns_t.NSConstr(t(z.box), t(z.pair))
    y = ns_t.NSConstr(t(y.box), t(y.pair))
    ops_f = nsfused.build_operands(data_t, op_t, pop, l, u)
    return nsfused.nsfused_chunk_reference(ops_f, rho_idx, s.sigma, s.alpha,
                                           t(w), z, y, n_inner)


def _max_rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


@pytest.mark.parametrize("M", [6, 8])
def test_twin_matches_pallas_kernel_interpret(M):
    data = _data(M, np.float32)
    s = _settings(fused_chunk=True)
    op = ns_j.prepare_ns_np(data, s)
    assert np.asarray(op.Dinvs).ndim == 5, "JAX kernel layout not engaged"
    dj, oj, pop, l, u, state = _cold_state_jax(data, op, s)
    rho_idx = 3
    ops_f = pallas_nsfused.build_operands(dj, oj, pop, l, u, 3)
    wj, zj, yj = pallas_nsfused.run_chunk(
        ops_f, rho_idx, s.sigma, s.alpha, *state, n_inner=N_INNER,
        interpret=True, pair_split=3)
    wt, zt, yt = _port_chunk(data, op, _port_settings(s), state, rho_idx)
    for a, b in ((wt, wj), (zt.box, zj.box), (zt.pair, zj.pair),
                 (yt.box, yj.box), (yt.pair, yj.pair)):
        assert a.dtype == torch.float32
        assert _max_rel(a.numpy(), b) < 5e-5


@pytest.mark.parametrize("rho_idx", [0, 4])
def test_twin_matches_xla_scan_float64(rho_idx):
    """One 50-iteration chunk equals the JAX XLA scan path's first chunk
    (fused_chunk=False, float64): a single-phase solve of exactly one
    chunk with zero tolerances, started on the given rung."""
    data = _data(6, np.float64)
    rho = float(np.logspace(-3, 1, 7)[rho_idx])
    s = _settings(max_iter=N_INNER, check_every=N_INNER, eps_abs=0.0,
                  eps_rel=0.0, eps_dual_abs=0.0, rho=rho, warm_start="x0")
    op = ns_j.prepare_ns_np(data, s)
    _, _, _, _, _, state = _cold_state_jax(data, op, s)
    _, _, (wj, zj, yj, _) = ns_j.solve_ns_phases(
        jax.tree.map(jnp.asarray, data), (s,),
        op=jax.tree.map(jnp.asarray, op), return_state=True)
    wt, zt, yt = _port_chunk(data, op, _port_settings(s), state, rho_idx)
    for a, b in ((wt, wj), (zt.box, zj.box), (zt.pair, zj.pair),
                 (yt.box, yj.box), (yt.pair, yj.pair)):
        assert _max_rel(a.numpy(), b) < 1e-9


def test_schedule_matches_jax_float64():
    """The phased schedule loop (residuals, rung walk, fences, early exit)
    gives the JAX schedule path's iteration count and solution."""
    data = _data(8, np.float64)
    base = _settings(max_iter=1500, check_every=50, eps_abs=2e-4,
                     eps_rel=2e-4, eps_dual_abs=5e-3, rho_min=1e-5,
                     rho_max=1e-2, n_rungs=5, warm_start="x0")
    phases = (dataclasses.replace(base, max_iter=150, rho_lo=1e-3),
              dataclasses.replace(base, max_iter=300),
              dataclasses.replace(base, max_iter=100, rho_lo=1e-2))
    op = ns_j.prepare_ns_np(data, phases[0])
    sched = ns_j.schedule_arrays(phases)
    xj, ij = ns_j.solve_ns_schedule(jax.tree.map(jnp.asarray, data),
                                    jax.tree.map(jnp.asarray, op), *sched)
    data_t, op_t = interop.from_numpy(data, op, device="cpu")
    sched_t = ns_t.schedule_arrays(tuple(_port_settings(p) for p in phases))
    assert all(np.array_equal(a, b) for a, b in zip(sched[1:], sched_t[1:]))
    xt, it = ns_t.solve_ns_schedule(data_t, op_t, *sched_t)
    assert it.iters == int(ij.iters)
    assert _max_rel(xt.numpy(), xj) < 1e-9
    assert abs(float(it.obj) - float(ij.obj)) <= 1e-9 * abs(float(ij.obj))


def test_pair_csr_is_the_selection_transpose():
    """The kernel's per-agent pair lists reproduce A^T's pair part
    (S^T (n_d * y_pair)) as a gather, including one-sided and masked
    pairs."""
    rng = np.random.default_rng(0)
    B, P, M, npp = 5, 9, 3, 6
    bi = rng.integers(-1, B, P).astype(np.int32)
    bj = rng.integers(0, B, P).astype(np.int32)
    bi[bi == bj] = -1
    mask = (rng.random(P) > 0.2).astype(np.float64)
    pn = rng.normal(size=(P, M, 3))
    ypair = rng.normal(size=(P, M * npp))
    ptr, pair, coef = nsfused.pair_csr(bi, bj, mask, B)
    at = np.zeros((B, 3, M * npp))
    m_of_d = np.arange(M * npp) // npp
    for b in range(B):
        for q in range(ptr[b], ptr[b + 1]):
            p = pair[q]
            at[b] += coef[q] * pn[p, m_of_d].T * ypair[p]
    S = np.zeros((P, B))
    np.add.at(S, (np.arange(P), np.clip(bj, 0, None)), (bj >= 0) * mask)
    np.add.at(S, (np.arange(P), np.clip(bi, 0, None)), -((bi >= 0) * mask))
    n_d = np.repeat(pn, npp, axis=1).transpose(0, 2, 1) * mask[:, None, None]
    ref = np.einsum("pb,pkd->bkd", S, n_d * ypair[:, None, :])
    np.testing.assert_allclose(at, ref, rtol=1e-6, atol=1e-9)


def test_rows_layout_roundtrip():
    v = torch.arange(2 * 3 * 4 * 3, dtype=torch.float32).reshape(2, 3, 12)
    rows = nsfused.rows_from_state(v, Mi=4, phi=3)
    # row k holds knot k of every (agent, axis), derivative order minor
    assert rows.shape == (4, 18)
    assert torch.equal(rows[1, 3:6], v[0, 1, 3:6])
    assert torch.equal(nsfused.state_from_rows(rows, 2, 3, 3), v)


def _cpu_chunk_inputs():
    data = _data(6, np.float32)
    s = _settings()
    op = ns_j.prepare_ns_np(data, s)
    _, _, _, _, _, (w, z, y) = _cold_state_jax(data, op, s)
    data_t, op_t = interop.from_numpy(data, op, device="cpu")
    pop = ns_t._pair_op(data_t)
    l, u = ns_t._bounds(data_t, s.tighten)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    ops_f = nsfused.build_operands(data_t, op_t, pop, l, u)
    return ops_f, s, (t(w), ns_t.NSConstr(t(z.box), t(z.pair)),
                      ns_t.NSConstr(t(y.box), t(y.pair)))


def test_wrapper_takes_twin_only_on_cpu():
    ops_f, s, (w, z, y) = _cpu_chunk_inputs()
    before = nsfused.nsfused_chunk.launches
    out = nsfused.nsfused_chunk(ops_f, 2, s.sigma, s.alpha, w, z, y, 3)
    ref = nsfused.nsfused_chunk_reference(ops_f, 2, s.sigma, s.alpha, w, z,
                                          y, 3)
    assert nsfused.nsfused_chunk.launches == before
    assert torch.equal(out[0], ref[0])
    assert all(torch.equal(a, b) for a, b in zip(out[1], ref[1]))
    # a tensor on neither the CPU nor a CUDA card is refused, not solved
    with pytest.raises(ValueError, match="CUDA"):
        nsfused.nsfused_chunk(ops_f, 2, s.sigma, s.alpha,
                              w.to("meta"), z, y, 3)



def test_state_errors_scale_each_part_by_itself():
    """A dual off by a tenth of its own (tiny) size shows as 0.1, not as
    its ratio to the primal state; the tolerance compares the worst error
    over the rungs of the kernel with that of the float32 twin."""
    t = torch.tensor
    ref = (t([4.0, -2.0]), ns_t.NSConstr(t([1.0]), t([3.0])),
           ns_t.NSConstr(t([1e-6]), t([0.0])))
    off = (ref[0], ref[1], ns_t.NSConstr(t([1.1e-6]), t([0.0])))
    errs = nsfused.state_errors(off, ref)
    assert errs[:3] == [0.0, 0.0, 0.0] and errs[4] == 0.0
    assert errs[3] == pytest.approx(0.1)
    k64 = [[0.0, 0.0, 0.0, 0.1, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0]]
    t64 = [[0.0, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.05, 0.0]]
    use = nsfused.twin_gap_use(k64, t64)
    assert use["y_box"] == pytest.approx(
        0.1 / (nsfused.TWIN_GAP_FACTOR * 0.05 + nsfused.TWIN_GAP_FLOOR))
    assert use["w"] == 0.0
