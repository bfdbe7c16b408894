"""PyTorch port, the KKT route of a host-prepped banded solve
(``joint.select_kkt_path``, ``ops/nsfused.fits``), on the CPU.

- ``select_kkt_path``'s decisions at 64, 96 and 256 agents (the forest's
  and the scatter problem's segment counts, all C(N, 2) pairs) on an
  H100's limits: K1 holds all three (its ring plan needs 113,176,
  221,460 and 193,800 bytes of a block's 232,448); on a card of 200,000
  bytes the 96-agent problem routes every phase to K2
  (thomas_kernel=True) and the others keep K1; ``unfit_reasons`` names
  the rule a problem breaks;
- the pass-through: schedules on the CPU, and schedules that take no K1
  chunk (kkt_refine 1, dense), come back untouched (the JAX package's
  select_kkt_path passes CPU schedules through too);
- the K2 route (thomas_kernel=True, kkt_refine 0) of the joint QP of an
  in-repo 8-agent forest through the plain twins (the Thomas twin runs,
  the fused chunk's does not), against the JAX package's XLA scan path
  (fused_chunk=False) in float64: the same total iterations, x within
  1e-8 of its scale, and bit-equal to the K1 route's twin on the CPU
  (the same ADMM step and Thomas sweeps).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_anderson import FOREST_BUDGETS  # noqa: E402
from test_torch_phases import (_port_data, _port_settings, _rel,  # noqa: E402
                               forest)  # noqa: F401
from test_torch_seqbatch import one_thread  # noqa: E402,F401

from swarm_simulator_tpu.qp import joint as joint_j  # noqa: E402
from swarm_simulator_tpu.qp import nullspace as ns_j  # noqa: E402
from swarm_simulator_tpu_torch.ops import nsfused, thomas  # noqa: E402
from swarm_simulator_tpu_torch.qp import interop  # noqa: E402
from swarm_simulator_tpu_torch.qp import joint as joint_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import nullspace as ns_t  # noqa: E402

#: (agents, segments): the 64-agent forest, a 96-agent mission of the
#: same geometry, the 256-agent scatter problem
SHAPES = {64: 36, 96: 36, 256: 72}
SMALL_CARD = nsfused.CardLimits(sms=132, smem_optin=200_000)


def _route(agents, limits, phases=None, device="cuda"):
    phases = phases or joint_t.production_phases()
    return phases, joint_t.select_kkt_path(
        phases, agents, SHAPES[agents], agents * (agents - 1) // 2, 3,
        device, limits)


@pytest.mark.parametrize("agents", sorted(SHAPES))
def test_select_kkt_path_decisions(agents):
    P = agents * (agents - 1) // 2
    ph, out = _route(agents, nsfused.H100)
    assert out is ph and nsfused.fits(agents, SHAPES[agents], P,
                                      nsfused.H100)
    ph, out = _route(agents, SMALL_CARD)
    unfit = nsfused.unfit_reasons(agents, SHAPES[agents], P, SMALL_CARD)
    if agents == 96:
        assert [p.thomas_kernel for p in out] == [True] * 3
        assert [dataclasses.replace(p, thomas_kernel=False)
                for p in out] == list(ph)
        assert len(unfit) == 1 and "221460 bytes" in unfit[0]
    else:
        assert out is ph and not unfit


def test_unfit_reasons_name_the_rule():
    assert "phi 5" in nsfused.unfit_reasons(64, 36, 2016, nsfused.H100,
                                            phi=5)[0]
    assert "no interior knot" in nsfused.unfit_reasons(64, 1, 2016,
                                                       nsfused.H100)[0]
    assert "ring plan" in nsfused.unfit_reasons(5000, 72, 12_497_500,
                                                nsfused.H100)[0]


def test_pass_through():
    tiny = nsfused.CardLimits(sms=132, smem_optin=1024)
    ph, out = _route(256, tiny, device="cpu")
    assert out is ph
    for ph in (joint_t.production_phases(kkt_refine=1),
               tuple(dataclasses.replace(p, kkt_mode="dense")
                     for p in joint_t.production_phases())):
        assert _route(256, tiny, ph)[1] is ph
    _, routed = _route(256, tiny)
    assert _route(256, tiny, routed)[1] is routed
    jph = joint_j.production_phases(fused=True)
    assert joint_j.select_kkt_path(jph, 256, 72, 32640, 3,
                                   backend="cpu") is jph


def test_k2_route_matches_jax_xla_scan(forest, monkeypatch):  # noqa: F811
    data = forest[3]
    ph = joint_j.production_phases(FOREST_BUDGETS, fused=False)
    assert not any(p.fused_chunk or p.thomas_kernel for p in ph)
    op = ns_j.prepare_ns_np(data, ph[0])
    xj, ij = jax.jit(ns_j.solve_ns_phases, static_argnames=("phases",))(
        jax.tree.map(jnp.asarray, data), phases=ph,
        op=jax.tree.map(jnp.asarray, op))
    _, op_t = interop.from_numpy(data, op, device="cpu")
    calls = {"thomas": 0, "fused": 0}
    solve, chunk = thomas.thomas_solve_reference, \
        nsfused.nsfused_chunk_reference

    def count(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f

    monkeypatch.setattr(thomas, "thomas_solve_reference",
                        count("thomas", solve))
    monkeypatch.setattr(nsfused, "nsfused_chunk_reference",
                        count("fused", chunk))
    k2 = tuple(dataclasses.replace(_port_settings(p), thomas_kernel=True)
               for p in ph)
    xt, it = ns_t.solve_ns_phases(_port_data(data), k2, op=op_t,
                                  device="cpu")
    assert calls["thomas"] == it.iters and calls["fused"] == 0
    assert it.iters == int(ij.iters)
    assert _rel(xt.numpy(), np.asarray(xj)) < 1e-8
    monkeypatch.undo()
    xk, ik = ns_t.solve_ns_phases(
        _port_data(data), tuple(_port_settings(p) for p in ph), op=op_t,
        device="cpu")
    assert ik.iters == it.iters and np.array_equal(xk.numpy(), xt.numpy())
