"""PyTorch port, the SCP baseline (qp/scp) and its dense ADMM (qp/dense),
against the JAX package on the CPU in float64.

- ``solve_dense`` on seeded dense QPs (with equality rows, a warm start
  and without): the same iterations, x within 1e-8;
- ``plan_scp`` on the 2- and 4-agent swaps of tests/test_scp.py: the same
  SCP iterations and inner iterations, the cost within 1e-8 relative;
- ``cli.plan --alg scp --device cpu`` prints the JAX CLI's lines;
- without a card and without ``device`` they raise.
"""
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_seqbatch import one_thread  # noqa: E402,F401

from swarm_simulator_tpu.core.types import Param as ParamJ  # noqa: E402
from swarm_simulator_tpu.io.mission_json import \
    swap_mission as swap_j  # noqa: E402
from swarm_simulator_tpu.qp import dense as dense_j  # noqa: E402
from swarm_simulator_tpu.qp import scp as scp_j  # noqa: E402
from swarm_simulator_tpu_torch.core.types import Param as ParamT  # noqa: E402
from swarm_simulator_tpu_torch.io.mission_json import \
    swap_mission as swap_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import dense as dense_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import scp as scp_t  # noqa: E402


def _qp(seed, n=30, m=45, n_eq=5):
    """A seeded convex QP: Q = G G^T + 0.1 I, q, A with n_eq equality
    rows first, two-sided bounds around A x_feas."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    Q = G @ G.T / n + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    ax = A @ rng.standard_normal(n)
    l = ax - rng.uniform(0.0, 1.0, m)
    u = ax + rng.uniform(0.0, 1.0, m)
    l[:n_eq] = u[:n_eq] = ax[:n_eq]
    return Q, q, A, l, u


@pytest.mark.parametrize("case", ["plain", "is_eq+x0"])
def test_solve_dense_matches_jax(case):
    Q, q, A, l, u = _qp(3)
    kw = {}
    if case == "is_eq+x0":
        is_eq = np.zeros(len(l), bool)
        is_eq[:5] = True
        kw = dict(is_eq=is_eq, x0=np.full(Q.shape[0], 0.1))
    s = dense_j.DenseSettings(max_iter=3000)
    xj, ij = dense_j.solve_dense(
        jnp.asarray(Q), jnp.asarray(q), jnp.asarray(A), jnp.asarray(l),
        jnp.asarray(u), s,
        *(jnp.asarray(kw[k]) if k in kw else None for k in ("is_eq", "x0")))
    st = dense_t.DenseSettings(max_iter=3000)
    xt, it = dense_t.solve_dense(Q, q, A, l, u, st, device="cpu", **kw)
    assert it.iters == int(ij.iters) < 3000
    assert np.abs(xt.numpy() - np.asarray(xj)).max() < 1e-8
    assert abs(float(it.obj) - float(ij.obj)) < 1e-8 * abs(float(ij.obj))


@pytest.mark.parametrize("n,kw,horizon", [
    (2, dict(z=0.5, span=1.0, radius=0.25), 10.0),
    (4, dict(z=1.0, span=2.0, radius=0.2), 12.0)], ids=["2-agent", "4-agent"])
def test_plan_scp_matches_jax(n, kw, horizon):
    rj = scp_j.plan_scp(swap_j(n, **kw),
                        ParamJ(solver_dtype="float64", time_step=1.0),
                        horizon=horizon, epsilon=0.01)
    rt = scp_t.plan_scp(swap_t(n, **kw),
                        ParamT(solver_dtype="float64", time_step=1.0),
                        horizon=horizon, epsilon=0.01, device="cpu")
    assert rt.iterations == rj.iterations >= 2
    assert [i.iters for i in rt.infos] == [int(i.iters) for i in rj.infos]
    assert abs(rt.cost - rj.cost) <= 1e-8 * abs(rj.cost)
    assert np.abs(rt.pos - rj.pos).max() < 1e-6
    assert rt.K == rj.K and rt.h == rj.h


def test_cli_scp_prints_the_jax_lines(tmp_path, capsys):
    """``--alg scp --device cpu`` on the 4-agent swap as a mission JSON,
    at a 2 s time step: the JAX CLI's lines (K, h, SCP iterations, cost,
    ratio, goal error, RESULT) and its exit code."""
    from swarm_simulator_tpu.cli.plan import main as main_j
    from swarm_simulator_tpu_torch.cli.plan import main as main_t

    m = swap_t(4, z=1.0, span=2.0, radius=0.2)
    doc = {"quadrotors": {}, "agents": []}
    for qi, name in enumerate(m.names):
        doc["quadrotors"][name] = {"max_vel": m.max_vel[qi].tolist(),
                                   "max_acc": m.max_acc[qi].tolist()}
        doc["agents"].append({"name": name, "start": m.start[qi].tolist(),
                              "goal": m.goal[qi].tolist(),
                              "radius": float(m.radius[qi]),
                              "speed": float(m.speed[qi])})
    path = tmp_path / "mission.json"
    path.write_text(json.dumps(doc))
    args = ["--mission", str(path), "--alg", "scp", "--dtype", "float64",
            "--time-step", "2.0"]
    rc_j = main_j(args)
    out_j = capsys.readouterr().out
    rc_t = main_t([*args, "--device", "cpu"])
    out_t = capsys.readouterr().out
    assert rc_t == rc_j == 0
    assert out_t.splitlines() == out_j.splitlines()
    assert out_t.splitlines()[-1] == "RESULT: collision-free"


def test_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Q, q, A, l, u = _qp(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dense_t.solve_dense(Q, q, A, l, u)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scp_t.plan_scp(swap_t(2, z=0.5, span=1.0, radius=0.25),
                       ParamT(time_step=1.0), horizon=4.0)
