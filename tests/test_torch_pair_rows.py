"""PyTorch port, the constraint rows' pair part and the QP export.

``qp/nullspace._A_x`` gathers each pair's two agents by index instead of
multiplying the dense signed selection S (whose einsum torch lowered to
one GEMV per pair on the card).  It is held against the JAX package's
``_A_x``/``_AT_x`` in float64 (1e-12 of the result's scale: the two
differ only in the order of a few roundings), against the old einsum
form in float32 (1e-6), and on a rank's slice of the pair rows as
qp/nullspace_shard places it.  ``Param.log`` makes
``joint.solve_trajectories`` print the problem size and write
``log/qp_joint.npz`` as the JAX package does.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_simulator_tpu.core import types as types_j
from swarm_simulator_tpu.eval import safety as safety_j
from swarm_simulator_tpu.eval import sample as sample_j
from swarm_simulator_tpu.qp import admm as admm_j
from swarm_simulator_tpu.qp import assemble as asm_j
from swarm_simulator_tpu.qp import joint as joint_j
from swarm_simulator_tpu.qp import nullspace as ns_j
from swarm_simulator_tpu.utils.timing import ProblemSize
from swarm_simulator_tpu_torch.core import types as types_t
from swarm_simulator_tpu_torch.eval import safety as safety_t
from swarm_simulator_tpu_torch.eval import sample as sample_t
from swarm_simulator_tpu_torch.eval.gate import gate_quality as gate_t
from swarm_simulator_tpu_torch.qp import admm as admm_t
from swarm_simulator_tpu_torch.qp import assemble as asm_t
from swarm_simulator_tpu_torch.qp import interop
from swarm_simulator_tpu_torch.qp import joint as joint_t
from swarm_simulator_tpu_torch.qp import nullspace as ns_t
from swarm_simulator_tpu_torch.qp import nullspace_shard as shard_t

# (agents, pairs, segments, control points per segment, seed)
CASES = [(5, 9, 3, 6, 0), (8, 28, 4, 6, 1), (12, 40, 6, 6, 2)]


def _pair_leaves(B, P, M, npp, seed):
    """Seeded pair leaves: random agent pairs, a fifth of them masked
    out, a quarter one-sided (pair_bi = -1), some one-sided on the j side
    too; x [B, 3, D] and y [P, D] to apply A and A^T to."""
    rng = np.random.default_rng(seed)
    bi = rng.integers(0, B, P).astype(np.int32)
    bj = ((bi + rng.integers(1, B, P)) % B).astype(np.int32)
    bi[rng.random(P) < 0.25] = -1
    bj[(rng.random(P) < 0.1) & (bi >= 0)] = -1
    mask = (rng.random(P) > 0.2).astype(np.float64)
    D = M * npp
    return dict(pair_bi=bi, pair_bj=bj, pair_mask=mask,
                pair_n=rng.normal(size=(P, M, 3)),
                lb=np.zeros((B, 3, D))), (rng.normal(size=(B, 3, D)),
                                          rng.normal(size=(B, 3, D)),
                                          rng.normal(size=(P, D)))


def _both(leaves, dtype):
    """The pair leaves _pair_op reads, as attributes, for either package."""
    def cast(v):
        return v.astype(dtype) if v.dtype.kind == "f" else v

    return (SimpleNamespace(**{k: jnp.asarray(cast(v))
                               for k, v in leaves.items()}),
            SimpleNamespace(**{k: torch.as_tensor(cast(v))
                               for k, v in leaves.items()}))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("B, P, M, npp, seed", CASES)
def test_pair_rows_match_jax_float64(B, P, M, npp, seed):
    leaves, (x, ybox, ypair) = _pair_leaves(B, P, M, npp, seed)
    dj, dt = _both(leaves, np.float64)
    pop_j, pop_t = admm_j._pair_op(dj), admm_t._pair_op(dt)
    ax_j = ns_j._A_x(dj, jnp.asarray(x), pop_j)
    ax_t = ns_t._A_x(torch.as_tensor(x), pop_t)
    assert np.array_equal(ax_t.box.numpy(), x)
    assert _rel(ax_t.pair.numpy(), ax_j.pair) <= 1e-12
    y_j = ns_j.NSConstr(box=jnp.asarray(ybox), pair=jnp.asarray(ypair))
    y_t = ns_t.NSConstr(box=torch.as_tensor(ybox),
                        pair=torch.as_tensor(ypair))
    assert _rel(ns_t._AT_x(y_t, pop_t).numpy(),
                ns_j._AT_x(dj, y_j, pop_j)) <= 1e-12


@pytest.mark.parametrize("B, P, M, npp, seed", CASES)
def test_pair_rows_match_the_einsum_form_float32(B, P, M, npp, seed):
    """The gather against the dense-selection einsum it replaces, both in
    float32 on the same inputs."""
    leaves, (x, _, _) = _pair_leaves(B, P, M, npp, seed)
    _, dt = _both(leaves, np.float32)
    pop = admm_t._pair_op(dt)
    x32 = torch.as_tensor(x, dtype=torch.float32)
    old = torch.einsum("pkd,pkd->pd", pop.n_d,
                       torch.einsum("pb,bkd->pkd", pop.S, x32))
    got = ns_t._A_x(x32, pop).pair
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), old.numpy()) <= 1e-6


def _qpdata(B, P, M, npp, seed):
    """A port QPData with the seeded pair leaves (other leaves random)."""
    leaves, (x, _, _) = _pair_leaves(B, P, M, npp, seed)
    rng = np.random.default_rng(seed + 100)
    D = M * npp
    return asm_t.QPData(
        Qseg=rng.normal(size=(M, npp, npp)), Aeq=rng.normal(size=(4, D)),
        deq=rng.normal(size=(B, 3, 4)), lb=leaves["lb"] - 1.0,
        ub=leaves["lb"] + 1.0, pair_bi=leaves["pair_bi"],
        pair_bj=leaves["pair_bj"], pair_n=leaves["pair_n"],
        pair_rhs=rng.normal(size=(P, D)), pair_mask=leaves["pair_mask"],
        x0=rng.normal(size=(B, 3, D)), agents=np.arange(B, dtype=np.int32),
        pair_qi=leaves["pair_bi"], pair_qj=leaves["pair_bj"],
        pair_rsum=np.full(P, 0.3)), x


@pytest.mark.parametrize("ranks", [2, 3])
def test_rank_slice_pair_rows_match_the_whole(ranks):
    """Each rank's PairOp, built from its slice of the (padded) pair rows
    as nullspace_shard.place slices them, gives the matching rows of the
    whole operator's A x, and padded rows give 0."""
    data, x = _qpdata(*CASES[2])
    P = data.pair_n.shape[0]
    padded = shard_t.pad_pairs(data, ranks)
    Pl = padded.pair_n.shape[0] // ranks
    x = torch.as_tensor(x)
    whole = ns_t._A_x(x, admm_t._pair_op(data.to("cpu"))).pair
    rows = []
    for rank in range(ranks):
        local = dataclasses.replace(padded, **{
            k: np.asarray(getattr(padded, k))[rank * Pl:(rank + 1) * Pl]
            for k in shard_t.PAIR_LEAVES}).to("cpu")
        rows.append(ns_t._A_x(x, admm_t._pair_op(local)).pair)
    rows = torch.cat(rows)
    assert torch.equal(rows[:P], whole)
    assert torch.equal(rows[P:], torch.zeros_like(rows[P:]))


def _tiny(types, n_agents=8, M=3):
    """tests/test_qp.py's straight-line problem in either package's types:
    8 agents stacked in y, whole-world boxes, +y separating planes."""
    param = types.Param(solver="nullspace", solver_dtype="float64",
                        time_scale=False, log=True)
    ys = np.linspace(-0.5, 0.5, n_agents)
    start, goal = np.zeros((n_agents, 9)), np.zeros((n_agents, 9))
    start[:, 0], start[:, 1], start[:, 2] = -1.0, ys, 0.5
    goal[:, 0], goal[:, 1], goal[:, 2] = 1.0, ys, 0.5
    mission = types.Mission(
        start=start, goal=goal, radius=np.full(n_agents, 0.15),
        speed=np.ones(n_agents), max_vel=np.full((n_agents, 3), 1.7),
        max_acc=np.full((n_agents, 3), 6.2), names=["d"] * n_agents)
    L = M + 1
    init = np.stack([np.linspace(start[:, k], goal[:, k], L).T
                     for k in range(3)], axis=-1)
    plan = types.PlanResult(init_traj=init, T=np.arange(L, dtype=float))
    plan.seg_boxes = np.tile(np.array([-5.0, -5.0, 0.0, 5.0, 5.0, 2.5]),
                             (n_agents, M, 1))
    iu, ju = np.triu_indices(n_agents, k=1)
    plan.pair_idx = np.stack([iu, ju], axis=1).astype(np.int32)
    normals = np.zeros((len(iu), M, 3))
    normals[:, :, 1] = 1.0
    plan.pair_normals = normals
    return plan, mission, param


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_export_matches_jax(tmp_path):
    """The port's export of its assembled 8-agent problem (host numpy
    leaves, and the same leaves as tensors) equals the JAX package's
    export of its own assembly: same keys, equal arrays."""
    data_j, _ = joint_j.assemble_joint(*_tiny(types_j))
    data_t, _ = joint_t.assemble_joint(*_tiny(types_t))
    asm_j.export_qp_npz(str(tmp_path / "jax.npz"), data_j)
    asm_t.export_qp_npz(str(tmp_path / "port.npz"), data_t)
    asm_t.export_qp_npz(str(tmp_path / "tensors.npz"), data_t.to("cpu"))
    want = _npz(tmp_path / "jax.npz")
    for name in ("port.npz", "tensors.npz"):
        got = _npz(tmp_path / name)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            assert np.array_equal(got[k], v), k


def test_log_prints_size_and_writes_the_export(tmp_path, monkeypatch,
                                               capsys):
    """solve_trajectories with Param.log, run in an empty working
    directory: it prints the problem-size line (the one solver_info
    carries, as the JAX package's ProblemSize prints it) and writes
    log/qp_joint.npz equal to the JAX package's export of the same
    problem."""
    plan, mission, param = _tiny(types_t)
    monkeypatch.chdir(tmp_path)
    out = joint_t.solve_trajectories(
        plan, mission, param, device="cpu", polish_rounds=0,
        phases=joint_t.production_phases((50, 0, 0)))
    line = out.solver_info["problem_size"]
    assert line == str(ProblemSize.of_batch(8, 3, param.n, param.phi,
                                            len(plan.pair_idx)))
    assert line in capsys.readouterr().out.splitlines()
    data_j, _ = joint_j.assemble_joint(*_tiny(types_j))
    asm_j.export_qp_npz(str(tmp_path / "jax.npz"), data_j)
    got, want = _npz(tmp_path / "log" / "qp_joint.npz"), _npz(
        tmp_path / "jax.npz")
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], v) for k, v in want.items())


def _seeded_samples(seed=0, N=4, M=3, n=5):
    """Seeded piecewise polynomials coef [N, M, n+1, 3] on knot times T
    [M+1] and dense sample times t, as numpy float64."""
    rng = np.random.default_rng(seed)
    coef = rng.normal(size=(N, M, n + 1, 3))
    T = np.cumsum(np.r_[0.0, rng.uniform(0.5, 1.5, M)])
    t = np.linspace(0.0, T[-1], 17)
    return coef, T, t, n


def _entry_call(entry):
    """(function, positional arguments, keyword arguments) of one entry
    point of the port on small inputs; the inputs never get read when the
    device resolution raises first."""
    plan, mission, param = _tiny(types_t)
    coef, T, t, n = _seeded_samples()
    pos = np.zeros((4, 5, 3))
    return {
        "solve_trajectories": (joint_t.solve_trajectories,
                               (plan, mission, param), {}),
        # no control points: the raise comes first
        "gate_quality": (gate_t, (None, plan, mission, param), {}),
        "sample_trajectories": (sample_t.sample_trajectories, (coef, T, t),
                                {"n": n}),
        "safety_margin_ratio": (safety_t.safety_margin_ratio,
                                (pos, np.ones(4)), {"downwash": 2.0}),
        "flight_distance": (safety_t.flight_distance, (pos,), {}),
        "knot_continuity_error": (safety_t.knot_continuity_error,
                                  (coef, T, n, 3), {}),
        "from_numpy": (interop.from_numpy, (None, None), {}),
    }[entry]


ENTRIES = ["solve_trajectories", "gate_quality", "sample_trajectories",
           "safety_margin_ratio", "flight_distance", "knot_continuity_error",
           "from_numpy"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_without_a_card_raise(entry, monkeypatch):
    """device=None means the card: on a host without one,
    joint.solve_trajectories, eval/gate.gate_quality, the eval functions
    it samples and measures with and qp/interop.from_numpy raise the
    resolver's error (which names device='cpu') before they touch an
    input, as pipeline.plan does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, args, kwargs = _entry_call(entry)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(*args, **kwargs)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fn(*args, **kwargs, device="cuda")


@pytest.mark.parametrize("entry", ENTRIES[2:])
def test_eval_and_interop_on_cpu_match_jax(entry):
    """With device="cpu" the eval functions and qp/interop.from_numpy give
    the JAX package's numbers on small seeded inputs: samples of seeded
    polynomials (and their positions' safety ratio and flight distance,
    and the knot continuity error of the polynomials) within 1e-12 of the
    result's scale in float64; the QP data and operator of the 8-agent
    problem carried across bit for bit."""
    coef, T, t, n = _seeded_samples()
    if entry == "from_numpy":
        data_j, _ = joint_j.assemble_joint(*_tiny(types_j))
        data_j = jax.tree.map(np.asarray, data_j)
        op_j = ns_j.prepare_ns_np(data_j, ns_j.NSSettings(kkt_mode="banded",
                                                          n_rungs=2))
        data_t, op_t = interop.from_numpy(data_j, op_j, device="cpu")
        for f in dataclasses.fields(asm_t.QPData):
            want = getattr(data_j, f.name, None)
            got = getattr(data_t, f.name)
            assert (got is None) == (want is None), f.name
            if want is not None:
                assert got.device.type == "cpu"
                assert np.array_equal(got.numpy(), np.asarray(want)), f.name
        assert op_t.Kinvs is None and op_j.Kinvs is None  # banded
        for k in (k for k in ns_t.NSOp._fields if k != "Kinvs"):
            assert getattr(op_t, k).device.type == "cpu"
            assert np.array_equal(getattr(op_t, k).numpy(),
                                  np.asarray(getattr(op_j, k))), k
        return
    states_j = np.array(sample_j.sample_trajectories(
        jnp.asarray(coef), jnp.asarray(T), jnp.asarray(t), n=n))
    if entry == "sample_trajectories":
        got = sample_t.sample_trajectories(coef, T, t, n=n, device="cpu")
        assert got.device.type == "cpu"
        got, want = got.numpy(), states_j
    elif entry == "knot_continuity_error":
        got = safety_t.knot_continuity_error(coef, T, n, 3, device="cpu")
        want = safety_j.knot_continuity_error(coef, T, n, 3)
    else:
        pos = states_j[:, :, 0]
        if entry == "flight_distance":
            got = safety_t.flight_distance(pos, device="cpu")
            want = float(safety_j.flight_distance(jnp.asarray(pos)))
        else:
            radius = np.full(pos.shape[0], 0.2)
            got = safety_t.safety_margin_ratio(pos, radius, downwash=2.0,
                                               device="cpu")
            want = float(safety_j.safety_margin_ratio(
                jnp.asarray(pos), jnp.asarray(radius), downwash=2.0))
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_gate_quality_on_cpu_matches_jax(tmp_path, monkeypatch):
    """gate_quality with device='cpu' on the 8-agent problem solved at 50
    iterations on the CPU: the same verdict and metrics (1e-6) as the JAX
    package's bench.gate_quality on the same control points."""
    import bench

    plan, mission, param = _tiny(types_t)
    monkeypatch.chdir(tmp_path)
    out = joint_t.solve_trajectories(
        plan, mission, param, device="cpu", polish_rounds=0,
        phases=joint_t.production_phases((50, 0, 0)))
    ok_t, m_t = gate_t(out.ctrl, out, mission, param, device="cpu")
    plan_j, mission_j, param_j = _tiny(types_j)
    ok_j, m_j = bench.gate_quality(out.ctrl, plan_j, mission_j, param_j)
    assert ok_t == ok_j
    assert m_t.keys() == m_j.keys()
    for k in m_j:
        assert np.isfinite(float(m_t[k])), k
        assert abs(float(m_t[k]) - float(m_j[k])) <= 1e-6, k
