"""PyTorch port, the cross-device joint solve (qp/nullspace_shard) and its
chunked Thomas sweeps (ops/thomas, kernels K3a/K3b).

The K3 twins are held against the JAX package's Pallas chunk kernels in
interpret mode (float32, the 2e-5 tolerance tests/test_pallas.py holds
those kernels to), and chained over 1, 2 and 4 chunks against the full
Thomas twin (float64, 1e-12).  The sharded solve runs on gloo ranks on the
CPU, spawned through parallel/distributed.run_ranks (one rank runs in the
test process), and is held against the JAX package's sharded solve on the
conftest's virtual CPU devices in float64: the same iterations and x
within 1e-10 of its scale (the collectives re-associate sums, so the two
agree to round-off, not bitwise; the rho rung is pinned so that a
round-off tie cannot move one path's rung).  Cases that share a rank
count run in one spawn.  The CUDA kernels themselves are compared with
the twins in tests/test_torch_cuda.py, which needs a card.
"""
import ast
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
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from test_nullspace import _data as _data_j  # noqa: E402

from chip_smoke import chunked_solve  # noqa: E402

from swarm_simulator_tpu.ops import pallas_thomas  # noqa: E402
from swarm_simulator_tpu.qp import nullspace as ns_j  # noqa: E402
from swarm_simulator_tpu.qp import nullspace_shard as sh_j  # noqa: E402
import swarm_simulator_tpu_torch as st  # noqa: E402
from swarm_simulator_tpu_torch import pipeline  # noqa: E402
from swarm_simulator_tpu_torch.ops import thomas  # noqa: E402
from swarm_simulator_tpu_torch.parallel import distributed as pd  # noqa: E402
from swarm_simulator_tpu_torch.qp import assemble as asm_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import interop  # noqa: E402
from swarm_simulator_tpu_torch.qp import nullspace as ns_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import nullspace_shard as sh_t  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "swarm_simulator_tpu_torch"
PHI = 3


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _numpy(data):
    return jax.tree.map(np.asarray, data)


# ---------------------------------------------------------------------------
# 1. the K3 twins against the Pallas chunk kernels (interpret mode, f32)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uniform_f32():
    """The uniform-dt 3-agent M = 5 operator (Mi = 4) of
    tests/test_torch_thomas.py in float32, with seeded right-hand sides
    and carries."""
    data, _ = _data_j(n_agents=3, M=5)
    op = ns_j.prepare_ns_np(_numpy(data),
                            ns_j.NSSettings(kkt_mode="banded", n_rungs=3))
    dinv = np.asarray(op.Dinvs, np.float32)
    ho = np.asarray(op.Kos, np.float32)
    assert np.allclose(ho, ho[0], atol=1e-6), "uniform dt -> constant Ho"
    rng = np.random.default_rng(0)
    bs = dinv.shape[-1]
    vecs = rng.standard_normal((2, 3, bs)).astype(np.float32)
    carry = rng.standard_normal((2, bs)).astype(np.float32)
    return dinv, ho, vecs, carry


def _lane_pad(a, bsp):
    """Zero-pad the trailing block dims of ``a`` to bsp lanes (the JAX
    chunk kernels take lane-padded operands)."""
    out = np.zeros(a.shape[:-1] + (bsp,), a.dtype)
    out[..., :a.shape[-1]] = a
    return out


@pytest.mark.parametrize("rho_idx", [0, 1, 2])
@pytest.mark.parametrize("sweep", ["fwd", "bwd"])
def test_chunk_twins_match_pallas_interpret(uniform_f32, sweep, rho_idx):
    """One 3-knot chunk whose couplings are all real (fwd: knots 1-3 with
    a carry from knot 0; bwd: knots 0-2 with a carry from knot 3), so the
    TPU kernels' hoisted uniform I (x) Ho equals the port's per-knot
    kin/kout."""
    dinv, ho, vecs, carry = uniform_f32
    R, Mi, bs, _ = dinv.shape
    bsp = 128
    knots = slice(1, 4) if sweep == "fwd" else slice(0, 3)
    slab = np.ascontiguousarray(dinv[:, knots])
    # fwd: kin of knots 1-3 is Kos[0..2]; bwd: kout of knots 0-2 likewise
    coupling = ho
    v, c = vecs[0 if sweep == "fwd" else 1], carry[0 if sweep == "fwd" else 1]
    koM = np.zeros((bsp, bsp), np.float32)
    koM[:bs, :bs] = np.kron(np.eye(bs // PHI), ho[0])
    args_j = (jnp.asarray(pallas_thomas.pad_pivots(slab)), jnp.asarray(koM),
              jnp.asarray(_lane_pad(v, bsp)), jnp.asarray(_lane_pad(c, bsp)),
              jnp.int32(rho_idx))
    args_t = (torch.tensor(slab), torch.tensor(coupling), torch.tensor(v),
              torch.tensor(c), rho_idx)
    if sweep == "fwd":
        want = pallas_thomas.thomas_chunk_fwd(*args_j, interpret=True)
        got = thomas.thomas_chunk_fwd_reference(*args_t)
    else:
        want = pallas_thomas.thomas_chunk_bwd(*args_j, interpret=True)
        got = thomas.thomas_chunk_bwd_reference(*args_t)
    want = np.asarray(want)[:, :bs]
    assert got.dtype == torch.float32 and got.shape == (3, bs)
    assert np.abs(got.numpy() - want).max() < 2e-5 * max(np.abs(want).max(),
                                                          1.0)


# ---------------------------------------------------------------------------
# 2. chained chunks == the full Thomas solve (float64, non-uniform dt)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nonuniform_f64():
    data, _ = _data_j(n_agents=3, M=8, nonuniform=True)       # Mi = 7
    op = ns_j.prepare_ns_np(_numpy(data), ns_j.NSSettings(kkt_mode="banded",
                                                          n_rungs=3))
    assert not np.allclose(np.asarray(op.Kos), np.asarray(op.Kos)[:1])
    return op


@pytest.mark.parametrize("n", [1, 2, 4])
def test_chained_chunks_equal_full_solve(nonuniform_f64, n):
    """The chain split into n chunks (Mi = 7 pads to 8 for n = 2 and 4),
    the carries handed from chunk to chunk as the ranks hand them, equals
    thomas_solve_reference on the whole chain for every rung; the pad
    knots come out exactly 0."""
    op = nonuniform_f64
    dinv = torch.tensor(np.asarray(op.Dinvs))
    kos = torch.tensor(np.asarray(op.Kos))
    R, Mi, bs, _ = dinv.shape
    b = torch.tensor(np.random.default_rng(1).standard_normal((Mi, bs)))
    for r in range(R):
        x = chunked_solve(dinv, kos, b, r, n)
        assert x.shape == (-(-Mi // n) * n, bs)
        want = thomas.thomas_solve_reference(dinv, kos, b, r)
        assert _rel(x[:Mi], want) < 1e-12
        assert torch.count_nonzero(x[Mi:]) == 0


# ---------------------------------------------------------------------------
# 3-7. the sharded solve on gloo ranks against the JAX sharded solve
# ---------------------------------------------------------------------------

def _phases_j(max_iters=(100, 100), **kw):
    # as tests/test_shard.py: zero tolerances force the full budgets and
    # adapt_threshold=1e9 pins the rung
    kw.setdefault("check_every", 50)
    base = ns_j.NSSettings(kkt_mode="banded", eps_abs=0.0, eps_rel=0.0,
                           eps_dual_abs=0.0, rho_min=1e-4, rho_max=1e-1,
                           n_rungs=4, adapt_threshold=1e9, **kw)
    return tuple(dataclasses.replace(base, max_iter=mi) for mi in max_iters)


def _port_phases(phases):
    return tuple(ns_t.NSSettings(**{f.name: getattr(p, f.name)
                                    for f in dataclasses.fields(ns_t.NSSettings)})
                 for p in phases)


def _port_data(data):
    """The port's QPData with host numpy leaves (what spawned ranks get)."""
    return asm_t.QPData(**{
        f.name: None if getattr(data, f.name) is None
        else np.asarray(getattr(data, f.name))
        for f in dataclasses.fields(asm_t.QPData)})


def _port_op(op):
    return ns_t.NSOp(**{k: None if getattr(op, k) is None
                        else np.asarray(getattr(op, k))
                        for k in ns_t.NSOp._fields})


_PROBLEMS = {}


def _problem(name):
    """(JAX data, JAX phases, JAX op, mode, mesh size) of a named case,
    built once per module."""
    if name not in _PROBLEMS:
        kind, _, arg = name.partition(":")
        if kind == "spike":
            M, n = (int(v) for v in arg.split("x"))
            data = _numpy(_data_j(n_agents=8, M=M)[0])
            phases = _phases_j()
            op = sh_j.prepare_spike_np(data, phases[0], n)
            _PROBLEMS[name] = (data, phases, op, "spike", n)
        else:
            data = _numpy(_data_j(n_agents=8, M=8,
                                  nonuniform=(arg == "nonuniform"))[0])
            phases = (tuple(dataclasses.replace(p, kkt_refine=1)
                            for p in _phases_j((50,)))
                      if kind == "refine" else _phases_j())
            op = ns_j.prepare_ns_np(data, phases[0])
            mode = "blockrow" if kind == "blockrow" else "chunk"
            _PROBLEMS[name] = (data, phases, op, mode, 4)
    return _PROBLEMS[name]


def _port_case(name):
    data, phases, op, mode, _ = _problem(name)
    if mode == "spike":
        # the JAX SpikeOp carried across, as numpy for the spawned ranks
        _, sop = interop.from_numpy(data, op, device="cpu")
        op_t = sh_t.SpikeOp(
            ns_t.NSOp(*(None if v is None else v.numpy() for v in sop.base)),
            *(v.numpy() for v in sop[1:]))
    else:
        op_t = _port_op(op)
    return (_port_data(data), _port_phases(phases), op_t, mode)


#: the port's cases per rank count, each run in one spawn of that many ranks
RANK_CASES = {
    1: ["chunk:uniform", "chunk:nonuniform"],
    2: ["chunk:uniform", "chunk:nonuniform"],
    3: ["chunk:uniform", "spike:8x3"],
    4: ["chunk:uniform", "chunk:nonuniform", "refine:uniform",
        "blockrow:uniform", "spike:16x4"],
}
_PORT_RUNS = {}
_JAX_RUNS = {}


def _port(n, name):
    if n not in _PORT_RUNS:
        cases = [_port_case(c) for c in RANK_CASES[n]]
        _PORT_RUNS[n] = dict(zip(RANK_CASES[n], pd.run_ranks(
            sh_t.rank_solve_many, n, cases, backend="gloo")))
    return _PORT_RUNS[n][name]


def _jax(name):
    if name not in _JAX_RUNS:
        data, phases, op, mode, nmesh = _problem(name)
        mesh = Mesh(np.array(jax.devices()[:nmesh]), ("kkt",))
        x, info = sh_j.solve_ns_phases_sharded(data, phases, op, mesh,
                                               mode=mode)
        _JAX_RUNS[name] = (np.asarray(x, np.float64), int(info.iters))
    return _JAX_RUNS[name]


def _assert_matches_jax(n, name):
    x, iters, r_prim, obj, _ = _port(n, name)
    xj, itj = _jax(name)
    assert np.isfinite(x).all() and x.shape == xj.shape
    assert iters == itj
    assert _rel(x, xj) < 1e-10, (n, name, _rel(x, xj))


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dt", ["uniform", "nonuniform"])
def test_chunk_mode_matches_jax(n, dt):
    """8 agents, M = 8 (Mi = 7: n = 2 and 4 pad one knot), float64: the
    port over n gloo ranks against JAX over a 4-device mesh."""
    _assert_matches_jax(n, f"chunk:{dt}")


def test_chunk_kkt_refine_matches_jax():
    """kkt_refine = 1 (a PCG step against the fresh operator on every
    w-update, its A^T A riding the sharded psum) over 4 ranks."""
    _assert_matches_jax(4, "refine:uniform")


def test_pair_padding_never_binds():
    """P = 28 pairs over 3 ranks pads to 30 inactive-tailed rows; the
    solution equals the unpadded 4-device JAX solve."""
    data = _problem("chunk:uniform")[0]
    padded = sh_t.pad_pairs(_port_data(data), 3)
    assert np.asarray(data.pair_n).shape[0] == 28
    assert padded.pair_n.shape[0] == 30
    assert np.all(padded.pair_mask[28:] == 0)
    assert np.all(padded.pair_rhs[28:] <= -1e7)
    _assert_matches_jax(3, "chunk:uniform")


def test_blockrow_matches_jax():
    """bs = 72 rows split 18 per rank over 4 ranks."""
    _assert_matches_jax(4, "blockrow:uniform")


@pytest.mark.parametrize("case", ["16x4", "8x3"])
def test_spike_prep_matches_jax(case):
    data, phases, op_j, _, n = _problem(f"spike:{case}")
    op_t = sh_t.prepare_spike_np(_port_data(data), _port_phases(phases)[0], n)
    for k in ("Dloc", "Ssch", "Soff"):
        a, b = getattr(op_t, k), np.asarray(getattr(op_j, k))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1.0), k
    for k in ("N", "x_pin", "g", "Kos", "ladder"):
        assert _rel(getattr(op_t.base, k), getattr(op_j.base, k)) < 1e-12


@pytest.mark.parametrize("n, case", [(4, "16x4"), (3, "8x3")])
def test_spike_matches_jax(n, case):
    """(M, n) = (16, 4): Mi = 15 partitions exactly (Lq = 3); (8, 3):
    Mi = 7 with one pad knot (Lq = 2)."""
    _assert_matches_jax(n, f"spike:{case}")


# ---------------------------------------------------------------------------
# 8-9. guards and failing ranks
# ---------------------------------------------------------------------------

def _small():
    data, phases, op, _, _ = _problem("chunk:uniform")
    return _port_data(data), _port_phases(phases), _port_op(op)


def test_guard_unknown_mode():
    data, phases, op = _small()
    with pytest.raises(ValueError, match="unknown shard mode"):
        pd.run_ranks(sh_t.rank_solve, 1, data, phases, op, "diagonal",
                     backend="gloo")


def test_guard_spike_prepared_for_other_rank_count():
    args = _port_case("spike:8x3")
    with pytest.raises(ValueError, match="prepared for 3 chunks"):
        pd.run_ranks(sh_t.rank_solve, 1, *args, backend="gloo")


def test_guard_spike_rejects_kkt_refine():
    data, phases, op, mode = _port_case("spike:8x3")
    refine = tuple(dataclasses.replace(p, kkt_refine=1) for p in phases)
    with pytest.raises(ValueError, match="kkt_refine"):
        pd.run_ranks(sh_t.rank_solve, 1, data, refine, op, mode,
                     backend="gloo")


def test_guard_spike_needs_two_knots_per_rank():
    data = _port_data(_numpy(_data_j(n_agents=4, M=5)[0]))     # Mi = 4
    with pytest.raises(ValueError, match="Mi >= 2n"):
        sh_t.prepare_spike_np(data, _port_phases(_phases_j((50,)))[0], 4)


def test_run_ranks_names_its_backend():
    """run_ranks has no default backend (no entry point drifts onto the
    CPU), and ``nccl`` without a card raises instead of falling back to
    gloo."""
    data, phases, op = _small()
    with pytest.raises(TypeError, match="backend"):
        pd.run_ranks(sh_t.rank_solve, 1, data, phases, op, "chunk")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            pd.run_ranks(sh_t.rank_solve, 1, data, phases, op, "chunk",
                         backend="nccl")


def test_failing_ranks_make_run_ranks_raise():
    """blockrow with bs = 27 over 2 ranks: every spawned rank raises its
    ValueError, and run_ranks raises with the rank's message instead of
    returning."""
    data = _numpy(_data_j(n_agents=3, M=5)[0])
    phases = _phases_j((50,))
    op = ns_j.prepare_ns_np(data, phases[0])
    with pytest.raises(Exception, match="must divide over 2 ranks"):
        pd.run_ranks(sh_t.rank_solve, 2, _port_data(data),
                     _port_phases(phases), _port_op(op), "blockrow",
                     backend="gloo")


# ---------------------------------------------------------------------------
# 10. the repairs: the port's own native source, the card by default
# ---------------------------------------------------------------------------

def test_native_source_is_a_byte_equal_copy():
    from swarm_simulator_tpu_torch.search import native_binding

    ours = PORT / "csrc" / "swarm_native.cpp"
    assert native_binding._SRC == ours.resolve()
    assert ours.read_bytes() == (REPO / "swarm_simulator_tpu" / "search"
                                 / "native" / "swarm_native.cpp").read_bytes()


def test_port_names_no_path_into_the_jax_package():
    """No module of the port imports the JAX package or builds a path
    into it: no import of it, and no string other than a docstring that
    names its directory."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif (isinstance(node, ast.Constant)
                  and isinstance(node.value, str) and id(node) not in docs):
                names = [node.value] if "swarm_simulator_tpu" in node.value \
                    else []
            else:
                continue
            for name in names:
                if name.split(".")[0].split("/")[0] in (
                        "jax", "swarm_simulator_tpu"):
                    found.append(f"{path.relative_to(REPO)}: {name}")
    assert not found, found


def test_plan_without_a_card_raises_not_cpu():
    """device=None means the card: without one, plan() raises before any
    work instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    assert pipeline.default_device() == torch.device("cuda")
    from swarm_simulator_tpu_torch.io.mission_json import \
        perimeter_swap_mission

    mission = perimeter_swap_mission(4, half=4.0, z=1.0, radius=0.15)
    param = st.Param(solver="nullspace")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        st.plan(mission, param)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        st.plan(mission, param, device="cuda")
