"""PyTorch port, the dense KKT inverse of the batch ADMM (qp/admm.
build_kkt_operator's dense branch), built from the KKT's block-tridiagonal
structure without forming K, on the CPU in float64:

- against a plain dense reference written here (K formed whole as
  [nx, nx], torch.linalg.cholesky, cholesky_solve against I) within 1e-11
  relative, and K @ Kinv within 1e-10 of I: on the two 4-agent batch QPs
  of tests/test_torch_seqbatch.py's forest (M 34), on synthetic problems
  of 1-3 segments with 1 or 4 agents (one-sided pairs, a padded agent, an
  all-masked pair block) and on tools/profile_solve's swap-shaped stack;
- the route's precondition: assemble.build_aeq ties only adjacent
  segments;
- a problem's inverse is the same bits alone and in a stack of 3 (pair
  rows padded alike), through _prepare_stack;
- ``kkt.dense_inverses`` counts the stack's problems and ``kkt.not_pd``
  those of which a block's Cholesky failed; ``profile_solve --kkt``
  exits 2 without a card.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_seqbatch import forest, one_thread  # noqa: E402,F401

from swarm_simulator_tpu_torch.core import bernstein  # noqa: E402
from swarm_simulator_tpu_torch.parallel.seqbatch import \
    _stack_qpdata  # noqa: E402
from swarm_simulator_tpu_torch.qp import admm  # noqa: E402
from swarm_simulator_tpu_torch.qp import assemble as asm  # noqa: E402
from swarm_simulator_tpu_torch.tools import profile_solve  # noqa: E402
from swarm_simulator_tpu_torch.utils import timing  # noqa: E402

SETTINGS = admm.ADMMSettings(kkt_solver="dense")


def _dense_k(data: asm.QPData, s: admm.ADMMSettings) -> torch.Tensor:
    """K = P + sigma I + A^T diag(rho) A of one scaled problem, formed
    whole as [nx, nx] in float64 (rows and columns (agent * 3 + axis) *
    D + d): the same base block on every (agent, axis), plus each control
    point's pair rows between the agents."""
    f64 = admm._tree_map(
        lambda a: a.double() if a.is_floating_point() else a, data)
    M, npp, _ = f64.Qseg.shape
    D = M * npp
    B3 = 3 * f64.lb.shape[0]
    base = torch.block_diag(*f64.Qseg) + (s.sigma + s.rho) * torch.eye(
        D, dtype=torch.float64)
    base += s.rho * s.rho_eq_scale * f64.Aeq.T @ f64.Aeq
    K = torch.zeros(B3, D, B3, D, dtype=torch.float64)
    for a in range(B3):
        K[a, :, a, :] = base
    pop = admm._pair_op(f64)
    # a pair row's entries at control point d: S[p, b] n_d[p, k, d]
    w = torch.einsum("pb,pkd->pbkd", pop.S, pop.n_d).reshape(-1, B3, D)
    coupling = s.rho * torch.einsum("pad,pcd->dac", w, w)
    for d in range(D):
        K[:, d, :, d] += coupling[d]
    return K.reshape(B3 * D, B3 * D)


def _reference_inverse(K: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(K.shape[0], dtype=K.dtype)
    return torch.cholesky_solve(eye, torch.linalg.cholesky(K))


def _check_against_dense(data: asm.QPData) -> None:
    """The route's inverse of ``data`` (a stack) against the dense
    reference, problem by problem, on the equilibrated problems."""
    sdata, _, op = admm._prepare_stack(data, SETTINGS, kkt_chunk=1)
    assert op.Kinv.dtype == admm.KINV_DTYPE
    for l in range(data.lb.shape[0]):
        K = _dense_k(admm._tree_map(lambda a: a[l], sdata), SETTINGS)
        want = _reference_inverse(K)
        got = op.Kinv[l]
        err = (got - want).abs().max() / want.abs().max()
        assert err <= 1e-11, float(err)
        resid = (K @ got - torch.eye(K.shape[0], dtype=K.dtype)).abs().max()
        assert resid <= 1e-10, float(resid)


def _synthetic(M: int, B: int, variant: str, seed: int) -> asm.QPData:
    """A batch QP of ``B`` agents over ``M`` segments (n 5, phi 3, random
    durations, boxes and plane normals) with 6 pair rows: one-sided
    against agents outside the batch (``one_sided``; two-sided too where
    B > 1, ``pairs``), the same with the last agent a padded one that no
    pair row touches (``padded``), or every pair row masked
    (``masked``)."""
    rng = np.random.default_rng(seed)
    n, phi, P = 5, 3, 6
    npp = n + 1
    D = M * npp
    T = np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 1.5, M))])
    dt = np.diff(T)
    Qseg = (bernstein.derivative_cost_matrix(n, phi)[None]
            * (dt ** (1 - 2 * phi))[:, None, None])
    Aeq = asm.build_aeq(T, n, phi)
    Re = Aeq.shape[0]
    ours = B - 1 if variant == "padded" else B
    bi = np.full(P, -1, np.int32)
    bj = np.full(P, -1, np.int32)
    for p in range(P):
        side = rng.integers(3) if ours > 1 else rng.integers(2)
        if side == 0:          # the i side fixed
            bj[p] = rng.integers(ours)
        elif side == 1:        # the j side fixed
            bi[p] = rng.integers(ours)
        else:                  # both in the batch
            bi[p], bj[p] = rng.choice(ours, 2, replace=False)
    normals = rng.standard_normal((P, M, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    mask = np.zeros(P) if variant == "masked" else np.ones(P)
    lo = rng.uniform(-3.0, -1.0, (B, 3, D))
    agents = np.arange(B, dtype=np.int32)
    if variant == "padded":
        agents[-1] = 8        # past the last agent of the swarm
    return asm.QPData(
        Qseg=Qseg, Aeq=Aeq, deq=rng.standard_normal((B, 3, Re)), lb=lo,
        ub=lo + rng.uniform(2.0, 4.0, (B, 3, D)), pair_bi=bi, pair_bj=bj,
        pair_n=normals,
        pair_rhs=np.where(mask[:, None] > 0,
                          rng.uniform(0.2, 0.4, (P, D)), -asm.BIG),
        pair_mask=mask, x0=rng.standard_normal((B, 3, D)), agents=agents,
        pair_qi=np.maximum(bi, 0), pair_qj=np.maximum(bj, 0),
        pair_rsum=np.full(P, 0.3), dt=dt)


@pytest.mark.parametrize("batch", [0, 1])
def test_forest_batch_inverse_matches_dense_cholesky(forest, batch):
    _check_against_dense(_stack_qpdata([forest["dt"][batch]]).to("cpu"))


@pytest.mark.parametrize("M, B, variant", [
    (1, 1, "one_sided"), (1, 4, "pairs"), (1, 4, "masked"),
    (2, 1, "one_sided"), (2, 1, "masked"), (2, 4, "padded"),
    (3, 1, "one_sided"), (3, 4, "pairs"), (3, 4, "padded"),
    (3, 4, "masked")])
def test_synthetic_inverse_matches_dense_cholesky(M, B, variant):
    datas = [_synthetic(M, B, variant, seed) for seed in (M * 10 + B, 7)]
    _check_against_dense(_stack_qpdata(datas).to("cpu"))


def test_swap_shaped_stack_inverse_matches_dense_cholesky():
    """tools/profile_solve's swap-shaped stack (its ``--kkt`` input) at a
    small size."""
    _check_against_dense(profile_solve.kkt_stack(3, 4, 4, seed=11,
                                                 device="cpu"))


@pytest.mark.parametrize("M, n, phi", [(1, 5, 3), (2, 5, 3), (7, 5, 3),
                                       (5, 7, 4), (4, 3, 2)])
def test_build_aeq_ties_only_adjacent_segments(M, n, phi):
    """Every equality row of build_aeq touches the columns of one segment
    or of two adjacent ones, so A^T A (and K) has no block beyond the
    first off-diagonal: the dense route's precondition."""
    rng = np.random.default_rng(M + n + phi)
    T = np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 1.5, M))])
    Aeq = asm.build_aeq(T, n, phi)
    seg = np.arange(M * (n + 1)) // (n + 1)
    for row in Aeq:
        touched = seg[row != 0]
        assert touched.size and touched.max() - touched.min() <= 1
    ata = (np.abs(Aeq.T) @ np.abs(Aeq)) != 0
    assert not (ata & (np.abs(seg[:, None] - seg[None, :]) > 1)).any()


@pytest.mark.parametrize("kkt_chunk", [1, 4, None])
def test_inverse_alone_equals_inverse_in_stack(forest, kkt_chunk):
    """Each problem's inverse (and its scaled problem) is the same bits
    alone and in a stack of 3 of one shape: the forest's two batches and
    the second with half of its pair rows masked, all padded to one pair
    count."""
    second = forest["dt"][1]
    P = int(second.pair_mask.sum())
    keep = (np.arange(second.pair_mask.shape[0]) < P // 2).astype(
        second.pair_mask.dtype)
    third = dataclasses.replace(
        second, pair_mask=second.pair_mask * keep,
        pair_rhs=np.where(keep[:, None] > 0, second.pair_rhs, -asm.BIG))
    datas = [forest["dt"][0], second, third]
    stacked = _stack_qpdata(datas).to("cpu")
    chunk = kkt_chunk or 1
    sdata, _, op = admm._prepare_stack(stacked, SETTINGS, chunk)
    for l, d in enumerate(datas):
        s1, _, op1 = admm._prepare_stack(_stack_qpdata([d]).to("cpu"),
                                         SETTINGS, chunk)
        assert torch.equal(op.Kinv[l], op1.Kinv[0])
        assert torch.equal(sdata.Aeq[l], s1.Aeq[0])
    assert not torch.equal(op.Kinv[1], op.Kinv[2])
    if kkt_chunk is None:
        # solve_qp's route: one problem, no leading axis
        one = admm.build_kkt_operator(admm._tree_map(lambda a: a[0], sdata),
                                      SETTINGS)
        assert torch.equal(one.Kinv, op.Kinv[0])


@pytest.mark.parametrize("rho, not_pd", [(0.1, 0), (-1.0, 3)])
def test_counters(forest, rho, not_pd):
    """kkt.dense_inverses counts the stack's problems; kkt.not_pd those of
    which a block's Cholesky failed (all three where rho < 0 makes K
    negative definite); nothing is counted without a recording."""
    stacked = _stack_qpdata([forest["dt"][0], forest["dt"][1],
                             forest["dt"][0]]).to("cpu")
    s = dataclasses.replace(SETTINGS, rho=rho)
    with timing.recording() as rec:
        admm._prepare_stack(stacked, s, 4)
    assert rec.counters == {"kkt.dense_inverses": 3, "kkt.not_pd": not_pd}
    assert not timing.active()


def test_profile_kkt_without_a_card_exits_2(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["profile_solve", "--kkt"])
    assert profile_solve.main() == 2
