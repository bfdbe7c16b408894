"""PyTorch port, the sequential-batch sweeps: the same 8-agent forest
and batch QPs as tests/test_torch_seqbatch.py (its fixture) through the
JAX package (x64 on the CPU) and the port (float64, ``device="cpu"``):
- ``parallel/mesh.gauss_seidel_sweep``, two rounds over three batches,
  the last padded to the others' agent count (its padded agent's
  write-back dropped): the dummy within 1e-6, the last round's iters;
- ``parallel/seqbatch.solve_trajectories`` in every branch (device
  Gauss-Seidel, Jacobi, the host loop of single solves, init-only): the
  same mode, solved agents and iters, ctrl and coef within 1e-6, each
  solve's info within 1e-6 relative (residuals of the solver's eps_abs
  where they sit near the rounding of their terms);
- the path's entry points raise without a card when no device is given.
"""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

import swarm_simulator_tpu as sj  # noqa: E402
import swarm_simulator_tpu_torch as st  # noqa: E402
from test_torch_seqbatch import (  # noqa: E402,F401
    _close, _jax, _rel, _settings, forest, one_thread)


def test_gauss_seidel_sweep_matches_jax(forest):
    """Two rounds of the device sweep over the forest's two batches (a
    third, short batch of 2 padded to 4 agents, so the padded agents'
    write-back is dropped): the same dummy within 1e-6, the last round's
    iters."""
    jax = _jax()
    from swarm_simulator_tpu.parallel import mesh as mesh_j
    from swarm_simulator_tpu.parallel.seqbatch import _stack_qpdata as stk_j
    from swarm_simulator_tpu.qp import assemble as asm_j
    from swarm_simulator_tpu_torch.parallel import mesh as mesh_t
    from swarm_simulator_tpu_torch.parallel.seqbatch import \
        _stack_qpdata as stk_t
    from swarm_simulator_tpu_torch.qp import assemble as asm_t

    f = forest
    batches = [np.arange(3), np.arange(3, 6), np.arange(6, 8)]
    pad = max(int(np.isin(f["plan"].pair_idx, b).any(axis=1).sum())
              for b in batches)
    dj = stk_j([asm_j.assemble_batch(f["plan"], f["mission"], f["param"], b,
                                     f["dummy"], pad, device=False)
                for b in batches])
    dt = stk_t([asm_t.assemble_batch(f["plan"], f["mission"], f["param_t"],
                                     b, f["dummy"], pad) for b in batches])
    assert dt.agents[-1].tolist() == [6, 7, 2**30]
    s_j, s_t = _settings("dense", False)
    outj, ij = mesh_j.gauss_seidel_sweep(
        jax.tree.map(jax.numpy.asarray, dj), jax.numpy.asarray(f["dummy"]),
        s_j, rounds=2)
    outt, it = mesh_t.gauss_seidel_sweep(
        dt.to("cpu"), torch.as_tensor(f["dummy"]), s_t, rounds=2)
    assert it.iters.tolist() == np.asarray(ij.iters).tolist()
    assert _close(outt, outj)


BRANCHES = {
    "gauss-seidel-device": dict(sequential=True, batch_size=4,
                                batch_iter=-1),
    "jacobi": dict(sequential=True, batch_size=4, batch_iter=-1,
                   parallel_mode="jacobi", iteration=2),
    # a single batch in Jacobi mode runs the host loop of solve_qp calls
    "host": dict(sequential=True, batch_size=4, batch_iter=1,
                 parallel_mode="jacobi"),
    "init-only": dict(sequential=True, batch_size=4, batch_iter=0),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_solve_trajectories_matches_jax(forest, branch):
    """seqbatch.solve_trajectories in each branch: the same mode, solved
    agents and iters, ctrl and coef within 1e-6, the per-solve info within
    1e-6 relative."""
    from swarm_simulator_tpu.parallel import seqbatch as sb_j
    from swarm_simulator_tpu_torch.parallel import seqbatch as sb_t

    kw = dict(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
              solver_dtype="float64", **BRANCHES[branch])
    s_j, s_t = _settings("dense", False)
    rj = sb_j.solve_trajectories(copy.deepcopy(forest["plan"]),
                                 forest["mission"], sj.Param(**kw), s_j)
    rt = sb_t.solve_trajectories(copy.deepcopy(forest["plan"]),
                                 forest["mission"], st.Param(**kw), s_t,
                                 device="cpu")
    ij, it = rj.solver_info, rt.solver_info
    assert it["mode"] == ij["mode"] == (
        "host" == branch and "jacobi" or branch)
    assert it["device"] == "cpu"
    assert it["iters"] == ij["iters"]
    assert set(ij) <= set(it)
    if "solved" in ij:
        assert np.array_equal(it["solved"], ij["solved"])
        assert it["problem_size"] == ij["problem_size"]
    # a residual is held to 1e-6 of itself or, where it sits near the
    # rounding of its terms, of the solver's absolute tolerance eps_abs
    for k, floor in (("r_prim", s_t.eps_abs), ("r_dual", s_t.eps_abs),
                     ("obj", 1e-300)):
        for g, w in zip(it.get(k, []), ij.get(k, [])):
            assert _rel(g, w, floor), k
    assert _close(rt.ctrl, rj.ctrl)
    assert _close(rt.coef, rj.coef)


ENTRIES = ["plan", "solve_trajectories", "solve_qp", "solve_qp_batched"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_without_a_card_raise(forest, entry, monkeypatch):
    """device=None means the card: without one, the path's entry points
    raise the resolver's error (which names device='cpu')."""
    from swarm_simulator_tpu_torch.parallel import seqbatch as sb_t
    from swarm_simulator_tpu_torch.parallel.seqbatch import \
        _stack_qpdata as stk_t
    from swarm_simulator_tpu_torch.qp import admm as admm_t

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, args = {
        "plan": (st.plan, (forest["mission"], forest["param_t"])),
        "solve_trajectories": (sb_t.solve_trajectories, (
            copy.deepcopy(forest["plan"]), forest["mission"],
            forest["param_t"])),
        "solve_qp": (admm_t.solve_qp, (forest["dt"][0],)),
        "solve_qp_batched": (admm_t.solve_qp_batched,
                             (stk_t(forest["dt"]),)),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(*args)
