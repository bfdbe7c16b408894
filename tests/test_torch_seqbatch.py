"""PyTorch port, the sequential-batch ADMM path (``Param.solver="admm"``).

The same inputs go through the JAX package (x64 on the CPU) and the port
(float64, ``device="cpu"``):
- one 4-agent batch QP of the in-repo 8-agent forest, assembled by both
  packages (bit-equal, pair rows padded) and refreshed from a dummy on
  the device (bit-equal);
- its Ruiz equilibration (1e-12 relative);
- ``solve_qp`` in dense and cg KKT mode with adaptive rho off and on: the
  same iteration count, x within 1e-6, r_prim / r_dual / obj within 1e-6
  relative (a dual tolerance of 0.5 stops each solve before max_iter);
- ``solve_qp_batched`` on a stack of the forest's two batches, which stop
  at different counts: each problem's count and x as JAX's, and as its own
  solve alone (a stopped problem keeps its state);
- ``make_batches`` and the KKT mode ``solver_kkt="auto"`` picks.
The sweeps are tests/test_torch_seqbatch_sweep.py's, the plans
tests/test_torch_seqbatch_plan.py's.

Run as a script (``PYTHONPATH=. python tests/test_torch_seqbatch.py
[--package jax|port] [--dtype float32|float64] [--out DIR] [RUN ...]``),
the file plans the canonical 64-agent forest on the CPU through one
package (the JAX package with x64 on for float64 only, as its CLI) in the
three modes that chip_smoke.py's phase 18 runs on the card (Gauss-Seidel
batches of 4, Jacobi with two rounds, and ``Param()``'s one joint batch),
and prints each run's seconds, per-batch solver info and evaluate()
metrics as JSON (forest64_plans); ``--compare DIR`` prints each saved
float32 plan's largest control-point distance to the same package's
float64 plan.
"""
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

# the repository root when run as a script
sys.path.insert(0, str(Path(__file__).parents[1]))

import swarm_simulator_tpu as sj  # noqa: E402
import swarm_simulator_tpu_torch as st  # noqa: E402

#: the 64-agent forest's three phase-18 runs: Param overrides by name
FOREST64_RUNS = {
    "gauss-seidel": dict(sequential=True, batch_size=4, batch_iter=-1),
    "jacobi": dict(sequential=True, batch_size=4, batch_iter=-1,
                   parallel_mode="jacobi", iteration=2),
    "default": dict(),
}

#: the solver tests' ADMM settings: a dual tolerance that stops every
#: solve of the forest's batches before max_iter (the production 1e-4
#: runs this problem class to the cap)
FAST = dict(eps_dual_abs=0.5, max_iter=300)
#: the KKT modes under test: (kkt_solver, adaptive_rho)
MODES = [("dense", False), ("dense", True), ("cg", False), ("cg", True)]
RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's many small products: several
    multi-threaded MKL processes on one host's cores (tier-1 runs six
    workers) make them tens of times slower.  Left at one after the
    module: raising the count again with torch.set_num_threads(n > 1)
    breaks this torch build's batched LU inverse (MKL DLASWP errors)."""
    torch.set_num_threads(1)


def _jax():
    import jax
    return jax


@pytest.fixture(scope="module")
def forest():
    """The in-repo 8-agent forest through the JAX package's host layer,
    and its two 4-agent batch QPs from each package (pair rows padded to
    the larger batch's count)."""
    from swarm_simulator_tpu.corridor.times import build_corridors
    from swarm_simulator_tpu.io.mission_json import perimeter_swap_mission
    from swarm_simulator_tpu.qp import assemble as asm_j
    from swarm_simulator_tpu.search.planner import plan_initial_trajectories
    from swarm_simulator_tpu.world.esdf import ESDF
    from swarm_simulator_tpu.world.forest import generate_forest
    from swarm_simulator_tpu_torch.qp import assemble as asm_t

    param = sj.Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                     solver_dtype="float64")
    mission = perimeter_swap_mission(8, half=4.0, z=1.0, radius=0.15)
    world = generate_forest(mission, world_min=param.world_min,
                            world_max=param.world_max, obs_num=6, r_min=0.3,
                            r_max=0.3, h_min=0.0, h_max=2.5, margin=0.5,
                            seed=1)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)
    dummy = asm_j.build_dummy(plan.init_traj, param.n, plan.M)
    param_t = st.Param(**dataclasses.asdict(param))
    batches = [np.arange(4), np.arange(4, 8)]
    pad = max(int(np.isin(plan.pair_idx, b).any(axis=1).sum())
              for b in batches)
    dj = [asm_j.assemble_batch(plan, mission, param, b, dummy, pad,
                               device=False) for b in batches]
    dt = [asm_t.assemble_batch(plan, mission, param_t, b, dummy, pad)
          for b in batches]
    return dict(plan=plan, mission=mission, param=param, param_t=param_t,
                dummy=dummy, dj=dj, dt=dt, pad=pad)


def _settings(kkt, adaptive, **kw):
    from swarm_simulator_tpu.qp import admm as admm_j
    from swarm_simulator_tpu_torch.qp import admm as admm_t
    kw = {**FAST, "kkt_solver": kkt, "adaptive_rho": adaptive, **kw}
    return admm_j.ADMMSettings(**kw), admm_t.ADMMSettings(**kw)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    return float(np.abs(got - want).max()) <= rtol * scale if want.size \
        else True


def _rel(got, want, floor=1e-300):
    """|got - want| within RTOL of max(|want|, floor)."""
    return abs(float(got) - float(want)) <= RTOL * max(abs(float(want)),
                                                       floor)


def test_assemble_pad_pairs_and_refresh_bit_equal(forest):
    """assemble_batch(pad_pairs=...) and refresh_from_dummy (a moved
    dummy, so every one-sided rhs changes) give the JAX package's bits."""
    jax = _jax()
    from swarm_simulator_tpu.qp import assemble as asm_j
    from swarm_simulator_tpu_torch.qp import assemble as asm_t

    rng = np.random.default_rng(0)
    moved = forest["dummy"] + 0.05 * rng.standard_normal(
        forest["dummy"].shape)
    for dj, dt in zip(forest["dj"], forest["dt"]):
        assert dj.pair_mask.shape[0] == forest["pad"]
        for f in dataclasses.fields(dj):
            a, b = getattr(dj, f.name), getattr(dt, f.name)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        rj = asm_j.refresh_from_dummy(jax.tree.map(jax.numpy.asarray, dj),
                                      jax.numpy.asarray(moved))
        rt = asm_t.refresh_from_dummy(dt.to("cpu"), torch.as_tensor(moved))
        for name in ("pair_rhs", "x0"):
            assert np.array_equal(np.asarray(getattr(rj, name)),
                                  getattr(rt, name).numpy()), name


def test_equilibrate_matches_jax(forest):
    jax = _jax()
    from swarm_simulator_tpu.qp.scaling import equilibrate as eq_j
    from swarm_simulator_tpu_torch.qp.scaling import equilibrate as eq_t

    sj_, cj = eq_j(jax.tree.map(jax.numpy.asarray, forest["dj"][0]))
    st_, ct = eq_t(forest["dt"][0].to("cpu"))
    for f in dataclasses.fields(cj):
        assert _close(getattr(ct, f.name), getattr(cj, f.name), 1e-12), f.name
    for f in dataclasses.fields(sj_):
        want = getattr(sj_, f.name)
        if want is not None:
            assert _close(getattr(st_, f.name), want, 1e-12), f.name


def test_operators_match_jax(forest):
    """A x, A^T y, P x, the bounds and _rho_vec on seeded vectors."""
    jax = _jax()
    from swarm_simulator_tpu.qp import admm as admm_j
    from swarm_simulator_tpu_torch.qp import admm as admm_t

    dj = jax.tree.map(jax.numpy.asarray, forest["dj"][0])
    dt = forest["dt"][0].to("cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal(dt.lb.shape)
    y = [rng.standard_normal(a.shape) for a in (dt.deq, dt.lb, dt.pair_rhs)]
    pj, pt = admm_j._pair_op(dj), admm_t._pair_op(dt)
    got = admm_t.A_matvec(dt, torch.as_tensor(x), pt)
    want = admm_j.A_matvec(dj, jax.numpy.asarray(x), pj)
    for g, w in zip(got, want):
        assert _close(g, w, 1e-12)
    assert _close(admm_t.AT_matvec(dt, admm_t.Constr(*map(torch.as_tensor,
                                                          y)), pt),
                  admm_j.AT_matvec(dj, admm_j.Constr(*y), pj), 1e-12)
    assert _close(admm_t.P_matvec(dt, torch.as_tensor(x)),
                  admm_j.P_matvec(dj, jax.numpy.asarray(x)), 1e-12)
    s_j, s_t = _settings("dense", False)
    for g, w in zip((*admm_t._bounds(dt), admm_t._rho_vec(dt, s_t)),
                    (*admm_j._bounds(dj), admm_j._rho_vec(dj, s_j))):
        for a, b in zip(g, w):
            assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kkt,adaptive", MODES)
def test_solve_qp_matches_jax(forest, kkt, adaptive):
    """One batch QP through solve_qp: the same iters, x within 1e-6 of its
    scale, r_prim / r_dual / obj within 1e-6 relative."""
    jax = _jax()
    from swarm_simulator_tpu.qp import admm as admm_j
    from swarm_simulator_tpu_torch.qp import admm as admm_t

    s_j, s_t = _settings(kkt, adaptive)
    xj, ij = admm_j.solve_qp(jax.tree.map(jax.numpy.asarray,
                                          forest["dj"][0]), s_j)
    xt, it = admm_t.solve_qp(forest["dt"][0], s_t, device="cpu")
    assert it.iters == int(ij.iters) < FAST["max_iter"]
    assert _close(xt, xj)
    for k in ("r_prim", "r_dual", "obj"):
        assert _rel(getattr(it, k), getattr(ij, k)), k


@pytest.mark.parametrize("kkt,adaptive", [("dense", False), ("cg", True)])
def test_solve_qp_batched_mixed_stops(forest, kkt, adaptive):
    """The forest's two batches stacked stop at different counts; each
    keeps its state from its own stop on: its count and x as JAX's
    batched solve gives them, and as its own solve alone."""
    jax = _jax()
    from swarm_simulator_tpu.parallel.seqbatch import _stack_qpdata as stk_j
    from swarm_simulator_tpu.qp import admm as admm_j
    from swarm_simulator_tpu_torch.parallel.seqbatch import \
        _stack_qpdata as stk_t
    from swarm_simulator_tpu_torch.qp import admm as admm_t

    s_j, s_t = _settings(kkt, adaptive)
    xj, ij = admm_j.solve_qp_batched(
        jax.tree.map(jax.numpy.asarray, stk_j(forest["dj"])), s_j)
    xt, it = admm_t.solve_qp_batched(stk_t(forest["dt"]), s_t,
                                     device="cpu")
    iters = it.iters.tolist()
    assert iters == np.asarray(ij.iters).tolist()
    assert iters[0] != iters[1] and max(iters) < FAST["max_iter"]
    assert _close(xt, xj)
    for k in ("r_prim", "r_dual", "obj"):
        for g, w in zip(getattr(it, k), np.asarray(getattr(ij, k))):
            assert _rel(g, w), k
    for l, d in enumerate(forest["dt"]):
        x1, i1 = admm_t.solve_qp(d, s_t, device="cpu")
        assert i1.iters == iters[l]
        assert _close(xt[l], x1, 1e-12)


@pytest.mark.parametrize("N,kw,want", [
    (10, dict(sequential=True, batch_size=4, batch_iter=-1), (3, 3)),
    (10, dict(sequential=True, batch_size=4, batch_iter=0), (3, 0)),
    (10, dict(sequential=True, batch_size=4, batch_iter=2), (3, 2)),
    (10, dict(sequential=True, batch_size=4, batch_iter=7), (3, 3)),
    (10, dict(sequential=False, batch_size=4, batch_iter=2), (1, 1)),
])
def test_make_batches_matches_jax(N, kw, want):
    from swarm_simulator_tpu.parallel.seqbatch import make_batches as mb_j
    from swarm_simulator_tpu_torch.parallel.seqbatch import \
        make_batches as mb_t

    bj, kj = mb_j(N, sj.Param(**kw))
    bt, kt = mb_t(N, st.Param(**kw))
    assert (len(bt), kt) == want == (len(bj), kj)
    for a, b in zip(bt, bj):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kkt", ["dense", "cg"])
def test_float32_kkt_operator_dtypes(forest, kkt):
    """A float32 batch QP: the dense KKT inverse is computed and kept in
    admm.KINV_DTYPE (float64), and its product with a float32 right-hand
    side comes back in float32 within 1e-6 (relative) of the float64
    problem's; the cg parts stay in the problem's dtype, as the JAX
    package keeps them."""
    from swarm_simulator_tpu_torch.qp import admm as admm_t

    d64 = forest["dt"][0].to("cpu")
    d32 = admm_t._tree_map(
        lambda a: a.float() if a.is_floating_point() else a, d64)
    _, s_t = _settings(kkt, False)
    op32 = admm_t.build_kkt_operator(d32, s_t)
    if kkt == "cg":
        assert op32.Kinv is None
        assert {t.dtype for t in (op32.base0, op32.base1, op32.coupling)} \
            == {torch.float32}
        return
    assert admm_t.KINV_DTYPE == torch.float64 == op32.Kinv.dtype
    op64 = admm_t.build_kkt_operator(d64, s_t)
    rhs = torch.as_tensor(np.random.default_rng(2).standard_normal(
        d64.lb.shape))[None]
    x32 = admm_t.kkt_solve(admm_t._tree_map(lambda a: a[None], op32), None,
                           None, None, rhs.float(), None, s_t)
    x64 = admm_t.kkt_solve(admm_t._tree_map(lambda a: a[None], op64), None,
                           None, None, rhs, None, s_t)
    assert x32.dtype == torch.float32
    assert _close(x32, x64, 1e-6)


def test_default_settings_pick_dense_until_2gb():
    """solver_kkt="auto": dense while the stacked inverses stay under 2 GB
    counted at 4 bytes an entry (16 batches of 4 at M = 36: 430 MB; the
    port's float64 inverses take 860 MB), cg past it (one batch of 64
    agents: 6.9 GB), as the JAX package picks."""
    from swarm_simulator_tpu_torch.io.mission_json import \
        perimeter_swap_mission
    from swarm_simulator_tpu_torch.parallel.seqbatch import default_settings

    class P:
        M = 36

    mission = perimeter_swap_mission(64)
    seq = st.Param(sequential=True, batch_size=4, batch_iter=-1)
    assert default_settings(P, mission, seq).kkt_solver == "dense"
    assert default_settings(P, mission, st.Param()).kkt_solver == "cg"


def forest64_plans(pkg, dtype="float32", runs=tuple(FOREST64_RUNS),
                   out_dir=None) -> dict:
    """The 64-agent forest (seed 0, 20 obstacles; chip_smoke.build_problem's
    knobs) planned on this host's CPU by one package (``pkg``: sj or st)
    in ``dtype``: each run's wall seconds, stage seconds, solver info and
    metrics; each run's control points saved under ``out_dir`` as
    ``{package}-{dtype}-{run}.npy`` where given."""
    out = {}
    name_of = "jax" if pkg is sj else "port"
    kw = {} if pkg is sj else dict(device="cpu")
    for name in runs:
        param = pkg.Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                          solver_dtype=dtype, **FOREST64_RUNS[name])
        mission = pkg.io.mission_json.perimeter_swap_mission(
            64, half=4.0, z=1.0, radius=0.15)
        world = pkg.world.forest.generate_forest(
            mission, world_min=param.world_min, world_max=param.world_max,
            obs_num=20, r_min=0.3, r_max=0.3, h_min=0.0, h_max=2.5,
            margin=0.5, seed=0)
        t0 = time.perf_counter()
        result, times = pkg.plan(mission, param, world, **kw)
        wall = time.perf_counter() - t0
        info = result.solver_info
        if out_dir is not None:
            np.save(Path(out_dir) / f"{name_of}-{dtype}-{name}.npy",
                    result.ctrl)
        out[name] = {
            "wall_s": wall, "times": dataclasses.asdict(times),
            "iters": [int(i) for i in info["iters"]],
            "max_r_prim": float(max(info["r_prim"])),
            "obj": [float(o) for o in info["obj"]], "mode": info["mode"],
            "metrics": pkg.evaluate(result, mission, param, **kw)}
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(
        description="Plan the 64-agent forest on the CPU through one "
        "package; print the runs as JSON, or (--compare) the largest "
        "control-point distance of each saved float32 plan to the same "
        "package's float64 plan of the same run.")
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--out", default=None, help="directory for the ctrl")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--compare", default=None,
                    help="a directory of saved plans to compare")
    ap.add_argument("runs", nargs="*", default=list(FOREST64_RUNS))
    args = ap.parse_args()
    if args.compare:
        d = Path(args.compare)
        gaps = {}
        for f in sorted(d.glob("*-float32-*.npy")):
            pkg, run = f.stem.split("-float32-")
            ref = d / f"{pkg}-float64-{run}.npy"
            if ref.exists():
                gaps[f.stem] = float(np.abs(np.load(f) - np.load(ref)).max())
        print(json.dumps(gaps))
        sys.exit(0)
    torch.set_num_threads(args.threads)
    if args.package == "jax":
        import jax

        # as the JAX package's CLI (cli/plan.py): x64 only for float64
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", args.dtype == "float64")
    import swarm_simulator_tpu.io.mission_json  # noqa: E402,F401
    import swarm_simulator_tpu.world.forest  # noqa: E402,F401
    import swarm_simulator_tpu_torch.io.mission_json  # noqa: E402,F401
    import swarm_simulator_tpu_torch.world.forest  # noqa: E402,F401
    print(json.dumps(forest64_plans(sj if args.package == "jax" else st,
                                    args.dtype, tuple(args.runs), args.out),
                     default=float))
