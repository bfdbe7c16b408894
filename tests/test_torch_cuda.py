"""PyTorch port on a CUDA card: the fused ADMM chunk kernel (K1) and its
stacked form (csrc/nsfused_stack.cu, on two Jacobi groups), the
Thomas solve kernel (K2, on float32 and bf16 pivots), the chunked Thomas
sweeps (K3a/K3b), the pivot-stream kernel (T4) and the probe kernels
(T1, T2, T3, T5) against their plain twins, and the planning paths
through them: the cold plan through K1, the
corridor replan and the device-prep cold plan through K2, and the sharded
joint solve on a 1-rank NCCL group through K3a/K3b; and the
sequential-batch ADMM path (no kernel of its own) in float64 on the card
against the CPU; the oracle gate (the host f64 IPM's objective criterion)
and the exact polish on plans made on the card.

These tests import torch and the port only (no jax), so they also run on
a machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Without a card they skip: the kernel has no CPU mode.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import swarm_simulator_tpu_torch as st
from swarm_simulator_tpu_torch.corridor.times import build_corridors
from swarm_simulator_tpu_torch.io.mission_json import (
    perimeter_swap_mission, scatter_mission)
from swarm_simulator_tpu_torch.eval import gate
from swarm_simulator_tpu_torch.eval.gate import gate_quality
from swarm_simulator_tpu_torch.ops import nsfused, thomas
from swarm_simulator_tpu_torch.ops import nsfused_probe as npb
from swarm_simulator_tpu_torch.ops import row_patterns as rp
from swarm_simulator_tpu_torch.ops import thomas_prim as tp
from swarm_simulator_tpu_torch.ops import thomas_probe as tq
from swarm_simulator_tpu_torch.ops import thomas_stream as ts
from swarm_simulator_tpu_torch.parallel import distributed as pd
from swarm_simulator_tpu_torch.qp import convert, joint
from swarm_simulator_tpu_torch.qp import nullspace as ns
from swarm_simulator_tpu_torch.qp import nullspace_shard as shard
from swarm_simulator_tpu_torch.search.planner import plan_initial_trajectories
from swarm_simulator_tpu_torch.world.esdf import ESDF
from swarm_simulator_tpu_torch.world.forest import generate_forest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (MXU_WALK, chunked_solve,  # noqa: E402
                        mxu_exact_pivots)

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA card (the kernel has no CPU mode)"),
]

N_INNER = 50


def _forest(n_agents=8, seed=1):
    param = st.Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                     solver="nullspace", solver_dtype="float32")
    # the perimeter swap takes multiples of 4 agents; other counts scatter
    mission = (perimeter_swap_mission(n_agents, half=4.0, z=1.0, radius=0.15)
               if n_agents % 4 == 0 else
               scatter_mission(n_agents, half=3.5, z=1.0, seed=seed))
    world = generate_forest(mission, world_min=param.world_min,
                            world_max=param.world_max, obs_num=6, r_min=0.3,
                            r_max=0.3, h_min=0.0, h_max=2.5, margin=0.5,
                            seed=seed)
    return mission, param, world


def _corridors(n_agents=8):
    mission, param, world = _forest(n_agents)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)
    return plan, mission, param


def _host_prep(n_agents=8):
    plan, mission, param = _corridors(n_agents)
    s = joint.production_phases()[0]
    data, _ = joint.assemble_joint(plan, mission, param)
    return s, data, ns.prepare_ns_np(data, s)


def _chunk_setups(n_agents=8):
    s, data, op = _host_prep(n_agents)
    dev = torch.device("cuda")
    out = {}
    for dtype in (torch.float32, torch.float64):
        d = data.to(dev)
        d = dataclasses.replace(d, **{
            f.name: getattr(d, f.name).to(dtype)
            for f in dataclasses.fields(d)
            if torch.is_floating_point(getattr(d, f.name))})
        o = ns.NSOp(*(None if v is None else v.to(dtype)
                      for v in op.to(dev)))
        out[dtype] = ns.cold_chunk_inputs(d, o, s)
    return s, out


def test_kernel_matches_twin_on_cuda():
    """One chunk per rung from the cold state: the kernel is as accurate
    as the plain float32 twin, both judged against a float64 twin, on
    every part of the state (nsfused.twin_gap_use)."""
    s, setups = _chunk_setups()
    ops32, st32 = setups[torch.float32]
    ops64, st64 = setups[torch.float64]
    k64, t64 = [], []
    for r in range(ops32.dinv.shape[0]):
        before = nsfused.nsfused_chunk.launches
        kern = nsfused.nsfused_chunk(ops32, r, s.sigma, s.alpha, *st32,
                                     n_inner=N_INNER)
        assert nsfused.nsfused_chunk.launches == before + 1
        twin32 = nsfused.nsfused_chunk_reference(ops32, r, s.sigma, s.alpha,
                                                 *st32, n_inner=N_INNER)
        twin64 = nsfused.nsfused_chunk_reference(ops64, r, s.sigma, s.alpha,
                                                 *st64, n_inner=N_INNER)
        assert all(torch.isfinite(t).all()
                   for t in (kern[0], *kern[1], *kern[2]))
        k64.append(nsfused.state_errors(kern, twin64))
        t64.append(nsfused.state_errors(twin32, twin64))
    use = nsfused.twin_gap_use(k64, t64)
    assert max(use.values()) <= 1.0, use


def test_plan_launches_kernel_not_twin_on_cuda():
    mission, param, world = _forest()
    nsfused.nsfused_chunk.launches = 0
    nsfused.nsfused_chunk_reference.cuda_calls = 0
    result, _ = st.plan(mission, param, world, device="cuda")
    chunks = result.solver_info["iters"][0] // N_INNER
    assert nsfused.nsfused_chunk.launches == chunks > 0
    assert nsfused.nsfused_chunk_reference.cuda_calls == 0
    assert np.isfinite(result.ctrl).all()
    metrics = st.evaluate(result, mission, param, device="cuda")
    assert metrics["min_safety_ratio"] >= 1.0


def _reset_counts():
    nsfused.nsfused_chunk.launches = 0
    nsfused.nsfused_chunk_reference.cuda_calls = 0
    thomas.thomas_solve.launches = 0
    thomas.thomas_solve_reference.cuda_calls = 0
    for f in (thomas.thomas_chunk_fwd, thomas.thomas_chunk_bwd):
        f.launches = 0
    for f in (thomas.thomas_chunk_fwd_reference,
              thomas.thomas_chunk_bwd_reference):
        f.cuda_calls = 0


@pytest.mark.parametrize("prep", ["host", "device"])
def test_thomas_kernel_matches_twin_on_cuda(prep):
    """One solve per rung with a seeded right-hand side, on the host-f64
    inventory and on the device inventory (whose pivots are not
    symmetric): the kernel is as accurate as the float32 twin, both
    judged against a float64 twin on the same float32 pivots
    (thomas.twin_gap_use)."""
    s, data, op = _host_prep()
    dev = torch.device("cuda")
    if prep == "device":
        op = ns.prepare_ns(data.to(dev), s)
    dinv32 = torch.as_tensor(op.Dinvs, device=dev).float().contiguous()
    ho32 = torch.as_tensor(op.Kos, device=dev).float().contiguous()
    dinv64, ho64 = dinv32.double(), ho32.double()
    Mi, bs = dinv32.shape[1], dinv32.shape[-1]
    gen = torch.Generator().manual_seed(0)
    k64, t64 = [], []
    for r in range(dinv32.shape[0]):
        b = torch.randn((Mi, bs), generator=gen, dtype=torch.float64)
        b32, b64 = b.float().to(dev), b.to(dev)
        before = thomas.thomas_solve.launches
        kern = thomas.thomas_solve(dinv32, ho32, b32, r)
        assert thomas.thomas_solve.launches == before + 1
        twin32 = thomas.thomas_solve_reference(dinv32, ho32, b32, r)
        twin64 = thomas.thomas_solve_reference(dinv64, ho64, b64, r)
        assert torch.isfinite(kern).all()
        k64.append(thomas.rel_error(kern, twin64))
        t64.append(thomas.rel_error(twin32, twin64))
    assert thomas.twin_gap_use(k64, t64) <= 1.0, (k64, t64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("agents, Mi", [(5, 4), (6, 4), (8, 2), (64, 2),
                                        (64, 5), (256, 3)])
def test_thomas_kernel_ring_shapes_match_twin_on_cuda(agents, Mi, dtype):
    """K2's TMA ring at the widths it has to handle (bs = 9 * agents):
    rows that are not 16-byte multiples (5 and 6 agents, float32 and bf16:
    the copies' ragged edges, on knots at any offset when bs is odd), the
    8-, 64- and 256-agent widths (whole stages in a slot; 48 KB tiles at
    256), and Mi = 2, the shortest chain.  Seeded well-conditioned pivots
    (I/2 + N(0, 1/4bs)) and couplings; the kernel is as accurate as the
    float32 twin on the same pivots, both against a float64 twin
    (thomas.twin_gap_use), and one rung past the first is solved so the
    rung's offset is exercised."""
    dev = torch.device("cuda")
    bs, phi = 9 * agents, 3
    rng = np.random.default_rng(agents * 10 + Mi)
    eye = np.eye(bs)
    dinv = np.stack([[0.5 * eye + rng.normal(size=(bs, bs)) / (2 * bs ** 0.5)
                      for _ in range(Mi)] for _ in range(2)])
    ho = rng.normal(size=(Mi - 1, phi, phi)) * 0.3
    b = rng.normal(size=(Mi, bs))
    d = torch.as_tensor(dinv, device=dev).to(dtype).contiguous()
    ho32 = torch.as_tensor(ho, device=dev).float().contiguous()
    b32 = torch.as_tensor(b, device=dev).float()
    kern = thomas.thomas_solve(d, ho32, b32, 1)
    twin32 = thomas.thomas_solve_reference(d, ho32, b32, 1)
    twin64 = thomas.thomas_solve_reference(d, ho32.double(), b32.double(), 1)
    assert torch.isfinite(kern).all()
    use = thomas.twin_gap_use([thomas.rel_error(kern, twin64)],
                              [thomas.rel_error(twin32, twin64)])
    assert use <= 1.0, use


def test_kernel_matches_twin_on_cuda_unaligned_rows():
    """K1 on one chunk of a 5-agent forest (bs = 45: rows of 180 bytes,
    knots at every offset within a 16-byte line, so every ring tile has
    ragged edges), as accurate as the float32 twin on every part of the
    state, on every rung."""
    s, setups = _chunk_setups(n_agents=5)
    ops32, st32 = setups[torch.float32]
    ops64, st64 = setups[torch.float64]
    assert ops32.dims["bs"] % 4
    k64, t64 = [], []
    for r in range(ops32.dinv.shape[0]):
        kern = nsfused.nsfused_chunk(ops32, r, s.sigma, s.alpha, *st32,
                                     n_inner=N_INNER)
        twin32 = nsfused.nsfused_chunk_reference(ops32, r, s.sigma, s.alpha,
                                                 *st32, n_inner=N_INNER)
        twin64 = nsfused.nsfused_chunk_reference(ops64, r, s.sigma, s.alpha,
                                                 *st64, n_inner=N_INNER)
        k64.append(nsfused.state_errors(kern, twin64))
        t64.append(nsfused.state_errors(twin32, twin64))
    use = nsfused.twin_gap_use(k64, t64)
    assert max(use.values()) <= 1.0, use


@pytest.mark.parametrize("change", [{"iteration": 2},
                                    {"cold_prep": "device"}])
def test_replan_and_device_prep_launch_thomas_kernel_not_twins(change):
    """The corridor replan (replan_prep auto -> "device" on CUDA) and the
    device-prep cold plan solve through K2; neither twin runs on CUDA."""
    mission, param, world = _forest()
    param = dataclasses.replace(param, **change)
    _reset_counts()
    result, _ = st.plan(mission, param, world, device="cuda")
    info = result.solver_info
    assert thomas.thomas_solve.launches > 0
    assert nsfused.nsfused_chunk_reference.cuda_calls == 0
    assert thomas.thomas_solve_reference.cuda_calls == 0
    if "iteration" in change:
        assert info["replan_prep"] == "device"
        assert info["replan_rounds"] == 1
        assert nsfused.nsfused_chunk.launches > 0    # the cold round
    else:
        assert nsfused.nsfused_chunk.launches == 0
    assert np.isfinite(result.ctrl).all()
    metrics = st.evaluate(result, mission, param, device="cuda")
    assert metrics["min_safety_ratio"] >= 1.0


@pytest.mark.parametrize("B3, Mi, n", [(192, 35, 1), (192, 35, 4),
                                       (768, 6, 1), (768, 6, 2),
                                       (193, 7, 1), (193, 7, 2)])
def test_chunk_kernels_match_twins_on_cuda(B3, Mi, n):
    """K3a/K3b with the chain of Mi knots split into n chunks: the 64-agent
    shapes (bs = 576, Mi = 35; n = 4 gives L = 9 and one pad knot), the
    256-agent width on a short chain (bs = 2304) and rows off 16 bytes
    (B3 = 193, bs = 579: K3a's ragged spans; n = 2 pads one knot), on
    seeded well-conditioned pivots and per-knot couplings.  Each chunk is
    one launch of each kernel; the pad knots' rows are exactly 0; the
    chained kernels are as accurate as the chained float32 twins against
    float64 twins (thomas.twin_gap_use), and agree with K2's full solve on
    the same input."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    phi, R = 3, 2
    bs = B3 * phi
    dinv = (torch.eye(bs, dtype=torch.float64) * 0.5
            + 0.02 * torch.randn((R, Mi, bs, bs), generator=gen,
                                 dtype=torch.float64) / bs ** 0.5)
    kos = 0.3 * torch.randn((Mi - 1, phi, phi), generator=gen,
                            dtype=torch.float64)
    b = torch.randn((Mi, bs), generator=gen, dtype=torch.float64)
    d32, k32, b32 = (t.float().to(dev).contiguous() for t in (dinv, kos, b))
    d64, k64, b64 = (t.to(dev) for t in (dinv, kos, b))
    del dinv
    k_err, t_err = [], []
    for r in range(R):
        fwd0, bwd0 = thomas.thomas_chunk_fwd.launches, \
            thomas.thomas_chunk_bwd.launches
        kern = chunked_solve(d32, k32, b32, r, n)
        assert thomas.thomas_chunk_fwd.launches == fwd0 + n
        assert thomas.thomas_chunk_bwd.launches == bwd0 + n
        assert int(torch.count_nonzero(kern[Mi:])) == 0
        kern = kern[:Mi]
        twins = (thomas.thomas_chunk_fwd_reference,
                 thomas.thomas_chunk_bwd_reference)
        twin32 = chunked_solve(d32, k32, b32, r, n, *twins)[:Mi]
        twin64 = chunked_solve(d64, k64, b64, r, n, *twins)[:Mi]
        assert torch.isfinite(kern).all()
        k_err.append(thomas.rel_error(kern, twin64))
        t_err.append(thomas.rel_error(twin32, twin64))
        full = thomas.thomas_solve(d32, k32, b32, r)
        assert thomas.rel_error(full, twin64) <= \
            thomas.TWIN_GAP_FACTOR * t_err[-1] + thomas.TWIN_GAP_FLOOR
    assert thomas.twin_gap_use(k_err, t_err) <= 1.0, (k_err, t_err)


@pytest.mark.parametrize("B3, Mi, n", [(192, 35, 1), (192, 35, 4),
                                       (192, 3, 3), (193, 7, 1),
                                       (768, 6, 1)])
def test_chunk_bwd_ring_matches_twins_on_cuda(B3, Mi, n):
    """K3b alone on the chain ring, on the last chunk of a chain of Mi
    knots split into n: the 64-agent width at L = 35 and at L = 9 (one
    pad knot: zero pivots, zero couplings and T's zero rows), L = 1, rows
    off 16 bytes (bs 579: ragged spans) and the 256-agent width (bs
    2304), a seeded T and carry on each of two rungs: one launch a
    sweep; as accurate as its float32 twin against its float64 twin
    (thomas.twin_gap_use); the pad knot's rows exactly 0."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    phi, R = 3, 2
    bs = B3 * phi
    L = -(-Mi // n)
    real = Mi - (n - 1) * L   # real knots of the last chunk
    dinv = (torch.eye(bs, dtype=torch.float64) * 0.5
            + 0.02 * torch.randn((R, L, bs, bs), generator=gen,
                                 dtype=torch.float64) / bs ** 0.5)
    dinv[:, real:] = 0.0
    kos = 0.3 * torch.randn((Mi - 1, phi, phi), generator=gen,
                            dtype=torch.float64)
    kout = shard.chunk_couplings(kos, n * L)[1][(n - 1) * L:].contiguous()
    T = torch.randn((L, bs), generator=gen, dtype=torch.float64)
    T[real:] = 0.0
    x_in = (torch.randn(bs, generator=gen, dtype=torch.float64)
            if n == 1 else torch.zeros(bs, dtype=torch.float64))
    d32, k32, T32, x32 = (t.float().to(dev).contiguous()
                          for t in (dinv, kout, T, x_in))
    d64, k64, T64, x64 = (t.to(dev) for t in (dinv, kout, T, x_in))
    k_err, t_err = [], []
    for r in range(R):
        before = thomas.thomas_chunk_bwd.launches
        got = thomas.thomas_chunk_bwd(d32, k32, T32, x32, r)
        assert thomas.thomas_chunk_bwd.launches == before + 1
        assert torch.isfinite(got).all()
        assert int(torch.count_nonzero(got[real:])) == 0
        twin32 = thomas.thomas_chunk_bwd_reference(d32, k32, T32, x32, r)
        twin64 = thomas.thomas_chunk_bwd_reference(d64, k64, T64, x64, r)
        k_err.append(thomas.rel_error(got[:real], twin64[:real]))
        t_err.append(thomas.rel_error(twin32[:real], twin64[:real]))
    assert thomas.twin_gap_use(k_err, t_err) <= 1.0, (k_err, t_err)


def test_sharded_solve_on_one_nccl_rank():
    """The sharded joint solve (chunk mode) on a 1-rank NCCL group for the
    8-agent forest: every KKT solve goes through K3a/K3b, neither K1 nor
    K2 nor a twin runs, and the plan passes the gate."""
    plan, mission, param = _corridors()
    phases = joint.production_phases()
    data, _ = joint.assemble_joint(plan, mission, param)
    op = ns.prepare_ns_np(data, phases[0])
    _reset_counts()
    x, iters, _, obj, _ = pd.run_ranks(shard.rank_solve, 1, data, phases, op,
                                       "chunk", backend="nccl")
    assert thomas.thomas_chunk_fwd.launches == \
        thomas.thomas_chunk_bwd.launches == iters > 0
    assert nsfused.nsfused_chunk.launches == 0
    assert thomas.thomas_solve.launches == 0
    assert thomas.thomas_chunk_fwd_reference.cuda_calls == 0
    assert thomas.thomas_chunk_bwd_reference.cuda_calls == 0
    ctrl = convert.x_to_ctrl(x, plan.M, param.n)
    ok, metrics = gate_quality(ctrl, plan, mission, param, device="cuda")
    assert ok, metrics
    assert np.isfinite(obj)


def test_thomas_kernel_bf16_matches_twin_on_cuda():
    """K2 on the device inventory rounded to bf16: as accurate as the
    float32 twin on the same bf16 pivots, both judged against a float64
    twin on those pivots (thomas.twin_gap_use), so the comparison holds
    the arithmetic, not the rounding; counted as a bf16 launch."""
    s, data, op = _host_prep()
    dev = torch.device("cuda")
    op = ns.prepare_ns(data.to(dev), dataclasses.replace(
        s, kkt_refine=1, precond_dtype="bfloat16"))
    d16, ho = op.Dinvs, op.Kos.float().contiguous()
    assert d16.dtype == torch.bfloat16
    Mi, bs = d16.shape[1], d16.shape[-1]
    gen = torch.Generator().manual_seed(0)
    k64, t64 = [], []
    for r in range(d16.shape[0]):
        b = torch.randn((Mi, bs), generator=gen, dtype=torch.float64)
        b32, b64 = b.float().to(dev), b.to(dev)
        before = (thomas.thomas_solve.launches,
                  thomas.thomas_solve.launches_bf16)
        kern = thomas.thomas_solve(d16, ho, b32, r)
        assert (thomas.thomas_solve.launches,
                thomas.thomas_solve.launches_bf16) == (before[0],
                                                       before[1] + 1)
        twin32 = thomas.thomas_solve_reference(d16, ho, b32, r)
        twin64 = thomas.thomas_solve_reference(d16, ho.double(), b64, r)
        assert torch.isfinite(kern).all()
        k64.append(thomas.rel_error(kern, twin64))
        t64.append(thomas.rel_error(twin32, twin64))
    assert thomas.twin_gap_use(k64, t64) <= 1.0, (k64, t64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", sorted(ts.VARIANTS))
def test_stream_kernel_matches_plain_on_cuda(variant, dtype):
    """T4 on a seeded [2, 12, 576, 576] inventory (64-agent blocks): each
    column sum within 1e-5 of the column's absolute sum of the plain
    version's float32 sums (the kernel adds each block's rows in order and
    the blocks' partials in order; float32 either way)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dinv = torch.randn((2, 12, 576, 576), generator=gen, device=dev).to(dtype)
    slots, split = ts.VARIANTS[variant]
    for r in range(2):
        before = ts.thomas_stream.launches
        got = ts.thomas_stream(dinv, r, slots, split)
        assert ts.thomas_stream.launches == before + 1
        want = ts.thomas_stream_reference(dinv, r)
        absum = dinv[r].float().abs().sum(dim=(0, 1))
        assert ((got - want).abs() <= 1e-5 * absum).all()


def test_bf16_inventory_refused_on_cuda_k1_path():
    """A kkt_refine=0 solve (one fused chunk, K1, per check) on a bf16
    inventory raises before any launch."""
    s, data, op = _host_prep()
    dev = torch.device("cuda")
    s16 = dataclasses.replace(s, kkt_refine=1, precond_dtype="bfloat16")
    op16 = ns.prepare_ns(data.to(dev), s16)
    s0 = dataclasses.replace(s16, kkt_refine=0)
    _reset_counts()
    with pytest.raises(ValueError, match="bf16 pivot inventory"):
        ns.solve_ns_schedule(data.to(dev), op16, *ns.schedule_arrays((s0,)))
    assert nsfused.nsfused_chunk.launches == 0


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.parametrize("grid, bs", [("one", 576), ("ring", 576),
                                      ("ring", 640), ("ring", 2304)])
@pytest.mark.parametrize("spec", ["dma", "mv_sub", "mv_lane", "mv_mxu",
                                  "trans", "fwd", "dmag", "dmaq", "dma@4"])
def test_prim_kernel_matches_plain_on_cuda(spec, grid, bs):
    """T2 (Mi 6, two reps) from a seeded start, on one block at bs 576 and
    on the chain ring at bs 576 (rows in groups of 3), 640 (single rows)
    and 2304 (tiles of a few rows): within 1e-5 of the plain version's
    scale (float32 sums in another order); mv_mxu, which rounds its
    carried row to bf16 each step (so float32 runs summing in another
    order drift apart), bit for bit on signed-permutation pivots (exact in
    any order: chip_smoke.mxu_exact_pivots) and against a float64 plain
    run within 3x the float32 plain run's error plus one bf16 unit, 2^-8
    (a rounding flip of the carried row), at bs 576; at the widths added
    with the ring (640, 2304) plus chip_smoke.py's walk of 2^-8
    sqrt(steps) instead: there one block and the plain float32 run walk
    as far, and each grid's walk is its summation order's
    (tools/t2_mxu_drift: over five seeds a single step errs <= 1e-6 on
    both grids, and each grid's result sides with a float32 witness of
    its block and tile order)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    Mi = 6
    dinv = torch.randn((1, Mi, bs, bs), generator=gen, device=dev) * 0.01
    # koM as the T2 tool draws it: the probe's 0.1, at bs 2304 0.5/sqrt(bs)
    koM = (torch.randn((bs, bs), generator=gen, device=dev)
           * (0.1 if bs < 2304 else 0.5 / bs ** 0.5))
    b = torch.randn((Mi, bs), generator=gen, device=dev)
    acc0 = torch.randn((bs, bs), generator=gen, device=dev)
    mode, nbuf = tp.parse_mode(spec)
    before = tp.thomas_prim.launches
    got = tp.thomas_prim(dinv, koM, b, mode, nbuf, 2, acc0, grid=grid)
    assert tp.thomas_prim.launches == before + 1
    want = tp.thomas_prim_reference(dinv, koM, b, mode, nbuf, 2, acc0)
    if mode != "mv_mxu":
        assert _rel(got, want) <= 1e-5
        return
    exact = mxu_exact_pivots(Mi, bs, dev)
    assert torch.equal(
        tp.thomas_prim(exact, koM, b, mode, nbuf, 2, acc0, grid=grid),
        tp.thomas_prim_reference(exact, koM, b, mode, nbuf, 2, acc0))
    w64 = tp.thomas_prim_reference(dinv, koM.double(), b.double(), mode,
                                   nbuf, 2, acc0.double())
    walk = 2.0 ** -8 if bs == 576 else MXU_WALK * (2 * Mi) ** 0.5
    assert thomas.rel_error(got, w64) <= \
        thomas.TWIN_GAP_FACTOR * thomas.rel_error(want, w64) + walk


@pytest.mark.parametrize("grid, bs", [("one", 576), ("ring", 576),
                                      ("ring", 640), ("ring", 2304)])
@pytest.mark.parametrize("nbuf", [2, 4])
def test_prim_dmag_tensor_map_matches_plain_on_cuda(nbuf, grid, bs):
    """T2's dmag, each group of nbuf knots in one 3-D tensor-map copy, on
    Mi 9 (so the group leaves the last knot out at nbuf 2 and 4; two reps)
    from a seeded start: within 1e-5 of the plain version's scale."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    Mi = 9
    dinv = torch.randn((1, Mi, bs, bs), generator=gen, device=dev) * 0.01
    koM = torch.zeros((bs, bs), device=dev)
    b = torch.randn((Mi, bs), generator=gen, device=dev)
    acc0 = torch.randn((bs, bs), generator=gen, device=dev)
    want = tp.thomas_prim_reference(dinv, koM, b, "dmag", nbuf, 2, acc0)
    got = tp.thomas_prim(dinv, koM, b, "dmag", nbuf, 2, acc0, grid=grid)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("bs, Mi", [(576, 8), (576, 35), (2304, 6)])
@pytest.mark.parametrize("stage", tq.STAGES + ("dma@knot", "mv@knot"))
def test_probe_kernel_matches_plain_on_cuda(stage, bs, Mi):
    """T3 at the 64-agent width (bs 576, Mi 8 and the production Mi 35:
    whole-stage tiles of the chain's spans, coupling rows in shared
    memory) and the 256-agent width (bs 2304, Mi 6: tiles of a few rows,
    koM^T resident beside a two-slot ring in fwd, the coupling rows through
    L2 in full), rung 1 of 2, dma and mv on flat spans and on the chain's
    (@knot): within 1e-5 of the plain version's scale (1e-4 over Mi 35's
    69 dependent stages, as chip_smoke.py holds it)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    st, knot = stage.split("@")[0], stage.endswith("@knot")
    plan = tq.probe_plan(bs, Mi, st, thomas.sm_count(dev), knot)
    if knot or st in ("fwd", "full"):
        assert (plan.tile_rows < plan.rows) == (bs == 2304)
        assert plan.resident == (st == "fwd" or (st == "full" and bs == 576))
    dinv = torch.randn((2, Mi, bs, bs), generator=gen, device=dev) * 0.01
    dinv += torch.eye(bs, device=dev)
    koM = torch.randn((bs, bs), generator=gen, device=dev) * 0.5 / bs ** 0.5
    b = torch.randn((Mi, bs), generator=gen, device=dev)
    before = tq.thomas_probe.launches
    got = tq.thomas_probe(dinv, koM, b, st, 1, knot)
    assert tq.thomas_probe.launches == before + 1
    assert _rel(got, tq.thomas_probe_reference(dinv, koM, b, st, 1)) \
        <= (1e-5 if Mi <= 8 else 1e-4)


@pytest.mark.parametrize("probe, M", [(1, 216), (2, 216), (3, 216),
                                      (3, 100), (4, 9), (4, 35)])
def test_nsfused_probe_kernels_match_plain_on_cuda(probe, M):
    """T1's P1-P4 at their fixed sizes (P3 also at M = 100 rows, its
    64-row tiles' masked edge; P4, 2 iterations, over M = 9 knots and the
    full 35, its chain also at 0 knots resident and at the most, all 9 of
    9, 14 of 35, with the re-layout bit-equal to the plain permute):
    within 1e-5 of the plain version's scale; P3 also within 3e-6 of a
    float64 product."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    if probe == 1:
        wrapper, args = npb.p1_reshape_combine, (r(216, 192),)
        plain = npb.p1_reshape_combine_reference
    elif probe == 2:
        wrapper, args = npb.p2_tile_apply, (r(2, 4, 3, 3, 192, 192),
                                            r(3, 192), 1)
        plain = npb.p2_tile_apply_reference
    elif probe == 3:
        s = torch.randint(-1, 2, (192, 2048), generator=gen,
                          device=dev).float()
        wrapper, args = npb.p3_split_pair_product, (r(M, 192, scale=3.0), s)
        plain = npb.p3_split_pair_product_reference
    else:
        wrapper, args = npb.p4_resident_thomas, (
            r(1, M, 3, 3, 192, 192, scale=0.1), r(3, 3, scale=0.1),
            r(M, 3, 192), 0, 2)
        plain = npb.p4_resident_thomas_reference
        want = plain(*args)
        before = npb.p4_relayout.launches
        m = npb.p4_relayout(args[0], 0)
        assert npb.p4_relayout.launches == before + 1
        assert torch.equal(m, npb.p4_relayout_reference(args[0], 0))
        most = npb.p4_max_resident(M, thomas.sm_count(dev))
        assert most == min(M, 14)
        for h in (0, most):
            before = wrapper.launches
            got = npb.p4_chain(m, args[1], args[2], 2, h)
            assert wrapper.launches == before + 1
            assert _rel(got, want) <= 1e-5, h
    before = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == before + 1
    assert _rel(got, plain(*args)) <= 1e-5
    if probe == 3:
        ref = args[0].double() @ args[1].double()
        assert float((got.double() - ref).abs().max()) <= \
            3e-6 * max(float(ref.abs().max()), 1.0)


def test_launch_floor_on_cuda():
    """The empty kernel launches on one block and on P2's clustered
    grid."""
    plan = npb.p2_plan(sms=thomas.sm_count(torch.device("cuda")))
    before = npb.launch_floor.launches
    npb.launch_floor(1, 256, 1, "cuda")
    npb.launch_floor(plan.tiles * plan.cluster, plan.threads, plan.cluster,
                     "cuda")
    torch.cuda.synchronize()
    assert npb.launch_floor.launches == before + 2


def test_row_pattern_kernel_matches_plain_on_cuda():
    """T5's fourteen patterns on the probe's inputs: bit-equal to the plain
    versions (P8's sum within 1e-6 of its scale)."""
    for name, ins in rp.pattern_inputs("cuda").items():
        before = rp.row_pattern.launches
        got = rp.row_pattern(name, *ins)
        assert rp.row_pattern.launches == before + 1
        want = rp.PATTERNS[name].plain(*ins)
        if name == rp.SUM_PATTERN:
            assert _rel(got, want) <= 1e-6, name
        else:
            assert torch.equal(got, want), name


def test_row_pattern_p8_split_matches_plain_on_cuda():
    """P8 on its warp-split grid, on seeded normal g and col (sums that
    cancel, unlike the probe's aranges): within 1e-6 of the plain
    version's scale (float32 sums of 192 products in another order)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    g = torch.randn((192, 3, 192), generator=gen, device="cuda")
    col = torch.randn((192, 1, 1), generator=gen, device="cuda")
    before = rp.row_pattern.launches
    got = rp.row_pattern(rp.SUM_PATTERN, g, col)
    assert rp.row_pattern.launches == before + 1
    assert _rel(got, rp.PATTERNS[rp.SUM_PATTERN].plain(g, col)) <= 1e-6


def test_seqbatch_sequential_swap_float64_on_cuda_matches_cpu():
    """The sequential-batch ADMM path (no kernel of its own) on the card:
    the 8-agent swap in Gauss-Seidel batches of 4, float64, against the
    same plan on the CPU: the same iters, ctrl within 1e-9."""
    from swarm_simulator_tpu_torch.io.mission_json import swap_mission

    param = st.Param(world_z_min=0.0, solver_dtype="float64",
                     grid_xy_res=0.5, grid_z_res=0.5, sequential=True,
                     batch_size=4, batch_iter=-1)
    mission = swap_mission(8, z=1.0, span=4.0, radius=0.12)
    out = {dev: st.plan(mission, param, device=dev)[0]
           for dev in ("cuda", "cpu")}
    assert out["cuda"].solver_info["device"].startswith("cuda")
    assert out["cuda"].solver_info["iters"] == out["cpu"].solver_info["iters"]
    assert np.abs(out["cuda"].ctrl - out["cpu"].ctrl).max() <= 1e-9


@pytest.mark.parametrize("kkt", ["dense", "cg"])
def test_solve_qp_float64_on_cuda_matches_cpu(kkt):
    """admm.solve_qp of the 8-agent forest's first 4-agent batch QP (the
    CPU tests' problem, their early-stopping dual tolerance) in float64 on
    the card against the CPU: the same iters, x within 1e-9."""
    from swarm_simulator_tpu_torch.qp import admm, assemble

    plan, mission, param = _corridors(8)
    param = dataclasses.replace(param, solver_dtype="float64")
    dummy = assemble.build_dummy(plan.init_traj, param.n, plan.M)
    data = assemble.assemble_batch(plan, mission, param, np.arange(4),
                                   dummy)
    s = admm.ADMMSettings(kkt_solver=kkt, eps_dual_abs=0.5, max_iter=300)
    (xg, ig), (xc, ic) = (admm.solve_qp(data, s, device=dev)
                          for dev in ("cuda", "cpu"))
    assert ig.iters == ic.iters < s.max_iter
    assert float((xg.cpu() - xc).abs().max()) <= 1e-9


#: bench.py's oracle batches: sequential groups of 4 (the joint solve
#: ignores these fields)
ORACLE_BATCHES = dict(sequential=True, batch_size=4, batch_iter=-1,
                      time_scale=False)


def test_oracle_gate_on_cuda():
    """The 8-agent forest planned on the card through K1 (no twin on CUDA)
    passes the full gate with the IPM objective criterion at obj_tol 1.25
    on both of its batches of 4."""
    mission, param, world = _forest()
    param = dataclasses.replace(param, **ORACLE_BATCHES)
    _reset_counts()
    result, _ = st.plan(mission, param, world, device="cuda")
    assert nsfused.nsfused_chunk.launches > 0
    assert nsfused.nsfused_chunk_reference.cuda_calls == 0
    for b_idx in range(2):
        obj_b0, _ = gate.batch0_objective(result.ctrl, result, mission,
                                          param, b_idx)
        obj_ref, _ = gate.ipm_best_response_batch0(result, mission, param,
                                                   result.ctrl, b_idx)
        ok, m = gate_quality(result.ctrl, result, mission, param, obj_ref,
                             obj_b0, device="cuda")
        assert ok, m


def test_exact_polish_on_cuda():
    """Param(exact_polish=True) on the card: K1 launched and no twin on
    CUDA, the polish accepted without raising the objective, and the
    polished plan passes the full gate at a margin <= 1.01 on batch 0
    (the oracle's pair rows lowered by 1e-6: an exact optimum leaves
    them at zero slack)."""
    mission, param, world = _forest()
    param = dataclasses.replace(param, exact_polish=True, **ORACLE_BATCHES)
    _reset_counts()
    result, _ = st.plan(mission, param, world, device="cuda")
    assert nsfused.nsfused_chunk.launches > 0
    assert nsfused.nsfused_chunk_reference.cuda_calls == 0
    info = result.solver_info["exact_polish"]
    assert info["accepted"] is True, info
    assert info["obj_out"] <= info["obj_in"] + 1e-9
    assert result.solver_info["exact_polish_rounds"] == [info]
    obj_b0, _ = gate.batch0_objective(result.ctrl, result, mission, param, 0)
    obj_ref, _ = gate.ipm_best_response_batch0(result, mission, param,
                                               result.ctrl, 0,
                                               pair_relax=1e-6)
    assert obj_b0 <= 1.01 * obj_ref
    ok, m = gate_quality(result.ctrl, result, mission, param, obj_ref,
                         obj_b0, device="cuda")
    assert ok, m


def _jacobi_groups(dtype):
    """The 8-agent forest's two groups of 4, host leaves in ``dtype``,
    padded to one pair count, and its dummy."""
    from swarm_simulator_tpu_torch.parallel import seqbatch
    from swarm_simulator_tpu_torch.qp import assemble

    plan, mission, param = _corridors(8)
    param = dataclasses.replace(param, solver_dtype=dtype, sequential=True,
                                batch_size=4, batch_iter=-1)
    batches, _ = seqbatch.make_batches(mission.qn, param)
    dummy = assemble.build_dummy(plan.init_traj, param.n, plan.M)
    pairs = np.asarray(plan.pair_idx)
    pad = max(int(np.isin(pairs, b).any(axis=1).sum()) for b in batches)
    return seqbatch._stack_qpdata([
        assemble.assemble_batch(plan, mission, param, b, dummy, pad)
        for b in batches]), dummy.astype(dtype)


def test_jacobi_sweep_through_k1_matches_cpu():
    """The knot-state Jacobi sweep (banded, two rounds of 100 and 50
    iterations) of the 8-agent forest's two groups of 4 on the card, each
    chunk one launch of K1's stacked form for both groups, against the
    same sweep on the CPU in float32 (the twin) and in float64: the card's
    error against the float64 run within K1's tolerance (TWIN_GAP_FACTOR x
    the float32 CPU run's + TWIN_GAP_FLOOR); the stacked kernel launched,
    per-problem K1 not, the twins never on CUDA."""
    from swarm_simulator_tpu_torch.parallel import mesh

    s = ns.NSSettings(kkt_mode="banded", tighten=2e-3)
    kw = dict(rounds=2, iters_schedule=(100, 50))
    g32, d32 = _jacobi_groups("float32")
    g64, d64 = _jacobi_groups("float64")
    nsfused.nsfused_chunk.launches = nsfused.nsfused_stack.launches = 0
    nsfused.nsfused_chunk_reference.cuda_calls = 0
    nsfused.nsfused_stack_reference.cuda_calls = 0
    ck, _ = mesh.jacobi_sweep(g32, d32, s, device="cuda", **kw)
    # the groups' chunks run as stack launches, per-problem K1 never
    assert nsfused.nsfused_stack.launches > 0
    assert nsfused.nsfused_chunk.launches == 0
    assert nsfused.nsfused_chunk_reference.cuda_calls == 0
    assert nsfused.nsfused_stack_reference.cuda_calls == 0
    cc, _ = mesh.jacobi_sweep(g32, d32, s, device="cpu", **kw)
    c64, _ = mesh.jacobi_sweep(g64, d64, s, device="cpu", **kw)
    ek = thomas.rel_error(ck.cpu(), c64)
    et = thomas.rel_error(cc, c64)
    assert thomas.twin_gap_use([ek], [et]) <= 1.0, (ek, et)


def test_solve_dense_float64_on_cuda_matches_cpu():
    """qp/dense's ADMM on a seeded QP (equality rows, two-sided bounds)
    in float64 on the card against the CPU: the same iterations, x within
    1e-8."""
    from swarm_simulator_tpu_torch.qp import dense

    rng = np.random.default_rng(3)
    n, m = 30, 45
    G = rng.standard_normal((n, n))
    Q = G @ G.T / n + 0.1 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    ax = A @ rng.standard_normal(n)
    l, u = ax - rng.uniform(0, 1, m), ax + rng.uniform(0, 1, m)
    l[:5] = u[:5] = ax[:5]
    s = dense.DenseSettings(max_iter=3000)
    xg, ig = dense.solve_dense(Q, q, A, l, u, s, device="cuda")
    xc, ic = dense.solve_dense(Q, q, A, l, u, s, device="cpu")
    assert xg.is_cuda and ig.iters == ic.iters < 3000
    assert float((xg.cpu() - xc).abs().max()) < 1e-8


def test_stack_kernel_matches_twins_on_cuda():
    """The stacked K1 (csrc/nsfused_stack.cu) on the 8-agent forest's two
    groups of 4, host prep, cold state: one chunk of both groups at rung
    0, at the last rung and at one rung each, against the float32 and the
    float64 twins, each group and state part within K1's tolerance
    (nsfused.twin_gap_use); a group launched alone bit-equal to it in the
    stack; a stack of three with one group repeated (an odd number of
    clusters) bit-equal copy to copy and to the stack of two; a frozen
    group passed through; float64 state refused."""
    from swarm_simulator_tpu_torch.qp import nullspace as ns_

    stacked, _ = _jacobi_groups("float64")
    s = ns_.NSSettings(kkt_mode="banded", tighten=2e-3)
    groups = [dataclasses.replace(stacked, **{
        f.name: np.asarray(getattr(stacked, f.name))[g]
        for f in dataclasses.fields(stacked)
        if getattr(stacked, f.name) is not None}) for g in range(2)]
    ops_h = [ns_.prepare_ns_np(g, s) for g in groups]
    dev = torch.device("cuda")
    inputs = {}
    for dtype in (torch.float32, torch.float64):
        prep = []
        for g, op in zip(groups, ops_h):
            d = g.to(dev)
            d = dataclasses.replace(d, **{
                f.name: getattr(d, f.name).to(dtype)
                for f in dataclasses.fields(d)
                if torch.is_floating_point(getattr(d, f.name))})
            o = ns_.NSOp(*(None if v is None else v.to(dtype)
                           for v in op.to(dev)))
            prep.append(ns_.cold_chunk_inputs(d, o, s))
        inputs[dtype] = (nsfused.stack_operands([p[0] for p in prep]),
                         ns_.stack_states([p[1] for p in prep]))
    sops, state = inputs[torch.float32]
    sops64, state64 = inputs[torch.float64]
    w, z, y = state
    w64, z64, y64 = state64

    def rows(out, g):
        wg, zg, yg = ns_.entry_state(out, g)
        return (wg, *zg, *yg)

    R = sops.dinv.shape[1]
    k64, t64 = [[], []], [[], []]
    for rungs in ([0, 0], [R - 1, R - 1], [1, R - 2]):
        before = nsfused.nsfused_stack.launches
        kern = nsfused.nsfused_stack(sops, [0, 1], rungs, s.sigma, s.alpha,
                                     w, z, y, N_INNER)
        assert nsfused.nsfused_stack.launches == before + 1
        twin = nsfused.nsfused_stack_reference(sops, [0, 1], rungs, s.sigma,
                                               s.alpha, w, z, y, N_INNER)
        ref = nsfused.nsfused_stack_reference(sops64, [0, 1], rungs,
                                              s.sigma, s.alpha, w64, z64,
                                              y64, N_INNER)
        for g in range(2):
            kg = ns_.entry_state(kern, g)
            assert all(torch.isfinite(t).all() for t in rows(kern, g))
            rg = ns_.entry_state(ref, g)
            k64[g].append(nsfused.state_errors(kg, rg))
            t64[g].append(nsfused.state_errors(ns_.entry_state(twin, g),
                                               rg))
        alone = nsfused.nsfused_stack(
            nsfused.stack_operands([sops.entries[1]]), [0], rungs[1:],
            s.sigma, s.alpha, *ns_.entry_state(state, slice(1, 2)), N_INNER)
        for a, b in zip(rows(kern, 1), rows(alone, 0)):
            assert torch.equal(a, b)
    for g in range(2):
        use = nsfused.twin_gap_use(k64[g], t64[g])
        assert max(use.values()) <= 1.0, (g, use)
    # a stack of three, group 0 repeated: an odd number of clusters, and
    # the two copies bit-equal to each other and to group 0 in the pair
    e0, e1 = sops.entries
    three = nsfused.nsfused_stack(
        nsfused.stack_operands([e0, e1, e0]), [0, 1, 2], [1, R - 1, 1],
        s.sigma, s.alpha, *ns_.entry_state(state, [0, 1, 0]), N_INNER)
    pair = nsfused.nsfused_stack(sops, [0, 1], [1, R - 1], s.sigma, s.alpha,
                                 w, z, y, N_INNER)
    for g, h in ((0, 2), (0, 0), (1, 1)):
        want = rows(three, h) if g != h else rows(pair, g)
        for a, b in zip(rows(three, g), want):
            assert torch.equal(a, b), (g, h)
    one = nsfused.nsfused_stack(sops, [1], [0, 0], s.sigma, s.alpha, w, z,
                                y, N_INNER)
    for a, b in zip(rows(one, 0), rows(state, 0)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="float32"):
        nsfused.nsfused_stack(sops, [0], [0, 0], s.sigma, s.alpha, w64, z64,
                              y64, N_INNER)
