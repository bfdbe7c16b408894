"""PyTorch port, the Thomas KKT solve (ops/thomas, kernel K2) and the
pieces of the device-prep / refine path around it.

The plain twin ``thomas_solve_reference`` is held against the JAX
package's Pallas TPU kernel run in interpret mode (float32, the 2e-5
tolerance tests/test_pallas.py holds that kernel to) and against its XLA
scan (float64, 1e-10).  The device prep, the pair coupling, the host
refresh and a refine-1 schedule solve are held against the JAX package in
float64 on the CPU.  The CUDA kernel itself is compared with the twin in
tests/test_torch_cuda.py, which needs a card.
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

from test_nullspace import _data as _data_j  # noqa: E402

from swarm_simulator_tpu.ops.pallas_thomas import \
    thomas_solve_pallas  # noqa: E402
from swarm_simulator_tpu.qp import admm as admm_j  # noqa: E402
from swarm_simulator_tpu.qp import joint as joint_j  # noqa: E402
from swarm_simulator_tpu.qp import nullspace as ns_j  # noqa: E402
from swarm_simulator_tpu_torch.ops import thomas  # noqa: E402
from swarm_simulator_tpu_torch.qp import admm as admm_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import assemble as asm_t  # noqa: E402
from swarm_simulator_tpu_torch.qp import interop  # noqa: E402
from swarm_simulator_tpu_torch.qp import nullspace as ns_t  # noqa: E402

B, K3, PHI = 3, 3, 3


def _numpy(data):
    return jax.tree.map(np.asarray, data)


def _data_t(data):
    """The port's QPData on the CPU from a JAX QPData."""
    return asm_t.QPData(**{f.name: getattr(data, f.name)
                           for f in dataclasses.fields(asm_t.QPData)}
                        ).to("cpu")


def _port_settings(s):
    return ns_t.NSSettings(**{f.name: getattr(s, f.name)
                              for f in dataclasses.fields(ns_t.NSSettings)})


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _rows(rhs, M):
    """[B, K3, nw] -> knot-major rows [Mi, bs]."""
    Mi = M - 1
    return np.ascontiguousarray(
        np.asarray(rhs).reshape(B, K3, Mi, PHI).transpose(2, 0, 1, 3)
        .reshape(Mi, B * K3 * PHI))


@pytest.fixture(scope="module")
def uniform_f32():
    """The uniform-dt 3-agent M = 5 operator of tests/test_pallas.py,
    cast to float32, and one right-hand side from a numpy seed."""
    data, _ = _data_j(n_agents=B, M=5)
    op = ns_j.prepare_ns_np(_numpy(data),
                            ns_j.NSSettings(kkt_mode="banded", n_rungs=3))
    rhs = np.random.default_rng(0).standard_normal((B, K3, 4 * PHI))
    return op, rhs.astype(np.float32)


@pytest.mark.parametrize("rho_idx", [0, 1, 2])
def test_twin_matches_pallas_kernel_interpret(uniform_f32, rho_idx):
    op, rhs = uniform_f32
    M, Mi = 5, 4
    dinv = np.asarray(op.Dinvs, np.float32)
    ho = np.asarray(op.Kos, np.float32)
    assert np.allclose(ho, ho[0], atol=1e-6), "uniform dt -> constant Ho"
    koM = jnp.asarray(np.kron(np.eye(B * K3), ho[0]), jnp.float32)
    b = _rows(rhs, M)
    want = np.asarray(thomas_solve_pallas(
        jnp.asarray(dinv), koM, koM.T, jnp.asarray(b), jnp.int32(rho_idx),
        interpret=True))
    got = thomas.thomas_solve_reference(
        torch.tensor(dinv), torch.tensor(ho), torch.tensor(b), rho_idx)
    assert got.dtype == torch.float32 and got.shape == (Mi, B * K3 * PHI)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() < 2e-5 * max(scale, 1.0)


@pytest.fixture(scope="module")
def nonuniform_f64():
    data, _ = _data_j(n_agents=B, M=6, nonuniform=True)
    data = _numpy(data)
    op = ns_j.prepare_ns_np(data, ns_j.NSSettings(kkt_mode="banded"))
    assert not np.allclose(np.asarray(op.Kos), np.asarray(op.Kos)[:1])
    return data, op


@pytest.mark.parametrize("rho_idx", [0, 3, 6])
def test_twin_matches_xla_scan_float64_nonuniform(nonuniform_f64, rho_idx):
    """The per-knot Ho of non-uniform segment durations (the JAX Pallas
    kernel refuses them): the twin, through make_kinv_apply, equals the
    JAX XLA scan in float64."""
    data, op = nonuniform_f64
    M = 6
    rhs = np.random.default_rng(1).standard_normal((B, K3, (M - 1) * PHI))
    want = ns_j.make_kinv_apply(jax.tree.map(jnp.asarray, op), B, K3, M,
                                PHI)(jnp.int32(rho_idx), jnp.asarray(rhs))
    _, op_t = interop.from_numpy(data, op, device="cpu")
    got = ns_t.make_kinv_apply(op_t, B, K3, M, PHI)(rho_idx,
                                                   torch.tensor(rhs))
    assert _rel(got.numpy(), want) < 1e-10


def test_wrapper_takes_twin_only_on_cpu(uniform_f32):
    op, rhs = uniform_f32
    args = (torch.tensor(np.asarray(op.Dinvs, np.float32)),
            torch.tensor(np.asarray(op.Kos, np.float32)),
            torch.tensor(_rows(rhs, 5)))
    launches = thomas.thomas_solve.launches
    calls = thomas.thomas_solve_reference.cuda_calls
    out = thomas.thomas_solve(*args, 1)
    assert torch.equal(out, thomas.thomas_solve_reference(*args, 1))
    assert thomas.thomas_solve.launches == launches
    assert thomas.thomas_solve_reference.cuda_calls == calls
    # a tensor on neither the CPU nor a CUDA card is refused, not solved
    with pytest.raises(ValueError, match="CUDA"):
        thomas.thomas_solve(args[0], args[1], args[2].to("meta"), 1)


def _forest_f64(n_agents=8, seed=1):
    """The 8-agent forest of tests/test_torch_pipeline.py through the JAX
    package's host pipeline, assembled in float64 (numpy leaves)."""
    import swarm_simulator_tpu as sj
    from swarm_simulator_tpu.corridor.times import build_corridors
    from swarm_simulator_tpu.io.mission_json import perimeter_swap_mission
    from swarm_simulator_tpu.qp import joint
    from swarm_simulator_tpu.search.planner import plan_initial_trajectories
    from swarm_simulator_tpu.world.esdf import ESDF
    from swarm_simulator_tpu.world.forest import generate_forest

    param = sj.Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                     solver="nullspace", solver_dtype="float64")
    mission = perimeter_swap_mission(n_agents, half=4.0, z=1.0, radius=0.15)
    world = generate_forest(mission, world_min=param.world_min,
                            world_max=param.world_max, obs_num=6, r_min=0.3,
                            r_max=0.3, h_min=0.0, h_max=2.5, margin=0.5,
                            seed=seed)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)
    data, _ = joint.assemble_joint(plan, mission, param)
    return _numpy(data)


@pytest.fixture(scope="module")
def forest():
    return _forest_f64()


def test_build_coupling_matches_jax(forest):
    want = np.asarray(admm_j._build_coupling(
        jax.tree.map(jnp.asarray, forest), None))
    got = admm_t._build_coupling(_data_t(forest)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-9


@pytest.fixture(scope="module")
def device_preps(forest):
    s = dataclasses.replace(joint_j.production_settings(),
                            fused_chunk=False)
    want = ns_j.prepare_ns(jax.tree.map(jnp.asarray, forest), s)
    got = ns_t.prepare_ns(_data_t(forest), _port_settings(s))
    return want, got


@pytest.mark.parametrize("leaf", ["Dinvs", "x_pin", "g", "c_s", "Kos",
                                  "N", "ladder"])
def test_device_prep_matches_jax_float64(device_preps, leaf):
    want, got = device_preps
    a = getattr(got, leaf)
    b = np.asarray(getattr(want, leaf))
    assert isinstance(a, torch.Tensor) and a.dtype == torch.float64
    assert a.is_contiguous()     # the kernels refuse strided operands
    assert tuple(a.shape) == b.shape
    assert _rel(a.numpy(), b) < 1e-9


def test_refresh_matches_jax(forest):
    """A replan's endpoint refresh on the round-0 inventory: new start
    and goal pins (deq) give the JAX package's x_pin and g."""
    s = ns_j.NSSettings(kkt_mode="banded", n_rungs=2)
    op = ns_j.prepare_ns_np(forest, s)
    deq = np.asarray(forest.deq).copy()
    deq += 0.05 * np.random.default_rng(2).standard_normal(deq.shape)
    moved = dataclasses.replace(forest, deq=deq)
    want = ns_j.refresh_ns_op_np(op, moved)
    _, op_t = interop.from_numpy(forest, op, device="cpu")
    got = ns_t.refresh_ns_op_np(
        ns_t.NSOp(*(v.numpy() for v in op_t)), moved)
    for leaf in ("x_pin", "g"):
        assert _rel(getattr(got, leaf), getattr(want, leaf)) < 1e-9
    assert got.Dinvs is not None and np.shares_memory(got.Dinvs,
                                                      op_t.Dinvs.numpy())
    bad = dataclasses.replace(moved, dt=np.asarray(moved.dt) * 1.1)
    with pytest.raises(ValueError, match="time grid"):
        ns_t.refresh_ns_op_np(ns_t.NSOp(*(v.numpy() for v in op_t)), bad)


def test_refine_schedule_matches_jax_float64(forest):
    """A kkt_refine=1 phased solve on a device-prepped inventory (every
    w-update a PCG step against the fresh operator, three Thomas solves
    per iteration) gives the JAX schedule path's iterations and
    solution."""
    from swarm_simulator_tpu_torch.qp import joint as joint_t

    base = dataclasses.replace(joint_j.production_settings(),
                               fused_chunk=False)
    phases = tuple(dataclasses.replace(p, kkt_refine=1) for p in (
        dataclasses.replace(base, max_iter=150, rho_lo=1e-3),
        dataclasses.replace(base, max_iter=300),
        dataclasses.replace(base, max_iter=100, rho_lo=1e-2)))
    dj = jax.tree.map(jnp.asarray, forest)
    op_j = ns_j.prepare_ns(dj, phases[0])
    sched = ns_j.schedule_arrays(phases)
    xj, ij = ns_j.solve_ns_schedule(dj, op_j, *sched)

    phases_t = joint_t.production_phases(
        (150, 300, 100), base=_port_settings(base), kkt_refine=1)
    sched_t = ns_t.schedule_arrays(phases_t)
    assert sched_t[0].kkt_refine == 1
    assert all(np.array_equal(a, b) for a, b in zip(sched[1:], sched_t[1:]))
    data_t = _data_t(forest)
    op_t = ns_t.prepare_ns(data_t, phases_t[0])
    xt, it = ns_t.solve_ns_schedule(data_t, op_t, *sched_t)
    assert it.iters == int(ij.iters)
    assert _rel(xt.numpy(), xj) < 1e-9


def test_from_numpy_strips_lane_padding():
    """A JAX operator prepared for its streaming Thomas kernel carries
    pivots zero-padded to the 128-lane grid; carried across, they equal
    the unpadded prep of the same data."""
    data, _ = _data_j(n_agents=B, M=5)
    data = _numpy(data)
    padded = ns_j.prepare_ns_np(
        data, ns_j.NSSettings(kkt_mode="banded", n_rungs=3,
                              thomas_kernel=True))
    plain = ns_j.prepare_ns_np(
        data, ns_j.NSSettings(kkt_mode="banded", n_rungs=3))
    bs = B * K3 * PHI
    assert np.asarray(padded.Dinvs).shape[-1] == 128 != bs
    _, op_p = interop.from_numpy(data, padded, device="cpu")
    _, op_u = interop.from_numpy(data, plain, device="cpu")
    assert tuple(op_p.Dinvs.shape) == (3, 4, bs, bs)
    assert op_p.Dinvs.is_contiguous()
    assert torch.equal(op_p.Dinvs, op_u.Dinvs)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("bs, phi", [(45, 3), (54, 3), (72, 3), (576, 3),
                                     (640, 2), (2304, 3), (579, 3)])
def test_ring_plan_fits_and_keeps_the_16_byte_rules(bs, phi, itemsize):
    """The chain kernels' ring plans at the widths of 5, 6, 8, 64 and 256
    agents, of T2's probe and of a row off 16 bytes (B3 = 193): K1's and
    K2's (rows of 71 knots kept) and, on float32 rows, K3a's and K3b's
    (none kept).
    Each fits 227 KB with at least two slots, its slots hold a tile at
    any offset within a 16-byte line, and every tile's copy (rungs
    starting on a 16-byte line or off it by one element or 8 bytes, knots
    of an odd width falling anywhere) splits into a TMA part that starts,
    ends and lands on 16-byte boundaries and ragged edges of under 16
    bytes each."""
    Mi = 5
    plans = [(thomas.ring_plan(bs, phi, itemsize, hist_knots=71), 71)]
    if itemsize == 4:
        plans.append((thomas.chunk_plan(bs, phi), 0))
    aligned = (bs * itemsize) % 16 == 0   # the kernels' test
    for plan, hist in plans:
        rows = plan.groups * phi
        blocks, tiles = -(-bs // rows), -(-rows // plan.tile_rows)
        assert 2 <= plan.slots <= thomas.MAX_SLOTS
        assert plan.smem <= thomas.SMEM_PER_BLOCK
        assert plan.smem == (thomas.BAR_BYTES + plan.slots * plan.slot_bytes
                             + 4 * (bs + rows + hist * rows))
        assert plan.slot_bytes % 16 == 0
        assert plan.slot_bytes >= plan.tile_rows * bs * itemsize + 15
        assert plan.tile_rows == rows or \
            plan.tile_rows * bs * itemsize <= thomas.TILE_BYTES
        assert blocks <= 132      # one chain block per SM at most
        for base in (0, itemsize, 8):
            if aligned and base:
                continue   # the wrapper refuses an aligned-row rung off 16
            for blk in range(blocks):
                r0 = min(blk * rows, bs)
                r1 = min(r0 + rows, bs)
                for k in range(Mi):
                    for t in range(tiles):
                        a0 = r0 + t * plan.tile_rows
                        nr = min(plan.tile_rows, r1 - a0)
                        a = base + (k * bs * bs + a0 * bs) * itemsize
                        e = a + nr * bs * itemsize
                        lo, hi = -(-a // 16) * 16, e // 16 * 16
                        dst = lo - a // 16 * 16      # within the slot
                        if hi > lo:
                            assert (hi - lo) % 16 == 0 and dst % 16 == 0
                            assert dst + hi - lo <= plan.slot_bytes
                            assert lo - a < 16 and e - hi < 16
                            if aligned:
                                assert lo == a and hi == e
                        else:
                            assert e - a < 32
                        # the slot holds the tile at its offset in the line
                        assert a % 16 + (e - a) <= plan.slot_bytes


@pytest.mark.parametrize("bs", [576, 579, 2304])
def test_chunk_plan_owns_every_row_group_once(bs):
    """K3a's and K3b's ring plan (ops/thomas.chunk_plan) at the 64-agent
    width, rows off 16 bytes (B3 = 193) and the 256-agent width, on 132
    SMs: its blocks (one per SM at most) own every row group of a knot
    exactly once, each at least one group, and the layout csrc/thomas.cu
    carves beside the ring (the vector and the block's products) fits
    the plan's shared memory, within 227 KB, with at least two slots."""
    phi = 3
    plan = thomas.chunk_plan(bs, phi)
    B3, rows = bs // phi, plan.groups * phi
    blocks = -(-B3 // plan.groups)
    assert blocks <= 132
    owner = np.full(B3, -1)
    for c in range(blocks):
        g0, g1 = c * plan.groups, min((c + 1) * plan.groups, B3)
        assert g1 > g0 and (owner[g0:g1] == -1).all()
        owner[g0:g1] = c
    assert (owner >= 0).all()
    assert 2 <= plan.slots <= thomas.MAX_SLOTS
    carved = (thomas.BAR_BYTES + plan.slots * plan.slot_bytes
              + 4 * (bs + rows))
    assert carved == plan.smem <= thomas.SMEM_PER_BLOCK
