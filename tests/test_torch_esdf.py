"""PyTorch port, the device EDT (``world/esdf.esdf_from_occupancy``, the
separable min-plus transform) and ``ESDF(backend=...)``, against the JAX
package on the CPU.

- ``esdf_from_occupancy`` on tests/test_esdf.py's grids (a random 5%
  occupancy at max_dist 10, one occupied voxel at max_dist 1) and on the
  occupancy of an in-repo 8-agent forest: float32, bit-equal to the same
  transform in numpy float32 (each square and sum rounded once, exact
  minima, numpy's correctly rounded sqrt); within one ulp of the grid's
  largest coordinate of the JAX package's jitted op (ulp(res * max
  dimension): 9.5e-7 on the forest, whose worst difference is 4.9e-7),
  because XLA's CPU code contracts the coordinate difference and the
  square-and-add into fused multiply-adds, so that its occupied voxels
  may read a few 1e-7 where this form reads 0;
- the chunked trailing axis (a pass's broadcast cut to a few columns)
  bit-equal to the unchunked one;
- ``ESDF(grid, backend="device", device="cpu")``: the distance tensor
  within tests/test_esdf.py's 1e-4 of the native EDT, and its queries on
  test_esdf.py's octomap-convention grid equal to the JAX package's
  ``ESDF``; "auto" is the native form; an unknown backend raises; without
  a card ``device=None`` raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_simulator_tpu.world import esdf as esdf_j
from swarm_simulator_tpu.world.voxel import OccupancyGrid as GridJ
from swarm_simulator_tpu_torch.world import esdf as esdf_t
from swarm_simulator_tpu_torch.world.voxel import OccupancyGrid as GridT


def _random():
    rng = np.random.default_rng(42)
    occ = rng.random((24, 20, 12)) < 0.05
    occ[0, 0, 0] = True
    return occ, 0.1, 10.0


def _single():
    occ = np.zeros((30, 30, 10), dtype=bool)
    occ[0, 0, 0] = True
    return occ, 0.1, 1.0


def _forest():
    from swarm_simulator_tpu_torch import Param
    from swarm_simulator_tpu_torch.io.mission_json import \
        perimeter_swap_mission
    from swarm_simulator_tpu_torch.world.forest import generate_forest

    param = Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0)
    mission = perimeter_swap_mission(8, half=2.0, z=1.0, radius=0.15)
    world = generate_forest(mission, world_min=param.world_min,
                            world_max=param.world_max, obs_num=6,
                            r_min=0.3, r_max=0.3, h_min=0.0, h_max=2.5,
                            margin=0.5, seed=1)
    assert world.occ.any()
    return world.occ, world.res, param.esdf_max_dist


GRIDS = {"random": _random, "single": _single, "forest8": _forest}


def _numpy_edt(occ, res, md):
    f = np.where(occ, np.float32(0), np.float32(1e12))
    for axis in range(3):
        L = f.shape[axis]
        idx = np.arange(L, dtype=np.float32) * np.float32(res)
        cost = (idx[:, None] - idx[None, :]) ** 2
        g = np.moveaxis(f, axis, 0).reshape(L, -1)
        g = np.stack([(cost + g[None, :, c]).min(axis=1)
                      for c in range(g.shape[1])], axis=1)
        f = np.moveaxis(g.reshape((L,) + np.moveaxis(f, axis, 0).shape[1:]),
                        0, axis)
    return np.minimum(np.sqrt(f), np.float32(md))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_esdf_from_occupancy_matches_numpy_and_jax(name):
    occ, res, md = GRIDS[name]()
    got = esdf_t.esdf_from_occupancy(torch.as_tensor(occ), res=res,
                                     max_dist=md)
    assert got.dtype == torch.float32 and got.shape == occ.shape
    got = got.numpy()
    assert np.array_equal(got, _numpy_edt(occ, res, md))
    assert (got[occ] == 0).all()
    want = np.asarray(esdf_j.esdf_from_occupancy(jnp.asarray(occ), res=res,
                                                 max_dist=md))
    ulp = np.spacing(np.float32(res * max(occ.shape)))
    assert np.abs(got - want).max() <= ulp


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_chunked_equals_unchunked(name):
    occ, res, md = GRIDS[name]()
    whole = esdf_t.esdf_from_occupancy(occ, res=res, max_dist=md,
                                       chunk_elems=1 << 40)
    # a few columns a chunk, ragged at the end of every pass
    small = esdf_t.esdf_from_occupancy(occ, res=res, max_dist=md,
                                       chunk_elems=3 * 30 * 30)
    assert torch.equal(whole, small)


def test_device_backend_matches_native_and_jax():
    occ, res, md = _forest()
    grid = GridT.empty([-2.5, -2.5, 0.3], [2.5, 2.5, 2.5], res)
    grid.occ[...] = occ[:grid.occ.shape[0], :grid.occ.shape[1],
                        :grid.occ.shape[2]]
    dev = esdf_t.ESDF(grid, md, backend="device", device="cpu")
    nat = esdf_t.ESDF(grid, md)
    assert dev.dist.dtype == np.float32
    np.testing.assert_allclose(dev.dist, nat.dist, atol=1e-4)
    assert np.array_equal(esdf_t.ESDF(grid, md, backend="auto").dist,
                          nat.dist)
    with pytest.raises(ValueError, match="backend"):
        esdf_t.ESDF(grid, md, backend="xla")


def test_device_backend_queries_match_jax(monkeypatch):
    gj = GridJ.empty([-1.0, -1.0, 0.0], [1.0, 1.0, 1.0], 0.1)
    gt = GridT.empty([-1.0, -1.0, 0.0], [1.0, 1.0, 1.0], 0.1)
    gj.occ[10, 10, 5] = gt.occ[10, 10, 5] = True
    pts = np.array([[0.05, 0.05, 0.55], [0.15, 0.05, 0.55],
                    [0.35, -0.45, 0.15], [5.0, 0.0, 0.0]])
    got = esdf_t.ESDF(gt, 10.0, backend="device", device="cpu").query(pts)
    want = esdf_j.ESDF(gj, 10.0).query(pts)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[0] == 0.0 and got[-1] == -1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        esdf_t.ESDF(gt, 10.0, backend="device")
