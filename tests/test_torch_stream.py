"""PyTorch port, T4 (the pivot-stream study): the plain version of
ops/thomas_stream against the JAX package's Pallas kernel
(tools/thomas_bw_study.py::make_dma_kernel) run in interpret mode, on the
same seeded inventory: every variant (2 or 4 slots, whole or split
copies) and both rungs, rel 1e-5 of the result's scale (float32 sums of
the same rows in another order).  The wrapper routes CPU tensors to the
plain version; the CUDA kernel itself is held against it in
tests/test_torch_cuda.py, which needs a card.
"""
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from swarm_simulator_tpu_torch.ops import thomas_stream as ts

REPO = Path(__file__).resolve().parents[1]
R, MI, BS = 2, 5, 64


@pytest.fixture(scope="module")
def study():
    spec = importlib.util.spec_from_file_location(
        "jax_thomas_bw_study", REPO / "tools" / "thomas_bw_study.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inventory():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((R, MI, BS, BS)) * 0.01).astype(np.float32)


@pytest.mark.parametrize("rho_idx", [0, 1])
@pytest.mark.parametrize("variant", sorted(ts.VARIANTS))
def test_plain_matches_pallas_dma_kernel(study, inventory, monkeypatch,
                                         variant, rho_idx):
    slots, split = ts.VARIANTS[variant]
    monkeypatch.setattr(pallas, "pallas_call", functools.partial(
        pallas.pallas_call, interpret=True))
    run = study.make_dma_kernel(MI, BS, slots, split)
    want = np.asarray(run(jnp.asarray(inventory), rho_idx))
    assert want.shape == (1, BS)
    got = ts.thomas_stream(torch.from_numpy(inventory), rho_idx, slots,
                           split)
    assert got.dtype == torch.float32 and got.shape == (BS,)
    assert np.abs(got.numpy() - want[0]).max() <= \
        1e-5 * np.abs(want).max()


def test_wrapper_takes_plain_version_only_on_cpu(inventory):
    dinv = torch.from_numpy(inventory)
    launches = ts.thomas_stream.launches
    out = ts.thomas_stream(dinv.to(torch.bfloat16), 1, 4, True)
    assert torch.equal(out, ts.thomas_stream_reference(
        dinv.to(torch.bfloat16), 1))
    assert ts.thomas_stream.launches == launches
    with pytest.raises(ValueError, match="CUDA"):
        ts.thomas_stream(dinv.to("meta"), 0)
