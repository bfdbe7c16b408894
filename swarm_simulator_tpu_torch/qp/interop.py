"""State carried across from the JAX package.

``from_numpy`` turns the JAX package's ``QPData`` and ``NSOp`` (handed
over with numpy leaves — the port never imports the JAX package) into the
port's tensors on a given device, so one prepared operator can feed both
packages.  The JAX fused-kernel pivot layout [R, Mi, phi, B3, GW]
(``prep_pivots_grouped``: group f' occupies lanes [G f', G f' + B3) of
each GW = phi*G row, pad lanes zero) is undone back to the flat
[R, Mi, bs, bs] layout, bs = B3*phi with row index b3*phi + f.  The
zero padding of an operator prepared for the JAX streaming Thomas kernel
(``thomas_kernel=True``: ``pad_pivots`` pads both block dims to the
128-lane grid) is stripped back to bs.  A bf16 inventory
(``precond_dtype="bfloat16"``) comes across bit for bit as a
``torch.bfloat16`` tensor.  A JAX ``SpikeOp`` (the SPIKE prep
of the sharded solve) comes across as the port's
``nullspace_shard.SpikeOp``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from .assemble import QPData
from .nullspace import NSOp
from .nullspace_shard import SpikeOp


def flat_pivots(d: np.ndarray) -> np.ndarray:
    """[R, Mi, phi, B3, GW] grouped pivots -> flat [R, Mi, bs, bs]."""
    R, Mi, phi, B3, GW = d.shape
    group = GW // phi
    d = d.reshape(R, Mi, phi, B3, phi, group)[..., :B3]   # [.., f, b3, f', b3']
    return np.ascontiguousarray(
        d.transpose(0, 1, 3, 2, 5, 4)).reshape(R, Mi, B3 * phi, B3 * phi)


def from_numpy(data, op, *, device=None):
    """(QPData, NSOp or SpikeOp) on ``device`` (None = the card, raising
    without one; pass ``device="cpu"`` for the CPU) from objects carrying
    the JAX package's field names with numpy (or array-like) leaves.
    A dense-mode operator (``Kinvs``, no pivots) comes across as one."""
    device = resolve_device(device)
    data_t = QPData(**{
        f.name: (None if getattr(data, f.name, None) is None
                 else np.asarray(getattr(data, f.name)))
        for f in dataclasses.fields(QPData)}).to(device)
    if hasattr(op, "Dloc"):
        base = NSOp(**{k: None if getattr(op.base, k) is None
                       else torch.as_tensor(np.asarray(getattr(op.base, k)),
                                            device=device)
                       for k in NSOp._fields})
        return data_t, SpikeOp(base, *(
            torch.as_tensor(np.asarray(getattr(op, k)), device=device)
            for k in ("Dloc", "Ssch", "Soff")))
    leaves = {k: (None if getattr(op, k, None) is None
                  else np.asarray(getattr(op, k))) for k in NSOp._fields}
    dinv = leaves.pop("Dinvs")
    if dinv is not None:
        if dinv.ndim == 5:
            dinv = flat_pivots(dinv)
        B, K3, _ = leaves["x_pin"].shape
        bs = B * K3 * leaves["F0"].shape[1]
        if dinv.shape[-1] != bs:
            dinv = np.ascontiguousarray(dinv[..., :bs, :bs])
        dinv = _pivots(dinv, device)
    out = {k: None if v is None else torch.as_tensor(v, device=device)
           for k, v in leaves.items()}
    return data_t, NSOp(Dinvs=dinv, **out)


def _pivots(d: np.ndarray, device) -> torch.Tensor:
    """The pivot inventory as a tensor: a bf16 one (an ``ml_dtypes``
    array, recognised by its dtype's name: the port does not import
    ``ml_dtypes``) crosses as its 16-bit patterns."""
    if d.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(d).view(np.uint16)
                                ).view(torch.bfloat16).to(device)
    return torch.as_tensor(d, device=device)
