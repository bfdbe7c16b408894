"""Where the port's entry points run: the card, unless the caller asks
for the CPU (``device="cpu"``).  Shared by ``pipeline.plan``/``evaluate``,
``qp/joint.solve_trajectories``, ``parallel/seqbatch.solve_trajectories``,
``qp/admm.solve_qp``/``solve_qp_batched``, ``qp/interop.from_numpy`` and
the ``eval`` functions (``gate_quality``, ``sample_trajectories`` and the
safety metrics); and the float32 precision every solve on the card pins."""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The card: the port's entry points run on CUDA unless the caller
    asks for the CPU (``device="cpu"``)."""
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device, None meaning the card; raises when a
    CUDA device is asked for (or implied) and no card is available."""
    device = default_device() if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested (device=None means the card) but "
            "no CUDA card is available; pass device='cpu' to run on the CPU")
    return device


def pin_ieee_fp32() -> None:
    """Full-precision float32 products on the card, as the JAX package's
    "highest" matmul precision: the KKT inverses have condition numbers
    near 1/rho_min, and TF32's ~10-bit mantissa wrecks them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
