"""swarm_simulator_tpu_torch — the planner ported to PyTorch and CUDA.

A second package beside the JAX reference ``swarm_simulator_tpu``: the
same host pipeline (native EDT, ECBS, SFC/RSFC corridors, QP assembly,
host-f64 KKT prep, time scaling) and the joint knot-state ADMM on a torch
device, whose check_every chunks run as one hand-written CUDA kernel
(ops/nsfused) on an NVIDIA Hopper card.  It imports neither ``jax`` nor
the JAX package.
"""
__version__ = "0.1.0"

from .core.types import GridSpec, Mission, Param, PlanResult  # noqa: F401
from .pipeline import evaluate, plan  # noqa: F401
