"""The least time the card could take for a kernel's work, from the shapes
of the problem it solved and nothing the kernel reports.

The peaks are the published ones of one NVIDIA H100 SXM (80 GB HBM3) at
its 700 W limit: 3.35 TB/s of memory bandwidth and 67 TFLOP/s of float32
outside the tensor cores.  A kernel's bound is the larger of its bytes
over the bandwidth and its operations over the float32 rate.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12

#: K1's kernel as the device trace names it; the stacked form
#: (``nsfused_stack_kernel``) does not match
K1_KERNEL = "nsfused_kernel"


def k1_chunk(qn: int, M: int, pairs: int, phi: int, n: int,
             check_every: int) -> tuple[int, int]:
    """(bytes, operations) of one launch of K1 (csrc/nsfused.cu):
    ``check_every`` knot-state ADMM iterations of the joint QP of ``qn``
    agents, ``M`` segments of degree ``n``, ``pairs`` pair rows and
    ``phi`` knot derivatives.  Bytes: one rung of the pivot inventory and
    every other operand read once, the state (w, z, y) read and written
    once, four bytes an entry.  Operations a iteration: the 2 Mi - 1
    pivot matvecs of the Thomas chain, the knot-state map N and N^T, the
    pair rows A x and A^T y."""
    B3, D, Mi = 3 * qn, M * (n + 1), M - 1
    bs, nw = B3 * phi, Mi * phi
    nnz = 2 * pairs                   # each pair row: agent i's and j's
    operands = ((Mi - 1) * phi * phi          # the off-diagonal blocks
                + 2 * M * phi * phi           # ctrl -> knot state maps
                + 3 * B3 * D                  # x_pin, lower, upper bound
                + Mi * bs                     # the linear cost term
                + pairs * D + pairs * M * 3   # pair bounds and normals
                + 4 * pairs + (qn + 1) + 2 * nnz)   # pair index tables
    state = B3 * nw + 2 * B3 * D + 2 * pairs * D      # w, z, y
    nbytes = 4 * (Mi * bs * bs + operands + 2 * state)
    flops = check_every * ((2 * Mi - 1) * 2 * bs * bs
                           + 2 * 2 * B3 * D * nw
                           + 2 * 4 * pairs * 3 * D)
    return nbytes, flops


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds the card could take to move ``nbytes`` and do
    ``flops`` float32 operations."""
    return max(nbytes / HBM_BYTES_S, flops / F32_FLOPS_S)


def k1_in_trace(tr: dict) -> tuple[int, float]:
    """(launches, device seconds) of K1 inside a traced window
    (trace.summarise's ``by_name``)."""
    hits = [v for name, v in (tr.get("by_name") or {}).items()
            if K1_KERNEL in name]
    return sum(c for c, _ in hits), sum(s for _, s in hits)
