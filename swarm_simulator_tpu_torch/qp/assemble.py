"""QP assembly: Bernstein trajectory optimization as a structured QP.

Builds the same mathematical program as RBPPlanner::buildConstMtx +
populatebyrow (rbp_planner.hpp:100-109, 551-688):

  minimize    sum_segments ctrl^T (Q_base dt^(1-2phi)) ctrl        (jerk^2)
  subject to  Aeq x = deq      start/goal state pins + C^phi continuity
              lb <= x <= ub    per-control-point SFC box bounds
              n_p . (x_j - x_i) >= r_i + r_j   per pair, per control point

but keeps every block structured (no monolithic sparse matrix).  Assembly
runs on the host in numpy (bit-equal to the JAX package's host assembly);
``QPData.to(device)`` turns every leaf into a torch tensor on one device
in a single bulk transfer.

Variable layout: x[B, 3, D] with D = M*(n+1), d = m*(n+1)+i.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core import bernstein
from ..core.types import Mission, Param, PlanResult

BIG = 1e8  # reference uses 1e7 placeholders (rbp_planner.hpp:480-481)

#: knot-face guard: a knot is BOTH the last control point of segment
#: m-1 and the first of segment m, so its duplicated rows bind to the
#: INTERSECTION of the two SFC boxes, which may have zero width.  The
#: solver layer (nullspace._bounds) pre-relaxes such rows by
#: min(tighten, KNOT_FACE_GUARD) so the tightened constraint recovers the
#: true intersection exactly; the cap keeps a relaxed interval inside the
#: union of the two obstacle-free boxes.
KNOT_FACE_GUARD = 2e-3


def relax_thin_knot_rows(lb: np.ndarray, ub: np.ndarray, n: int,
                         interior: float = 5e-4):
    """Relax zero/near-zero-width duplicated knot rows of host [B, 3, D]
    bounds by ``interior``, for barrier consumers (qp/ipm.py) that need
    strictly positive slack on every inequality.  First-order paths must
    not use this (nullspace._bounds handles thin rows tighten-aware); the
    5e-4 excursion stays under the 1e-3 acceptance-gate bound.  Returns
    new (lb, ub) copies."""
    B, K3, D = lb.shape
    npp = n + 1
    M = D // npp
    lbv = lb.reshape(B, K3, M, npp).copy()
    ubv = ub.reshape(B, K3, M, npp).copy()
    ilo = np.maximum(lbv[:, :, :-1, n], lbv[:, :, 1:, 0])
    ihi = np.minimum(ubv[:, :, :-1, n], ubv[:, :, 1:, 0])
    thin = (ihi - ilo) < 2 * KNOT_FACE_GUARD
    lbv[:, :, :-1, n] = np.where(thin, ilo - interior, lbv[:, :, :-1, n])
    lbv[:, :, 1:, 0] = np.where(thin, ilo - interior, lbv[:, :, 1:, 0])
    ubv[:, :, :-1, n] = np.where(thin, ihi + interior, ubv[:, :, :-1, n])
    ubv[:, :, 1:, 0] = np.where(thin, ihi + interior, ubv[:, :, 1:, 0])
    return lbv.reshape(B, K3, D), ubv.reshape(B, K3, D)


@dataclass(frozen=True)
class QPData:
    """One batch QP (the joint solve's batch is every agent).  Leaves are
    host numpy arrays after assembly and torch tensors after
    ``to(device)``; a stack of batch QPs (seqbatch._stack_qpdata) carries
    a leading batch axis on every leaf."""

    Qseg: object  # [M, n+1, n+1] per-segment cost blocks
    Aeq: object  # [Re, D]
    deq: object  # [B, 3, Re]
    lb: object  # [B, 3, D]
    ub: object  # [B, 3, D]
    pair_bi: object  # [P] int32, batch-local index of qi (-1 = fixed)
    pair_bj: object  # [P] int32, batch-local index of qj (-1 = fixed)
    pair_n: object  # [P, M, 3] plane normals
    pair_rhs: object  # [P, D] rhs (rsum, dummy terms folded in)
    pair_mask: object  # [P] float 0/1
    x0: object  # [B, 3, D] warm start (dummy control points)
    agents: object  # [B] int32 global agent ids
    pair_qi: object  # [P] int32 global id of qi
    pair_qj: object  # [P] int32 global id of qj
    pair_rsum: object  # [P] r_i + r_j
    dt: object = None  # [M] segment durations

    def to(self, device) -> "QPData":
        """Every leaf as a torch tensor on ``device`` (dtypes kept)."""
        return dataclasses.replace(self, **{
            f.name: (None if getattr(self, f.name) is None
                     else torch.as_tensor(getattr(self, f.name),
                                          device=device))
            for f in dataclasses.fields(self)})


def host_f64(data: QPData) -> QPData:
    """Every leaf as a host numpy array, floating leaves in float64 (the
    host oracles' input: qp/ipm, qp/activeset)."""
    def leaf(v):
        if v is None:
            return None
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        v = np.asarray(v)
        return (v.astype(np.float64, copy=False) if v.dtype.kind == "f"
                else v)
    return dataclasses.replace(data, **{
        f.name: leaf(getattr(data, f.name))
        for f in dataclasses.fields(data)})


def refresh_from_dummy(data: QPData, dummy: torch.Tensor) -> QPData:
    """Recompute the dummy-dependent pieces of a batch QP on its device.

    dummy: [N, M, n+1, 3] global control points of all agents, a tensor on
    the device of ``data``'s leaves.  Rebuilds pair_rhs (one-sided
    constraints against fixed agents, rbp_planner.hpp:645-666) and the
    warm start x0, so that a Gauss-Seidel sweep needs no host round trip.
    A padded agent (id past the last agent, seqbatch._pad_agents) takes
    the last agent's row, as the JAX package's clamped gather does.
    """
    N, M, npp, _ = dummy.shape
    D = M * npp
    dd = dummy.to(data.pair_rhs.dtype)
    # [N, 3, D]
    dd = dd.permute(0, 3, 1, 2).reshape(N, 3, D).contiguous()
    n_d = data.pair_n.repeat_interleave(npp, dim=1).permute(0, 2, 1)
    dj = dd[data.pair_qj.long().clamp(min=0)]  # [P, 3, D]
    di = dd[data.pair_qi.long().clamp(min=0)]
    ndj = (n_d * dj).sum(1)  # [P, D]
    ndi = (n_d * di).sum(1)
    j_fixed = (data.pair_bj < 0).to(ndj.dtype)[:, None]
    i_fixed = (data.pair_bi < 0).to(ndi.dtype)[:, None]
    rhs = data.pair_rsum[:, None] - j_fixed * ndj + i_fixed * ndi
    rhs = torch.where(data.pair_mask[:, None] > 0, rhs,
                      torch.full((), -BIG, dtype=rhs.dtype,
                                 device=rhs.device))
    x0 = dd[data.agents.long().clamp(max=N - 1)]  # [B, 3, D]
    return dataclasses.replace(data, pair_rhs=rhs, x0=x0)


def build_aeq(T: np.ndarray, n: int, phi: int) -> np.ndarray:
    """Per-agent equality matrix [ (M+1)*phi, M*(n+1) ].

    Rows 0..phi-1: start derivatives; phi..2phi-1: goal derivatives;
    then phi rows per interior knot for C^phi continuity
    (build_Aeq_base, rbp_planner.hpp:353-405).
    """
    M = len(T) - 1
    A0, AT = bernstein.endpoint_derivative_matrices(n)
    D = M * (n + 1)
    Re = (M + 1) * phi
    Aeq = np.zeros((Re, D), dtype=np.float64)
    dt = np.diff(T)

    nn = 1.0
    for i in range(phi):
        Aeq[i, 0:n + 1] = dt[0] ** (-i) * nn * A0[i]
        Aeq[phi + i, (n + 1) * (M - 1):] = dt[-1] ** (-i) * nn * AT[i]
        nn *= (n - i)

    for m in range(1, M):
        nn = 1.0
        for j in range(phi):
            row = 2 * phi + phi * (m - 1) + j
            Aeq[row, (n + 1) * (m - 1):(n + 1) * m] = dt[m - 1] ** (-j) * nn * AT[j]
            Aeq[row, (n + 1) * m:(n + 1) * (m + 1)] = -dt[m] ** (-j) * nn * A0[j]
            nn *= (n - j)
    return Aeq


def build_deq(mission: Mission, agents: np.ndarray, M: int, phi: int) -> np.ndarray:
    """[B, 3, (M+1)*phi] rhs: start/goal pos-vel-acc pins, zeros for
    continuity rows (build_deq, rbp_planner.hpp:408-432)."""
    B = len(agents)
    Re = (M + 1) * phi
    deq = np.zeros((B, 3, Re), dtype=np.float64)
    for b, qi in enumerate(agents):
        for k in range(3):
            for i in range(min(phi, 3)):
                deq[b, k, i] = mission.start[qi, k + 3 * i]
                deq[b, k, phi + i] = mission.goal[qi, k + 3 * i]
    return deq


def build_dummy(init_traj: np.ndarray, n: int,
                M: int | None = None) -> np.ndarray:
    """Warm-start control points from the discrete path: first half of each
    segment's control points at the segment start waypoint, second half at
    the end waypoint; segments beyond the path length sit at the last
    waypoint (build_dummy, rbp_planner.hpp:513-549 including the
    idx >= size-1 clamp).

    init_traj [N, L, 3] -> dummy [N, M, n+1, 3] (M defaults to L-1).
    """
    N, L, _ = init_traj.shape
    if M is None:
        M = L - 1
    half = (n + 1) // 2
    idx0 = np.minimum(np.arange(M), L - 1)
    idx1 = np.minimum(np.arange(M) + 1, L - 1)
    dummy = np.zeros((N, M, n + 1, 3), dtype=np.float64)
    dummy[:, :, :half, :] = init_traj[:, idx0, None, :]
    dummy[:, :, half:, :] = init_traj[:, idx1, None, :]
    return dummy


def assemble_batch(
    plan: PlanResult,
    mission: Mission,
    param: Param,
    batch_agents: np.ndarray,
    dummy: np.ndarray,  # [N, M, n+1, 3]
    pad_pairs: int | None = None,
) -> QPData:
    """Build the host QPData for one batch of agents (the joint solve
    passes every agent).

    Pairs with exactly one batch member enter as one-sided constraints
    against the fixed agent's ``dummy`` control points
    (populatebyrow, rbp_planner.hpp:638-684).  ``pad_pairs`` pads the
    pair rows with masked rows to that count, so that every batch QP of
    a sweep has the same shapes.  Float leaves are cast to
    ``param.solver_dtype``.
    """
    n, phi = param.n, param.phi
    T = np.asarray(plan.T)
    M = len(T) - 1
    D = M * (n + 1)
    dt = np.diff(T)
    batch_agents = np.asarray(batch_agents)
    B = len(batch_agents)

    Q_base = bernstein.derivative_cost_matrix(n, phi)
    Qseg = Q_base[None, :, :] * (dt ** (1 - 2 * phi))[:, None, None]

    Aeq = build_aeq(T, n, phi)
    deq = build_deq(mission, batch_agents, M, phi)

    # box bounds per control point (convex hull property); the TRUE
    # per-segment boxes — see KNOT_FACE_GUARD for the thin knot rows
    boxes = plan.seg_boxes[batch_agents]  # [B, M, 6]
    lb = np.ascontiguousarray(
        np.broadcast_to(boxes[:, :, None, 0:3], (B, M, n + 1, 3)))
    ub = np.ascontiguousarray(
        np.broadcast_to(boxes[:, :, None, 3:6], (B, M, n + 1, 3)))
    lb = lb.reshape(B, D, 3).transpose(0, 2, 1).copy()  # [B, 3, D]
    ub = ub.reshape(B, D, 3).transpose(0, 2, 1).copy()

    # pair rows: any pair with at least one batch member (vectorized over
    # the O(N^2) global pair list)
    radius = mission.radius
    pi_all = np.asarray(plan.pair_idx).reshape(-1, 2)
    gmap = np.full(dummy.shape[0], -1, dtype=np.int32)
    gmap[batch_agents] = np.arange(B, dtype=np.int32)
    if len(pi_all):
        bi_all = gmap[pi_all[:, 0]]
        bj_all = gmap[pi_all[:, 1]]
        idx = np.nonzero((bi_all >= 0) | (bj_all >= 0))[0]
    else:
        idx = np.zeros(0, dtype=int)
    P = len(idx)
    P_pad = pad_pairs if pad_pairs is not None else P
    pair_bi = np.full(P_pad, -1, dtype=np.int32)
    pair_bj = np.full(P_pad, -1, dtype=np.int32)
    pair_n = np.zeros((P_pad, M, 3), dtype=np.float64)
    pair_rhs = np.full((P_pad, D), -BIG, dtype=np.float64)
    pair_mask = np.zeros(P_pad, dtype=np.float64)
    pair_qi = np.zeros(P_pad, dtype=np.int32)
    pair_qj = np.zeros(P_pad, dtype=np.int32)
    pair_rsum = np.zeros(P_pad, dtype=np.float64)
    if P:
        qi_a = pi_all[idx, 0]
        qj_a = pi_all[idx, 1]
        bi_a = bi_all[idx]
        bj_a = bj_all[idx]
        npm_a = np.asarray(plan.pair_normals)[idx]  # [P, M, 3]
        rsum_a = np.asarray(radius)[qi_a] + np.asarray(radius)[qj_a]
        rhs_a = np.broadcast_to(rsum_a[:, None, None],
                                (P, M, n + 1)).astype(np.float64).copy()
        mj = bj_a < 0  # qj fixed: n.(dummy_j - x_i) >= rsum
        if mj.any():
            rhs_a[mj] -= np.einsum("pmk,pmik->pmi", npm_a[mj],
                                   dummy[qj_a[mj]])
        mi = bi_a < 0  # qi fixed: n.(x_j - dummy_i) >= rsum
        if mi.any():
            rhs_a[mi] += np.einsum("pmk,pmik->pmi", npm_a[mi],
                                   dummy[qi_a[mi]])
        pair_bi[:P] = bi_a
        pair_bj[:P] = bj_a
        pair_n[:P] = npm_a
        pair_rhs[:P] = rhs_a.reshape(P, D)
        pair_mask[:P] = 1.0
        pair_qi[:P] = qi_a
        pair_qj[:P] = qj_a
        pair_rsum[:P] = rsum_a

    x0 = dummy[batch_agents].reshape(B, D, 3).transpose(0, 2, 1).copy()

    dtype = np.float64 if param.solver_dtype == "float64" else np.float32
    f = lambda a: np.asarray(a, dtype=dtype)  # noqa: E731
    return QPData(
        Qseg=f(Qseg), Aeq=f(Aeq), deq=f(deq), lb=f(lb), ub=f(ub),
        pair_bi=pair_bi, pair_bj=pair_bj,
        pair_n=f(pair_n), pair_rhs=f(pair_rhs), pair_mask=f(pair_mask),
        x0=f(x0), agents=batch_agents.astype(np.int32),
        pair_qi=pair_qi, pair_qj=pair_qj,
        pair_rsum=f(pair_rsum), dt=f(dt),
    )


def export_qp_npz(path: str, data: QPData) -> None:
    """Persist one joint QP to .npz, as the reference's LP-model export
    when logging (exportModel to log/, rbp_planner.hpp:150-153): every
    QPData leaf under its field name (tensors as CPU numpy arrays), so
    np.load(path) gives the whole program back for offline inspection or
    replay through any solver."""
    arrays = {}
    for f in dataclasses.fields(data):
        v = getattr(data, f.name)
        arrays[f.name] = (v.detach().cpu().numpy()
                          if isinstance(v, torch.Tensor) else np.asarray(v))
    np.savez_compressed(path, **arrays)
