"""Segment-indexed corridor tensors.

The QP consumes corridors per *segment*: for segment m the active box /
plane is the first one whose end-time is >= T[m+1] (the time-lookup loops
in build_dlq, rbp_planner.hpp:448-452 and :485-489).  This module converts
the variable-length (box, end_time) lists into dense [N, M, 6] / [P, M, 3]
tensors so everything downstream is fixed-shape.
"""
from __future__ import annotations

import numpy as np

from ..core.types import Param, PlanResult
from ..world.esdf import ESDF
from .rsfc import build_rsfc
from .sfc import update_obs_boxes


def seg_boxes_from_sfc(sfc, T: np.ndarray) -> np.ndarray:
    """[N, M, 6] active box per segment."""
    N = len(sfc)
    M = len(T) - 1
    out = np.zeros((N, M, 6), dtype=np.float64)
    for qi in range(N):
        bi = 0
        boxes = sfc[qi]
        for m in range(M):
            while bi < len(boxes) and boxes[bi][1] < T[m + 1]:
                bi += 1
            out[qi, m] = boxes[min(bi, len(boxes) - 1)][0]
    return out


def build_corridors(esdf: ESDF, plan: PlanResult, radius: np.ndarray,
                    param: Param, device=None) -> PlanResult:
    """Fill plan.sfc / rsfc / seg_boxes / pair_normals / pair_idx in place;
    a large swarm's RSFC planes are computed on ``device`` (build_rsfc)."""
    plan.sfc = update_obs_boxes(esdf, plan, radius, param)
    plan.seg_boxes = seg_boxes_from_sfc(plan.sfc, plan.T)

    pair_idx, normals = build_rsfc(plan.init_traj, param.downwash, device)
    plan.pair_idx = pair_idx
    plan.pair_normals = np.asarray(normals, dtype=np.float64)
    # raw (normal, end_time) list form for parity with RSFC_t — a debug/
    # parity view fully derivable from pair_normals + T, so it is only
    # materialized at small scale (building 2.3M python tuples for a
    # 256-agent problem measured 35 s, dominating corridor time)
    M = plan.M
    if len(pair_idx) * M <= 200_000:
        plan.rsfc = {}
        for p, (qi, qj) in enumerate(pair_idx):
            plan.rsfc[(int(qi), int(qj))] = [
                (plan.pair_normals[p, m], float(plan.T[m + 1]))
                for m in range(M)
            ]
    return plan
