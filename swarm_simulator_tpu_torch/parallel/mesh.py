"""The sweeps of sequential batch planning on one device.

``gauss_seidel_sweep`` solves the agent groups in order, each against the
latest dummy; ``jacobi_sweep`` solves every group of a round against the
previous round's dummy, with the ADMM or the knot-state solver.  Scenario
batching (parallel/scenarios) folds (scenario, group) into the one
leading axis of ``stacked_sweep``, each scenario's agents offset into one
stacked dummy.  The JAX module also places the stacks on a (scenario,
batch) device mesh (``make_mesh``, ``shard_stacked``); the port runs on
one card.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.device import pin_ieee_fp32, resolve_device
from ..qp import admm, assemble


def _with_refreshed(sd: assemble.QPData, d: assemble.QPData, scal):
    """The equilibrated problem ``sd`` with the coupling rhs and warm start
    of the refreshed problem ``d``, rescaled by ``scal`` (None: unscaled);
    leading stack axes, if any, on every leaf."""
    if scal is None:
        return dataclasses.replace(sd, pair_rhs=d.pair_rhs, x0=d.x0)
    rhs = torch.where(d.pair_mask[..., None] > 0, d.pair_rhs * scal.pair_row,
                      torch.full((), -assemble.BIG, dtype=d.pair_rhs.dtype,
                                 device=d.pair_rhs.device))
    return dataclasses.replace(sd, pair_rhs=rhs,
                               x0=d.x0 / scal.d[..., None, None, :])


def gauss_seidel_sweep(stacked: assemble.QPData, dummy: torch.Tensor,
                       settings: admm.ADMMSettings,
                       rounds: int = 1, kkt_chunk: int = 4):
    """The reference's sequential batch planning with the dummy control
    points kept on the device: each batch refreshes its coupling rhs from
    the current dummy, solves, and writes its solution back — exactly the
    Gauss-Seidel semantics of rbp_planner.hpp:140-204, with no host round
    trip between batches.

    stacked: the batch QPs on one device, a leading batch axis on every
    leaf (seqbatch._stack_qpdata); dummy [N, M, n+1, 3] on that device.
    The KKT operators are built ``kkt_chunk`` batches at a time.  Padded
    agents (id >= N) are solved but never written back.
    Returns (dummy [N, M, n+1, 3], SolveInfo of the last round, [L]).
    """
    N, M, npp, _ = dummy.shape
    if dummy.is_cuda:
        pin_ieee_fp32()
    sdatas, scals, ops = admm._prepare_stack(stacked, settings, kkt_chunk)
    # one spare row takes the padded agents' writes (the JAX package's
    # mode="drop" scatter)
    ext = torch.cat([dummy, dummy.new_zeros((1,) + dummy.shape[1:])])
    dummy = ext[:N]
    L = stacked.lb.shape[0]
    for _ in range(rounds):
        infos = []
        for i in range(L):
            def pick(tree):
                return admm._tree_map(lambda a: a[i], tree)

            data_l, sd, scal, op = (pick(stacked), pick(sdatas),
                                    pick(scals), pick(ops))
            d = assemble.refresh_from_dummy(data_l, dummy)
            sd = _with_refreshed(sd, d, scal)
            x, info = admm._iterate(
                *(admm._tree_map(lambda a: a[None], t)
                  for t in (d, sd, scal, op)), settings)
            B = x.shape[1]
            ctrl = x[0].permute(0, 2, 1).reshape(B, M, npp, 3)
            ext[data_l.agents.long().clamp(max=N)] = ctrl.to(ext.dtype)
            infos.append(info)
    return dummy, admm._tree_map(lambda *v: torch.cat(v), *infos)


def jacobi_sweep(stacked: assemble.QPData, dummy, settings,
                 rounds: int = 1, kkt_chunk: int = 4,
                 iters_schedule: tuple[int, ...] | None = None,
                 carry_state: bool = False,
                 tighten_schedule: tuple[float, ...] | None = None,
                 device=None):
    """Jacobi sequential-batch planning on ``device`` (None = the card;
    raises without one: pass ``device="cpu"`` for the CPU).

    stacked: QPData with a leading group axis [L] on every leaf (host
    numpy or tensors); dummy: [N, M, n+1, 3] global control points.  Each
    round refreshes every group's coupling rhs from the previous round's
    dummy, solves all groups, and writes their solutions back (padded
    agents dropped).  ``settings`` picks the solver: admm.ADMMSettings
    (the groups' KKT operators and equilibration prepared once, every
    round rescaling the refreshed rhs and warm-starting x0, the groups
    iterated as one stack) or nullspace.NSSettings (one operator per group
    by prepare_ns, each group solved alone: in banded mode each chunk is
    one launch of the fused kernel K1 a group).

    iters_schedule: per-round max_iter, one entry a round.  carry_state
    (needs iters_schedule): carry each group's solver state (x, z, y in
    the scaled space, or the knot-state (w, z, y, rho_idx)) across
    rounds.  tighten_schedule (knot-state solver and iters_schedule):
    per-round constraint tightening.

    Returns (ctrl [N, M, n+1, 3], SolveInfo of the last round, [L])."""
    device = resolve_device(device)
    dummy = torch.as_tensor(dummy, device=device)
    stacked = stacked.to(device)
    scen = torch.zeros(stacked.lb.shape[0], dtype=torch.long, device=device)
    ctrl, info = stacked_sweep(stacked, scen, dummy[None], settings, rounds,
                               kkt_chunk, iters_schedule, carry_state,
                               tighten_schedule)
    return ctrl[0], info


def stacked_sweep(stacked: assemble.QPData, scen: torch.Tensor,
                  dummy: torch.Tensor, settings, rounds: int = 1,
                  kkt_chunk: int = 4,
                  iters_schedule: tuple[int, ...] | None = None,
                  carry_state: bool = False,
                  tighten_schedule: tuple[float, ...] | None = None):
    """jacobi_sweep of S scenarios at once: ``stacked`` [G, ...] holds
    every scenario's groups (tensors on one device), ``scen`` [G] the
    scenario of each group and ``dummy`` [S, N, M, n+1, 3] the scenarios'
    dummies.  Each group reads and writes only its scenario's dummy (its
    agent ids offset by scen * N into the stacked [S * N] rows), and every
    group stops on its own residuals, so a scenario's result does not
    depend on what it is stacked with.  Returns (ctrl [S, N, M, n+1, 3],
    SolveInfo of the last round, [G])."""
    from ..qp import nullspace

    S, N, M, npp, _ = dummy.shape
    if iters_schedule is not None and len(iters_schedule) != rounds:
        raise ValueError(
            f"iters_schedule has {len(iters_schedule)} entries for "
            f"{rounds} rounds")
    if carry_state and iters_schedule is None:
        raise ValueError("carry_state requires iters_schedule")
    is_ns = isinstance(settings, nullspace.NSSettings)
    if iters_schedule is not None and tighten_schedule is not None and (
            not is_ns or len(tighten_schedule) != rounds):
        raise ValueError("tighten_schedule needs the knot-state solver and "
                         "one entry per round")
    if dummy.is_cuda:
        pin_ieee_fp32()

    G = stacked.lb.shape[0]
    off = (scen * N)[:, None]
    agents = stacked.agents.long()
    # the refresh reads the stacked dummy rows of each group's scenario
    # (a padded agent, id >= N, its scenario's last agent, as the JAX
    # package's per-scenario clamped gather); the write-back drops
    # padded agents into one spare row
    ids = dataclasses.replace(
        stacked, pair_qi=stacked.pair_qi.long() + off,
        pair_qj=stacked.pair_qj.long() + off,
        agents=agents.clamp(max=N - 1) + off)
    dst = torch.where(agents < N, agents + off,
                      torch.full_like(agents, S * N)).reshape(-1)
    ext = torch.cat([dummy.reshape(S * N, M, npp, 3),
                     dummy.new_zeros((1, M, npp, 3))])

    def schedule(r):
        s = settings
        if iters_schedule is not None:
            s = dataclasses.replace(s, max_iter=iters_schedule[r])
            if tighten_schedule is not None:
                s = dataclasses.replace(s, tighten=tighten_schedule[r])
        return s

    def refresh(dm):
        fresh = assemble.refresh_from_dummy(ids, dm)
        return dataclasses.replace(stacked, pair_rhs=fresh.pair_rhs,
                                   x0=fresh.x0)

    with torch.no_grad():
        if is_ns:
            def pick(tree, g):
                return admm._tree_map(lambda a: a[g], tree)

            ops = [nullspace.prepare_ns(pick(stacked, g), settings)
                   for g in range(G)]
            states = [None] * G
        else:
            sdatas, scals, kops = admm._prepare_stack(stacked, settings,
                                                      kkt_chunk)
            state = None
        for r in range(rounds):
            s_round = schedule(r)
            d = refresh(ext[:S * N])
            if is_ns:
                outs = [nullspace._iterate_ns(
                    pick(d, g), ops[g], s_round, init=states[g],
                    return_state=True) for g in range(G)]
                xs, info = nullspace.stack_solves(outs)
                if carry_state:
                    states = [o[2] for o in outs]
            else:
                xs, info, st = admm._iterate(
                    d, _with_refreshed(sdatas, d, scals), scals, kops,
                    s_round, init=state, return_state=True)
                if carry_state:
                    state = st
            # xs [G, B, 3, D] -> control points [G * B, M, npp, 3]
            B = xs.shape[1]
            ctrl = xs.permute(0, 1, 3, 2).reshape(G * B, M, npp, 3)
            ext = ext.clone()
            ext[dst] = ctrl.to(ext.dtype)
    return ext[:S * N].reshape(S, N, M, npp, 3), info
