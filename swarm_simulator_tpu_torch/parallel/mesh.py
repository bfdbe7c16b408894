"""The sweeps of sequential batch planning, and the (scenario, batch) grid
of ranks that spreads them over cards.

``gauss_seidel_sweep`` solves the agent groups in order, each against the
latest dummy; ``jacobi_sweep`` solves every group of a round against the
previous round's dummy, with the ADMM or the knot-state solver.  Scenario
batching (parallel/scenarios) folds (scenario, group) into the one
leading axis of ``stacked_sweep``, each scenario's agents offset into one
stacked dummy.

The JAX module places the stacks on a (scenario, batch) device mesh; the
port runs one rank a card (parallel/distributed) and factors the ranks
the same way: ``make_mesh`` gives each rank its place in the grid and the
two sub-groups it belongs to, ``shard_stacked`` keeps a rank's own rows
of a (scenario, group) stack on its card, and ``grid_sweep`` runs the
Jacobi sweep over the grid:
  * ``scenario`` -- independent planning problems (Monte-Carlo maps): a
    row of the grid solves its own block of scenarios, and the rows'
    results are gathered to rank 0 with one collective per sweep;
  * ``batch`` -- the agent groups of sequential batch planning
    (rbp_planner.hpp:849-872): a rank solves only its groups each round,
    and the refreshed dummy is all-gathered over the row's batch
    sub-group at the end of the round, the collective form of the
    reference's dummy write-back (rbp_planner.hpp:183).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..core.device import pin_ieee_fp32, resolve_device
from ..qp import admm, assemble
from ..utils import timing
from . import distributed as pd


class RankGrid(NamedTuple):
    """A rank's place in the (scenario, batch) grid: rank r of the grid sits
    at row r // n_batch, column r % n_batch."""
    n_scenario: int
    n_batch: int
    row: int              # its block of scenarios
    col: int              # its block of agent groups
    batch_group: object   # the ranks of its row (the dummy's all-gather)
    scenario_group: object  # the ranks of its column (the rows' gather)


def factor(n: int, n_scenario: int | None = None,
           n_batch: int | None = None) -> tuple[int, int]:
    """(n_scenario, n_batch) of n ranks by the JAX package's make_mesh rule:
    neither given, the batch axis takes the first of 4, 2, 1 dividing n and
    the scenario axis the rest; one given, the other is n // it."""
    if n_scenario is None and n_batch is None:
        n_batch = next(c for c in (4, 2, 1) if n % c == 0)
        n_scenario = n // n_batch
    elif n_scenario is None:
        n_scenario = n // n_batch
    elif n_batch is None:
        n_batch = n // n_scenario
    return n_scenario, n_batch


def make_mesh(n_scenario: int | None = None, n_batch: int | None = None,
              group=None) -> RankGrid | None:
    """Factor the ranks of ``group`` (None = the default group) into a
    (scenario, batch) grid (``factor``) and return this rank's RankGrid,
    with the process groups of its row and of its column.  Every rank of
    ``group`` must call it (each row's and column's group is created on
    all of them, in one order); ranks past n_scenario * n_batch get None,
    as the JAX package's mesh leaves its trailing devices out."""
    ranks = (list(range(dist.get_world_size())) if group is None
             else dist.get_process_group_ranks(group))
    a, b = factor(len(ranks), n_scenario, n_batch)
    if a < 1 or b < 1 or a * b > len(ranks):
        raise ValueError(f"a ({a}, {b}) grid does not fit {len(ranks)} "
                         "ranks")
    me = dist.get_rank()
    rows = [dist.new_group([ranks[i * b + j] for j in range(b)])
            for i in range(a)]
    cols = [dist.new_group([ranks[i * b + j] for i in range(a)])
            for j in range(b)]
    pos = ranks.index(me)
    if pos >= a * b:
        return None
    return RankGrid(a, b, pos // b, pos % b, rows[pos // b], cols[pos % b])


def _leaves(data: assemble.QPData, fn) -> assemble.QPData:
    """``fn`` over the array leaves (numpy or tensors) of a QPData."""
    return dataclasses.replace(data, **{
        f.name: None if getattr(data, f.name) is None
        else fn(getattr(data, f.name)) for f in dataclasses.fields(data)})


def _take(data: assemble.QPData, axis: int, sl: slice) -> assemble.QPData:
    return _leaves(data, lambda x: x[(slice(None),) * axis + (sl,)])


def shard_stacked(stacked: assemble.QPData, grid: RankGrid,
                  axes: tuple[str, ...] = ("scenario", "batch"),
                  device=None) -> assemble.QPData:
    """This rank's rows of a stacked QPData whose leading axes are ``axes``
    (each "scenario" or "batch"): the grid row's block of the scenario
    axis, the grid column's block of the batch (group) axis, on ``device``
    (None = the rank's device, parallel/distributed.group_device)."""
    for i, ax in enumerate(axes):
        if ax == "scenario":
            n = stacked.lb.shape[i]
            stacked = _take(stacked, i,
                            pd.block(n, grid.row, grid.n_scenario))
        elif ax == "batch":
            n = stacked.lb.shape[i]
            stacked = _take(stacked, i, pd.block(n, grid.col, grid.n_batch))
        elif ax is not None:
            raise ValueError(f"unknown axis {ax!r}")
    return stacked.to(pd.group_device() if device is None else device)


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
    The KKT operators are built by admm._prepare_stack (``kkt_chunk``
    bounds their working set).  Padded
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
    iterated as one stack) or nullspace.NSSettings (one operator per group,
    prepared ``kkt_chunk`` groups at a time by nullspace.prepare_ns_stack,
    the groups iterated as one stack by nullspace.iterate_ns_stack, each
    stopping on its own residuals: each chunk is one launch of the stacked
    kernel (banded) or one batched product an iteration (dense) for every
    running group, where nullspace.stack_route takes a stack route).

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
                  tighten_schedule: tuple[float, ...] | None = None,
                  batch_group=None):
    """jacobi_sweep of S scenarios at once: ``stacked`` [G, ...] holds
    every scenario's groups (tensors on one device), ``scen`` [G] the
    scenario of each group and ``dummy`` [S, N, M, n+1, 3] the scenarios'
    dummies.  Each group reads and writes only its scenario's dummy (its
    agent ids offset by scen * N into the stacked [S * N] rows), and every
    group stops on its own residuals, so a scenario's result does not
    depend on what it is stacked with.

    batch_group: a process group whose ranks share the S scenarios and
    each hold their own groups of them (``stacked``, ``scen``, the same
    count on every rank); each round every rank solves its groups and the
    solutions are all-gathered over the group and written into every
    rank's dummy, so each rank ends a round with the dummy the whole stack
    would give.  Returns (ctrl [S, N, M, n+1, 3], SolveInfo of the last
    round of this rank's groups, [G])."""
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
    if batch_group is not None:
        dst = pd.all_gather_tiled(dst, batch_group)
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
        with timing.span("sweep.prepare"):
            if is_ns:
                def pick(tree, g):
                    return admm._tree_map(lambda a: a[g], tree)

                ops = nullspace.prepare_ns_stack(stacked, settings,
                                                 kkt_chunk)
                states = None
            else:
                sdatas, scals, kops = admm._prepare_stack(stacked, settings,
                                                          kkt_chunk)
                state = None
        if timing.active():
            # the stack's operands on the device: the problems and their
            # KKT operators (and, on the ADMM, the scaled copy and Scal)
            timing.count("stack.bytes", timing.storage_bytes(
                stacked, *((ops,) if is_ns else (sdatas, scals, kops))))
        for r in range(rounds):
            with timing.span("sweep.round", round=r):
                s_round = schedule(r)
                d = refresh(ext[:S * N])
                if is_ns:
                    outs = nullspace.iterate_ns_stack(
                        [pick(d, g) for g in range(G)], ops, s_round,
                        inits=states, return_state=True)
                    xs, info = nullspace.stack_solves(outs)
                    if carry_state:
                        states = [o[2] for o in outs]
                else:
                    xs, info, st = admm._iterate(
                        d, _with_refreshed(sdatas, d, scals), scals, kops,
                        s_round, init=state, return_state=True,
                        count_bytes=r == 0)
                    if carry_state:
                        state = st
                # xs [G, B, 3, D] -> control points [G * B, M, npp, 3]
                B = xs.shape[1]
                ctrl = xs.permute(0, 1, 3, 2).reshape(G * B, M, npp, 3)
                if batch_group is not None:
                    ctrl = pd.all_gather_tiled(ctrl, batch_group)
                ext = ext.clone()
                ext[dst] = ctrl.to(ext.dtype)
    return ext[:S * N].reshape(S, N, M, npp, 3), info


def grid_sweep(stacked: assemble.QPData, scen: torch.Tensor,
               dummy: torch.Tensor, settings, grid: RankGrid,
               n_scenarios: int, rounds: int = 1, **kw):
    """The Jacobi sweep of a (scenario, group) stack over the grid's
    ranks.  A rank holds its row's block of the ``n_scenarios`` scenarios
    (dummy [S_row, N, M, n+1, 3]) and its column's block of each
    scenario's groups (``stacked`` [G_rank, ...] and ``scen`` [G_rank],
    scenario indices within the row; shard_stacked's rows), every column
    the same number of groups.  Each round a rank solves its groups and
    the row's batch sub-group all-gathers the refreshed dummy
    (stacked_sweep's batch_group); after the last round the rows' dummies
    are gathered to every rank of a column (rank 0 among them) in one
    collective.  ``kw``: stacked_sweep's schedule arguments.  Returns
    (ctrl [n_scenarios, N, M, n+1, 3], SolveInfo of this rank's groups'
    last round)."""
    rows = [pd.block(n_scenarios, i, grid.n_scenario)
            for i in range(grid.n_scenario)]
    if dummy.shape[0] != rows[grid.row].stop - rows[grid.row].start:
        raise ValueError(f"row {grid.row} holds {dummy.shape[0]} scenarios, "
                         f"its block of {n_scenarios} has "
                         f"{rows[grid.row].stop - rows[grid.row].start}")
    counts = pd.all_gather_tiled(
        torch.tensor([stacked.lb.shape[0]], device=dummy.device),
        grid.batch_group)
    if bool((counts != counts[0]).any()):
        raise ValueError(f"the row's ranks hold {counts.tolist()} groups: "
                         "the batch sub-group's all-gather needs one count")
    ctrl, info = stacked_sweep(stacked, scen, dummy, settings, rounds,
                               batch_group=grid.batch_group, **kw)
    most = rows[0].stop - rows[0].start
    pad = ctrl.new_zeros((most,) + ctrl.shape[1:])
    pad[:ctrl.shape[0]] = ctrl
    every = pd.all_gather_tiled(pad, grid.scenario_group)
    return torch.cat([every[i * most:i * most + r.stop - r.start]
                      for i, r in enumerate(rows)]), info
