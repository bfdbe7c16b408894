"""The one generator every traffic mix runs through.

A mix (traffic/<mix>.json) is a closed loop of one client: batches of
``maps_per_batch`` forests planned one after another.  The maps come from
a fixed pool: ``blocks`` lists the first seeds of runs of
``maps_per_batch`` consecutive map seeds, each map of which plans
without error (screened once, when the mix was made).  A run plans the
blocks in an order drawn from its seed, one block a batch, in whole
passes (swarmbench/run.py), so that every run does the same work in
another order;
``warmup_block`` plans once during set-up.  After the window
``check_maps`` of the maps it planned, drawn from the run's seed with one
of the most segments among them, are worked out again by the reference;
every map is judged by what its plan states.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % (1 << 63))


def block_order(seed: int, mix: dict) -> list[int]:
    """The blocks' first seeds in the order a run plans them."""
    blocks = list(mix["blocks"])
    return [blocks[i] for i in _rng(seed).permutation(len(blocks))]


def batch_seed0(seed: int, k: int, mix: dict) -> int:
    """The first map seed of batch k (run_monte_carlo plans seed0 + i)."""
    order = block_order(seed, mix)
    return order[k % len(order)]


def sample(seed: int, maps: list[tuple[int, int]], count: int) -> list[int]:
    """Which of the window's maps (map seed, segments) the reference
    judges, drawn from the run's seed: a map with the most segments first
    (ties drawn), then the rest."""
    maps = sorted(set(maps))
    if not maps or count <= 0:
        return []
    order = _rng(seed + 1).permutation(len(maps))
    most = max(M for _, M in maps)
    first = next(i for i in order if maps[i][1] == most)
    rest = [i for i in order if i != first][:max(0, count - 1)]
    return [maps[first][0]] + [maps[i][0] for i in rest]
