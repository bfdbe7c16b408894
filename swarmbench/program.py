"""The system under test: swarm_simulator_tpu_torch driven from a
configuration file, with the harness's spans around its public calls.

The window's entry is ``parallel.scenarios.run_monte_carlo`` in two
phases; ``prep_scenarios`` (host search and corridors) and
``solve_scenarios`` (assembly and the stacked solve) are looked up on
the module at call time, so ``Program.traced`` wraps them there for the
life of a run and puts everything back after it.  The wrapper also hands
``prep_scenarios`` the configuration's ``prep_workers``: the width of its
thread pool, below the host's cores.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np


class Program:
    def __init__(self, cfg: dict, device):
        import swarm_simulator_tpu_torch as port
        from swarm_simulator_tpu_torch.io import mission_json
        from swarm_simulator_tpu_torch.parallel import scenarios
        from swarm_simulator_tpu_torch.qp import admm

        spec = dict(cfg["mission"])
        kind = spec.pop("kind")
        if kind == "perimeter_swap":
            self.mission = mission_json.perimeter_swap_mission(
                spec.pop("n_agents"), **spec)
        elif kind == "antipodal_swap":
            self.mission = mission_json.swap_mission(spec.pop("n_agents"),
                                                     **spec)
        else:
            raise ValueError(f"unknown mission kind {kind!r}")
        self.param = port.Param(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg["param"].items()})
        self.settings = admm.ADMMSettings(**cfg["settings"])
        self.forest = dict(cfg["forest"])
        self.prep_workers = int(cfg["prep_workers"])
        self.device = device
        self.scenarios = scenarios
        #: the spans of the run: (name, start, end) on the host clock
        self.spans: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def traced(self):
        """The harness's spans around prep_scenarios and solve_scenarios,
        and the prep pool's width.  Plan only inside it."""
        scn = self.scenarios
        saved = scn.prep_scenarios, scn.solve_scenarios

        def wrap(fn, name, **fixed):
            def inner(*a, **kw):
                kw.update(fixed)
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.spans.append((name, t0, time.perf_counter()))
            return inner

        scn.prep_scenarios = wrap(saved[0], "prep",
                                  max_workers=self.prep_workers)
        scn.solve_scenarios = wrap(saved[1], "solve")
        try:
            yield self
        finally:
            scn.prep_scenarios, scn.solve_scenarios = saved

    def plan(self, seed0: int, n_maps: int):
        """One batch: the maps seed0 .. seed0 + n_maps - 1 planned through
        run_monte_carlo in two phases; returns its scenarios."""
        return self.scenarios.run_monte_carlo(
            self.mission, self.param, n_scenarios=n_maps, seed0=seed0,
            forest_kwargs=self.forest, settings=self.settings,
            pipeline=None, device=self.device)


def planned(sc) -> bool:
    return (sc.error is None and sc.plan is not None
            and sc.plan.ctrl is not None and sc.plan.coef is not None)


def keep(sc) -> dict:
    """What the reference reads of one map, as host arrays: the world and
    mission the program planned and its plan (None where it has none)."""
    m = sc.mission
    out = {"occ": np.asarray(sc.world.occ), "start": np.asarray(m.start),
           "goal": np.asarray(m.goal), "radius": np.asarray(m.radius),
           "plan": None}
    if planned(sc):
        p = sc.plan
        out["plan"] = {k: np.asarray(getattr(p, k)) for k in (
            "init_traj", "T", "seg_boxes", "pair_idx", "pair_normals",
            "ctrl", "coef")}
    return out


def stacks(scs) -> list[tuple[float, float]]:
    """(assemble_s, solve_s) of each stacked solve of a batch, once a
    stack (every map of a stack carries the same pair)."""
    seen = {}
    for sc in scs:
        info = sc.plan.solver_info if sc.plan is not None else None
        if info:
            seen[(info["M"], info["stack"], info["solve_s"])] = (
                info["assemble_s"], info["solve_s"])
    return list(seen.values())
