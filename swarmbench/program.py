"""The system under test: swarm_simulator_tpu_torch driven from a
configuration file, with the harness's spans around its public calls.

A configuration's ``entry`` names the window's entry:

- ``"monte_carlo"`` (the default): ``parallel.scenarios.run_monte_carlo``
  in two phases; ``prep_scenarios`` (host search and corridors) and
  ``solve_scenarios`` (assembly and the stacked solve) are looked up on
  the module at call time, so ``Program.traced`` wraps them there for the
  life of a run and puts everything back after it.  The wrapper also
  hands ``prep_scenarios`` the configuration's ``prep_workers``: the
  width of its thread pool, below the host's cores.
- ``"plan"``: the production per-request ``pipeline.plan``, one request
  a map, one after another: the map's forest made as ``run_monte_carlo``
  makes it, then the whole plan with the program's own solver phases.
  ``Program.traced`` wraps, for the life of a run, the module attributes
  the plan calls through: ``pipeline.ESDF`` and
  ``pipeline.plan_initial_trajectories`` (span ``search``),
  ``pipeline.build_corridors`` (``corridor``),
  ``nullspace.prepare_ns_np`` (``ns_prep``, the host inventory without
  its upload) and ``nullspace.solve_ns_phases`` (``ns_solve``); the
  forest is span ``forest`` and the plan call span ``plan``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np


class Program:
    def __init__(self, cfg: dict, device):
        import swarm_simulator_tpu_torch as port
        from swarm_simulator_tpu_torch import pipeline
        from swarm_simulator_tpu_torch.io import mission_json
        from swarm_simulator_tpu_torch.ops import nsfused
        from swarm_simulator_tpu_torch.parallel import scenarios
        from swarm_simulator_tpu_torch.qp import admm, nullspace

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
        self.entry = cfg.get("entry", "monte_carlo")
        if self.entry == "monte_carlo":
            self.settings = admm.ADMMSettings(**cfg["settings"])
            self.prep_workers = int(cfg["prep_workers"])
        elif self.entry != "plan":
            raise ValueError(f"unknown entry {self.entry!r}")
        self.forest = dict(cfg["forest"])
        self.device = device
        self.scenarios = scenarios
        self.pipeline = pipeline
        self.nullspace = nullspace
        self.nsfused = nsfused
        #: the spans of the run: (name, start, end) on the host clock
        self.spans: list[tuple[str, float, float]] = []
        #: the check_every of each phase of the plan's last solve
        self._check_every: list[int] | None = None

    def _timed(self, fn, name, **fixed):
        def inner(*a, **kw):
            kw.update(fixed)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.spans.append((name, t0, time.perf_counter()))
        return inner

    @contextlib.contextmanager
    def traced(self):
        """The harness's spans around the entry's calls (and, on the
        Monte-Carlo entry, the prep pool's width).  Plan only inside
        it."""
        if self.entry == "monte_carlo":
            wrapped = [(self.scenarios, "prep_scenarios", "prep",
                        {"max_workers": self.prep_workers}),
                       (self.scenarios, "solve_scenarios", "solve", {})]
        else:
            wrapped = [(self.pipeline, "ESDF", "search", {}),
                       (self.pipeline, "plan_initial_trajectories",
                        "search", {}),
                       (self.pipeline, "build_corridors", "corridor", {}),
                       (self.nullspace, "prepare_ns_np", "ns_prep", {}),
                       (self.nullspace, "solve_ns_phases", "ns_solve", {})]
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _
                 in wrapped]
        for (mod, attr, name, fixed), (_, _, fn) in zip(wrapped, saved):
            if attr == "solve_ns_phases":
                fn = self._noting_phases(fn)
            setattr(mod, attr, self._timed(fn, name, **fixed))
        try:
            yield self
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)

    def _noting_phases(self, fn):
        def inner(data, phases, *a, **kw):
            self._check_every = [int(p.check_every) for p in phases]
            return fn(data, phases, *a, **kw)
        return inner

    def plan(self, seed0: int, n_maps: int):
        """One batch: the maps seed0 .. seed0 + n_maps - 1, planned
        through the configuration's entry; returns their scenarios."""
        if self.entry == "monte_carlo":
            return self.scenarios.run_monte_carlo(
                self.mission, self.param, n_scenarios=n_maps, seed0=seed0,
                forest_kwargs=self.forest, settings=self.settings,
                pipeline=None, device=self.device)
        return [self._request(seed0 + i) for i in range(n_maps)]

    def _request(self, seed: int):
        """One request of the plan entry: the map of ``seed`` made with
        run_monte_carlo's generate_forest call, planned by pipeline.plan
        with the program's production phases.  Returns a Scenario whose
        ``times`` are the plan's StageTimes and, of its joint solve, the
        phases' check_every and solver_info's solve_s."""
        from swarm_simulator_tpu_torch.world.forest import generate_forest

        t0 = time.perf_counter()
        world = generate_forest(self.mission,
                                world_min=self.param.world_min,
                                world_max=self.param.world_max,
                                resolution=self.param.world_resolution,
                                seed=seed, **self.forest)
        self.spans.append(("forest", t0, time.perf_counter()))
        sc = self.scenarios.Scenario(mission=self.mission, world=world)
        self._check_every = None
        t0 = time.perf_counter()
        try:
            sc.plan, times = self.pipeline.plan(
                self.mission, self.param, world, ns_phases=None,
                device=self.device)
            sc.times = dataclasses.asdict(times)
        except Exception as e:  # a failed request is counted, not fatal
            sc.error = f"{type(e).__name__}: {e}"
            sc.times = {}
        self.spans.append(("plan", t0, time.perf_counter()))
        info = sc.plan.solver_info if sc.plan is not None else None
        sc.times["check_every"] = self._check_every
        sc.times["solve_s"] = (info or {}).get("solve_s")
        return sc

    def shape(self, sc) -> dict | None:
        """The solved problem's shape: agents, segments, pairs, phi, the
        segment degree and (the plan entry) the check_every of each phase
        of its solve."""
        if not planned(sc):
            return None
        return {"qn": int(sc.mission.qn), "M": int(sc.plan.M),
                "pairs": len(np.asarray(sc.plan.pair_idx)),
                "phi": int(self.param.phi), "n": int(self.param.n),
                "check_every": (sc.times or {}).get("check_every")}

    def k1_launches(self) -> int:
        """The port's own count of K1 launches (ops/nsfused)."""
        return self.nsfused.nsfused_chunk.launches


def planned(sc) -> bool:
    return (sc.error is None and sc.plan is not None
            and sc.plan.ctrl is not None and sc.plan.coef is not None)


def keep(sc) -> dict:
    """What the reference reads of one map, as host arrays: the world and
    mission the program planned and its plan (None where it has none).
    A plan that pipeline.plan rescaled in time (StageTimes.extra's
    ``time_scale`` other than 1) is kept as its solve gave it: the knot
    times and coefficients scaled back, the scale beside them."""
    from swarm_simulator_tpu_torch.qp import timescale

    m = sc.mission
    out = {"occ": np.asarray(sc.world.occ), "start": np.asarray(m.start),
           "goal": np.asarray(m.goal), "radius": np.asarray(m.radius),
           "plan": None}
    if planned(sc):
        p = sc.plan
        out["plan"] = {k: np.asarray(getattr(p, k)) for k in (
            "init_traj", "T", "seg_boxes", "pair_idx", "pair_normals",
            "ctrl", "coef")}
        scale = ((sc.times or {}).get("extra") or {}).get("time_scale", 1.0)
        if scale != 1.0:
            plan = out["plan"]
            plan["coef"], plan["T"] = timescale.apply_time_scale(
                plan["coef"], plan["T"], 1.0 / scale, p.coef.shape[2] - 1)
        out["time_scale"] = scale
    return out


def stacks(scs) -> list[tuple[float, float]]:
    """(assemble_s, solve_s) of each stacked solve of a batch, once a
    stack (every map of a stack carries the same pair); a plan of no
    stack adds nothing."""
    seen = {}
    for sc in scs:
        info = sc.plan.solver_info if sc.plan is not None else None
        if info and "stack" in info:
            seen[(info["M"], info["stack"], info["solve_s"])] = (
                info["assemble_s"], info["solve_s"])
    return list(seen.values())
