"""PyTorch port, the sequential-batch path's host modules and CLI.

Against the JAX package on the same inputs (all host code in both):
- ``corridor/flat``: SFC boxes, sector RSFC and the rebuilt knot vector
  of the 2-agent swap and an 8-agent swap, equal;
- ``io/coef_csv``: the same bytes written, read back equal;
- ``world/btree``: a small .bt file written here (the repo holds none)
  read back to the same leaves and rasterized to the same grid;
- ``core/config``: every preset equal;
- ``io/viz``: each plot and the playback GIF written with the same bytes;
- ``utils/timing``: ProblemSize's counters and text.
The port's CLI (``python -m swarm_simulator_tpu_torch.cli.plan``) on a
mission JSON written from the in-repo 2-agent swap with ``--device cpu``:
exit 0, the JAX CLI's printed lines, ``--json`` metrics equal to the
port's library, CSVs and plots under ``--log-dir``; without a card and
without ``--device`` it raises (``--alg scp`` too, which runs with
``--device cpu``).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import swarm_simulator_tpu as sj
import swarm_simulator_tpu_torch as st

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_seqbatch import one_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]



def _swap_plan(pkg, n_agents, span):
    """A swap mission's plan up to its initial trajectories, through one
    package's host layer."""
    mj = __import__(f"{pkg.__name__}.io.mission_json", fromlist=["x"])
    esdf_m = __import__(f"{pkg.__name__}.world.esdf", fromlist=["x"])
    voxel = __import__(f"{pkg.__name__}.world.voxel", fromlist=["x"])
    search = __import__(f"{pkg.__name__}.search.planner", fromlist=["x"])
    param = pkg.Param(world_z_min=0.0, solver_dtype="float64",
                      grid_xy_res=0.5, grid_z_res=0.5, corridor_mode="flat")
    mission = mj.swap_mission(n_agents, z=0.5 if n_agents == 2 else 1.0,
                              span=span,
                              radius=0.25 if n_agents == 2 else 0.12)
    world = voxel.OccupancyGrid.empty(param.world_min, param.world_max,
                                      param.world_resolution)
    esdf = esdf_m.ESDF(world, max_dist=param.esdf_max_dist)
    plan = search.plan_initial_trajectories(esdf, mission, param,
                                            backend="python")
    return esdf, plan, mission, param


@pytest.mark.parametrize("n_agents,span", [(2, 1.0), (8, 4.0)])
def test_flat_corridors_match_jax(n_agents, span):
    from swarm_simulator_tpu.corridor.flat import build_flat_corridors as fj
    from swarm_simulator_tpu_torch.corridor.flat import \
        build_flat_corridors as ft

    out = []
    for pkg, fn in ((sj, fj), (st, ft)):
        esdf, plan, mission, param = _swap_plan(pkg, n_agents, span)
        out.append(fn(esdf, plan, mission, param))
    pj, pt = out
    assert pt.sfc == pj.sfc
    assert pt.rsfc.keys() == pj.rsfc.keys()
    for k in pj.rsfc:
        assert len(pt.rsfc[k]) == len(pj.rsfc[k])
        for (nt, tt), (nj, tj) in zip(pt.rsfc[k], pj.rsfc[k]):
            assert np.array_equal(nt, nj) and tt == tj
    for name in ("T", "pair_idx", "seg_boxes", "pair_normals"):
        assert np.array_equal(getattr(pt, name), getattr(pj, name)), name


def _coef(seed=0, N=3, M=4, n=5):
    rng = np.random.default_rng(seed)
    coef = rng.standard_normal((N, M, n + 1, 3)) * 10.0 ** rng.integers(
        -4, 3, size=(N, M, n + 1, 3))
    return coef, np.cumsum(np.r_[0.0, rng.uniform(0.5, 2.0, M)])


def test_coef_csv_same_bytes(tmp_path):
    from swarm_simulator_tpu.io import coef_csv as cj
    from swarm_simulator_tpu_torch.io import coef_csv as ct

    coef, T = _coef()
    cj.write_all(tmp_path / "j", coef, T, 5)
    ct.write_all(tmp_path / "t", coef, T, 5)
    for qi in range(coef.shape[0]):
        name = f"coef{qi + 1}.csv"
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())
        got, dur = ct.read_coef_csv(tmp_path / "t" / name)
        want, dur_j = cj.read_coef_csv(tmp_path / "j" / name)
        assert np.array_equal(got, want) and np.array_equal(dur, dur_j)
        np.testing.assert_allclose(dur, np.diff(T), rtol=1e-5)


def _node(children):
    """One octree node's 2-byte child classification: per child i,
    occupied -> bit 2i, free -> bit 2i+1, inner -> both."""
    bits = 0
    for i, c in children.items():
        code = 3 if isinstance(c, dict) else {"occ": 1, "free": 2}[c]
        bits |= code << (2 * i)
    return bytes([bits & 0xFF, bits >> 8])


def _encode(children) -> bytes:
    """Depth-first encoding of a node and its inner children, in child
    order (octomap's writeBinaryNode)."""
    out = _node(children)
    for i in sorted(children):
        if isinstance(children[i], dict):
            out += _encode(children[i])
    return out


def _write_bt(path: Path, res: float = 0.1) -> None:
    """A .bt file: child 7 (+x+y+z) of the root, then child 0 down to
    depth 13, whose children (0.4 m cubes at res 0.1 near the origin)
    mix occupied and free leaves; a free and an occupied leaf higher up
    too (the occupied one a large pruned cube far outside the world)."""
    leaf = {0: "occ", 1: "free", 3: "occ", 6: "occ", 7: "free"}
    node = leaf
    for _ in range(12):
        node = {0: node, 5: "free"}
    root = {7: node, 1: "occ", 2: "free"}
    path.write_bytes(b"# Octomap OcTree binary file\nid OcTree\nsize 99\n"
                     + f"res {res}\n".encode() + b"data\n" + _encode(root))


def test_btree_matches_jax(tmp_path):
    from swarm_simulator_tpu.world import btree as bj
    from swarm_simulator_tpu_torch.world import btree as bt

    f = tmp_path / "world.bt"
    _write_bt(f)
    lt, rt = bt.read_bt(f)
    lj, rj = bj.read_bt(f)
    assert rt == rj == 0.1
    assert np.array_equal(lt, lj)
    assert len(lt) == 4  # three 0.4 m cubes and the pruned one
    gt = bt.load_bt_world(f, [-1.0, -1.0, 0.0], [1.0, 1.0, 1.0])
    gj = bj.load_bt_world(f, [-1.0, -1.0, 0.0], [1.0, 1.0, 1.0])
    assert np.array_equal(gt.occ, gj.occ)
    assert gt.occ.sum() == 3 * 4 ** 3


def test_config_presets_match_jax():
    from swarm_simulator_tpu.core import config as cj
    from swarm_simulator_tpu_torch.core import config as ct

    assert ct.available() == cj.available()
    for name in cj.available():
        pj, pt = cj.preset(name), ct.preset(name)
        assert dataclasses.asdict(pt.param) == dataclasses.asdict(pj.param)
        for f in dataclasses.fields(pj):
            if f.name != "param":
                assert getattr(pt, f.name) == getattr(pj, f.name), f.name
    with pytest.raises(KeyError, match="unknown preset"):
        ct.preset("nope")


def test_viz_same_bytes(tmp_path):
    from swarm_simulator_tpu.io import viz as vj
    from swarm_simulator_tpu.world.voxel import OccupancyGrid
    from swarm_simulator_tpu_torch.io import viz as vt

    rng = np.random.default_rng(3)
    ts = np.linspace(0.0, 1.0, 21)
    pos = np.cumsum(rng.standard_normal((3, 21, 3)) * 0.1, axis=1)
    vel, acc = rng.standard_normal((2, 3, 21, 3))
    lim = np.full((3, 3), 1.5)
    radius = np.full(3, 0.15)
    world = OccupancyGrid.empty([-1, -1, 0], [1, 1, 1], 0.1)
    world.occ[3:5, 4:7, :] = True
    assert np.array_equal(vt.agent_colors(7), vj.agent_colors(7))
    for name, call in {
        "dyn.png": lambda v, p: v.plot_quad_dynamics(ts, vel, acc, lim, lim,
                                                     path=p),
        "safety.png": lambda v, p: v.plot_safety_margin(ts, pos, radius,
                                                        2.0, path=p),
        "top.png": lambda v, p: v.plot_trajectories_topview(
            pos, pos[:, ::5], world, path=p),
        "play.gif": lambda v, p: v.animate_swarm(ts, pos, radius, world,
                                                 path=p, fps=10),
    }.items():
        call(vj, str(tmp_path / f"j_{name}"))
        call(vt, str(tmp_path / f"t_{name}"))
        got = (tmp_path / f"t_{name}").read_bytes()
        assert got == (tmp_path / f"j_{name}").read_bytes(), name
        assert len(got) > 1000


def test_timing_matches_jax():
    from swarm_simulator_tpu.utils import timing as tj
    from swarm_simulator_tpu_torch.utils import timing as tt

    for args in ((4, 36, 5, 3, 246), (64, 36, 5, 3, 2016), (1, 7, 7, 4, 0)):
        pt, pj = tt.ProblemSize.of_batch(*args), tj.ProblemSize.of_batch(*args)
        assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
        assert str(pt) == str(pj)


def _mission_json(path: Path) -> Path:
    """The in-repo 2-agent swap (tests/test_pipeline.py's) as a mission
    JSON of the reference's schema."""
    from swarm_simulator_tpu_torch.io.mission_json import swap_mission

    m = swap_mission(2, z=0.5, span=1.0, radius=0.25)
    doc = {"quadrotors": {}, "agents": []}
    for qi, name in enumerate(m.names):
        doc["quadrotors"][name] = {"max_vel": m.max_vel[qi].tolist(),
                                   "max_acc": m.max_acc[qi].tolist()}
        doc["agents"].append({"name": name, "start": m.start[qi].tolist(),
                              "goal": m.goal[qi].tolist(),
                              "radius": float(m.radius[qi]),
                              "speed": float(m.speed[qi])})
    path.write_text(json.dumps(doc))
    return path


ARGS = ["--world-min", "-5", "-5", "0", "--grid-z-res", "0.5",
        "--dtype", "float64", "--sequential", "--batch-size", "1"]


def test_cli_json_matches_library(tmp_path, capsys):
    """``--json`` prints the metrics of the library's plan of the same
    mission and Param; ``--log-dir`` writes the CSVs and the plots."""
    from swarm_simulator_tpu_torch.cli.plan import main
    from swarm_simulator_tpu_torch.io.mission_json import load_mission

    mpath = _mission_json(tmp_path / "mission.json")
    rc = main(["--mission", str(mpath), *ARGS, "--device", "cpu", "--json",
               "--log-dir", str(tmp_path / "log")])
    assert rc == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    mission = load_mission(mpath)
    param = st.Param(grid_xy_res=0.5, grid_z_res=0.5, solver_dtype="float64",
                     sequential=True, batch_size=1, batch_iter=-1)
    result, _ = st.plan(mission, param, device="cpu")
    want = st.evaluate(result, mission, param, device="cpu")
    assert got["metrics"].keys() == want.keys()
    for k, v in want.items():
        assert got["metrics"][k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
    assert got["times"]["qp"] > 0
    for name in ("coef1.csv", "coef2.csv", "dynamics.png",
                 "safety_margin.png", "trajectories.png"):
        assert (tmp_path / "log" / name).stat().st_size > 0, name


def test_cli_module_prints_the_jax_lines(tmp_path):
    """``python -m swarm_simulator_tpu_torch.cli.plan ... --device cpu``:
    exit 0 and the JAX CLI's lines (agents/M/makespan, stage runtimes,
    one line a metric, RESULT)."""
    mpath = _mission_json(tmp_path / "mission.json")
    # one thread, as the in-process tests (one_thread)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "swarm_simulator_tpu_torch.cli.plan",
         "--mission", str(mpath), *ARGS, "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("agents=2 M=")
    assert lines[1].startswith("stage runtimes [s]: esdf=")
    assert [ln.split(":")[0].strip() for ln in lines[2:-1]] == [
        "min_safety_ratio", "flight_distance", "knot_continuity_err",
        "dynamic_violation", "start_err", "goal_err"]
    assert lines[-1] == "RESULT: collision-free"


def test_cli_needs_a_card_or_device_cpu(tmp_path, monkeypatch):
    from swarm_simulator_tpu_torch.cli.plan import main

    mpath = _mission_json(tmp_path / "mission.json")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SWARM_MISSIONS_DIR", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--mission", str(mpath), *ARGS])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--mission", str(mpath), "--alg", "scp"])
    from swarm_simulator_tpu.cli.plan import main as main_j
    scp = ["--mission", str(mpath), "--alg", "scp", "--dtype", "float64"]
    assert main([*scp, "--device", "cpu"]) == main_j(scp)
    assert main(["--preset", "rbp_test", "--device", "cpu"]) == 2
