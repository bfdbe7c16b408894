"""PyTorch port, the benchmark sweep CLI over stored worlds
(``python -m swarm_simulator_tpu_torch.cli.sweep``), against the JAX
package's sweep CLI on the CPU in float64.

Two seeded 8-agent forests are written as .bt files with the port's
``world/btree.write_bt`` (read back by both packages' importers to the
forest's own grid), with the 8-agent swap as a mission JSON.  The port's
sweep (sequential batches of 4) with ``--device cpu`` gives the JAX CLI's
rows (map, ok, ratio), its error row for a map the mission cannot fly (a
third .bt file), and its ``# success`` line; without a card and without
``--device`` it raises.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_seqbatch import one_thread  # noqa: E402,F401

from swarm_simulator_tpu.world import btree as bt_j  # noqa: E402
from swarm_simulator_tpu_torch.core.types import Param  # noqa: E402
from swarm_simulator_tpu_torch.io.mission_json import \
    swap_mission  # noqa: E402
from swarm_simulator_tpu_torch.world import btree as bt_t  # noqa: E402
from swarm_simulator_tpu_torch.world.forest import generate_forest  # noqa: E402


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """map1.bt and map2.bt (forest seeds 0 and 1 around the 8-agent
    swap), map3.bt (a wall through the swap's start row), and the
    mission JSON."""
    d = tmp_path_factory.mktemp("worlds")
    m = swap_mission(8, z=1.0, span=4.0, radius=0.12)
    p = Param()
    for i, seed in enumerate((0, 1)):
        w = generate_forest(m, world_min=p.world_min, world_max=p.world_max,
                            obs_num=6, r_min=0.3, r_max=0.3, h_min=0.0,
                            h_max=2.5, margin=0.5, seed=seed)
        bt_t.write_bt(d / f"map{i + 1}.bt", w)
        for mod in (bt_t, bt_j):
            back = mod.load_bt_world(d / f"map{i + 1}.bt", p.world_min,
                                     p.world_max)
            assert np.array_equal(back.occ, w.occ)
    wall = generate_forest(m, world_min=p.world_min, world_max=p.world_max,
                           obs_num=0)
    ix = wall.point_to_index(m.start[:1, :3])[0]
    wall.occ[:, :, :] = False
    wall.occ[ix[0], :, :] = True
    bt_t.write_bt(d / "map3.bt", wall)
    doc = {"quadrotors": {}, "agents": []}
    for qi, name in enumerate(m.names):
        doc["quadrotors"][name] = {"max_vel": m.max_vel[qi].tolist(),
                                   "max_acc": m.max_acc[qi].tolist()}
        doc["agents"].append({"name": name, "start": m.start[qi].tolist(),
                              "goal": m.goal[qi].tolist(),
                              "radius": float(m.radius[qi]),
                              "speed": float(m.speed[qi])})
    mission = d / "mission.json"
    mission.write_text(json.dumps(doc))
    return d, mission


def _rows(out):
    lines = out.strip().splitlines()
    return [json.loads(ln) for ln in lines[:-1]], lines[-1]


def test_sweep_matches_jax_cli(worlds, capsys):
    from swarm_simulator_tpu.cli.sweep import main as main_j
    from swarm_simulator_tpu_torch.cli.sweep import main as main_t

    d, mission = worlds
    args = ["--mission", str(mission), "--worlds-dir", str(d), "--maps",
            "1-4", "--dtype", "float64", "--sequential", "--json"]
    assert main_j(args) == 0
    rows_j, last_j = _rows(capsys.readouterr().out)
    assert main_t([*args, "--device", "cpu"]) == 0
    rows_t, last_t = _rows(capsys.readouterr().out)
    assert last_t == last_j
    assert [r["map"] for r in rows_t] == [r["map"] for r in rows_j] == [
        1, 2, 3]
    for a, b in zip(rows_t, rows_j):
        assert a["ok"] == b["ok"]
        assert ("error" in a) == ("error" in b)
        if "error" in b:
            assert a["error"] == b["error"]
        else:
            assert a["ratio"] == b["ratio"]
    assert sum(r["ok"] for r in rows_t) == 2
    assert last_t == "# success 2/3"


def test_sweep_without_a_card_raises(worlds, monkeypatch):
    from swarm_simulator_tpu_torch.cli.sweep import main

    d, mission = worlds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--mission", str(mission), "--worlds-dir", str(d)])
