"""BENCHMARK.json keeps its rules, and every file it names is there."""
import json

import pytest

from swarmbench.manifest import HERE, ROOT, Manifest, problems
from swarmbench.reference import check

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keeps_its_rules():
    assert problems(DOC) == []


def test_every_per_layer_metric_lists_its_cells():
    """A per-layer metric without a list would be owed by every cell a
    later PR adds."""
    cells = {w["name"] for w in DOC["workloads"]}
    for m in DOC["per_layer"]:
        assert m.get("workloads") and set(m["workloads"]) <= cells, m


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= DOC["run_seconds"] <= 51
    assert DOC["paths"] == ["swarmbench"]
    for m in DOC["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in DOC["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", "", "x" * 65, "ü"])
def test_problems_refuses_a_bad_name(bad):
    doc = json.loads(json.dumps(DOC))
    doc["workloads"][0]["name"] = bad
    assert problems(doc)


@pytest.mark.parametrize("bad", ["tokens per second", "", "µs",
                                 "x" * 17])
def test_problems_refuses_a_bad_unit(bad):
    doc = json.loads(json.dumps(DOC))
    doc["end_to_end"][1]["unit"] = bad
    assert problems(doc)


def test_problems_refuses_a_metric_whose_cells_miss_its_target():
    doc = json.loads(json.dumps(DOC))
    doc["end_to_end"][1]["workloads"] = [doc["workloads"][0]["name"]]
    assert any("do not report" in p for p in problems(doc))


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_every_cell_finds_its_files(cell):
    man = Manifest()
    w = man.cell(cell)
    cfg = man.config(w["config"])
    mix = man.traffic(w["traffic"])
    assert {"mission", "forest", "param", "settings", "env",
            "limits", "precision", "source"} <= set(cfg)
    assert len(cfg["source"]) <= 200
    assert set(cfg["limits"]) <= set(check.NUMBERS)
    assert {"maps_unplanned", "inputs_differ", "corridor_differ"} \
        <= set(cfg["limits"])
    assert cfg["env"]["OPENBLAS_NUM_THREADS"] == "1"
    assert mix["maps_per_batch"] > 0 and mix["check_maps"] > 0
    for m in man.metrics(cell, "per_layer"):
        assert callable(man.reader(m["name"]))
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def test_configs_write_out_the_solver_settings_in_full():
    """Every Param field; the Monte-Carlo entry's ADMM settings in full;
    the plan entry's none, as it runs the program's own production
    phases, which its file writes out field by field: a change to them
    fails here, since the limits were set for these tolerances."""
    from swarm_simulator_tpu_torch.core.types import Param
    from swarm_simulator_tpu_torch.qp import joint
    from swarm_simulator_tpu_torch.qp.admm import ADMMSettings
    import dataclasses

    for c in DOC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(cfg["param"]) == {f.name for f in
                                     dataclasses.fields(Param)}
        if cfg.get("entry", "monte_carlo") == "plan":
            assert cfg["settings"] is None
            assert cfg["phases"]["each"] == [
                dataclasses.asdict(p) for p in joint.production_phases()]
            assert cfg["param"]["polish_rounds"] is None
            assert cfg["phases"]["polish_rounds"] == \
                joint.polish_rounds_for_swarm(cfg["mission"]["n_agents"])
        else:
            assert set(cfg["settings"]) == {f.name for f in
                                            dataclasses.fields(ADMMSettings)}
        assert cfg["reduced"] == c["reduced"]
