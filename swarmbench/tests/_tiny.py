"""A tiny copy of the benchmark for CPU tests: the manifest, configs,
traffic and readers copied to a temporary folder, each configuration cut
to a few agents and obstacles, and a cell added as data."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from swarmbench.manifest import HERE, ROOT, Manifest

#: a configuration's sizes for the CPU: agents, obstacles and, for the
#: Jacobi sweep, the group size (two groups, as the cell has)
SMALL = {"forest64_mc": {"n_agents": 4, "obs_num": 4},
         "swap8_mc": {"n_agents": 4, "obs_num": 20, "batch_size": 2},
         "forest64_joint": {"n_agents": 4, "obs_num": 4}}


def tiny(tmp: Path, config: str, maps: int = 2, check: int = 2,
         **keys) -> Manifest:
    """A manifest in ``tmp`` with the cell ``tiny.cell``: ``config`` cut to
    SMALL's sizes (and its top-level ``keys`` set), ``maps`` maps a batch,
    ``check`` of them judged; it reports the per-layer metrics that list
    a cell of ``config``."""
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(HERE / sub, tmp / sub)
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    small = SMALL[config]
    cfg["mission"]["n_agents"] = small["n_agents"]
    cfg["forest"]["obs_num"] = small["obs_num"]
    if "batch_size" in small:
        cfg["param"]["batch_size"] = small["batch_size"]
    cfg.update(keys)
    (tmp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (tmp / "traffic" / "tiny.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "maps_per_batch": maps,
         "blocks": [0, maps], "warmup_block": 2 * maps,
         "check_maps": check}))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny", "source": "a test",
                           "file": str(tmp / "configs" / "tiny.json"),
                           "reduced": [], "why": "a test"})
    mine = {w["name"] for w in man["workloads"] if w["config"] == config}
    for m in man["per_layer"]:
        if mine & set(m.get("workloads", ())):
            m["workloads"].append("tiny.cell")
    man["workloads"].append({"name": "tiny.cell", "config": "tiny",
                             "traffic": "tiny", "chips": 1,
                             "why": "a test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return Manifest(tmp / "BENCHMARK.json", base=tmp)
