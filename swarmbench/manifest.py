"""BENCHMARK.json and the files it names: lookup by name, and the rules a
manifest keeps."""
from __future__ import annotations

import json
import re
from pathlib import Path

#: the checkout's root: BENCHMARK.json sits here, beside this package
ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Manifest:
    def __init__(self, path: Path | None = None, base: Path | None = None):
        self.path = Path(path) if path else ROOT / "BENCHMARK.json"
        self.doc = json.loads(self.path.read_text())
        #: where configs/, traffic/ and metrics/ are looked up
        self.base = Path(base) if base else HERE

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.path.parent / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in {self.path}")

    def traffic(self, name: str) -> dict:
        return json.loads((self.base / "traffic" / f"{name}.json")
                          .read_text())

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
        return [m for m in self.doc[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        """The ``read(record)`` function of metrics/<metric>.py."""
        import importlib.util

        path = self.base / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"swarmbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def problems(doc: dict) -> list[str]:
    """What in a manifest breaks the rules its later editions keep (names,
    units, directions, each per-layer metric's end-to-end metric reported
    in every cell it lists)."""
    out = []
    names = ([c["name"] for c in doc["configs"]]
             + [w["name"] for w in doc["workloads"]]
             + [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
             + [w["config"] for w in doc["workloads"]]
             + [w["traffic"] for w in doc["workloads"]]
             + [k for c in doc["configs"] for k in c["reduced"]])
    out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
    for kind in ("configs", "workloads"):
        seen = [x["name"] for x in doc[kind]]
        out += [f"duplicate {kind} name {n!r}" for n in set(seen)
                if seen.count(n) > 1]
    metrics = doc["end_to_end"] + doc["per_layer"]
    seen = [m["name"] for m in metrics]
    out += [f"duplicate metric {n!r}" for n in set(seen)
            if seen.count(n) > 1]
    cells = {w["name"] for w in doc["workloads"]}
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    for m in metrics:
        if not UNIT.match(m["unit"]):
            out.append(f"bad unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"bad direction of {m['name']}")
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"{m['name']} lists an unknown cell {c!r}")
    for m in doc["per_layer"]:
        target = e2e.get(m["moves"])
        if target is None:
            out.append(f"{m['name']} moves an unknown metric {m['moves']!r}")
            continue
        mine = set(m.get("workloads", cells))
        theirs = set(target.get("workloads", cells))
        if not mine <= theirs:
            out.append(f"{m['name']} lists cells that do not report "
                       f"{m['moves']}: {sorted(mine - theirs)}")
    for w in doc["workloads"]:
        if w["config"] not in {c["name"] for c in doc["configs"]}:
            out.append(f"{w['name']} names an unknown config")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']} asks for {w['chips']} chips")
        reports = [m for m in doc["end_to_end"]
                   if w["name"] in m.get("workloads", cells)]
        if "setup_s" not in {m["name"] for m in reports} or len(reports) < 2:
            out.append(f"{w['name']} reports too few end-to-end metrics")
        if not any(w["name"] in m.get("workloads", cells)
                   for m in doc["per_layer"]):
            out.append(f"{w['name']} reports no per-layer metric")
    pairs = [(w["config"], w["traffic"]) for w in doc["workloads"]]
    out += [f"config and traffic {p} twice" for p in set(pairs)
            if pairs.count(p) > 1]
    return out
