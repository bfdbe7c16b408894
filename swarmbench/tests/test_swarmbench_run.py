"""A run of the harness on the CPU at a tiny size: a cell added as data is
found, each traffic mix's logic goes through the reference, the faults a
cell can have make ``correct`` false, and the runner and the reference
load nothing they must not."""
import ast
import json
import subprocess
import sys

import pytest
import torch

from _tiny import tiny
from swarmbench import run
from swarmbench.manifest import HERE, ROOT

CONFIGS = ["forest64_mc", "swap8_mc", "forest64_joint"]

#: the maps a batch of a configuration's tiny cell: the plan entry's
#: requests each run the whole production solve (900 iterations of K1's
#: plain twin on the CPU), so it plans one a batch
MAPS = {"forest64_joint": 1}


def _run(man, seconds=0.5, control=None):
    return run.run_cell(man, "tiny.cell", 2 ** 33 + 7, seconds, False,
                        "cpu", control=control, log=lambda *a: None,
                        note=lambda *a: None)


def _tiny(tmp_path, config, **kw):
    kw.setdefault("maps", MAPS.get(config, 2))
    return tiny(tmp_path, config, **kw)


@pytest.mark.parametrize("config", CONFIGS)
def test_a_cell_added_as_data_runs_and_is_correct(tmp_path, config):
    res = _run(_tiny(tmp_path, config))
    assert res["correct"], res["check"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "plans_per_s"}
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("config", CONFIGS)
def test_the_control_fails(tmp_path, config):
    """The reference's own plan computed in bfloat16 in the program's
    place breaks a limit."""
    res = _run(_tiny(tmp_path, config), control="bfloat16")
    assert not res["correct"]
    assert any(v["value"] > v["limit"] for v in res["check"].values())


@pytest.mark.parametrize("control,number", [("nobox", "box_viol_m"),
                                            ("nopair", "pair_viol_m")])
@pytest.mark.parametrize("config", CONFIGS)
def test_a_plan_that_leaves_its_corridor_fails(tmp_path, config, control,
                                               number):
    """The reference's float64 plan with its box rows or its pair planes
    relaxed, in the program's place, breaks that number's limit."""
    res = _run(_tiny(tmp_path, config), control=control)
    assert not res["correct"]
    assert res["check"][number]["value"] > res["check"][number]["limit"]


def _unchanged(orig):
    def sweep(stacked, scen, dummy, *a, **kw):
        ctrl, info = orig(stacked, scen, dummy, *a, **kw)
        return dummy.clone(), info
    return sweep


def _stack_half(orig):
    """The first half of every stack's maps left at their dummies."""
    def sweep(stacked, scen, dummy, *a, **kw):
        ctrl, info = orig(stacked, scen, dummy, *a, **kw)
        ctrl = ctrl.clone()
        half = ctrl.shape[0] // 2
        ctrl[:half] = dummy[:half].to(ctrl.dtype)
        return ctrl, info
    return sweep


def _altered(orig):
    """One control point of agent 0 moved by 1 cm, in every map."""
    def sweep(*a, **kw):
        ctrl, info = orig(*a, **kw)
        ctrl = ctrl.clone()
        ctrl[:, 0, ctrl.shape[2] // 2, 2, 2] += 0.01
        return ctrl, info
    return sweep


def _x0(data, x):
    return torch.as_tensor(data.x0).to(device=x.device, dtype=x.dtype)


def _joint_unchanged(orig):
    """The joint solve returning its warm start."""
    def solve(data, phases, *a, **kw):
        x, info = orig(data, phases, *a, **kw)
        return _x0(data, x), info
    return solve


def _joint_half(orig):
    """The first half of the swarm's agents left at their warm start."""
    def solve(data, phases, *a, **kw):
        x, info = orig(data, phases, *a, **kw)
        x = x.clone()
        half = x.shape[0] // 2
        x[:half] = _x0(data, x)[:half]
        return x, info
    return solve


def _joint_altered(orig):
    """One control point of agent 0 moved by 1 cm (segment M // 2, point
    2 of its n + 1 = 6, z)."""
    def solve(data, phases, *a, **kw):
        x, info = orig(data, phases, *a, **kw)
        x = x.clone()
        x[0, 2, (x.shape[2] // 6 // 2) * 6 + 2] += 0.01
        return x, info
    return solve


def _plant(monkeypatch, config, fault):
    """``fault`` in the solve of ``config``'s entry: the stacked sweep
    and the scenario solves (Monte-Carlo), or the joint solve and the
    plan's QP stage (the plan entry)."""
    from swarm_simulator_tpu_torch.parallel import mesh, scenarios
    from swarm_simulator_tpu_torch.qp import joint, nullspace

    if config == "forest64_joint":
        if fault == "half":
            orig, calls = joint.solve_trajectories, []

            def half(plan, *a, **kw):
                calls.append(plan)
                return orig(plan, *a, **kw) if len(calls) % 2 else plan
            monkeypatch.setattr(joint, "solve_trajectories", half)
            return
        planted = {"unchanged": _joint_unchanged, "stack_half": _joint_half,
                   "altered": _joint_altered}[fault]
        monkeypatch.setattr(nullspace, "solve_ns_phases",
                            planted(nullspace.solve_ns_phases))
    elif fault == "unchanged":
        monkeypatch.setattr(mesh, "stacked_sweep",
                            _unchanged(mesh.stacked_sweep))
    elif fault == "stack_half":
        monkeypatch.setattr(mesh, "stacked_sweep",
                            _stack_half(mesh.stacked_sweep))
    elif fault == "altered":
        monkeypatch.setattr(mesh, "stacked_sweep",
                            _altered(mesh.stacked_sweep))
    else:
        orig = scenarios.solve_scenarios

        def half(scs, *a, **kw):
            orig(scs[:len(scs) // 2], *a, **kw)
            return scs
        monkeypatch.setattr(scenarios, "solve_scenarios", half)


@pytest.mark.parametrize("fault", ["unchanged", "half", "stack_half",
                                   "altered"])
@pytest.mark.parametrize("config", CONFIGS)
def test_a_broken_program_is_not_correct(tmp_path, monkeypatch, config,
                                         fault):
    """Each fault, on 4 maps a batch (the plan entry: 2 requests) of
    which the sample works out 1 again: the solve returning its start,
    half the batch unsolved, half of each stack (the plan entry: of the
    swarm) left at its dummy, a control point moved 1 cm."""
    _plant(monkeypatch, config, fault)
    # stack_half: no map in the sample, so the reading of every map's
    # plan has to find it alone
    res = _run(tiny(tmp_path, config, maps=2 * MAPS.get(config, 2),
                    check=0 if fault == "stack_half" else 1))
    assert not res["correct"], res["check"]
    if fault in ("unchanged", "stack_half"):
        # read on every map, not on the sample alone
        jd = res["check"]["jerk_vs_dummy"]
        assert jd["value"] > jd["limit"]


@pytest.mark.parametrize("config", ["swap8_mc", "forest64_joint"])
def test_traced_run_reads_the_per_layer_metrics(tmp_path, config):
    man = _tiny(tmp_path, config)
    res = run.run_cell(man, "tiny.cell", 5, 0.5, True, "cpu",
                       log=lambda *a: None, note=lambda *a: None)
    cells = {w["name"] for w in man.doc["workloads"]
             if w["config"] == config}
    names = {m["name"] for m in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["per_layer"]
        if cells & set(m["workloads"])}
    # on the CPU no device is traced: the idle share reads 100, K1 runs
    # its plain twin (no launch, no roofline), the gaps are named by the
    # harness's spans
    assert set(res["metrics"]) == names - {"k1_roofline_pct.plan"}
    idle = [k for k in names if k.startswith("device_idle_pct")]
    assert [res["metrics"][k]["value"] for k in idle] == [100.0]
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    spans = {"prep", "solve", "forest", "plan", "search", "corridor",
             "ns_prep", "ns_solve", "window"}
    assert {g for g, _ in res["breakdown"]["idle_gaps"]} \
        <= {f"idle in swarmbench.{s}" for s in spans}


FORBIDDEN_RUNNER = {"jax", "jaxlib", "flax", "swarm_simulator_tpu"}
FORBIDDEN_REFERENCE = FORBIDDEN_RUNNER | {"swarm_simulator_tpu_torch"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = (
        "import sys, pathlib, torch\n"
        f"sys.path.insert(0, {str(HERE / 'tests')!r})\n"
        "torch.set_num_threads(1)\n"
        "from _tiny import tiny\n"
        "from swarmbench import run\n"
        f"man = tiny(pathlib.Path({str(tmp_path)!r}), 'swap8_mc')\n"
        "run.run_cell(man, 'tiny.cell', 3, 0.2, True, 'cpu',"
        " log=lambda *a: None, note=lambda *a: None)\n")
    loaded = _loaded(code)
    assert "swarm_simulator_tpu_torch" in loaded
    assert not loaded & FORBIDDEN_RUNNER


def test_the_reference_loads_no_jax_and_no_program():
    code = (
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from swarmbench.reference import check, corridor, qp, world\n"
        "m = world.antipodal_swap(4, span=2.0, z=1.0, radius=0.12)\n"
        "g = world.forest(m, [-3, -3, 0], [3, 3, 2.5], 0.1, 1, obs_num=0,"
        " r_min=0.3, r_max=0.3, h_min=0, h_max=2.5, margin=0.5)\n"
        "s = np.linspace(0, 1, 9)[None, :, None]\n"
        "paths = m.start[:, None, :3] * (1 - s) + m.goal[:, None, :3] * s\n"
        "paths[:, :, 2] += np.arange(4)[:, None] * 0.3\n"
        "T = np.arange(9.0)\n"
        "b = corridor.boxes(g, paths, T, m.radius, [0.1] * 3,"
        " [-3, -3, 0], [3, 3, 2.5])\n"
        "p, n, _ = corridor.pair_planes(paths, 2.0)\n"
        "check.sweep(b, p, n, paths, T, m, qp.groups(4, 2), 2, 5, 3,"
        " 'cpu', torch.float64)\n")
    assert not _loaded(code) & FORBIDDEN_REFERENCE


def test_no_source_of_the_reference_imports_the_program():
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN_REFERENCE, \
                    (path, name)


def test_a_run_without_the_program_prints_no_result(tmp_path):
    """In a folder with only BENCHMARK.json and swarmbench/, a run exits
    with another code than 0 and prints nothing on standard output."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "swarmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "swarmbench.run", "--workload",
         "swap8_mc.maps128", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_sample_keeps_a_longest_map_and_follows_the_seed():
    from swarmbench import traffic

    maps = [(10, 32), (11, 40), (12, 32), (13, 32), (14, 40)]
    a = traffic.sample(7, maps, 3)
    assert a[0] in (11, 14) and len(set(a)) == 3
    assert a == traffic.sample(7, maps, 3)
    assert {traffic.sample(s, maps, 1)[0] for s in range(20)} == {11, 14}


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (HERE / "traffic").glob("*.json")))
def test_every_run_plans_the_pool_in_its_own_order(mix):
    from swarmbench import traffic

    m = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    n = len(m["blocks"])
    assert m["warmup_block"] not in m["blocks"]
    assert all(b % 1 == 0 and b >= 0 for b in m["blocks"])
    for seed in (0, 1, 2 ** 31 + 5, 2 ** 40):
        order = [traffic.batch_seed0(seed, k, m) for k in range(2 * n)]
        assert sorted(order[:n]) == sorted(m["blocks"])
        assert order[n:] == order[:n]
    assert len({tuple(traffic.block_order(s, m)) for s in range(50)}) > 1
    maps = [(b + i, 40) for b in m["blocks"] for i in range(3)]
    assert len(traffic.sample(7, maps, m["check_maps"])) == m["check_maps"]


@pytest.mark.cuda
def test_a_short_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = run.run_cell(tiny(tmp_path, "swap8_mc"), "tiny.cell", 9, 0.5,
                       True, "cuda:0", log=lambda *a: None,
                       note=lambda *a: None)
    assert res["correct"] and res["device"]["busy_s"] > 0
