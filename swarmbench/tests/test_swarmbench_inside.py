"""The program's spans and counters beside the device trace
(swarmbench/inside.py): each reader on a synthetic record and on a
record without the program's entries, the idle gaps named by the
innermost span with ``by_span`` on a synthetic timeline, and a tiny
window on the CPU that reads every number but the device trace's."""
import pytest

from _tiny import tiny
from swarmbench import inside


def _batch(t, sync, steps, nbytes, prep_maps, waits):
    """A batch's program entry: spans (name, ident, t0, t1, attrs)."""
    main, worker = 1, 2
    spans = [("mc.forest", main, t, t + 0.5, {}),
             ("sweep.prepare", main, t + 2, t + 2.25, {}),
             ("admm.check", main, t + 3, t + 4, {}),
             ("admm.sync", main, t + 3, t + 3 + sync, {}),
             ("admm.check", main, t + 4, t + 4.5, {}),
             ("admm.sync", main, t + 4, t + 4 + sync, {})]
    for d, w in zip(prep_maps, waits):
        spans += [("mc.prep_map", worker, t + 1, t + 1 + d, {"wait_s": w}),
                  ("prep.search", worker, t + 1, t + 1 + d / 2, {})]
    return {"iters": [[50]], "prep_s": 1.0, "program": {
        "spans": spans, "counters": {"admm.steps": steps,
                                     "solve.syncs": 5,
                                     "stack.bytes": nbytes}}}


RECORD = {
    "batches": [_batch(0.0, 0.25, 50, 2e9, [0.5, 1.5], [0.0, 0.5]),
                _batch(10.0, 0.5, 100, 3e9, [1.0], [1.0])],
    "trace": {"by_span": {"admm.check": {"ops": 600}}}}

WANT = {
    "forest_gen_s.maps": 0.5,
    "prep_map_s.maps": (1.0 + 1.0) / 2,
    "prep_wait_s.maps": (0.25 + 1.0) / 2,
    "search_s.maps": (0.5 + 0.5) / 2,
    "kkt_prep_s.maps": 0.25,
    # (checks 1.5 s - syncs) / steps, in ms
    "admm_host_ms.maps": (1e3 * 1.0 / 50 + 1e3 * 0.5 / 100) / 2,
    "admm_sync_s.maps": (0.5 + 1.0) / 2,
    "host_syncs.maps": 5.0,
    "launches_per_iter.maps": 600 / 150,
    "stack_gb.maps": 3.0,
}


@pytest.mark.parametrize("name", sorted(inside.READERS))
def test_a_reader_on_a_synthetic_record(name):
    assert inside.READERS[name](RECORD) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(inside.READERS))
def test_a_reader_without_the_program_reads_none(name):
    """swarmbench/run.py's record: no program entry in its batches."""
    plain = {"batches": [{"iters": [[50]], "stacks": [(0.1, 1.0)]}],
             "spans": [("prep", 0.0, 1.0)],
             "trace": {"idle_pct": 50.0}}
    assert inside.READERS[name](plain) is None


def test_checks_tie_the_numbers():
    ok = inside.checks(RECORD, prep_workers=2, peak_gb=3.5)
    assert ok == {"stack_gb_within_peak": True, "steps_cover_iters": True,
                  "prep_within_pool": True}
    bad = inside.checks(RECORD, prep_workers=1, peak_gb=2.5)
    assert not bad["stack_gb_within_peak"] and not bad["prep_within_pool"]


def test_gaps_named_by_the_innermost_program_span():
    ops = [("k1", 0.0, 1.0), ("k2", 3.0, 3.5), ("k3", 5.0, 5.2),
           ("k3", 8.0, 10.0)]
    ranges = [("swarmbench.window", 0.0, 10.0),
              ("swarmbench.prep", 1.0, 3.0), ("swarmbench.solve", 3.0, 9.0)]
    program = [("mc.prep", 1.2, 2.8),
               ("sweep.round", 3.2, 8.5), ("admm.check", 4.0, 6.0),
               ("admm.sync", 4.0, 5.1), ("admm.check", 6.0, 8.5),
               ("admm.sync", 6.0, 6.5)]
    s = inside.summarise(ops, ranges, program)
    assert s["busy_s"] == pytest.approx(1 + 0.5 + 0.2 + 2)
    gaps = {round(v, 6): k for k, v in s["idle_gaps"]}
    assert gaps[2.0] == "idle in mc.prep"              # 1..3
    assert gaps[1.5] == "idle in admm.sync"            # 3.5..5
    assert gaps[2.8] == "idle in admm.check"           # 5.2..8
    by = s["by_span"]
    assert by["admm.sync"]["s"] == pytest.approx(1.1 + 0.5)
    assert by["admm.sync"]["busy_s"] == pytest.approx(0.1)
    assert by["admm.sync"]["ops"] == 1
    assert by["admm.sync"]["idle_s"] == pytest.approx(1.0 + 0.5)
    assert by["admm.check"]["ops"] == 2 and by["sweep.round"]["ops"] == 2
    # idle in 5.2..6 and 6.5..8, with the checks inside the round
    assert by["admm.check"]["idle_s"] == pytest.approx(0.8 + 1.5)
    assert by["sweep.round"]["idle_s"] == pytest.approx(0.5)   # 3.5..4
    assert by["mc.prep"]["idle_s"] == pytest.approx(1.6)
    assert by["swarmbench.prep"]["idle_s"] == pytest.approx(0.4)
    assert by["swarmbench.solve"]["idle_s"] == pytest.approx(0.0)
    assert by["swarmbench.window"]["idle_s"] == pytest.approx(0.0)
    assert sum(v["idle_s"] for v in by.values()) == \
        pytest.approx(s["window_s"] - s["busy_s"])


def test_a_tiny_window_on_the_cpu_reads_every_program_number(tmp_path):
    rec = inside.window(tiny(tmp_path, "swap8_mc"), "tiny.cell",
                        2 ** 33 + 7, 0.5, "cpu")
    got = inside.report(rec)
    assert got["metrics"].pop("launches_per_iter.maps") is None
    assert all(v is not None and v >= 0 for v in got["metrics"].values()), \
        got["metrics"]
    assert got["checks"]["steps_cover_iters"]
    assert got["checks"]["prep_within_pool"]
