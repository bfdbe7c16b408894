"""The idle share from a timeline whose kernels overlap."""
import pytest

from swarmbench.trace import summarise, union


def test_union_counts_overlap_once():
    assert union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == [(0, 3), (5, 6)]


def test_idle_share_and_gaps_on_a_synthetic_timeline():
    ops = [("k1", 1.0, 3.0), ("k2", 2.0, 4.0),    # overlap: busy 1..4
           ("k3", 6.0, 7.0), ("k3", 6.5, 6.8),    # nested: busy 6..7
           ("k4", -1.0, 0.5), ("k5", 9.5, 11.0)]  # cut at the window
    ranges = [("swarmbench.window", 0.0, 10.0),
              ("swarmbench.prep", 4.0, 6.0), ("swarmbench.solve", 0.0, 9.0)]
    s = summarise(ops, ranges)
    assert s["window_s"] == pytest.approx(10.0)
    # 0..0.5, 1..4, 6..7, 9.5..10
    assert s["busy_s"] == pytest.approx(0.5 + 3 + 1 + 0.5)
    assert s["idle_pct"] == pytest.approx(50.0)
    gaps = dict((round(v, 6), k) for k, v in s["idle_gaps"])
    assert gaps[2.0] == "idle in swarmbench.prep"      # 4..6
    assert gaps[2.5] == "idle in swarmbench.solve"     # 7..9.5
    assert gaps[0.5] == "idle in swarmbench.solve"     # 0.5..1
    # every name's launches and seconds inside the window
    assert s["by_name"]["k3"] == [2, pytest.approx(1.3)]
    assert s["by_name"]["k5"] == [1, pytest.approx(0.5)]
    assert set(s["by_name"]) == {"k1", "k2", "k3", "k4", "k5"}
    names = [k for k, _ in s["device_ops"]]
    assert names[0] == "k1" and sum(v for _, v in s["device_ops"]) \
        == pytest.approx(2 + 2 + 1 + 0.3 + 0.5 + 0.5)


def test_no_window_reads_nothing():
    assert summarise([("k", 0, 1)], []) == {}
