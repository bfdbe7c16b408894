"""The device's busy time from the profiler's timeline.

Busy time is the length of the union of the intervals in which a kernel,
copy or fill ran on the device (overlapping operations count once), read
inside the traced window, the harness's ``swarmbench.window`` range.  An
idle gap is named by the innermost harness range the host was in at its
middle.

The profiler records the device's activity alone: recording every host
operation besides slowed a forest window by a third and took minutes to
stop.  The harness's ranges are its own spans on the host clock, moved
onto the profiler's clock by a marker kernel launched at a known host
time before the window (``mark``).
"""
from __future__ import annotations


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted, merged intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def summarise(device_ops: list[tuple[str, float, float]],
              ranges: list[tuple[str, float, float]], top: int = 10) -> dict:
    """device_ops: (name, start, end) of each device operation; ranges:
    (name, start, end) of the harness's ranges, one of them
    "swarmbench.window" (seconds on one clock).  Returns busy_s, window_s,
    idle_pct, the breakdown's two lists and ``by_name``: each device
    operation's name -> [count, seconds] inside the window, every name."""
    win = [r for r in ranges if r[0] == "swarmbench.window"]
    if not win:
        return {}
    _, lo, hi = win[0]
    ops = clip([(a, b) for _, a, b in device_ops], lo, hi)
    merged = union(ops)
    busy = sum(b - a for a, b in merged)
    window = hi - lo
    by_name: dict[str, list] = {}
    for name, a, b in device_ops:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            tot = by_name.setdefault(name, [0, 0.0])
            tot[0] += 1
            tot[1] += b - a
    gaps, t = [], lo
    for a, b in merged + [(hi, hi)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    inner = sorted((r for r in ranges if r[0] != "swarmbench.window"),
                   key=lambda r: r[2] - r[1])

    def host_at(t: float) -> str:
        for name, a, b in inner:
            if a <= t <= b:
                return name
        return "swarmbench.window"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "busy_s": busy, "window_s": window,
        "idle_pct": 100.0 * (1.0 - busy / window) if window > 0 else None,
        "device_ops": sorted(([k, v] for k, (_, v) in by_name.items()),
                             key=lambda kv: -kv[1])[:top],
        "by_name": by_name,
        "idle_gaps": [[f"idle in {host_at((a + b) / 2)}", b - a]
                      for a, b in longest],
    }


def start() -> None:
    """Start a kineto trace of the device's operations.  torch.profiler's
    own wrapper turns every event into a Python object when it stops; the
    autograd layer underneath hands the raw events over."""
    from torch._C import _autograd as ag
    from torch._C._profiler import (ProfilerConfig, ProfilerState,
                                    _ExperimentalConfig)
    from torch.autograd import ProfilerActivity

    acts = {ProfilerActivity.CUDA}
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    ag._prepare_profiler(cfg, acts)
    ag._enable_profiler(cfg, acts, set())


def mark(device) -> float:
    """Launch the marker (a short spin kernel) on ``device``, idle since
    ``start``, and return the host time (time.perf_counter) just before
    the launch: the trace's first device operation."""
    import time

    import torch

    torch.cuda.synchronize(device)
    t = time.perf_counter()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(device)
    return t


def stop(marked: float) -> tuple[list, float]:
    """Stop the trace; (device operations as (name, start, end) in seconds
    on the profiler's clock, the offset that moves a host time onto that
    clock: the marker's start less ``marked``, its launch's host
    time)."""
    from torch._C import _autograd as ag

    ops = []
    for e in ag._disable_profiler().events():
        if "cuda" in str(e.device_type()).lower():
            a = e.start_ns() * 1e-9
            ops.append((e.name(), a, a + e.duration_ns() * 1e-9))
    if not ops:
        raise RuntimeError("the trace holds no device operation")
    return ops, min(a for _, a, _ in ops) - marked
