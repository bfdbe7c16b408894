"""CUDA-event timing and card identity for the probe tools."""
from __future__ import annotations

import subprocess

import numpy as np
import torch


#: GPU cycles the stream spins before each timed call (~0.5 ms), so that
#: the host has queued the call's launches before the first event is
#: reached and the events time the device, not the wrapper's host work
#: (a call that takes the host longer than this to queue is timed with
#: its host gaps)
SPIN_CYCLES = 1_000_000


def event_ms(fn, reps: int, warmup: int = 1) -> list[float]:
    """Milliseconds of each of ``reps`` calls of ``fn()`` between two CUDA
    events (each call synchronised), after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def median_ms(fn, reps: int, warmup: int = 1) -> float:
    return float(np.median(event_ms(fn, reps, warmup)))


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
