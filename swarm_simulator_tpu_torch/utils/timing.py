"""Timing, profiling, and problem-size observability.

The reference wraps every stage in a wall-clock Timer and prints runtimes
plus QP problem-size counters (timer.hpp:6-35; rbp_planner.hpp:51-60).
Card work is asynchronous under PyTorch, so the Timer here synchronises
the card when given a result on it, and a torch.profiler context is
provided for deep traces.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in ``tree`` (nested tuples, lists,
    dicts and dataclasses)."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif hasattr(tree, "__dataclass_fields__"):
        tree = [getattr(tree, f) for f in tree.__dataclass_fields__]
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in tree))
    return set()


class Timer:
    """Wall-clock stage timer (timer.hpp semantics + async-aware stop)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._elapsed = 0.0

    def stop(self, result=None) -> float:
        for dev in _cuda_devices(result):
            torch.cuda.synchronize(dev)
        self._elapsed = time.perf_counter() - self._t0
        return self._elapsed

    def elapsed_seconds(self) -> float:
        return self._elapsed


@contextlib.contextmanager
def scoped_timer(name: str, sink=None):
    """ScopedTimer (timer.hpp:24-35): prints on exit."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    msg = f"{name}: {dt:.6f}s"
    if sink is None:
        print(msg)
    else:
        sink(msg)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A torch.profiler trace of the CPU and (where there is one) the card,
    written as a TensorBoard trace into ``log_dir`` on exit."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@dataclass
class ProblemSize:
    """QP problem-size counters (printed by the reference after each
    solve: rbp_planner.hpp:58-60)."""

    n_vars: int = 0
    n_eq: int = 0
    n_ineq: int = 0

    @classmethod
    def of_batch(cls, B: int, M: int, n: int, phi: int,
                 n_pairs: int) -> "ProblemSize":
        D = M * (n + 1)
        return cls(
            n_vars=3 * B * D,
            n_eq=3 * B * (M + 1) * phi,
            n_ineq=2 * 3 * B * D + n_pairs * D,
        )

    def __str__(self):
        return (f"x size={self.n_vars}, eq const size={self.n_eq}, "
                f"ineq const size={self.n_ineq}")
