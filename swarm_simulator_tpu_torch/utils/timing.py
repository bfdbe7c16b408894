"""Problem-size counters, and the recorder of the program's own spans and
counters.

The reference prints QP problem-size counters after each solve
(rbp_planner.hpp:58-60): ``ProblemSize``.

The recorder times the program from inside.  ``recording()`` installs a
``Recorder`` for the work inside it; meanwhile ``span(name, **attrs)``
records (name, thread ident, t0, t1, attrs) on ``time.perf_counter``,
``add_span`` records one from host-clock reads the caller already made,
and ``count(name, n)`` adds to an integer counter.  Workers of a thread
pool record into the same recorder, under its lock.

Off is the default: ``span`` then returns one shared no-op context and
``add_span`` and ``count`` return after one global check.  On or off the
recorder never synchronises the card: a span that needs the card's time
ends where the program already waits for it.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass

import torch


class Recorder:
    """The spans and counters of the work inside one ``recording()``."""

    def __init__(self):
        self._lock = threading.Lock()
        #: (name, thread ident, t0, t1, attrs), in the order they ended
        self.spans: list[tuple[str, int, float, float, dict]] = []
        self.counters: dict[str, int] = {}

    def add(self, name: str, t0: float, t1: float, attrs: dict) -> None:
        entry = (name, threading.get_ident(), t0, t1, attrs)
        with self._lock:
            self.spans.append(entry)

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def drain(self) -> dict:
        """What was recorded since the last drain, as {"spans": [...],
        "counters": {...}}; the recorder is left empty."""
        with self._lock:
            out = {"spans": self.spans, "counters": self.counters}
            self.spans, self.counters = [], {}
        return out


#: the recorder in force, None when off
_ACTIVE: Recorder | None = None


@contextlib.contextmanager
def recording():
    """Record the spans and counters of the work inside; yields the
    Recorder.  A nested recording takes over until it ends."""
    global _ACTIVE
    outer, rec = _ACTIVE, Recorder()
    _ACTIVE = rec
    try:
        yield rec
    finally:
        _ACTIVE = outer


def active() -> bool:
    """Whether a recording is in force: for a count whose value costs
    work to compute."""
    return _ACTIVE is not None


class _Span:
    __slots__ = ("rec", "name", "attrs", "t0")

    def __init__(self, rec: Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.rec.add(self.name, self.t0, time.perf_counter(), self.attrs)
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A context that records its host-clock interval as ``name``."""
    rec = _ACTIVE
    if rec is None:
        return _OFF
    return _Span(rec, name, attrs)


def add_span(name: str, t0: float, t1: float, **attrs) -> None:
    """Record ``name`` over [t0, t1], reads of time.perf_counter the
    caller made."""
    rec = _ACTIVE
    if rec is not None:
        rec.add(name, t0, t1, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    rec = _ACTIVE
    if rec is not None:
        rec.count(name, n)


def storage_bytes(*trees) -> int:
    """The bytes of the distinct storages under the tensors in ``trees``
    (nested tuples, lists, dicts and dataclasses; a storage that several
    tensors view counts once)."""
    seen: dict[int, int] = {}

    def walk(t):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif hasattr(t, "__dataclass_fields__"):
            for f in t.__dataclass_fields__:
                walk(getattr(t, f))
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    for tree in trees:
        walk(tree)
    return sum(seen.values())


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
