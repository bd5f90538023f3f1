"""Spans and counters of the port's host side, on one clock.

``span(name, **attrs)`` is a context manager around a phase of the
program. It reads ``time.time_ns()`` at entry and exit, the clock that
``torch.profiler`` writes its traces on (an event's ``ts`` in
microseconds plus the trace's ``baseTimeNanoseconds / 1000``), so that a
span can be laid over the device's timeline. After it exits the span
object gives its duration (``seconds``; while open, the time so far),
whether or not anything is recorded, so that a call site that logs a
time reads it from the span.

Recording is off by default: a span then takes its two clock reads and
keeps nothing. ``enable(True)`` starts recording; every span entered
while recording is on is kept when it exits, with its parent (the
innermost recorded span open on the same thread: each thread keeps its
own stack, since the threaded pipeline maps on a thread of its own), its
thread and its attributes. ``drain()`` hands the kept spans over, as
dicts, and forgets them.

``count(name, n)`` adds to a process-wide counter, whether or not
recording is on; ``snapshot()`` reads the counters together with the
compositing kernels' launch counts (``ops/launches.py``, under
``launch.<name>``).

Nothing here reads a device value, synchronises or allocates on the
device: a call site records only what it already holds on the host.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_on = False
_spans: List["Span"] = []
_counts: Dict[str, int] = {}


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One phase: ``with span("backend.map") as sp: ...``, then
    ``sp.seconds``."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "id", "parent",
                 "tid")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.end_ns: Optional[int] = None
        self.id = self.parent = self.tid = None

    def __enter__(self) -> "Span":
        if _on:
            st = _stack()
            self.id = next(_ids)
            self.parent = st[-1].id if st else None
            self.tid = threading.get_ident()
            st.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self.id is not None:         # kept: recording was on at entry
            _stack().pop()
            with _lock:
                _spans.append(self)
        return False

    @property
    def seconds(self) -> float:
        """The span's duration, or the time since it opened while it is
        open."""
        end = self.end_ns if self.end_ns is not None else time.time_ns()
        return (end - self.start_ns) * 1e-9

    def as_dict(self) -> dict:
        return dict(name=self.name, id=self.id, parent=self.parent,
                    tid=self.tid, start_ns=self.start_ns,
                    end_ns=self.end_ns, attrs=dict(self.attrs))


def span(name: str, **attrs) -> Span:
    return Span(name, attrs)


def enable(flag: bool) -> None:
    """Record the spans entered from now on (``True``), or none."""
    global _on
    _on = bool(flag)


def drain() -> List[dict]:
    """The spans kept so far, in the order they closed; forgets them."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return [s.as_dict() for s in out]


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def snapshot() -> Dict[str, int]:
    """The counters, and each compositing launch counter as
    ``launch.<name>``."""
    from ..ops import launches
    with _lock:
        out = dict(_counts)
    out.update({f"launch.{k}": v for k, v in launches.counts().items()})
    return out
