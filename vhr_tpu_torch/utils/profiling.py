"""The port's one tracing system: spans, counters, stage timers and device
traces.

- :func:`span` times a block of the program where its work runs.  Spans
  are off unless a :func:`tracing` block is open: then :func:`span`
  returns a shared no-op after one check of a module flag.  On, a span is
  kept in memory as a :class:`Span` (its name, id, parent, request,
  attributes, the counts added while it was innermost, and its host start
  and end on the clock ``torch.profiler`` stamps host events with), and,
  while a profiler records host activity, it also opens a
  ``torch.profiler.record_function`` range of its name, so that the
  profiler's timeline (and its device annotations) show the same span.
- :func:`request` is a span that starts a request: every span opened
  under it, in its thread, carries its request id.
- :func:`count` bumps a named counter.  Counters are always on; with
  tracing on the count is also added to the innermost open span.
  :func:`counter` reads a total, :func:`reset_counters` zeroes some.
- :func:`wait` is the span around a call that blocks the host on the card
  (``vhr.wait``); it counts ``waits`` whether tracing is on or not.
- :func:`tracing` turns spans on for its block and hands back the block's
  spans and counter totals (a :class:`Traced`).
- :class:`StageTimer` accumulates wall-clock time per named stage, each
  stage a span; :func:`device_trace` records a ``torch.profiler`` trace
  of its block, with tracing on, into a directory as a Chrome trace.

The spans and counters the port keeps, and what reads them, are listed in
``PERF.md`` (section 3).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["Span", "Traced", "span", "request", "wait", "count", "counter",
           "reset_counters", "tracing", "StageTimer", "device_trace"]

# The profiler stamps host events with CLOCK_REALTIME in nanoseconds (its
# cycle counter converted to Unix time), so the spans take their ends from
# the same clock and need no conversion to be compared with its events.
_clock_ns = time.time_ns

_ON = False                   # spans are kept: a tracing() block is open
_DEPTH = 0                    # tracing() blocks open
_SPANS: List["Span"] = []     # finished spans since the outer block opened
_LOCAL = threading.local()    # each thread's stack of open spans
_IDS = itertools.count(1)
_REQUESTS = itertools.count(1)
_COUNTERS: Dict[str, int] = defaultdict(int)
_COUNT_LOCK = threading.Lock()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class _Off:
    """The shared span of tracing off: enters and exits, keeps nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One timed block: ``name``, ``id``, ``parent`` (the enclosing span's
    id, or ``None``), ``request`` (the request id it runs under, or
    ``None``), ``attrs``, ``counts`` (added while it was innermost) and
    ``start_ns``, ``end_ns`` on the profiler's host clock."""

    __slots__ = ("name", "id", "parent", "request", "attrs", "counts",
                 "start_ns", "end_ns", "_range")

    def __init__(self, name: str, attrs: dict, request: Optional[int]):
        self.name, self.attrs, self.request = name, attrs, request
        self.id = next(_IDS)
        self.parent = None
        self.counts: Dict[str, int] = {}
        self.start_ns = self.end_ns = 0
        self._range = None

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self) -> "Span":
        st = _stack()
        if st:
            self.parent = st[-1].id
            if self.request is None:
                self.request = st[-1].request
        st.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = _clock_ns()
        return self

    def __exit__(self, *exc):
        # Each end is read where it falls nearest the profiler's own
        # stamp: the start just after the range opens, the end just after
        # it closes (medians of 3 and 1 us, torch 2.11 on an H100's host).
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end_ns = _clock_ns()
        _stack().pop()
        _SPANS.append(self)
        return False


def span(name: str, **attrs):
    """A context manager timing its block as the span ``name`` (with
    ``attrs``) while tracing is on; the shared no-op otherwise."""
    if not _ON:
        return _OFF
    return Span(name, attrs, None)


def request(name: str, **attrs):
    """:func:`span` that starts a request: a new request id, which every
    span opened under it inherits."""
    if not _ON:
        return _OFF
    return Span(name, attrs, next(_REQUESTS))


def wait(what: str):
    """The ``vhr.wait`` span around a call that blocks the host until the
    card has run what was queued before it (a copy from pageable host
    memory, a value read back); counts ``waits`` in the enclosing span."""
    count("waits")
    if not _ON:
        return _OFF
    return Span("vhr.wait", {"what": what}, None)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (and, while tracing, to the
    innermost open span's counts)."""
    with _COUNT_LOCK:
        _COUNTERS[name] += n
    if _ON:
        st = _stack()
        if st:
            c = st[-1].counts
            c[name] = c.get(name, 0) + n


def counter(name: str) -> int:
    """The total of the counter ``name`` since it was last reset."""
    return _COUNTERS.get(name, 0)


def reset_counters(*names: str) -> None:
    """Zero the counters ``names``."""
    with _COUNT_LOCK:
        for name in names:
            _COUNTERS.pop(name, None)


class Traced:
    """What a :func:`tracing` block kept, filled when the block ends:
    ``spans`` (finished spans in the order they ended) and ``counts`` (each
    counter's total over the block)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}

    def self_ns(self) -> Dict[int, int]:
        """Each span's own time: its length less its children's, by id."""
        out = {s.id: s.ns for s in self.spans}
        for s in self.spans:
            if s.parent in out:
                out[s.parent] -= s.ns
        return out


@contextlib.contextmanager
def tracing() -> Iterator[Traced]:
    """Keep every span opened in the block (in any thread) and hand them
    back with the counters' totals over the block."""
    global _ON, _DEPTH
    out = Traced()
    first = len(_SPANS)
    before = dict(_COUNTERS)
    _DEPTH += 1
    _ON = True
    try:
        yield out
    finally:
        _DEPTH -= 1
        _ON = _DEPTH > 0
        out.spans = _SPANS[first:]
        out.counts = {k: v - before.get(k, 0)
                      for k, v in _COUNTERS.items() if v != before.get(k, 0)}
        if not _ON:
            del _SPANS[:]


class StageTimer:
    """Accumulating per-stage wall-clock timer; each stage is the span
    ``vhr.stage.<name>``.

    >>> timer = StageTimer()
    >>> with timer.stage("decode"):
    ...     ...
    >>> timer.report()
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = False) -> Iterator[None]:
        """Time the block as stage ``name``; ``sync=True`` waits for the
        CUDA card's queued work, where there is a card, so that the stage
        owns its device time."""
        t0 = time.perf_counter()
        with span("vhr.stage." + name):
            try:
                yield
            finally:
                if sync and torch.cuda.is_available():
                    with wait("stage"):
                        torch.cuda.synchronize()
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k],
                    "count": self.counts[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}

    def json(self) -> str:
        return json.dumps(self.report(), indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the block, with the port's
    spans on, into ``log_dir`` as ``trace_<pid>.json`` (Chrome trace
    format: ``chrome://tracing`` or Perfetto), with the card's activity
    where there is a card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with tracing():
            yield
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))
