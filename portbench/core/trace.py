"""The traced calls: spans around the port's call sites, and the reduction
of ``torch.profiler``'s traces to busy time, spans' device time and the
breakdown.

A span is a ``torch.profiler.record_function`` range named after the call
site (``<module>.<attribute>``) that the harness wraps while the calls are
traced with host activity; the device time under it is the device time of
every kernel launched inside it.  Busy time comes from a second pass
traced with device activity alone (``busy``), whose cost on the host is
far smaller.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

WINDOW = "portbench.window"
ISSUE = "portbench.issue"
WAIT = "portbench.wait"


@dataclass
class Hit:
    device_s: float
    info: Optional[dict]


@dataclass
class Trace:
    window_s: float
    busy_s: float
    spans: Dict[str, List[Hit]] = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    span_window_s: float = 0.0
    span_busy_s: float = 0.0

    def span_idle_pct(self) -> float:
        """The idle share of the spans pass, which the host profiling
        slows."""
        return 100.0 * (1.0 - self.span_busy_s / self.span_window_s) \
            if self.span_window_s > 0 else math.nan


@contextlib.contextmanager
def spans(targets):
    """Wrap each ``(module, attribute, describe)`` in a named range while
    the block runs; yields ``{name: [info, ...]}``, one entry a call, from
    ``describe(args, kwargs)`` (``None`` without one)."""
    infos: Dict[str, list] = {}
    undo = []
    try:
        for module, attr, describe in targets:
            mod = importlib.import_module(module)
            name = f"{module}.{attr}"
            if name in infos:
                continue
            orig = getattr(mod, attr)
            hits = infos.setdefault(name, [])

            def wrapped(*a, _orig=orig, _name=name, _hits=hits,
                        _describe=describe, **k):
                _hits.append(_describe(a, k) if _describe else None)
                with torch.profiler.record_function(_name):
                    return _orig(*a, **k)
            setattr(mod, attr, wrapped)
            undo.append((mod, attr, orig))
        yield infos
    finally:
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)


def _events(prof) -> list:
    """``(name, on the device, start, end)`` of every event that ``prof``
    recorded, in microseconds, read from the profiler's raw results:
    building its per-operator events instead costs some 90 microseconds
    an event, minutes for a traced MediaPipe set."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        out.append((e.name(), e.device_type() == DeviceType.CUDA, a * 1e-3,
                    (a + e.duration_ns()) * 1e-3))
    return out


def _union(intervals):
    """Merged ``[(start, end)]`` of possibly overlapping intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(prof, infos: Dict[str, list], top: int = 10) -> Optional[Trace]:
    """The trace of ``prof`` within its ``WINDOW`` range; ``None`` when it
    holds no window.

    The profiler puts each named range on the device's timeline too,
    spanning the kernels launched inside it; those annotations are not
    device work.  A span's device time is the kernel, copy and set time
    inside its annotation: on one stream the kernels run in the order they
    were launched, so these are the ones launched inside the range (also
    those a library launches through its own C entry points, which the
    profiler's per-operator totals miss)."""
    events = _events(prof)
    win = [(a, b) for name, on_dev, a, b in events
           if name == WINDOW and not on_dev]
    if not win:
        return None
    w0, w1 = win[0]
    ranges = set(infos) | {WINDOW, ISSUE, WAIT}
    dev, per_op = [], {}
    cpu_s, cpu_e, cpu_n = [], [], []
    notes: Dict[str, list] = {n: [] for n in infos}
    for name, on_dev, a, b in events:
        if on_dev:
            if name in ranges:
                if name in notes:
                    notes[name].append((a, b))
                continue
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b))
                per_op[name] = per_op.get(name, 0.0) + (b - a) * 1e-6
        elif name != WINDOW:
            cpu_s.append(a)
            cpu_e.append(b)
            cpu_n.append(name)
    merged = _union(dev)
    window_s = (w1 - w0) * 1e-6
    busy_s = sum(b - a for a, b in merged) * 1e-6
    out = Trace(window_s=window_s, busy_s=busy_s, span_window_s=window_s,
                span_busy_s=busy_s)
    starts = [a for a, _ in merged]
    for name, spans_ in notes.items():
        info = infos[name]
        spans_.sort()
        aligned = len(spans_) == len(info)
        out.spans[name] = [Hit(_covered(merged, starts, a, b) * 1e-6,
                               info[i] if aligned else None)
                           for i, (a, b) in enumerate(spans_)]
    out.device_ops = [[k, v] for k, v in sorted(per_op.items(),
                                                key=lambda kv: -kv[1])[:top]]
    out.idle_gaps = _gaps(merged, w0, w1, cpu_s, cpu_e, cpu_n, top)
    return out


def busy(tr: Trace, prof, window_s: float, top: int = 10) -> None:
    """Replace ``tr``'s busy time, window and device operations by those
    of ``prof``, a trace of device activity alone over ``window_s``
    seconds of the host's clock: the union of every kernel, copy and set
    on the device (all of them launched, and waited for, in the window)."""
    dev, per_op = [], {}
    for name, on_dev, a, b in _events(prof):
        if on_dev and b > a:
            dev.append((a, b))
            per_op[name] = per_op.get(name, 0.0) + (b - a) * 1e-6
    tr.window_s = window_s
    tr.busy_s = sum(b - a for a, b in _union(dev)) * 1e-6
    tr.device_ops = [[k, v] for k, v in sorted(per_op.items(),
                                               key=lambda kv: -kv[1])[:top]]


def _covered(merged, starts, a, b) -> float:
    """Microseconds of the merged intervals inside ``[a, b]``."""
    k = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while k < len(merged) and merged[k][0] < b:
        total += max(0.0, min(b, merged[k][1]) - max(a, merged[k][0]))
        k += 1
    return total


def _gaps(merged, w0, w1, cpu_s, cpu_e, cpu_n, top):
    """Idle time in the window, summed by what the host was doing when
    each gap began: the innermost host range open then."""
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    order = np.argsort(np.asarray(cpu_s, np.float64)) if cpu_s else []
    s = np.asarray(cpu_s, np.float64)[order] if cpu_s else np.zeros(0)
    e = np.asarray(cpu_e, np.float64)[order] if cpu_s else np.zeros(0)
    names = [cpu_n[i] for i in order]
    by_label: Dict[str, float] = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:500]:
        k = bisect.bisect_right(s, a)
        label = "host: no range open"
        if k:
            lo = max(0, k - 20000)
            cover = np.nonzero(e[lo:k] >= a)[0]
            if cover.size:
                j = lo + cover[np.argmin(e[lo:k][cover] - s[lo:k][cover])]
                label = names[j]
        by_label[label] = by_label.get(label, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(by_label.items(),
                                      key=lambda kv: -kv[1])[:top]]
