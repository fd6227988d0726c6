"""Stage timers and device traces.

The port's counterpart of ``vhr_tpu/utils/profiling.py``, rewritten
without JAX: :class:`StageTimer` accumulates wall-clock time per named
stage (``sync=True`` waits for the CUDA card's queued work, where there is
a card, so a stage owns its device time), and :func:`device_trace`
records a ``torch.profiler`` trace (host and, with a card, device
activity) into a directory as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

__all__ = ["StageTimer", "device_trace"]


class StageTimer:
    """Accumulating per-stage wall-clock timer.

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
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_available():
                # Drain queued device work so the stage owns its time.
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
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
    """Record a ``torch.profiler`` trace of the block into ``log_dir`` as
    ``trace_<pid>.json`` (Chrome trace format: ``chrome://tracing`` or
    Perfetto), with the card's activity where there is a card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))
