"""Closed-loop pacing: the traffic's ``in_flight`` calls in flight.  The
harness enqueues call ``i + in_flight - 1``, then waits until call ``i``'s
outputs are in host memory; a recording's time runs from entering the
call that carries it to that moment."""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Optional

import torch

from portbench.core import trace


def run(cell, seconds: Optional[float] = None, calls: int = 0,
        label: bool = False):
    """Issue calls until ``seconds`` have passed (or ``calls`` are
    issued); every issued call is waited for.  ``label`` puts the issue
    and the wait in named profiler ranges.  Returns ``(calls, window
    start, window end)``; a call is in the window when its outputs reached
    the host by the end."""
    rf = torch.profiler.record_function
    depth = int(cell.traffic["in_flight"])
    done, inflight = [], deque()
    t_start = time.perf_counter()
    t_end = t_start + seconds if seconds is not None else math.inf
    first = cell.next

    def more():
        return (time.perf_counter() < t_end if seconds is not None
                else cell.next < first + calls)

    while True:
        while more() and len(inflight) < depth:
            if label:
                with rf(trace.ISSUE):
                    inflight.append(cell.issue())
            else:
                inflight.append(cell.issue())
        if not inflight:
            break
        c = inflight.popleft()
        if label:
            with rf(trace.WAIT):
                cell.wait(c)
        else:
            cell.wait(c)
        c.in_window = c.t_done <= t_end
        done.append(c)
    return done, t_start, t_end
