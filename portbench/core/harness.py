"""One run of one cell: set up, warm up, measure for ``--seconds``, judge
what the timed calls produced, print one JSON line.

What is particular to a cell is found by name: its recordings
(``scenes/<scene>.py``), how they are paced (``pacing/<pacing>.py``: the
closed loop holds a fixed number of calls in flight), how the port is
called and judged (``drivers/<driver>.py``), and its metrics
(``metrics/<metric>.py``).
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from portbench.core import guard, judge, loader, trace


@dataclass
class Call:
    group: int
    recordings: int
    frames: int
    t_enter: float
    t_return: float
    t_done: float = math.nan
    in_window: bool = False
    event: object = None
    slot: Optional[dict] = None
    staged: dict = field(default_factory=dict)
    host: dict = field(default_factory=dict)


def merge(base: dict, over: Optional[dict]) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


class Cell:
    """A cell set up on a device from a seed: its driver, its pacing, and
    its resident recordings in groups of one call each."""

    def __init__(self, config: dict, traffic: dict, device, seed: int,
                 fault=None):
        self.config, self.traffic = config, traffic
        self.device = device
        self.cuda = device.type == "cuda"
        self.driver_mod = loader.plugin("drivers", config["driver"])
        self.driver = self.driver_mod.Driver(config, device)
        self.call_fn = fault(self.driver.call) if fault else self.driver.call
        self.pacing = loader.plugin("pacing", traffic["pacing"])
        t = traffic
        self.R, self.P = int(t["resident"]), int(t["per_call"])
        if self.R % self.P:
            raise ValueError("resident recordings must fill whole calls")
        self.T, self.H, self.W = int(t["frames"]), int(t["height"]), \
            int(t["width"])
        scene = loader.plugin("scenes", t["scene"])
        self.frames = scene.make(
            device, self.R, self.T, self.H, self.W, float(config["fps"]),
            seed % 2 ** 63, t)
        self.groups = [self.frames[g * self.P:(g + 1) * self.P]
                       for g in range(self.R // self.P)]
        # Pinned host buffers that a call's outputs are copied into, a set
        # a call in flight, back in ``free`` once its call was waited for:
        # a fresh pinned allocation, or device memory held from call to
        # call, would add the driver's allocation calls (and their waits)
        # to the loop.
        self.free: list = []
        self.next = 0

    def issue(self) -> Call:
        """Enter the next call; its named outputs are queued for copying
        to host memory."""
        k = self.next
        self.next += 1
        g = k % len(self.groups)
        t0 = time.perf_counter()
        outs = self.call_fn(self.groups[g])
        t1 = time.perf_counter()
        c = Call(g, self.P, self.P * self.T, t0, t1)
        if self.cuda:
            c.slot = self.free.pop() if self.free else {}
            for name, t in outs.items():
                buf = c.slot.get(name)
                if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                    buf = c.slot[name] = torch.empty(t.shape, dtype=t.dtype,
                                                     pin_memory=True)
                c.staged[name] = buf.copy_(t, non_blocking=True)
            c.event = torch.cuda.Event()
            c.event.record()
        else:
            c.staged = {name: t.detach() for name, t in outs.items()}
        return c

    def wait(self, c: Call) -> None:
        """Wait until the call's outputs are in host memory, then keep a
        copy of them off the reused buffers."""
        if c.event is not None:
            c.event.synchronize()
        c.t_done = time.perf_counter()
        c.host = {name: t.numpy().copy() for name, t in c.staged.items()}
        if c.slot is not None:
            self.free.append(c.slot)
        c.staged, c.event, c.slot = {}, None, None

    def run(self, seconds: Optional[float] = None, calls: int = 0,
            label: bool = False):
        """The cell's pacing for ``seconds`` (or ``calls`` calls):
        ``(calls, window start, window end)``."""
        return self.pacing.run(self, seconds=seconds, calls=calls,
                               label=label)

    def close(self) -> None:
        self.driver.close()
        self.driver = self.call_fn = None


def span_targets(metrics) -> list:
    out = []
    for mod in metrics:
        for module, attr in getattr(mod, "SPANS", ()):
            out.append((module, attr, getattr(mod, "describe", None)))
    return out


def traced_window(cell: Cell, metrics):
    """The traced calls before the window, in two passes: the traffic's
    ``trace_calls`` with host activity and the spans on (the spans' device
    time, the idle gaps by what the host was doing), then its
    ``busy_calls`` with device activity alone (busy time and the window's
    length, the device's operations), so that the profiler's cost on the
    host weighs as little as it can on the idle share."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if cell.cuda else [])
    with trace.spans(span_targets(metrics)) as infos:
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                done, _, _ = cell.run(calls=int(cell.traffic["trace_calls"]),
                                      label=True)
    tr = trace.reduce(prof, infos)
    if not cell.cuda:
        return tr, done
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        more, t0, _ = cell.run(calls=int(cell.traffic["busy_calls"]))
        t1 = time.perf_counter()
    trace.busy(tr, prof, t1 - t0)
    print(f"traced: spans pass idle {tr.span_idle_pct():.2f} % over "
          f"{len(done)} calls; device-only pass idle "
          f"{100.0 * (1.0 - tr.busy_s / tr.window_s):.2f} % over "
          f"{len(more)} calls, {tr.window_s / len(more) * 1e3:.3f} ms a "
          f"call", file=sys.stderr)
    return tr, done + more


def window_summary(calls, t_start: float, seconds: float) -> None:
    """One line on standard error about the window's calls: how many, the
    host's enqueue and the calls' times, and the frames a second of each
    half of the window (a rate that drifts within a run shows here)."""
    done = [c for c in calls if c.in_window]
    if not done:
        return
    half = t_start + seconds / 2
    first = sum(c.frames for c in done if c.t_done <= half)
    second = sum(c.frames for c in done if c.t_done > half)
    enq = sorted((c.t_return - c.t_enter) * 1e3 for c in done)
    lat = sorted((c.t_done - c.t_enter) * 1e3 for c in done)
    print(f"window: {len(done)} calls of {len(calls)} in {seconds:g} s; "
          f"enqueue ms median {enq[len(enq) // 2]:.3f} max {enq[-1]:.3f}; "
          f"call ms median {lat[len(lat) // 2]:.3f} max {lat[-1]:.3f}; "
          f"frames/s first half {first / (seconds / 2):.1f} second half "
          f"{second / (seconds / 2):.1f}", file=sys.stderr)


def power_limit():
    """(card name, power limit in W) from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.splitlines()[0]
        name, watts = (s.strip() for s in out.split(","))
        return {"name": name, "power_limit_w": float(watts)}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float, device=None, overrides: Optional[dict] = None,
         fault=None, out=None) -> int:
    """Run one cell once.  ``device``, ``overrides`` (``{"config": {...},
    "traffic": {...}}``) and ``fault`` (wraps the driver's call) are for
    the CPU tests; the command line takes the CUDA card or stops."""
    args = parse(argv)
    out = out or sys.stdout
    bench = loader.benchmark()
    cell_entry = loader.cell(bench, args.workload)
    if device is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if cards < int(cell_entry["chips"]):
            print(f"portbench: {args.workload} needs {cell_entry['chips']} "
                  f"CUDA card(s); torch sees {cards}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    over = overrides or {}
    config = merge(loader.config(cell_entry["config"]), over.get("config"))
    traffic = merge(loader.traffic(cell_entry["traffic"]),
                    over.get("traffic"))
    section = "per_layer" if args.trace else "end_to_end"
    entries = loader.metrics_of(bench, args.workload, section)
    metrics = [loader.plugin("metrics", m["name"]) for m in entries]

    t_imported = time.perf_counter()
    cell = Cell(config, traffic, device, args.seed, fault)
    if cell.cuda:
        torch.cuda.synchronize(device)
    t_made = time.perf_counter()
    cell.run(calls=int(traffic["warmup_calls"]))
    t_warm = time.perf_counter()
    tr, traced = traced_window(cell, metrics) if args.trace else (None, [])
    gc.collect()
    gc.freeze()             # set-up's objects out of the window's collections
    setup_s = time.perf_counter() - t0
    print(f"setup: imports {t_imported - t0:.3f} s, driver and recordings "
          f"{t_made - t_imported:.3f} s, warm-up {t_warm - t_made:.3f} s, "
          f"then {setup_s - (t_warm - t0):.3f} s (traced calls, "
          f"collection)", file=sys.stderr)
    calls, t_start, _ = cell.run(seconds=args.seconds)
    peak = torch.cuda.max_memory_allocated(device) if cell.cuda else 0
    found = guard.loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    cell.close()
    gc.collect()
    if cell.cuda:
        torch.cuda.empty_cache()
    window_summary(calls, t_start, args.seconds)
    numbers, attempted, failed = judge.judge_calls(cell, calls + traced)
    limits = config["limits"]

    ctx = dict(calls=calls, seconds=args.seconds, setup_s=setup_s,
               trace=tr, traced_calls=traced, config=config)
    values = {}
    for entry, mod in zip(entries, metrics):
        v = mod.read(ctx)
        if v is not None:
            values[entry["name"]] = {"value": v, "unit": entry["unit"]}
    device_info = {
        "platform": "gpu" if cell.cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cell.cuda
        else device.type,
        "count": int(cell_entry["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(attempted > 0 and failed == 0),
              "attempted": attempted, "failed": failed, "metrics": values,
              "device": device_info}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    card = power_limit() if cell.cuda else None
    if card:
        result["card"] = card
    result["checks"] = {k: {"value": numbers[k], "limit": limit}
                        for k, limit in limits.items()} if numbers else {}
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0
