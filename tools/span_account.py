#!/usr/bin/env python3
"""The port's spans on the card: where a benchmark cell's time goes, by
``vhr.*`` span, from the program's own spans and counters.

    python3 tools/span_account.py [--cell NAME ...] [--seed N]
                                  [--calls N] [--rounds N] [--sync-debug]
                                  [--out PATH]

Run it from the root of the checkout on a machine with a CUDA card; it
makes each cell of ``BENCHMARK.json`` (both by default) with the
benchmark's own scenes, driver and pacing (``portbench/``), warms it up,
then:

1. **The cost of tracing.**  The same calls traced by ``torch.profiler``
   with host and device activity, in turns with the program's spans off
   and on (off, on, on, off, ``--rounds`` times): the host's milliseconds
   a call up to its return.  Also the cost of one span with tracing off,
   in nanoseconds.
2. **The spans pass.**  ``--calls`` calls (the traffic's ``trace_calls``
   by default) under the profiler inside ``tracing()``.  Each program
   span's device time is the kernel, copy and set time of the work
   launched inside it: a device event belongs to the innermost span open
   on the host when its launch (the runtime call with the same
   correlation id) was made.  The device's idle gaps are put down to the
   innermost span open when each began.  It prints, per span name, the
   count, host, own host and device milliseconds a call and the idle time
   begun under it; the greatest gap between an in-memory span and its
   profiler range (the two clocks); and the per-layer quantities the
   benchmark lacks a reader for (``host_blocked_ms``, ``host_waits``,
   ``idle_after_wait_pct``, ``mp_ops_per_frame``, ``mp_dispatch_ms``,
   ``mp_resample_device_ms``).
3. With ``--sync-debug``: one call under
   ``torch.cuda.set_sync_debug_mode("warn")``, each synchronizing call
   listed by its site and whether a ``vhr.wait`` span holds it.

Prints the card's name and power limit first; writes everything to
``--out`` (``results/span_account.json`` by default).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import timeit
import traceback
import warnings
from bisect import bisect_right
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def card_line(torch) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not available"
    return f"{torch.cuda.get_device_name(0)}; {out}; torch {torch.__version__}"


def make_cell(name: str, seed: int, device, tiny: bool = False):
    """The cell as the benchmark makes it; ``tiny``: at the sizes of the
    benchmark's CPU tests, for a rehearsal on the CPU."""
    from portbench.core import harness, loader

    entry = loader.cell(loader.benchmark(), name)
    over = {}
    if tiny:
        sys.path.insert(0, os.path.join(ROOT, "portbench", "tests"))
        import tiny as sizes
        over = sizes.overrides(name)
    return harness.Cell(
        harness.merge(loader.config(entry["config"]), over.get("config")),
        harness.merge(loader.traffic(entry["traffic"]), over.get("traffic")),
        device, seed)


def _acts():
    import torch
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def enqueue_ms(calls) -> float:
    return statistics.mean((c.t_return - c.t_enter) * 1e3 for c in calls)


def cost_of_tracing(cell, rounds: int, calls: int) -> dict:
    """Host ms a call up to its return, the profiler recording host and
    device activity, program spans off and on in turns."""
    from torch.profiler import profile

    from vhr_tpu_torch.utils import profiling

    acts = _acts()
    got = {"off": [], "on": []}
    for _ in range(rounds):
        for mode in ("off", "on", "on", "off"):
            with profile(activities=acts):
                if mode == "on":
                    with profiling.tracing():
                        done, _, _ = cell.run(calls=calls)
                else:
                    done, _, _ = cell.run(calls=calls)
            _sync()
            got[mode].append(enqueue_ms(done))
    out = {k: {"runs_ms": v, "median_ms": statistics.median(v)}
           for k, v in got.items()}
    out["on_over_off"] = out["on"]["median_ms"] / out["off"]["median_ms"]
    return out


def span_off_ns() -> dict:
    from vhr_tpu_torch.utils import profiling

    def bare():
        with profiling.span("vhr.k1"):
            pass

    def attrs():
        with profiling.span("vhr.k1", T=960, H=1080, W=1920, pool=1):
            pass
    n = 200000
    return {f.__name__: min(timeit.repeat(f, number=n, repeat=5)) / n * 1e9
            for f in (bare, attrs)}


def _events(prof):
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        yield e, e.device_type() == DeviceType.CUDA


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Innermost:
    """The innermost in-memory span open at a host time (ns): the spans of
    one thread nest, so the innermost changes only where one starts or
    ends."""

    def __init__(self, spans):
        spans = [s for s in spans if s.end_ns > s.start_ns]
        self.by_id = {s.id: s for s in spans}
        marks = sorted([(s.start_ns, 1, s.id) for s in spans]
                       + [(s.end_ns, 0, s.id) for s in spans])
        self.times, self.top, stack = [], [], []
        for t, opens, sid in marks:
            if opens:
                stack.append(sid)
            else:
                stack.remove(sid)
            self.times.append(t)
            self.top.append(stack[-1] if stack else None)

    def at(self, t):
        k = bisect_right(self.times, t) - 1
        return self.by_id.get(self.top[k]) if k >= 0 else None

    def chain(self, s):
        while s is not None:
            yield s
            s = self.by_id.get(s.parent)


def covered(merged, starts, a, b) -> int:
    """Nanoseconds of the merged intervals inside ``[a, b]``."""
    k = max(bisect_right(starts, a) - 1, 0)
    total = 0
    while k < len(merged) and merged[k][0] < b:
        total += max(0, min(b, merged[k][1]) - max(a, merged[k][0]))
        k += 1
    return total


def spans_pass(cell, calls: int) -> dict:
    """``calls`` calls under the profiler with the program's spans on."""
    from torch.profiler import profile, record_function

    from portbench.core import trace
    from vhr_tpu_torch.utils import profiling

    with profile(activities=_acts()) as prof:
        with profiling.tracing() as traced:
            with record_function(trace.WINDOW):
                done, _, _ = cell.run(calls=calls, label=True)
    _sync()
    spans = [s for s in traced.spans if s.name.startswith("vhr.")]
    inner = Innermost(spans)
    win, host_ranges, launch_at = None, defaultdict(list), {}
    dev, notes = [], defaultdict(list)
    for e, on_dev in _events(prof):
        a = e.start_ns()
        b = a + e.duration_ns()
        name = e.name()
        if not on_dev:
            if name == trace.WINDOW:
                win = (a, b)
            elif name.startswith("vhr."):
                host_ranges[name].append((a, b))
            elif name.startswith("cuda") or name.startswith("cu"):
                launch_at[e.correlation_id()] = a
        elif name.startswith("vhr.") or name.startswith("portbench."):
            notes[name].append((a, b))
        elif b > a:
            dev.append((a, b, e.correlation_id(), name))
    w0, w1 = win
    dev = [(max(a, w0), min(b, w1), c, n) for a, b, c, n in dev
           if min(b, w1) > max(a, w0)]
    merged = _union([(a, b) for a, b, _, _ in dev])
    busy = sum(b - a for a, b in merged)

    # The two clocks: each in-memory span against its profiler range, the
    # range's start to the span's, the span's end to the range's (us).
    starts, ends, worst = [], [], (0, None)
    for name in {s.name for s in spans}:
        mine = sorted((s.start_ns, s.end_ns) for s in spans
                      if s.name == name)
        theirs = sorted(host_ranges.get(name, []))
        if len(mine) != len(theirs):
            continue
        for x, y in zip(mine, theirs):
            starts.append((x[0] - y[0]) / 1e3)
            ends.append((y[1] - x[1]) / 1e3)
            far = max(abs(starts[-1]), abs(ends[-1]))
            if far > worst[0]:
                worst = (far, name)
    clock = {"spans": len(starts), "worst_span": worst[1]}
    for key, v in (("start_us", sorted(starts)), ("end_us", sorted(ends))):
        if v:
            clock[key] = {"min": v[0], "median": v[len(v) // 2],
                          "p99": v[int(0.99 * (len(v) - 1))], "max": v[-1]}
    # Device time of each span: the device events launched inside it.
    per_span = defaultdict(list)
    matched = 0
    for a, b, corr, _ in dev:
        t = launch_at.get(corr)
        if t is None:
            continue
        matched += 1
        for s in inner.chain(inner.at(t)):
            per_span[s.id].append((a, b))
    dev_ns = {sid: sum(b - a for a, b in _union(iv))
              for sid, iv in per_span.items()}
    # Device time under each name's device annotations, for comparison.
    starts = [a for a, _ in merged]
    notes_ns = {name: sum(covered(merged, starts, a, b) for a, b in iv)
                for name, iv in notes.items()}
    # Idle gaps by the innermost span open when each began.
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle = sum(b - a for a, b in gaps)
    idle_by = defaultdict(int)
    after_wait = 0
    for a, b in gaps:
        s = inner.at(a)
        idle_by[s.name if s else "(outside the port)"] += b - a
        if any(x.name == "vhr.wait" for x in inner.chain(s)):
            after_wait += b - a
    self_ns = traced.self_ns()
    n = len(done)
    table = {}
    for s in spans:
        row = table.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                        "own_host_ms": 0.0,
                                        "device_ms": 0.0})
        row["count"] += 1
        row["host_ms"] += s.ns / 1e6 / n
        row["own_host_ms"] += self_ns[s.id] / 1e6 / n
        row["device_ms"] += dev_ns.get(s.id, 0) / 1e6 / n
    for name, ns in idle_by.items():
        table.setdefault(name, {})["idle_begun_ms"] = ns / 1e6 / n
    for name, ns in notes_ns.items():
        table.setdefault(name, {})["annotation_device_ms"] = ns / 1e6 / n
    counts = traced.counts
    recordings = counts.get("recordings", 0)
    waits = [s for s in spans if s.name == "vhr.wait"]
    nets = [s for s in spans if s.name in ("vhr.det.net", "vhr.mesh.net")]
    net_ids = {s.id for s in nets}
    net_waits = sum(s.ns for s in waits if s.parent in net_ids or any(
        x.id in net_ids for x in inner.chain(s)))
    resample = sum(dev_ns.get(s.id, 0) for s in spans
                   if s.name in ("vhr.det.letterbox", "vhr.mesh.crop"))
    metrics = {
        "host_blocked_ms": sum(s.ns for s in waits) / 1e6 / n,
        "host_blocked_ms_a_recording":
            sum(s.ns for s in waits) / 1e6 / max(recordings, 1),
        "host_waits": counts.get("waits", 0) / n,
        "idle_after_wait_pct": 100.0 * after_wait / idle if idle else None,
        "mp_ops_per_frame": counts["exec.ops"] / counts["frames"]
        if counts.get("exec.ops") else None,
        "mp_dispatch_ms": (sum(s.ns for s in nets) - net_waits) / 1e6
        / max(recordings, 1) if nets else None,
        "mp_resample_device_ms": resample / 1e6 / max(recordings, 1)
        if nets else None,
    }
    return {"calls": n, "window_ms": (w1 - w0) / 1e6,
            "busy_ms": busy / 1e6, "idle_pct": 100.0 * idle / (w1 - w0),
            "device_events": len(dev), "device_events_matched": matched,
            "clock": clock, "counts": counts,
            "metrics": metrics, "by_span": table}


def sync_debug(cell) -> dict:
    """One call with every synchronizing CUDA call reported: its site and
    whether a ``vhr.wait`` span holds it."""
    import torch

    from vhr_tpu_torch.utils import profiling

    sites = defaultdict(lambda: {"n": 0, "in_wait": 0})

    def show(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        port = [f for f in stack if "vhr_tpu_torch" in f.filename
                and "profiling.py" not in f.filename]
        where = (f"{os.path.relpath(port[-1].filename, ROOT)}:"
                 f"{port[-1].lineno} {port[-1].line}" if port
                 else f"{filename}:{lineno}")
        st = profiling._stack()
        sites[where]["n"] += 1
        if st and st[-1].name == "vhr.wait":
            sites[where]["in_wait"] += 1

    old = warnings.showwarning
    warnings.showwarning = show
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            with profiling.tracing():
                cell.run(calls=1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        warnings.showwarning = old
    return dict(sites)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", action="append")
    ap.add_argument("--seed", type=int, default=3000000019)
    ap.add_argument("--calls", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sync-debug", action="store_true")
    ap.add_argument("--out", default=os.path.join("results",
                                                  "span_account.json"))
    ap.add_argument("--tiny", action="store_true",
                    help="a rehearsal on the CPU at the sizes of the "
                    "benchmark's CPU tests")
    args = ap.parse_args()

    import torch

    from portbench.core import loader

    if args.tiny:
        dev, card = torch.device("cpu"), "cpu (a rehearsal: no times)"
    elif torch.cuda.is_available():
        dev, card = torch.device("cuda", 0), card_line(torch)
    else:
        print("span_account: needs a CUDA card", file=sys.stderr)
        return 2
    print(card, flush=True)
    cells = args.cell or [w["name"] for w in
                          loader.benchmark()["workloads"]]
    out = {"card": card, "span_off_ns": span_off_ns()}
    print(f"a span with tracing off: {out['span_off_ns']} ns", flush=True)
    for name in cells:
        t0 = time.perf_counter()
        cell = make_cell(name, args.seed, dev, args.tiny)
        calls = args.calls or int(cell.traffic["trace_calls"])
        cell.run(calls=int(cell.traffic["warmup_calls"]))
        _sync()
        res = {}
        if args.sync_debug and cell.cuda:
            res["sync_debug"] = sync_debug(cell)
            print(f"[{name}] synchronizing calls: "
                  f"{json.dumps(res['sync_debug'], indent=1)}", flush=True)
        res["cost"] = cost_of_tracing(cell, args.rounds, calls)
        print(f"[{name}] host ms a call under the profiler, spans off "
              f"{res['cost']['off']['runs_ms']}, on "
              f"{res['cost']['on']['runs_ms']}: on/off "
              f"{res['cost']['on_over_off']:.4f}", flush=True)
        print(f"[{name}] spans pass from {time.strftime('%H:%M:%S')}",
              flush=True)
        res["spans"] = spans_pass(cell, calls)
        sp = res["spans"]
        print(f"[{name}] spans pass: {sp['calls']} calls, window "
              f"{sp['window_ms']:.3f} ms, busy {sp['busy_ms']:.3f} ms, idle "
              f"{sp['idle_pct']:.2f} %, device events {sp['device_events']} "
              f"({sp['device_events_matched']} matched to a launch); "
              f"counts {sp['counts']}", flush=True)
        print(f"[{name}] clocks: {json.dumps(sp['clock'])}", flush=True)
        print(f"[{name}] metrics {json.dumps(sp['metrics'])}", flush=True)
        for sname, row in sorted(sp["by_span"].items(),
                                 key=lambda kv: -kv[1].get("host_ms", 0)):
            print(f"[{name}]   {sname:22s} " + " ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()), flush=True)
        cell.close()
        del cell
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t0
        out[name] = res
    path = os.path.join(ROOT, args.out)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"ok": True, "span_off_ns": out["span_off_ns"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
