"""The served pool's cell (``skin_fused-720p.pool64``) on the CPU at a
size a test run holds: a sound run is correct, one tick's means perturbed
is not, and a traced run reads the metrics the program's counters carry
(``pool_waits``, ``pool_tick_host_ms``) and leaves out those that need
the card's trace."""

import io
import json
import time

import torch

from portbench.core import harness, loader

CELL = "skin_fused-720p.pool64"

# Four slots of 64 x 128, 72 ticks a session; a 120-sample ring and 2 s
# Welch segments, so that the BPM is valid from tick 59 on.
OVERRIDES = {
    "config": {"slots": 4, "live": {"ring_len": 120,
                                    "welch_segment_seconds": 2.0}},
    "traffic": {"per_call": 4, "resident": 4, "frames": 72, "height": 64,
                "width": 128, "warmup_calls": 1, "trace_calls": 1,
                "busy_calls": 1}}


def run(fault=None, trace=0, seed=4000000033):
    out = io.StringIO()
    rc = harness.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                       "6.0", "--trace", str(trace)], time.perf_counter(),
                      device=torch.device("cpu"), overrides=OVERRIDES,
                      fault=fault, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def one_tick_means(call):
    """One slot's ROI means at one tick of the session 0.01 levels off."""
    def broken(frames):
        outs = call(frames)
        outs["means"] = outs["means"].clone()
        outs["means"][65, 1] += 0.01
        return outs
    return broken


def test_a_sound_run_is_correct():
    res = run()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in loader.metrics_of(loader.benchmark(), CELL,
                                                 "end_to_end")}
    assert set(res["metrics"]) == want
    assert set(res["checks"]) == set(loader.config(
        "skin_fused-720p")["limits"])


def test_one_ticks_means_perturbed_is_not_correct():
    res = run(fault=one_tick_means)
    assert not res["correct"] and res["failed"] > 0
    assert res["checks"]["means_gap"]["value"] > \
        res["checks"]["means_gap"]["limit"]


def test_a_traced_run_reads_the_programs_counters():
    from vhr_tpu_torch.utils.profiling import reset_counters

    reset_counters("waits", "pool.ticks", "pool.frames")
    res = run(trace=1)
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    # A tick's waits: the masks' upload and the fetch of its outputs.
    assert got["pool_waits"] == 2.0
    assert got["pool_tick_host_ms"] > 0
    # Device readings need the card's trace.
    assert "k4_roofline_pct" not in got
    assert "pool_finish_device_ms" not in got
    assert "device_idle_pct" not in got
