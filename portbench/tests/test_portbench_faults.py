"""A run with the timed path broken underneath comes out not correct, for
each fault the cells can have, and a sound run comes out correct; the
control (the reference a precision lower) fails the comparison."""

import io
import json
import time

import pytest
import torch

from portbench.core import harness, loader

import tiny

calibrate = loader.plugin("tools", "calibrate")

def run(cell, fault=None, trace=0, seed=11):
    out = io.StringIO()
    seconds = "4.0" if cell == tiny.MP else "2.0"
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       seconds, "--trace", str(trace)], time.perf_counter(),
                      device=torch.device("cpu"),
                      overrides=tiny.overrides(cell), fault=fault, out=out)
    assert rc == 0
    line = out.getvalue().strip().splitlines()[-1]
    return json.loads(line)


def unchanged(call):
    """The outputs and what the call produced on the way left as they
    were made: zeros."""
    def broken(frames):
        return {k: torch.zeros_like(v) for k, v in call(frames).items()}
    return broken


def half_batch(call):
    """Half of the batch left out (the first half of the recordings, or of
    a lone recording's frames), its results spread over the rest."""
    def broken(frames):
        S, T = frames.shape[:2]
        if S > 1:
            return {k: torch.cat([v] * 2)
                    for k, v in call(frames[:S // 2]).items()}
        outs = call(frames[:, :T // 2].contiguous())
        # Per-stream outputs are (1, T / 2), the flat ones (T / 2, ...).
        return {k: torch.cat([v] * 2, 1 if v.shape[0] == 1 else 0)
                for k, v in outs.items()}
    return broken


def altered(call):
    """One recording's answer altered where it is produced: its BPM
    trace 6 BPM higher."""
    def broken(frames):
        outs = call(frames)
        outs["bpm"] = outs["bpm"].clone()
        outs["bpm"][0] += 6.0
        return outs
    return broken


@pytest.mark.parametrize("cell", [tiny.SKIN, tiny.MP])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(cell, trace):
    res = run(cell, trace=trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    bench = loader.benchmark()
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in loader.metrics_of(bench, cell, section)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want


@pytest.mark.parametrize("cell", [tiny.SKIN, tiny.MP])
@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
def test_a_broken_path_is_not_correct(cell, fault):
    res = run(cell, fault=fault)
    assert not res["correct"] and res["failed"] > 0


@pytest.mark.parametrize("cell", [tiny.SKIN, tiny.MP])
def test_the_control_is_not_correct(cell):
    """The reference in the precision below the configuration's, in the
    program's place, fails the cell's comparison."""
    bench = loader.benchmark()
    entry = loader.cell(bench, cell)
    over = tiny.overrides(cell)
    config = harness.merge(loader.config(entry["config"]), over["config"])
    traffic = harness.merge(loader.traffic(entry["traffic"]),
                            over["traffic"])
    c = harness.Cell(config, traffic, torch.device("cpu"), 5)
    c.close()
    _, attempted, failed = calibrate.control(c, config, c.device)
    assert failed == attempted == len(c.groups) * c.P
