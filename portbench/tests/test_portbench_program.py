"""A traced run of each tiny CPU cell reads the metrics that the program's
own counters carry (``host_waits``, ``mp_ops_per_frame``) as numbers, the
count of wait sites and of dispatched ops that the code gives, and reads
the harness's other host-side per-layer metrics as before."""

import io
import json
import math
import time

import pytest
import torch

from portbench.core import harness, loader

import tiny

COUNTERS = ("waits", "recordings", "frames", "exec.ops")


def traced(cell):
    from vhr_tpu_torch.utils.profiling import reset_counters

    reset_counters(*COUNTERS)       # other runs of this process counted too
    out = io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", "4000000033",
                       "--seconds", "2.0", "--trace", "1"],
                      time.perf_counter(), device=torch.device("cpu"),
                      overrides=tiny.overrides(cell), out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def config(cell):
    entry = loader.cell(loader.benchmark(), cell)
    return harness.merge(loader.config(entry["config"]),
                         tiny.overrides(cell)["config"])


@pytest.mark.parametrize("cell", [tiny.SKIN, tiny.MP])
def test_a_traced_run_reads_the_programs_counters(cell):
    res = traced(cell)
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    p = config(cell)["pipeline"]
    fps = float(config(cell)["fps"])
    if cell == tiny.SKIN:
        # The sites: one a 64-length chunk of the ramp, its mask, the
        # band's frequencies and mask (one shard).
        ramp = round(p["window_seconds"] * fps) \
            - round(p["acquisition_seconds"] * fps) + 1
        assert got["host_waits"] == math.ceil(ramp / 64) + 3
        assert got["host_enqueue_ms"] > 0
    else:
        from vhr_tpu_torch.models.mediapipe_face import (_SLICE,
                                                         load_face_models)
        mp = config(cell)["mediapipe"]
        _, det, mesh = load_face_models(
            harness.loader.ROOT + "/" + mp["task_file"],
            activation_dtype=getattr(torch, mp["activation_dtype"]),
            fuse_stages="auto", device=torch.device("cpu"))
        frames = tiny.overrides(cell)["traffic"]["frames"]
        slices = math.ceil(frames / _SLICE)
        assert got["mp_ops_per_frame"] == pytest.approx(
            (det.n_dispatch + mesh.n_dispatch) * slices / frames)
        assert got["host_enqueue_ms.mp"] > 0
