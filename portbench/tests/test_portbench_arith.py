"""The yardstick's arithmetic on hand shapes: the FLOPs of the bundled
graphs, K1's and K5's least times, and the percentile over every
recording."""

import os
from types import SimpleNamespace

import pytest

from portbench.core import loader, peaks, stats
from portbench.reference.flops import task_flops

TASK = os.path.join(loader.ROOT, "checkpoints", "face_landmarker.task")


def test_flops_of_the_bundled_graphs():
    got = task_flops(TASK)
    assert got["face_detector.tflite"] == 61_521_920
    assert got["face_landmarks_detector.tflite"] == 225_726_976


def test_k1_bound_at_960_frames_of_1080p():
    nbytes, ops = peaks.k1_work(960, 1080, 1920, 8)
    assert nbytes == 960 * 1080 * 1920 * 3 + 960 * 40 + 48
    t, by = peaks.bound(nbytes, ops)
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(1.783, abs=1e-3)   # PERF.md's bound
    # Without row pooling the chroma tests cost more, still under bytes.
    assert peaks.k1_work(960, 1080, 1920, 1)[1] > ops
    assert peaks.bound(*peaks.k1_work(960, 1080, 1920, 1))[1] == "bytes"


def test_k5_bound_of_one_launch():
    # A 64-crop slice at the mesh net's first stage shape: 64x64, C=32.
    nbytes, ops, tensor_ops = peaks.k5_work(B=64, C=32, Cm=16, S=64 * 64,
                                            n_blocks=4, act_bytes=2,
                                            weight_floats=5000)
    assert nbytes == 2 * 2 * 64 * 32 * 4096 + 4 * 5000
    assert tensor_ops == 64 * 4096 * 4 * 4 * 32 * 16
    assert ops == tensor_ops + 64 * 4096 * (4 * (21 * 16 + 4 * 32) + 64)
    t, by = peaks.bound(nbytes, ops, tensor_ops)
    assert t == max(nbytes / peaks.HBM_BPS, (ops - tensor_ops)
                    / peaks.F32_OPS, tensor_ops / peaks.TF32_OPS)


def test_percentile_matches_numpy_linear():
    import numpy as np

    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0]
    for q in (0, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_p95_counts_every_recording():
    read = loader.plugin("metrics", "recording_ms_p95").read
    # 19 calls of 8 recordings at 10 ms and one of 8 at 100 ms: 5 % of
    # the recordings are slow, so the 95th percentile lies between.
    calls = [SimpleNamespace(t_enter=0.0, t_done=0.010, recordings=8,
                             in_window=True) for _ in range(19)]
    calls.append(SimpleNamespace(t_enter=0.0, t_done=0.100, recordings=8,
                                 in_window=True))
    calls.append(SimpleNamespace(t_enter=0.0, t_done=9.0, recordings=8,
                                 in_window=False))
    got = read({"calls": calls})
    assert 10.0 < got < 100.0
    times = [10.0] * 152 + [100.0] * 8
    assert got == pytest.approx(stats.percentile(times, 95.0))


def test_frames_per_s_counts_the_window_only():
    read = loader.plugin("metrics", "frames_per_s").read
    calls = [SimpleNamespace(frames=960, in_window=True)] * 3 + \
        [SimpleNamespace(frames=960, in_window=False)]
    assert read({"calls": calls, "seconds": 2.0}) == 1440.0

