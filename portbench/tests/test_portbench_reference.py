"""The plain reference on tiny hand-made clips on the CPU, and against
the port's own plain versions (which the reference never imports)."""

import os

import numpy as np
import pytest
import torch

from portbench.core import loader
from portbench.reference import dsp, executor, skin_fused, track
from portbench.reference.tflite_parse import load_task_models

TASK = os.path.join(loader.ROOT, "checkpoints", "face_landmarker.task")
SKIN = {"cb_min": 77.0, "cb_max": 127.0, "cr_min": 133.0, "cr_max": 173.0,
        "y_min": 40.0, "min_area_fraction": 0.005}
ROI = {"cheek_horizontal": 0.15, "cheek_top": 0.40, "cheek_bottom": 0.65,
       "landmark_hold_frames": 15}


def skin_clip(T=6, H=16, W=128, box=(40, 4, 71, 11), drop=()):
    """Grey frames with a skin rectangle ``box`` (inclusive ends), absent
    from the frames in ``drop``."""
    fr = np.full((T, H, W, 3), 60, np.uint8)
    x1, y1, x2, y2 = box
    for t in range(T):
        if t not in drop:
            fr[t, y1:y2 + 1, x1:x2 + 1] = (105, 135, 180)
    return torch.as_tensor(fr)


def test_skin_box_and_roi_by_hand():
    T, H, W, box = 6, 16, 128, (40, 4, 71, 11)
    stats = skin_fused.frame_stats(skin_clip(T, H, W, box), 1, SKIN)
    assert stats[0].tolist() == [32 * 8, 4, 11, 40, 71]
    rois, boxes, det, roi_ok = skin_fused.track(stats, H, W, T, 1, SKIN, ROI)
    assert boxes.tolist() == [list(box)] * T
    assert det.all() and not roi_ok[0] and roi_ok[1:].all()
    # The cheek ROI of the box from frame 1 on: floor(0.15 * 31) = 4,
    # ceil(4.65) = 5, floor(0.4 * 7) = 2, floor(0.65 * 7) = 4.
    assert rois[1].tolist() == [44, 6, 66, 8]
    means = track.roi_means(skin_clip(T, H, W, box), rois)
    assert means[1].tolist() == [105.0, 135.0, 180.0]


def test_tracker_holds_then_resets_at_each_stream():
    clip = skin_clip(8, drop=(2, 3))
    stats = skin_fused.frame_stats(clip, 1, SKIN)
    _, boxes, det, roi_ok = skin_fused.track(stats, 16, 128, 4, 1, SKIN, ROI)
    assert det.tolist() == [True, True, False, False] + [True] * 4
    assert roi_ok.tolist() == [False, True, True, True, False, True, True,
                               True]
    assert boxes[2].tolist() == boxes[1].tolist()


def test_reference_equals_the_ports_plain_k1():
    fused = pytest.importorskip("vhr_tpu_torch.ops.fused_cuda")
    g = torch.Generator().manual_seed(3)
    clip = skin_clip(12, 64, 128, (30, 10, 90, 50), drop=(5,))
    noise = torch.randint(0, 8, clip.shape, generator=g, dtype=torch.uint8)
    clip = (clip.int() + noise.int()).clamp(0, 255).to(torch.uint8)
    for pool in (1, 2):
        res, _ = fused.fused_detect_roi_plain(clip, fused.init_carry(),
                                              detect_row_pool=pool,
                                              seq_len=6)
        cfg = {"fused": {"detect_row_pool": pool}, "skin": SKIN,
               "pipeline": {"roi": ROI}}
        ref = skin_fused.reference(clip.reshape(2, 6, 64, 128, 3), cfg)
        assert np.array_equal(ref["boxes"].reshape(-1, 4), res.boxes.numpy())
        assert np.array_equal(ref["roi_valid"].reshape(-1),
                              res.roi_valid.numpy())
        ok = res.roi_valid.numpy()
        np.testing.assert_allclose(ref["means"].reshape(-1, 3)[ok],
                                   res.means.numpy()[ok], rtol=1e-6)


def test_rolling_bpm_finds_a_pure_tone():
    fps, T = 30.0, 400
    t = np.arange(T) / fps
    x = np.sin(2 * np.pi * 1.2 * t)[None] + 100.0
    bpm, ok = dsp.rolling_bpm(x, fps, (40 / 60, 200 / 60), 300, 150)
    assert not ok[0, :149].any() and ok[0, 149:].all()
    assert np.allclose(bpm[0, 299:], 72.0)


def test_rolling_bpm_equals_the_ports():
    windows = pytest.importorskip("vhr_tpu_torch.ops.windows")
    from vhr_tpu_torch.config import HRBand

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 120)).cumsum(-1)
    band = (40 / 60, 200 / 60)
    bpm, ok = dsp.rolling_bpm(x, 30.0, band, 90, 30)
    got = windows.rolling_bpm_fft(torch.as_tensor(x.T, dtype=torch.float32),
                                  30.0, HRBand(*band), 90, 30)
    assert np.array_equal(ok, got.valid.numpy().T)
    assert np.abs(bpm - got.bpm.numpy().T).max() < 1e-3


def test_fill_and_holdover():
    x = np.array([[1.0, 2.0, 3.0, 4.0, 5.0]])
    v = np.array([[False, True, False, False, True]])
    assert dsp.fill_invalid(x, v).tolist() == [[0.0, 2.0, 2.0, 2.0, 5.0]]
    boxes = np.arange(20).reshape(5, 4)
    held, ok = track.holdover(boxes, np.array([0, 1, 0, 0, 0], bool), 2)
    assert ok.tolist() == [False, True, True, True, False]
    assert held[3].tolist() == boxes[1].tolist()


def test_executor_equals_the_ports_numpy_oracle():
    tex = pytest.importorskip("vhr_tpu_torch.models.tflite_exec")
    models = load_task_models(TASK)
    rng = np.random.default_rng(1)
    for name, size in (("face_detector.tflite", 128),
                       ("face_landmarks_detector.tflite", 256)):
        g = models[name].graph
        x = rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
        want = tex.NumpyInterpreter(g)(x)
        got = executor.Graph(g, "cpu")(torch.as_tensor(x))
        for a, b in zip(got, want):
            b = np.asarray(b)
            scale = max(1.0, float(np.abs(b).max()))
            assert np.abs(a.numpy().reshape(b.shape) - b).max() < 1e-3 * scale


def test_float8_control_rounds():
    q = executor.rounder("float8")
    x = torch.tensor([1.0, 1.05, 300.0, 1000.0])
    assert q(x).tolist() == [1.0, 1.0, 288.0, 448.0]
