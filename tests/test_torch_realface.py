"""The real-face corpus in the port (``vhr_tpu_torch.utils.realface``) and
the real-photo-distilled landmarker on it, against the JAX package on the
CPU.

The portrait is ``checkpoints/real_face.jpg``, a byte copy of matplotlib's
``sample_data/grace_hopper.jpg`` that both packages read first; the clip
synthesis is numpy and cv2 in both and must be equal bit for bit.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vhr_tpu.models import landmarker as jlmk
from vhr_tpu.utils import realface as jrealface

from vhr_tpu_torch.models import landmarker as tlmk
from vhr_tpu_torch.utils import realface as trealface

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ASSET = REPO / "checkpoints" / "real_face.jpg"


def _iou(a, c):
    ix = max(0, min(a[2], c[2]) - max(a[0], c[0]))
    iy = max(0, min(a[3], c[3]) - max(a[1], c[1]))
    inter = ix * iy
    union = ((a[2] - a[0]) * (a[3] - a[1])
             + (c[2] - c[0]) * (c[3] - c[1]) - inter)
    return inter / max(union, 1)


def test_real_face_jpg_equals_matplotlib_asset():
    """The repo's portrait decodes equal to matplotlib's bundled one."""
    mpl = pytest.importorskip("matplotlib")
    import cv2
    path = os.path.join(mpl.get_data_path(), "sample_data",
                        "grace_hopper.jpg")
    if not os.path.exists(path):
        pytest.skip("matplotlib ships no grace_hopper.jpg here")
    ours, theirs = cv2.imread(str(ASSET)), cv2.imread(path)
    assert ours is not None and ours.shape == (600, 512, 3)
    assert np.array_equal(ours, theirs)


def test_both_packages_read_the_repo_asset():
    """The first candidate of each package is the repo's file, so neither
    needs matplotlib."""
    for mod in (jrealface, trealface):
        assert os.path.realpath(mod._ASSET_CANDIDATES[0]) == \
            os.path.realpath(ASSET)
    assert np.array_equal(trealface.real_face_image(),
                          jrealface.real_face_image())
    assert trealface.REAL_FACE_BOX == jrealface.REAL_FACE_BOX


@pytest.mark.parametrize("kw", [
    dict(),
    dict(scale=1.8, fps=30.0, duration_s=0.4, bpm=72.0),
    dict(duration_s=1.0, flicker_bpm=90.0, flicker_amp=0.02,
         occlude_frac=0.4, seed=3),
    dict(duration_s=0.5, motion_px=3.0, noise_std=0.0, scale=0.5)])
def test_synthesize_real_face_clip_equals_jax(kw):
    j = jrealface.synthesize_real_face_clip(**kw)
    t = trealface.synthesize_real_face_clip(**kw)
    assert np.array_equal(t.frames, j.frames)
    assert np.array_equal(t.face_boxes, j.face_boxes)
    assert np.array_equal(t.pulse, j.pulse)
    assert (t.fps, t.bpm_truth) == (j.fps, j.bpm_truth)


@pytest.mark.parametrize("scale", [1.0, 1.8])
def test_landmarker_real_on_the_portrait(scale):
    """``landmarker-real`` finds the real face: IoU >= 0.75 against the
    MediaPipe box (JAX's bar), boxes within 1 px of JAX's, validity
    equal."""
    clip = trealface.synthesize_real_face_clip(scale=scale, duration_s=0.4,
                                               seed=1)
    jb, jv = jlmk.load_real_distilled_detector()(jnp.asarray(clip.frames))
    tb, tv = tlmk.load_real_distilled_detector(device="cpu")(clip.frames)
    assert np.array_equal(tv.numpy(), np.asarray(jv)) and tv.all()
    assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 1
    truth = np.asarray(trealface.REAL_FACE_BOX) * scale
    photo = trealface.real_face_image()
    if scale == 1.0:
        b, v = tlmk.load_real_distilled_detector(device="cpu")(photo[None])
        assert bool(v[0]) and _iou(b[0].tolist(), truth) >= 0.75
    for t in range(len(tb)):
        assert _iou(tb[t].tolist(), clip.face_boxes[t]) >= 0.75
