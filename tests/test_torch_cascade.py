"""The port's cascade detectors (``vhr_tpu_torch.models.cascade``) against
the JAX package's on the CPU.

The same numpy clips go through both packages.  Integer outputs (the
window grid, NMS picks) must be equal; crops within 1e-5 (both products in
float32); the multi-face detectors' boxes and validity equal in the
float32 config and within 1 px in bf16 (the shipped config, where each
package rounds its layers to bf16 on its own); the cascade measure's BPM
within 0.5 of JAX's.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vhr_tpu.config import PipelineConfig as JPipelineConfig
from vhr_tpu.models import cascade as jcas
from vhr_tpu.models import facegen
from vhr_tpu.models import landmarker as jlmk
from vhr_tpu.models.train import TrainConfig
from vhr_tpu.pipeline import offline as joffline
from vhr_tpu.utils.synth import FaceSpec, synthesize_multi

from vhr_tpu_torch.config import PipelineConfig
from vhr_tpu_torch.models import cascade as tcas
from vhr_tpu_torch.models import landmarker as tlmk
from vhr_tpu_torch.models.multiface import detect_faces_multi
from vhr_tpu_torch.pipeline import offline as toffline

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SKIN_BG = (80.0, 102.0, 135.0)      # tests/test_multiface.py's background


@pytest.fixture(scope="module")
def params():
    """The shipped weights: ``(jax params, port state_dict)``."""
    return (jlmk.load_default_detector().args[0],
            tlmk.load_params(device="cpu"))


@pytest.fixture(scope="module")
def skin_duo():
    """Two faces on a skin-coloured background, 144 x 256 (the clip of
    ``tests/test_multiface.py::test_tiled_detector_survives_skin_background``,
    cut to 12 frames)."""
    return synthesize_multi(
        (FaceSpec(center=(0.25, 0.45), bpm=60.0),
         FaceSpec(center=(0.72, 0.5), bpm=96.0)),
        height=144, width=256, duration_s=12 / 30, noise_std=1.0,
        background_bgr=SKIN_BG)


@pytest.fixture(scope="module")
def solo():
    return synthesize_multi((FaceSpec(center=(0.5, 0.45), bpm=72.0),),
                            duration_s=12 / 30)


def _configs(dtype_name):
    jcfg, tcfg = TrainConfig().model, tlmk.LandmarkerConfig()
    if dtype_name == "float32":
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    return jcfg, tcfg


def _iou(a, b):
    ix = np.maximum(0, np.minimum(a[..., 2], b[..., 2])
                    - np.maximum(a[..., 0], b[..., 0]))
    iy = np.maximum(0, np.minimum(a[..., 3], b[..., 3])
                    - np.maximum(a[..., 1], b[..., 1]))
    inter = ix * iy
    area = lambda c: (c[..., 2] - c[..., 0]) * (c[..., 3] - c[..., 1])
    return inter / np.maximum(area(a) + area(b) - inter, 1)


# -- crops, windows, selection ------------------------------------------------

def test_crop_boxes_bilinear_matches_gather_oracle_and_jax():
    """``tests/test_landmarker.py``'s five boxes (interior, spilling
    top-left and bottom-right, degenerate, whole frame): the numpy gather
    oracle of the edge-clamp semantics and JAX's crops, within 1e-5."""
    rng = np.random.default_rng(3)
    H, W, S = 71, 103, 24
    frames = rng.integers(0, 256, (5, H, W, 3), dtype=np.uint8)
    boxes = np.array([[20, 15, 60, 55], [-10, -8, 30, 25],
                      [80, 50, 140, 100], [40, 30, 42, 31], [0, 0, W, H]],
                     np.int32)
    crops, origins = tcas.crop_boxes_bilinear(
        torch.as_tensor(frames), torch.as_tensor(boxes), S, pad=0.3)
    crops, origins = crops.numpy(), origins.numpy()
    jc, jo = jcas.crop_boxes_bilinear(jnp.asarray(frames),
                                      jnp.asarray(boxes), S, pad=0.3)
    np.testing.assert_allclose(crops, np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(origins, np.asarray(jo), atol=1e-5, rtol=0)

    b = boxes.astype(np.float64)
    cx, cy = (b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2
    half = np.maximum(np.maximum(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]),
                      2.0) * 0.5 * 1.6
    u = np.arange(S) / (S - 1)
    for t in range(5):
        xs = np.clip(cx[t] - half[t] + u * 2 * half[t], 0, W - 1)
        ys = np.clip(cy[t] - half[t] + u * 2 * half[t], 0, H - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, W - 2)
        y0 = np.clip(np.floor(ys).astype(int), 0, H - 2)
        fx, fy = xs - x0, ys - y0
        img = frames[t].astype(np.float64)
        g = (img[y0][:, x0] * (1 - fx)[None, :, None] * (1 - fy)[:, None, None]
             + img[y0][:, x0 + 1] * fx[None, :, None] * (1 - fy)[:, None, None]
             + img[y0 + 1][:, x0] * (1 - fx)[None, :, None] * fy[:, None, None]
             + img[y0 + 1][:, x0 + 1] * fx[None, :, None] * fy[:, None, None])
        np.testing.assert_allclose(crops[t], g[..., ::-1] / 255.0, atol=1e-5,
                                   rtol=0, err_msg=str(t))
        np.testing.assert_allclose(
            origins[t], [cx[t] - half[t], cy[t] - half[t], 2 * half[t],
                         2 * half[t]], atol=1e-3)


@pytest.mark.parametrize("hw,scales", [
    ((144, 256), (1.0, 0.6)), ((720, 1280), (1.0, 0.6)),
    ((1080, 1920), (1.0, 0.6)), ((96, 120), (1.0, 0.6)),
    ((480, 360), (1.0, 0.5, 0.3)), ((10, 9), (1.0, 0.6))])
def test_tile_windows_equal(hw, scales):
    got = tcas._tile_windows(*hw, scales)
    want = jcas._tile_windows(*hw, scales)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _nms_case(seed, ties):
    rng = np.random.default_rng(seed)
    T, N, H, W = 6, 24, 90, 160
    x1 = rng.integers(-5, W - 10, (T, N))
    y1 = rng.integers(-5, H - 10, (T, N))
    w = rng.integers(0, 60, (T, N))
    h = rng.integers(0, 60, (T, N))
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.int32)
    scores = rng.normal(0, 3, (T, N)).astype(np.float32)
    if ties:                # equal scores: the first window wins
        scores = np.round(scores).astype(np.float32)
        boxes[:, N // 2:] = boxes[:, :N // 2]
    return boxes, scores, (H, W)


@pytest.mark.parametrize("seed,ties,k,frame_hw,suppress", [
    (0, False, 2, True, 0.35), (1, True, 2, True, 0.5),
    (2, True, 3, False, 0.35), (3, False, 4, True, 0.0),
    (4, True, 1, True, 0.9)])
def test_select_faces_nms_equal(seed, ties, k, frame_hw, suppress):
    boxes, scores, hw = _nms_case(seed, ties)
    kw = dict(threshold=0.0, suppress=suppress,
              frame_hw=hw if frame_hw else None)
    jb, jv = jcas.select_faces_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                   k, **kw)
    tb, tv = tcas.select_faces_nms(torch.as_tensor(boxes),
                                   torch.as_tensor(scores), k, **kw)
    assert tb.dtype == torch.int32 and tv.dtype == torch.bool
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_iomin_equal():
    boxes, _, _ = _nms_case(5, False)
    for t in range(3):
        want = np.asarray(jcas._iomin(jnp.asarray(boxes[t, 0]),
                                      jnp.asarray(boxes[t])))
        got = tcas._iomin(torch.as_tensor(boxes[t, 0]),
                          torch.as_tensor(boxes[t])).numpy()
        assert np.array_equal(got, want)


# -- the detectors ------------------------------------------------------------

@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("scene", ["skin_duo", "solo"])
def test_tiled_detector_matches_jax(params, request, scene, dtype_name):
    """The tiled multi-face detector on the skin-background duo (both
    faces found) and on the one-face clip (no phantom second slot)."""
    clip = request.getfixturevalue(scene)
    jcfg, tcfg = _configs(dtype_name)
    jb, jv = jcas.make_tiled_detector_multi(params[0], jcfg, k_faces=2)(
        jnp.asarray(clip.frames))
    tb, tv = tcas.make_tiled_detector_multi(params[1], tcfg, k_faces=2,
                                            device="cpu")(clip.frames)
    jb, jv = np.asarray(jb), np.asarray(jv)
    assert tb.dtype == torch.int32 and tuple(tb.shape) == jb.shape
    assert np.array_equal(tv.numpy(), jv)
    if dtype_name == "float32":
        assert np.array_equal(tb.numpy(), jb)
    else:
        assert np.abs(tb.numpy() - jb).max() <= 1
    if scene == "solo":
        assert tv[:, 0].all() and not tv[:, 1].any()
    else:
        assert tv.all()
        assert (_iou(tb.numpy(), clip.face_boxes).mean(axis=0) >= 0.65).all()


def test_tiled_detector_no_face_no_detection(params):
    """A faceless scene: no valid slot in either package."""
    empty = synthesize_multi((), height=144, width=256, duration_s=6 / 30,
                             noise_std=2.0, background_bgr=(60.0,) * 3)
    _, jv = jcas.make_tiled_detector_multi(params[0], TrainConfig().model)(
        jnp.asarray(empty.frames))
    tb, tv = tcas.make_tiled_detector_multi(params[1], device="cpu")(
        empty.frames)
    assert not np.asarray(jv).any() and not tv.any()
    assert not tb.any()


def test_tiled_proposals_grouping_is_invisible(params, skin_duo):
    """Window groups of any size give the same proposals (float32: the
    batch size changes only the convolutions' summation order)."""
    model = tlmk.build_model(params[1], _configs("float32")[1], "cpu")
    fr = torch.as_tensor(skin_duo.frames[:3])
    b1, s1 = tcas.tiled_landmark_proposals(model, fr)
    b2, s2 = tcas.tiled_landmark_proposals(model, fr, window_batch=2)
    assert b1.shape[1] == len(tcas._tile_windows(144, 256))
    assert torch.equal(b1, b2)
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_refined_detector_matches_jax(params, solo, dtype_name):
    jcfg, tcfg = _configs(dtype_name)
    jb, jv = jcas.make_refined_detector(params[0], jcfg)(
        jnp.asarray(solo.frames))
    tb, tv = tcas.make_refined_detector(params[1], tcfg, device="cpu")(
        solo.frames)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.abs(tb.numpy() - np.asarray(jb)).max() <= \
        (0 if dtype_name == "float32" else 1)


def test_refined_detector_improves_iou_on_the_port():
    """Crop self-refinement sharpens the full-frame box on the held-out
    generator (the JAX package's bar: above the unrefined IoU)."""
    gen = facegen.FaceGenConfig(held_out=True, face_prob=1.0)
    one = tlmk.load_default_detector(device="cpu")
    two = tcas.load_default_refined_detector(device="cpu")
    rng = np.random.default_rng(7)
    ious = {0: [], 1: []}
    for _ in range(5):
        fr, truth = facegen.render_clip(gen, rng, 4, 96, 120)
        for i, det in enumerate((one, two)):
            b, v = det(fr)
            ious[i] += list(np.where(v.numpy(), _iou(b.numpy(), truth), 0.0))
    assert np.mean(ious[1]) > np.mean(ious[0]), ious


def test_cascade_multi_refines_skin_proposals(params, skin_duo):
    """``make_cascade_detector_multi`` on the skin proposals of a clean
    duo: equal to JAX in float32."""
    duo = synthesize_multi(
        (FaceSpec(center=(0.25, 0.45), bpm=60.0),
         FaceSpec(center=(0.72, 0.5), bpm=96.0)),
        height=144, width=256, duration_s=8 / 30, noise_std=1.0)
    jcfg, tcfg = _configs("float32")
    jb, jv = jcas.make_cascade_detector_multi(params[0], jcfg)(
        jnp.asarray(duo.frames))
    tb, tv = tcas.make_cascade_detector_multi(params[1], tcfg,
                                              device="cpu")(duo.frames)
    props, pv = detect_faces_multi(torch.as_tensor(duo.frames), 2)
    assert pv.all() and tv.all()
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(tb.numpy(), np.asarray(jb))


def test_cascade_multi_bpm_matches_jax(params):
    """The cascade in ``measure_green_avg_multi`` on a 144 x 256 duo, 12 s:
    both subjects' steady-state BPM within 0.5 of JAX's and within 5 of
    the truth."""
    duo = synthesize_multi(
        (FaceSpec(center=(0.25, 0.45), bpm=60.0),
         FaceSpec(center=(0.72, 0.5), bpm=96.0)),
        height=144, width=256, duration_s=12.0, noise_std=1.0)
    kw = dict(window_seconds=6.0, acquisition_seconds=3.0)
    jdet = jcas.make_cascade_detector_multi(params[0], TrainConfig().model,
                                            k_faces=2)
    tdet = tcas.make_cascade_detector_multi(params[1], k_faces=2,
                                            device="cpu")
    jts, jbpm, jok = joffline.measure_green_avg_multi(
        jnp.asarray(duo.frames), duo.fps, 2, JPipelineConfig(**kw),
        detector=jdet)
    cfg = PipelineConfig(**kw)
    tts, tbpm, tok = toffline.measure_green_avg_multi(
        torch.as_tensor(duo.frames), duo.fps, 2, cfg, detector=tdet)
    steady = slice(cfg.window_len(duo.fps), None)
    assert np.asarray(tok)[steady].all()
    assert np.array_equal(np.asarray(tok), np.asarray(jok))
    err = np.abs(np.asarray(tbpm)[steady] - np.asarray(jbpm)[steady])
    assert float(err.max()) <= 0.5, err.max()
    truth = np.abs(np.asarray(tbpm)[steady] - duo.bpm_truth[None, :])
    assert float(truth.mean()) <= 5.0
