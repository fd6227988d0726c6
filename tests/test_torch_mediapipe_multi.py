"""Port parity for the multi-face MediaPipe detector
(``models.mediapipe_face.make_mediapipe_detector_multi``) and the paths
that take it: ``extract_signals_multi`` and ``measure_green_avg_multi``,
the live ``step_multi`` and ``LivePipeline(k_faces=2)``, the K-face pool
tick, and ``--faces 2 --detector mediapipe`` in the three apps.

The same numpy inputs go to both packages; JAX runs on the CPU.
Tolerances and why:

* the x-order sort and validity on hand-made detections: equal (a stable
  sort on both sides);
* the detector end to end, float32 nets: validity equal, boxes within
  1 px (landmarks agree to ~1e-4 px; a value on an integer boundary can
  still truncate either way);
* the measure: validity equal, BPM within 1e-3 on valid frames (the
  means' float32 sums);
* the port's live and pool paths against its own sequential step: equal.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhr_tpu import config as jconfig
from vhr_tpu.models import mediapipe_face as jmp
from vhr_tpu.pipeline import offline as joffline

from vhr_tpu_torch import serving
from vhr_tpu_torch.apps import rppg_livestream, rppg_video, serve_bpm
from vhr_tpu_torch.config import PipelineConfig
from vhr_tpu_torch.io import video as tvio
from vhr_tpu_torch.models import mediapipe_face as tmp
from vhr_tpu_torch.pipeline import live
from vhr_tpu_torch.pipeline import offline as toffline

from test_torch_mediapipe import draw_face

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)

TASK = tmp.default_task_path()
FPS = 30.0
RATES = (1.25, 1.75)            # Hz: 75 and 105 BPM


def _iou(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ix = np.maximum(0.0, np.minimum(a[..., 2], b[..., 2])
                    - np.maximum(a[..., 0], b[..., 0]))
    iy = np.maximum(0.0, np.minimum(a[..., 3], b[..., 3])
                    - np.maximum(a[..., 1], b[..., 1]))
    inter = ix * iy
    ua = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    ub = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / np.maximum(ua + ub - inter, 1.0)


def duo_clip(T=48, H=192, W=384, pulse=3.0):
    """Two drawn faces side by side (x centres 102 and 282), each with its
    own green pulse on its skin ellipse (``RATES``)."""
    cxs = (W // 4 + 6, 3 * W // 4 - 6)
    a = draw_face(H=H, W=W, cx=cxs[0], cy=H // 2, rx=45, ry=62)
    b = draw_face(H=H, W=W, cx=cxs[1], cy=H // 2, rx=45, ry=62)
    img = a.copy()
    img[:, W // 2:] = b[:, W // 2:]
    ys, xs = np.mgrid[0:H, 0:W]
    frames = np.repeat(img[None], T, axis=0).astype(np.float32)
    t = np.arange(T) / FPS
    for cx, hz in zip(cxs, RATES):
        skin = ((xs - cx) / 45.0) ** 2 + ((ys - H // 2) / 62.0) ** 2 <= 1.0
        frames[:, skin, 1] += (pulse * np.sin(2 * np.pi * hz * t))[:, None]
    return np.clip(frames, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def duo():
    return duo_clip()


@pytest.fixture(scope="module")
def tdet():
    return tmp.make_mediapipe_detector_multi(TASK, k_faces=2,
                                             activation_dtype=None,
                                             device="cpu")


# -- the x-order sort ---------------------------------------------------------

def test_detect_multi_sort_matches_jax(monkeypatch):
    """Hand-made detections with tied ``x1``, invalid faces left of valid
    ones and frames with no valid face: ``_detect_multi``'s boxes and
    validity equal JAX's (both stages replaced by the same arrays)."""
    rng = np.random.default_rng(4)
    T, K, H, W = 8, 4, 100, 200
    x1 = rng.choice([10.0, 30.0, 50.0], (T, K))
    x1[:, 1] = x1[:, 0]                              # ties in every frame
    lm = np.stack([rng.uniform(0, 40, (T, K, 478)) + x1[..., None],
                   rng.uniform(20, 60, (T, K, 478))], -1).astype(np.float32)
    lm[..., 0, 0] = x1                               # the cloud's min x
    det_ok = rng.random((T, K)) > 0.3
    det_ok[3] = False
    presence = rng.uniform(0.2, 1.0, (T, K)).astype(np.float32)
    frames = np.zeros((T, H, W, 3), np.uint8)

    def stages(mod, conv):
        monkeypatch.setattr(mod, "detect_faces_mp",
                            lambda *a, **k: (None, None, conv(det_ok)))
        monkeypatch.setattr(mod, "face_landmarks",
                            lambda *a, **k: (conv(lm), conv(presence)))

    stages(jmp, jnp.asarray)
    jb, jv = jmp._detect_multi(None, None, None, K, jnp.asarray(frames))
    stages(tmp, torch.as_tensor)
    tb, tv = tmp._detect_multi(None, None, None, K, torch.as_tensor(frames))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not tv[3].any() and not tb[3].any()
    v = tv.numpy()
    assert (v[:, :-1] >= v[:, 1:]).all()             # valid faces first


# -- the detector ------------------------------------------------------------

def test_multi_detector_matches_jax(duo, tdet):
    """Float32 nets on the duo, the duo with its right face blanked, and a
    frame of noise: validity equal, boxes within 1 px, x-order; K=1 gives
    the single-face detector's box."""
    one = duo[0].copy()
    one[:, 192:] = one[0, -1]
    noise = np.random.default_rng(0).integers(0, 255, duo[0].shape, np.uint8)
    frames = np.stack([duo[0], one, noise])
    jdet = jmp.make_mediapipe_detector_multi(TASK, k_faces=2,
                                             activation_dtype=None)
    jb, jv = jax.jit(lambda f: jdet(f))(jnp.asarray(frames))
    tb, tv = tdet(torch.as_tensor(frames))
    assert tb.dtype == torch.int32 and tuple(tb.shape) == (3, 2, 4)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.tolist() == [[True, True], [True, False], [False, False]]
    assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 1
    assert tb[0, 0, 2] < tb[0, 1, 0] and not tb[2].any()
    single = tmp.make_mediapipe_detector(TASK, activation_dtype=None,
                                         device="cpu")
    k1 = tmp.make_mediapipe_detector_multi(TASK, k_faces=1,
                                           activation_dtype=None,
                                           device="cpu")
    b1, v1 = k1(torch.as_tensor(frames))
    bs, vs = single(torch.as_tensor(frames))
    assert torch.equal(b1[:, 0], bs) and torch.equal(v1[:, 0], vs)


@pytest.fixture(scope="module")
def photo():
    from vhr_tpu.utils.realface import real_face_image
    img = real_face_image()
    if img is None:
        pytest.skip("no bundled real-face asset in this environment")
    return img


def test_multiface_on_duo_real_photo(photo):
    """``tests/test_realface.py::test_production_multiface_on_duo_real_photo``
    on the port: two half-scale portraits, both found with IoU >= 0.9 at
    the product default, and the float32 nets' boxes within 1 px of
    JAX's."""
    import cv2
    from vhr_tpu.utils import realface
    s = 0.55
    small = cv2.resize(photo, (int(photo.shape[1] * s),
                               int(photo.shape[0] * s)),
                       interpolation=cv2.INTER_AREA)
    h, w = small.shape[:2]
    canvas = np.full((400, 640, 3), 70, np.uint8)
    (ox1, oy1), (ox2, oy2) = (30, 30), (330, 50)
    canvas[oy1:oy1 + h, ox1:ox1 + w] = small
    canvas[oy2:oy2 + h, ox2:ox2 + w] = small
    box = np.asarray(realface.REAL_FACE_BOX, np.float64) * s
    truth = np.stack([box + [ox1, oy1, ox1, oy1], box + [ox2, oy2, ox2, oy2]])

    b, v = tmp.make_mediapipe_detector_multi(k_faces=2, device="cpu")(
        torch.as_tensor(canvas[None]))
    assert bool(v.all())
    assert (_iou(b[0].numpy(), truth) >= 0.9).all()
    jdet = jmp.make_mediapipe_detector_multi(TASK, k_faces=2,
                                             activation_dtype=None)
    jb, jv = jax.jit(lambda f: jdet(f))(jnp.asarray(canvas[None]))
    tb, tv = tmp.make_mediapipe_detector_multi(
        TASK, k_faces=2, activation_dtype=None, device="cpu")(
        torch.as_tensor(canvas[None]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 1
    assert (_iou(tb[0].numpy(), truth) >= 0.9).all()


# -- the offline measure ------------------------------------------------------

_CFG_ARGS = dict(window_seconds=1.0, acquisition_seconds=0.5)


@pytest.mark.parametrize("detect_every", [1, 2])
def test_multi_measure_matches_jax(duo, tdet, detect_every):
    """``extract_signals_multi`` and ``measure_green_avg_multi`` with the
    K=2 MediaPipe detector, float32 nets: validity equal, boxes within
    1 px, BPM within 1e-3 on valid frames, both faces valid throughout."""
    jcfg, cfg = jconfig.PipelineConfig(**_CFG_ARGS), \
        PipelineConfig(**_CFG_ARGS)
    jdet = jmp.make_mediapipe_detector_multi(TASK, k_faces=2,
                                             activation_dtype=None)
    jtr = joffline.extract_signals_multi(jnp.asarray(duo), 2, jcfg,
                                         detector=jdet,
                                         detect_every=detect_every)
    ttr = toffline.extract_signals_multi(torch.as_tensor(duo), 2, cfg,
                                         detector=tdet,
                                         detect_every=detect_every)
    np.testing.assert_array_equal(ttr.valid.numpy(), np.asarray(jtr.valid))
    assert ttr.valid.all()
    assert np.abs(ttr.boxes.numpy() - np.asarray(jtr.boxes)).max() <= 1
    _, jbpm, jval = joffline.measure_green_avg_multi(
        jnp.asarray(duo), FPS, 2, jcfg, trace=jtr)
    _, tbpm, tval = toffline.measure_green_avg_multi(
        torch.as_tensor(duo), FPS, 2, cfg, trace=ttr)
    np.testing.assert_array_equal(tval, np.asarray(jval))
    assert tval.sum() > 0
    np.testing.assert_allclose(tbpm[tval], np.asarray(jbpm)[tval], rtol=0,
                               atol=1e-3)
    if detect_every == 1:
        # Without a trace the measure extracts its own, through the
        # detector.
        again = toffline.measure_green_avg_multi(torch.as_tensor(duo), FPS,
                                                 2, cfg, detector=tdet)
        np.testing.assert_array_equal(again[1], tbpm)


# -- the live step, LivePipeline and the pool ---------------------------------

def test_live_pipeline_multi_mediapipe_equals_step_multi(duo, tdet):
    """``LivePipeline(k_faces=2, detector=...)`` equals the sequential
    ``step_multi`` with the same detector on every frame and field."""
    cfg = live.LiveConfig(fps=10.0, ring_len=30)
    pipe = live.LivePipeline(cfg, detector=tdet, k_faces=2, device="cpu")
    st = live.init_state_multi(cfg, 2, device="cpu")
    outs, refs = [], []
    for f in duo[:36]:
        o = pipe.submit(f)
        if o is not None:
            outs.append(o)
        st, r = live.step_multi(st, torch.as_tensor(f), cfg, 2, tdet)
        refs.append(live.unpack_output(live.pack_output(r).numpy()))
    outs.append(pipe.flush())
    assert len(outs) == 36
    for o, r in zip(outs, refs):
        for k in r._fields:
            assert np.array_equal(getattr(o, k), getattr(r, k)), k
    assert outs[-1].face_valid.all() and outs[-1].box.shape == (2, 4)


@pytest.mark.parametrize("detect_every", [1, 2])
def test_pool_multi_mediapipe_equals_step_multi(duo, tdet, detect_every):
    """A 2-slot K=2 pool with the MediaPipe detector (one slot sees the
    clip mirrored): slot 0 equals ``step_multi`` on its frames on every
    tick, and the mirrored slot's face 0 is the right subject."""
    cfg = live.LiveConfig(fps=10.0, ring_len=30, detect_every=detect_every)
    pool = serving.BpmServer(cfg, n_slots=2, k_faces=2, detector=tdet,
                             device="cpu")
    pool.attach()
    pool.attach()
    st = live.init_state_multi(cfg, 2, device="cpu")
    mirrored = duo[:, :, ::-1].copy()
    for i in range(24):
        outs = pool.tick({0: duo[i], 1: mirrored[i]})
        st, r = live.step_multi(st, torch.as_tensor(duo[i]), cfg, 2, tdet)
        r = live.unpack_output(live.pack_output(r).numpy())
        for k in r._fields:
            assert np.array_equal(getattr(outs[0], k), getattr(r, k)), k
    # The drawn face is not mirror-symmetric (its nose), so the mirrored
    # box lands within a few pixels.
    assert outs[1].face_valid.all()
    assert abs(int(outs[1].box[0, 0]) - (384 - int(outs[0].box[1, 2]))) <= 4


# -- the apps -----------------------------------------------------------------

@pytest.fixture(scope="module")
def duo_avi(tmp_path_factory):
    path = tmp_path_factory.mktemp("mp_multi") / "duo.avi"
    tvio.write_video(duo_clip(T=60), str(path), FPS, fourcc="MJPG")
    return str(path)


def test_resolve_detector_multi_mediapipe(duo):
    """The MediaPipe choices build the K-face detector with the single-face
    choices' options; the learned choices build theirs too, each on the
    CPU and giving K slots a frame."""
    for name in ("mediapipe", "mediapipe-bf16", "mediapipe-exact"):
        det = rppg_video._resolve_detector_multi(name, 2, device="cpu")
        b, v = det(torch.as_tensor(duo[:1]))
        assert tuple(b.shape) == (1, 2, 4) and v.all(), name
    for name in ("landmarker", "landmarker-real", "refined"):
        det = rppg_video._resolve_detector_multi(name, 2, device="cpu")
        b, v = det(torch.as_tensor(duo[:1]))
        assert tuple(b.shape) == (1, 2, 4) and tuple(v.shape) == (1, 2)


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def test_apps_faces_mediapipe(duo_avi, tmp_path):
    """``--faces 2 --detector mediapipe`` runs in the three apps: the video
    app writes its annotated video (2 s: no BPM window fills), the live
    app processes its frames, the serving app builds its K-face pool with
    the detector."""
    rc, out = _run(rppg_video.main, [duo_avi, "--out-dir", str(tmp_path),
                                     "--faces", "2", "--detector",
                                     "mediapipe", "--device", "cpu"])
    assert rc == 0 and "annotated_multi.mp4" in out
    assert tvio.video_metadata(str(tmp_path / "annotated_multi.mp4"))[3] == 60
    rc, out = _run(rppg_livestream.main, [
        "--video", duo_avi, "--no-display", "--faces", "2", "--detector",
        "mediapipe", "--max-frames", "12", "--device", "cpu"])
    assert rc == 0 and "processed 12 frames" in out
    rc, _ = _run(serve_bpm.main, [
        "--host", "127.0.0.1", "--port", "0", "--height", "192", "--width",
        "384", "--slots", "2", "--faces", "2", "--detector", "mediapipe",
        "--max-seconds", "0", "--device", "cpu"])
    assert rc == 0
