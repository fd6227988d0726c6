"""Port parity for the landmark ROI forms: the landmark ROIs of
``ops.roi``, the mesh-polygon means of ``ops.polyroi``, the holdover of a
float vertex ring, the MediaPipe ROI and polygon detectors, and the two
measures that read them (``extract_signals_landmark_roi``,
``extract_signals_polygon``), against ``vhr_tpu`` on the same numpy inputs.

Tolerances and why:

* boxes, ROIs, masks, validity and held rings: equal (the same float32
  expressions on identical float inputs; a held ring is a copy);
* ``polygon_channel_means``: means within 1e-3 on the 0-255 scale and the
  count within ``rtol=1e-5`` of the JAX function run op by op (each sums
  1024 float32 samples in its own order);
* the polygon measure: validity, ROIs and boxes equal; means within 1e-4 of
  JAX's ``polygon_channel_means`` op by op on JAX's own held ring, and
  within 2e-3 of JAX's jitted measure: under ``jit`` XLA:CPU sums the
  masked samples in float32 in another order, up to 8e-4 away from the
  float64 sum of the same samples on noise frames, where the port and the
  op-by-op JAX function stay within 2e-5 of it;
* the landmark-ROI measure: validity, ROIs and boxes equal, means within
  1e-4 (the port sums exactly, JAX in float32);
* detectors end to end, float32 nets: boxes, ROIs and vertices within 1 px
  (landmarks agree to ~1e-4 px; a value on an integer boundary can still
  truncate either way), validity equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhr_tpu import config as jconfig
from vhr_tpu.models import mediapipe_face as jmp
from vhr_tpu.ops import polyroi as jpoly
from vhr_tpu.ops import roi as jroi
from vhr_tpu.pipeline import offline as joffline
from vhr_tpu.utils.synth import SynthSpec, synthesize

from vhr_tpu_torch.config import PipelineConfig, ROIConfig
from vhr_tpu_torch.models import mediapipe_face as tmp
from vhr_tpu_torch.ops import polyroi as tpoly
from vhr_tpu_torch.ops import reduce as treduce
from vhr_tpu_torch.ops import roi as troi
from vhr_tpu_torch.pipeline import offline as toffline

from test_torch_mediapipe import draw_face

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)

TASK = tmp.default_task_path()
W, H = 640, 480


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


# --- the landmark ROIs of ops.roi ------------------------------------------

def _ellipse_clouds(rng, n, roll_deg, L=68):
    """``n`` noisy rotated-ellipse boundary clouds ``(n, L, 2)`` float32 in
    normalized coordinates (``tests/test_roi_ops.py``'s layout)."""
    th = 2.0 * np.pi * np.arange(L) / L
    cx, cy = rng.uniform(0.3, 0.7, (n, 1)), rng.uniform(0.3, 0.6, (n, 1))
    rx, ry = rng.uniform(0.1, 0.25, (n, 1)), rng.uniform(0.15, 0.35, (n, 1))
    a = np.deg2rad(roll_deg)
    ex, ey = rx * np.cos(th), ry * np.sin(th)
    pts = np.stack([cx + ex * np.cos(a) - ey * np.sin(a),
                    cy + ex * np.sin(a) + ey * np.cos(a)], -1)
    return (pts + rng.normal(0, 0.003, pts.shape)).astype(np.float32)


def test_cheek_poly_idx_equals_jax():
    assert tpoly.CHEEK_POLY_IDX == jpoly.CHEEK_POLY_IDX


@pytest.mark.parametrize("seed", range(3))
def test_bbox_from_landmarks_matches_jax(seed):
    """Clouds inside and across the frame's edges: equal boxes."""
    rng = np.random.default_rng(seed)
    lms = rng.uniform(-0.1, 1.1, (32, 478, 2)).astype(np.float32)
    lms[:16] = rng.uniform(0.1, 0.9, (16, 478, 2))
    got = troi.bbox_from_landmarks(_t(lms), W, H)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jroi.bbox_from_landmarks(_j(lms), W, H)))


@pytest.mark.parametrize("roll", [0.0, 20.0])
def test_roi_from_landmarks_matches_jax(roll):
    """Upright and 20-degree rolled noisy clouds: the cheek ROI and a
    forehead-like ROI equal JAX's, eager and jitted; on an upright clean
    cloud the cheek ROI is the box-ratio ROI within 2 px
    (``tests/test_roi_ops.py``'s bound)."""
    rng = np.random.default_rng(int(roll) + 5)
    lms = _ellipse_clouds(rng, 64, roll)
    cfg, jcfg = ROIConfig(), jconfig.ROIConfig()
    got = troi.cheek_roi_from_landmarks(_t(lms), cfg, W, H)
    assert got.dtype == torch.int32
    want = jroi.cheek_roi_from_landmarks(_j(lms), jcfg, W, H)
    jitted = jax.jit(lambda x: jroi.cheek_roi_from_landmarks(
        x, jcfg, W, H))(_j(lms))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jitted))
    np.testing.assert_array_equal(
        troi.roi_from_landmarks(_t(lms), 0.2, 0.05, 0.3, W, H).numpy(),
        np.asarray(jroi.roi_from_landmarks(_j(lms), 0.2, 0.05, 0.3, W, H)))
    if roll == 0.0:             # tests/test_roi_ops.py's noise-free cloud
        th = 2.0 * np.pi * np.arange(68) / 68
        lm = _t(np.stack([0.5 + 0.2 * np.cos(th), 0.45 + 0.3 * np.sin(th)],
                         -1).astype(np.float32)[None])
        naive = troi.cheek_roi(troi.bbox_from_landmarks(lm, W, H), cfg, W, H)
        robust = troi.cheek_roi_from_landmarks(lm, cfg, W, H)
        assert int((robust - naive).abs().max()) <= 2


@pytest.mark.parametrize("seed", range(3))
def test_rotated_cheek_roi_matches_jax(seed):
    """The ROI carved in the rolled face frame, on the same pixel clouds
    and rolls (some clouds across the frame's edges): equal to JAX's, eager
    and jitted."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(-40, 680, (48, 478, 2)).astype(np.float32)
    lm[:24] = rng.uniform(100, 500, (24, 478, 2))
    rot = rng.uniform(-0.7, 0.7, 48).astype(np.float32)
    got = tmp._rotated_cheek_roi(_t(lm), _t(rot), 0.15, 0.4, 0.65, W, H)
    assert got.dtype == torch.int32
    fn = lambda a, b: jmp._rotated_cheek_roi(a, b, 0.15, 0.4, 0.65, W, H)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(fn(_j(lm), _j(rot))))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.jit(fn)(_j(lm), _j(rot))))


# --- ops.polyroi ------------------------------------------------------------

def _gradient_frame(H=120, W=160):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([xx, yy, (xx + yy) / 2.0], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _rings(rng, T, E=9, integer=False):
    """``T`` convex rings of ``E`` vertices ``(T, E, 2)`` float32, some
    across the 160 x 120 frame's edges."""
    c = rng.uniform(10, 150, (T, 1, 2))
    r = rng.uniform(5, 60, (T, E, 1))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (T, E)), axis=1)
    v = c + r * np.stack([np.cos(ang), np.sin(ang)], -1)
    return (np.round(v) if integer else v).astype(np.float32)


def _lattice(verts, grid=32):
    x1, x2 = verts[..., 0].min(-1), verts[..., 0].max(-1)
    y1, y2 = verts[..., 1].min(-1), verts[..., 1].max(-1)
    u = ((np.arange(grid, dtype=np.float32) + 0.5) / grid)[None]
    return ((x1[:, None] + u * (x2 - x1)[:, None]).astype(np.float32),
            (y1[:, None] + u * (y2 - y1)[:, None]).astype(np.float32))


@pytest.mark.parametrize("seed", range(2))
def test_polygon_bbox_matches_jax(seed):
    verts = _rings(np.random.default_rng(seed), 40) * 1.3 - 20.0
    got = tpoly.polygon_bbox(_t(verts), 160, 120)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpoly.polygon_bbox(_j(verts), 160, 120)))
    # tests/test_polyroi.py::test_polygon_bbox_clipping's case.
    verts = np.array([[[-10.0, 5.5], [200.0, 20.0], [50.0, 300.0]]],
                     np.float32)
    np.testing.assert_array_equal(
        tpoly.polygon_bbox(_t(verts), 160, 120)[0].numpy(), [0, 5, 160, 120])


@pytest.mark.parametrize("kind", ["float", "integer", "reversed",
                                  "degenerate", "on_edge"])
def test_convex_mask_matches_jax(kind):
    """The half-plane mask equals JAX's, op by op and jitted (XLA:CPU may
    fuse the cross product into a multiply-add under ``jit``): float and
    integer rings, the other winding, all-zero rings, and a triangle whose
    diagonal runs through lattice points."""
    rng = np.random.default_rng(3)
    verts = _rings(rng, 24, integer=(kind == "integer"))
    if kind == "reversed":
        verts = verts[:, ::-1].copy()
    if kind == "degenerate":
        verts[::2] = 0.0
    if kind == "on_edge":
        verts = np.array([[[0.0, 0.0], [32.0, 32.0], [0.0, 32.0]],
                          [[3.0, 7.0], [67.0, 71.0], [3.0, 71.0]]],
                         np.float32)
    xs, ys = _lattice(verts)
    got = tpoly._convex_mask(_t(verts), _t(xs), _t(ys))
    for fn in (jpoly._convex_mask, jax.jit(jpoly._convex_mask)):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(fn(_j(verts), _j(xs), _j(ys))))
    if kind == "on_edge":       # the samples on the diagonal are inside
        d = np.arange(32)
        assert got[0].numpy()[d, d].all()


def _means_close(got, want):
    (gm, gc), (wm, wc) = got, want
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=0, atol=1e-3)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("grid", [16, 32, 48])
def test_polygon_means_match_jax(grid):
    """Rings across the frame's edges, on noise frames, with a few
    all-zero rings: means and counts against JAX's."""
    rng = np.random.default_rng(grid)
    frames = rng.integers(0, 256, (24, 120, 160, 3), dtype=np.uint8)
    verts = _rings(rng, 24)
    verts[5] = 0.0
    got = tpoly.polygon_channel_means(_t(frames), _t(verts), grid=grid)
    assert got[0].dtype == torch.float32 and got[0].shape == (24, 3)
    _means_close(got, jpoly.polygon_channel_means(_j(frames), _j(verts),
                                                  grid=grid))
    assert float(got[1][5]) == 0.0 and not got[0][5].any()


def _exact_polygon_mean(frame, verts):
    from matplotlib.path import Path
    h, w = frame.shape[:2]
    pts = np.stack(np.mgrid[0:h, 0:w][::-1], -1).reshape(-1, 2).astype(float)
    mask = Path(verts).contains_points(pts).reshape(h, w)
    return frame[mask].astype(np.float64).mean(0), mask.sum()


def test_polygon_means_match_exact_rasterization():
    frame = _gradient_frame()
    verts = np.array([[30.0, 20.0], [130.0, 40.0], [60.0, 100.0]],
                     np.float32)
    got = tpoly.polygon_channel_means(_t(frame[None]), _t(verts[None]),
                                      grid=64)
    _means_close(got, jpoly.polygon_channel_means(
        _j(frame[None]), _j(verts[None]), grid=64))
    exact, npx = _exact_polygon_mean(frame, verts)
    np.testing.assert_allclose(got[0][0].numpy(), exact, atol=0.05)
    assert abs(float(got[1][0]) - npx) / npx < 0.02


def test_polygon_winding_invariance():
    frame = _t(_gradient_frame()[None])
    verts = np.array([[30.0, 20.0], [130.0, 40.0], [90.0, 90.0],
                      [40.0, 80.0]], np.float32)
    m1, c1 = tpoly.polygon_channel_means(frame, _t(verts[None]))
    m2, c2 = tpoly.polygon_channel_means(frame, _t(verts[::-1][None]))
    np.testing.assert_allclose(m1.numpy(), m2.numpy(), atol=1e-3)
    np.testing.assert_allclose(float(c1[0]), float(c2[0]), rtol=1e-5)
    _means_close((m2, c2), jpoly.polygon_channel_means(
        _j(frame.numpy()), _j(verts[::-1][None])))


def test_polygon_rectangle_matches_roi_channel_means():
    frame = _gradient_frame()
    x1, y1, x2, y2 = 24, 30, 120, 96
    verts = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.float32)
    got = tpoly.polygon_channel_means(_t(frame[None]), _t(verts[None]),
                                      grid=64)
    _means_close(got, jpoly.polygon_channel_means(
        _j(frame[None]), _j(verts[None]), grid=64))
    rect, _ = treduce.roi_channel_means(
        _t(frame[None]), torch.tensor([[x1, y1, x2, y2]], dtype=torch.int32))
    # The resampled estimate against the exact mean of the same rectangle.
    np.testing.assert_allclose(got[0][0].numpy(), rect[0].numpy(), atol=0.6)


def test_polygon_degenerate_vertices_zero():
    frame = _t(_gradient_frame()[None])
    m, c = tpoly.polygon_channel_means(frame, torch.zeros((1, 5, 2)))
    assert float(c[0]) == 0.0
    assert not m.any()


def test_polygon_means_clip_to_image():
    """A polygon hanging off the frame contributes no off-image area: the
    means agree with the exact rasterization of the clipped region and
    the count reports only in-image pixels."""
    frame = _gradient_frame()
    verts = np.array([[-50.0, -10.0], [100.0, 30.0], [20.0, 110.0]],
                     np.float32)
    got = tpoly.polygon_channel_means(_t(frame[None]), _t(verts[None]),
                                      grid=96)
    _means_close(got, jpoly.polygon_channel_means(
        _j(frame[None]), _j(verts[None]), grid=96))
    exact, npx = _exact_polygon_mean(frame, verts)
    np.testing.assert_allclose(got[0][0].numpy(), exact, atol=1.0)
    assert abs(float(got[1][0]) - npx) / npx < 0.05


# --- the holdover of a float ring ------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_holdover_ring_matches_jax(seed):
    """A ``(T, 2E)`` float32 vertex ring held through dropouts, with and
    without a detection cadence and a carried-in ring: the held rings,
    validity and final carry equal JAX's scan."""
    rng = np.random.default_rng(seed)
    T, E, hold = 90, 9, int(rng.integers(0, 8))
    ring = rng.uniform(0, 300, (T, 2 * E)).astype(np.float32)
    valid = rng.random(T) < rng.uniform(0.1, 0.7)
    valid[40:60] = False
    att = None if seed % 2 == 0 else (np.arange(T) % 3 == 0) | valid
    carry = None
    if seed >= 2:
        carry = (rng.uniform(0, 300, 2 * E).astype(np.float32), 3, True)
    jcarry = (jnp.zeros((2 * E,), jnp.float32), jnp.int32(0),
              jnp.asarray(False)) if carry is None else (
        _j(carry[0]), jnp.int32(carry[1]), jnp.asarray(carry[2]))
    want, wfinal = jroi.holdover_with_carry(
        _j(ring), _j(valid), hold, carry=jcarry,
        attempted=None if att is None else _j(att))
    tcarry = None if carry is None else (
        _t(carry[0]), torch.tensor(carry[1], dtype=torch.int32),
        torch.tensor(carry[2]))
    got, gfinal = troi.holdover_with_carry(
        _t(ring), _t(valid), hold, carry=tcarry,
        attempted=None if att is None else _t(att))
    assert got.box.dtype == torch.float32
    np.testing.assert_array_equal(got.box.numpy(), np.asarray(want.box))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for g, w in zip(gfinal, wfinal):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --- the two measures with a fake detector ---------------------------------

@pytest.fixture(scope="module")
def synth_clip():
    """60 frames of ``utils.synth``'s face with its true boxes, a 10-frame
    dropout (frames 20-29) and a second one past the hold (41-57)."""
    clip = synthesize(SynthSpec(duration_s=2.0, fps=30.0, height=72,
                                width=96, noise_std=1.0))
    valid = np.ones(60, bool)
    valid[20:30] = False
    valid[41:58] = False
    return clip.frames[:60], clip.face_boxes[:60], valid


def _fake(outs, detect_every, tensor):
    """A detector of the ``(boxes, payload, valid)`` contract returning the
    cadence frames' rows of ``outs``."""
    sub = [tensor(o[::detect_every]) for o in outs]
    return lambda fr: tuple(sub)


@pytest.mark.parametrize("detect_every", [1, 2])
def test_extract_signals_landmark_roi_matches_jax(synth_clip, detect_every):
    """The detector's ROI rides its own holdover into the plain reduction:
    validity, ROIs and boxes equal JAX's, means within 1e-4; during the
    first dropout the ROI is the last detected one."""
    frames, boxes, valid = synth_clip
    jcfg = jconfig.PipelineConfig()
    rois = np.asarray(jroi.cheek_roi(_j(boxes), jcfg.roi, 96, 72))
    rois = rois + np.arange(60, dtype=np.int32)[:, None] % 3   # per-frame
    outs = (boxes, rois, valid)
    want = joffline.extract_signals_landmark_roi(
        _j(frames), _fake(outs, detect_every, _j), jcfg,
        detect_every=detect_every)
    got = toffline.extract_signals_landmark_roi(
        _t(frames), _fake(outs, detect_every, _t), PipelineConfig(),
        detect_every=detect_every)
    for f in ("valid", "rois", "boxes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.bgr.numpy(), np.asarray(want.bgr),
                               rtol=0, atol=1e-4)
    v = got.valid.numpy()
    assert v[20:30].all() and not v[41 + 15 + detect_every:58].any()
    if detect_every == 1:
        np.testing.assert_array_equal(got.rois.numpy()[20:30],
                                      np.tile(rois[19], (10, 1)))
    m, _ = treduce.roi_channel_means(_t(frames), got.rois)
    assert torch.equal(got.bgr, m)


def _face_rings(boxes, rng, E=9):
    """A ring of ``E`` vertices inside each face box, jittered per frame."""
    ang = np.linspace(0, 2 * np.pi, E, endpoint=False)
    c = (boxes[:, :2] + boxes[:, 2:]) / 2.0
    r = (boxes[:, 2:] - boxes[:, :2]) / 2.0 * 0.8
    v = c[:, None] + r[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    return (v + rng.uniform(-0.5, 0.5, v.shape)).astype(np.float32)


@pytest.mark.parametrize("detect_every", [1, 2])
def test_extract_signals_polygon_matches_jax(synth_clip, detect_every):
    """The ring rides its own holdover into the polygon means: validity,
    ROIs and boxes equal JAX's; the means within 1e-4 of JAX's op-by-op
    ``polygon_channel_means`` on JAX's held ring and within 2e-3 of its
    jitted measure (see the module's docstring)."""
    frames, boxes, valid = synth_clip
    verts = _face_rings(boxes, np.random.default_rng(detect_every))
    verts[~valid] = 0.0
    outs = (boxes, verts, valid)
    jcfg = jconfig.PipelineConfig()
    want = joffline.extract_signals_polygon(
        _j(frames), _fake(outs, detect_every, _j), jcfg,
        detect_every=detect_every)
    got = toffline.extract_signals_polygon(
        _t(frames), _fake(outs, detect_every, _t), PipelineConfig(),
        detect_every=detect_every)
    for f in ("valid", "rois", "boxes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    # JAX's held ring: the ring rows its holdover carries, zero where the
    # track is not valid.
    jv = np.asarray(want.valid)
    spread = np.zeros_like(verts)
    spread[::detect_every] = verts[::detect_every]
    ok = np.zeros(60, bool)
    ok[::detect_every] = valid[::detect_every]
    att = None
    if detect_every > 1:
        att = np.zeros(60, bool)
        att[::detect_every] = True
    held, _ = jroi.holdover_with_carry(
        _j(spread.reshape(60, -1)), _j(ok), jcfg.roi.landmark_hold_frames,
        carry=(jnp.zeros((18,), jnp.float32), jnp.int32(0),
               jnp.asarray(False)),
        attempted=None if att is None else _j(att))
    ring = np.where(jv[:, None, None],
                    np.asarray(held.box).reshape(60, 9, 2), 0.0)
    eager, _ = jpoly.polygon_channel_means(_j(frames),
                                           _j(ring.astype(np.float32)))
    np.testing.assert_allclose(got.bgr.numpy(), np.asarray(eager), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.bgr.numpy(), np.asarray(want.bgr),
                               rtol=0, atol=2e-3)
    assert got.valid.numpy()[20:30].all()


# --- the MediaPipe ROI and polygon detectors --------------------------------

@pytest.fixture(scope="module")
def face_frames():
    """The drawn face upright and rolled 20 degrees, and a frame of
    noise."""
    import cv2
    img = draw_face()
    M = cv2.getRotationMatrix2D((160, 130), 20.0, 1.0)
    rolled = cv2.warpAffine(img, M, (320, 256), borderValue=(60, 70, 80))
    noise = np.random.default_rng(0).integers(0, 255, img.shape, np.uint8)
    return np.stack([img, rolled, noise])


def test_roi_detector_matches_jax(face_frames):
    """Float32 nets: validity equal, boxes and ROIs within 1 px; under the
    roll the rolled-frame ROI differs from the box-ratio one."""
    jdet = jmp.make_mediapipe_roi_detector(TASK, activation_dtype=None)
    jb, jr, jv = jax.jit(lambda f: jdet(f))(_j(face_frames))
    det = tmp.make_mediapipe_roi_detector(TASK, activation_dtype=None,
                                          device="cpu")
    tb, tr, tv = det(_t(face_frames))
    assert tb.dtype == tr.dtype == torch.int32 and tv.dtype == torch.bool
    assert tv.tolist() == [True, True, False]
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 1
    assert np.abs(tr.numpy() - np.asarray(jr)).max() <= 1
    assert not tr[2].any() and not tb[2].any()
    naive = troi.cheek_roi(tb, ROIConfig(), 320, 256)
    assert int((naive[0] - tr[0]).abs().max()) <= 12
    assert int((naive[1] - tr[1]).abs().max()) > 2


def test_poly_detector_matches_jax(face_frames):
    """Float32 nets: validity equal, boxes and vertices within 1 px, zero
    vertices on the frame without a face; a custom ``poly_idx``."""
    idx = (1, 4, 152, 10)
    for kw in ({}, {"poly_idx": idx}):
        jdet = jmp.make_mediapipe_poly_detector(TASK, activation_dtype=None,
                                                **kw)
        jb, jvx, jv = jax.jit(lambda f: jdet(f))(_j(face_frames))
        det = tmp.make_mediapipe_poly_detector(TASK, activation_dtype=None,
                                               device="cpu", **kw)
        tb, tvx, tv = det(_t(face_frames))
        E = len(kw.get("poly_idx", tpoly.CHEEK_POLY_IDX))
        assert tuple(tvx.shape) == (3, E, 2) and tvx.dtype == torch.float32
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 1
        assert np.abs(tvx.numpy() - np.asarray(jvx)).max() <= 1.0
        assert not tvx[2].any()


# --- the two measures with the real detectors -------------------------------

@pytest.fixture(scope="module")
def swaying_clip():
    """36 frames of the drawn face at 192 x 224 swaying +-3 px with a 1.25
    Hz green pulse on its skin."""
    fps, T = 30.0, 36
    img = draw_face(H=192, W=224, cx=112, cy=96, rx=45, ry=62)
    ys, xs = np.mgrid[0:192, 0:224]
    skin = ((xs - 112) / 45.0) ** 2 + ((ys - 96) / 62.0) ** 2 <= 1.0
    out = []
    for t in range(T):
        f = img.astype(np.float32)
        f[skin, 1] += 3.0 * np.sin(2 * np.pi * 1.25 * t / fps)
        out.append(np.roll(f, int(round(3 * np.sin(t / 5.0))), axis=1))
    return np.clip(np.stack(out), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["roi", "poly"])
def test_measures_with_real_detectors_match_jax(swaying_clip, kind):
    """The measures with the real float32 detectors, port against JAX at
    detection cadence 2: validity equal and every frame valid, boxes and
    ROIs within 1 px; the means within 1e-4 (ROI) or 2e-3 (polygon) on
    the frames whose ROIs are equal, and a pulse in the green trace."""
    frames = swaying_clip
    jmake = {"roi": jmp.make_mediapipe_roi_detector,
             "poly": jmp.make_mediapipe_poly_detector}[kind]
    tmake = {"roi": tmp.make_mediapipe_roi_detector,
             "poly": tmp.make_mediapipe_poly_detector}[kind]
    jrun = {"roi": joffline.extract_signals_landmark_roi,
            "poly": joffline.extract_signals_polygon}[kind]
    trun = {"roi": toffline.extract_signals_landmark_roi,
            "poly": toffline.extract_signals_polygon}[kind]
    want = jrun(_j(frames), jmake(TASK, activation_dtype=None),
                jconfig.PipelineConfig(), detect_every=2)
    got = trun(_t(frames), tmake(TASK, activation_dtype=None, device="cpu"),
               PipelineConfig(), detect_every=2)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.all()
    for f in ("rois", "boxes"):
        assert np.abs(getattr(got, f).numpy()
                      - np.asarray(getattr(want, f))).max() <= 1, f
    same = (got.rois.numpy() == np.asarray(want.rois)).all(1)
    assert same.mean() >= 0.5
    atol = 1e-4 if kind == "roi" else 2e-3
    np.testing.assert_allclose(got.bgr.numpy()[same],
                               np.asarray(want.bgr)[same], rtol=0,
                               atol=atol)
    green = got.bgr[:, 1].numpy()
    assert green.max() - green.min() > 2.0


# --- the port on the bundled portrait (tests/test_polyroi.py, -----------
# --- tests/test_realface.py::test_mediapipe_pose_robust_roi) -----------

@pytest.fixture(scope="module")
def portrait():
    from vhr_tpu.utils.realface import real_face_image
    img = real_face_image()
    if img is None:
        pytest.skip("no bundled real-face asset in this environment")
    return img


def test_cheek_poly_idx_derivation_on_port(portrait):
    """On the portrait the port's landmarks put ``CHEEK_POLY_IDX`` inside
    the cheek band of the rolled face frame, and their hull covers most
    of the band."""
    params, det_apply, lm_apply = tmp.load_face_models(device="cpu")
    frames = _t(portrait[None])
    rects, _, ok = tmp.detect_faces_mp(params, det_apply, frames)
    assert bool(ok[0, 0])
    lm_px, _ = tmp.face_landmarks(params, lm_apply, frames, rects)
    lm = lm_px[0, 0].numpy()
    rot = float(rects.rot[0, 0])
    c, s = np.cos(rot), np.sin(rot)
    px, py = lm[:, 0] * c + lm[:, 1] * s, -lm[:, 0] * s + lm[:, 1] * c
    x1, x2, y1, y2 = px.min(), px.max(), py.min(), py.max()
    r = ROIConfig()
    bx1 = x1 + r.cheek_horizontal * (x2 - x1)
    bx2 = x2 - r.cheek_horizontal * (x2 - x1)
    by1, by2 = y1 + r.cheek_top * (y2 - y1), y1 + r.cheek_bottom * (y2 - y1)
    idx = np.asarray(tpoly.CHEEK_POLY_IDX)
    assert (px[idx] >= bx1 - 1).all() and (px[idx] <= bx2 + 1).all()
    assert (py[idx] >= by1 - 1).all() and (py[idx] <= by2 + 1).all()
    v = np.stack([px[idx], py[idx]], -1)
    area = 0.5 * abs(np.sum(v[:, 0] * np.roll(v[:, 1], -1)
                            - np.roll(v[:, 0], -1) * v[:, 1]))
    assert 0.6 < area / ((bx2 - bx1) * (by2 - by1)) < 0.95


def test_polygon_excludes_band_corner_contamination_on_port(portrait):
    """Saturated green in the cheek band's corners outside the hull moves
    the rectangle's mean but barely the polygon's."""
    from matplotlib.path import Path
    f = _t(portrait[None])
    _, verts, okp = tmp.make_mediapipe_poly_detector(device="cpu")(f)
    _, rois, okr = tmp.make_mediapipe_roi_detector(device="cpu")(f)
    assert bool(okp[0]) and bool(okr[0])
    h, w = portrait.shape[:2]
    x1, y1, x2, y2 = rois[0].tolist()
    pts = np.stack(np.mgrid[0:h, 0:w][::-1], -1).reshape(-1, 2).astype(float)
    inside = Path(verts[0].numpy()).contains_points(pts).reshape(h, w)
    band = np.zeros((h, w), bool)
    band[y1:y2, x1:x2] = True
    corner = band & ~inside
    assert corner.sum() > 50
    dirty = portrait.copy()
    dirty[corner] = (0, 255, 0)
    fd = _t(dirty[None])
    shift_p = abs(float(tpoly.polygon_channel_means(fd, verts)[0][0, 1])
                  - float(tpoly.polygon_channel_means(f, verts)[0][0, 1]))
    shift_r = abs(float(treduce.roi_channel_means(fd, rois)[0][0, 1])
                  - float(treduce.roi_channel_means(f, rois)[0][0, 1]))
    assert shift_r > 5.0 and shift_p < 0.5 * shift_r


def test_polygon_pipeline_recovers_pulse_real_face(portrait):
    """The polygon measure on the portrait clip (4 s at 10 fps): every
    frame valid, the green trace follows the injected pulse, the ROIs
    inside the face boxes; cadence 2 equals cadence 1 on the static
    frames, and the ring holds through a forced dropout."""
    from vhr_tpu.utils.realface import synthesize_real_face_clip
    clip = synthesize_real_face_clip(duration_s=4.0, fps=10.0,
                                     noise_std=1.0, scale=0.5)
    det = tmp.make_mediapipe_poly_detector(device="cpu")
    cfg = PipelineConfig()
    trace = toffline.extract_signals_polygon(_t(clip.frames), det, cfg)
    assert bool(trace.valid.all())
    g = trace.bgr[:, 1].double().numpy()
    p = clip.pulse - clip.pulse.mean()
    assert np.corrcoef(g - g.mean(), p)[0, 1] > 0.95
    rois, boxes = trace.rois.numpy(), trace.boxes.numpy()
    assert (rois[:, 0] >= boxes[:, 0] - 2).all()
    assert (rois[:, 2] <= boxes[:, 2] + 2).all()

    fr = _t(np.repeat(portrait[::2, ::2][None], 8, axis=0))
    t1 = toffline.extract_signals_polygon(fr, det, cfg)
    t2 = toffline.extract_signals_polygon(fr, det, cfg, detect_every=2)
    assert torch.equal(t1.valid, t2.valid)
    np.testing.assert_allclose(t1.bgr.numpy(), t2.bgr.numpy(), atol=1e-3)

    def flaky(frames):
        b, v, ok = det(frames)
        drop = torch.zeros(frames.shape[0], dtype=torch.bool)
        drop[3:5] = True
        return (torch.where(drop[:, None], 0, b),
                torch.where(drop[:, None, None], 0.0, v), ok & ~drop)

    t3 = toffline.extract_signals_polygon(fr, flaky, cfg)
    assert bool(t3.valid.all())
    np.testing.assert_allclose(t3.bgr[3].numpy(), t3.bgr[2].numpy(),
                               atol=1e-3)


def test_pose_robust_roi_on_port(portrait):
    """The port's rolled-frame cheek ROI agrees with the box-ratio one on
    the upright portrait and tracks the cheek band under a 20-degree roll,
    where the box-ratio ROI drifts."""
    import cv2
    H0, W0 = 480, 640
    ih, iw = portrait.shape[:2]
    s = min(380 / ih, 380 / iw)
    small = cv2.resize(portrait, (int(iw * s), int(ih * s)),
                       interpolation=cv2.INTER_AREA)
    canvas = np.full((H0, W0, 3), 90, np.uint8)
    y0, x0 = (H0 - small.shape[0]) // 2, (W0 - small.shape[1]) // 2
    canvas[y0:y0 + small.shape[0], x0:x0 + small.shape[1]] = small
    det = tmp.make_mediapipe_detector(device="cpu")
    roi_det = tmp.make_mediapipe_roi_detector(device="cpu")

    def centers(frame):
        fr = _t(frame[None])
        _, rois, valid = roi_det(fr)
        assert bool(valid[0])
        b, _ = det(fr)
        mid = lambda r: np.array([(r[0] + r[2]) / 2.0, (r[1] + r[3]) / 2.0])
        return (mid(troi.cheek_roi(b, ROIConfig(), W0, H0)[0].numpy()),
                mid(rois[0].numpy()))

    n0, r0 = centers(canvas)
    assert np.linalg.norm(n0 - r0) < 12.0
    M = cv2.getRotationMatrix2D((W0 / 2, H0 / 2), 20.0, 1.0)
    frame = cv2.warpAffine(canvas, M, (W0, H0), flags=cv2.INTER_LINEAR,
                           borderValue=(90, 90, 90))
    expect = M[:, :2] @ r0 + M[:, 2]
    n1, r1 = centers(frame)
    d_robust, d_naive = np.linalg.norm(r1 - expect), \
        np.linalg.norm(n1 - expect)
    assert d_robust < d_naive and d_robust < 10.0
