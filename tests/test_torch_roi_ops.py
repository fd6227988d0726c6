"""Port parity: ROI geometry, holdover, ROI means (plain and K2's CPU path)
and the skin detector, against ``vhr_tpu`` on the same numpy inputs.

Tolerances: boxes, ROIs, valid masks, carries and counts are integers and
must be equal.  Means: ``rtol=1e-6, atol=1e-5`` — the port's sums are exact
(float64 over u8), and at these sizes JAX's float32 sums are exact too, so
only the final float32 division could differ.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhr_tpu import config as jconfig
from vhr_tpu.models import skin_detector as jdet
from vhr_tpu.ops import reduce as vreduce
from vhr_tpu.ops import roi as vroi
from vhr_tpu.ops.pallas_roi import roi_channel_means_pallas
from vhr_tpu.utils.synth import SynthSpec, synthesize

from vhr_tpu_torch import interop
from vhr_tpu_torch.config import ROIConfig
from vhr_tpu_torch.models import skin_detector as tdet
from vhr_tpu_torch.ops import reduce as treduce
from vhr_tpu_torch.ops import roi as troi
from vhr_tpu_torch.ops import roi_means_cuda

MEANS_TOL = dict(rtol=1e-6, atol=1e-5)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roi_geometry_matches_jax(seed):
    rng = np.random.default_rng(seed)
    W, H = 160, 120
    x1 = rng.integers(-5, W, 64)
    y1 = rng.integers(-5, H, 64)
    boxes = np.stack([x1, y1, x1 + rng.integers(-3, 90, 64),
                      y1 + rng.integers(-3, 90, 64)], -1).astype(np.int32)
    cfg, jcfg = ROIConfig(), jconfig.ROIConfig()
    jb, tb = jnp.asarray(boxes), torch.as_tensor(boxes)
    for site in ("cheek", "forehead"):
        np.testing.assert_array_equal(
            troi.measurement_roi(tb, cfg, W, H, site).numpy(),
            _np(vroi.measurement_roi(jb, jcfg, W, H, site)))
    np.testing.assert_array_equal(
        troi.roi_from_bbox(tb, 0.3, 0.1, 0.7, W, H).numpy(),
        _np(vroi.roi_from_bbox(jb, 0.3, 0.1, 0.7, W, H)))
    with pytest.raises(ValueError):
        troi.measurement_roi(tb, cfg, W, H, "chin")


@pytest.mark.parametrize("seed", range(6))
def test_holdover_matches_jax_scan(seed):
    """The cummax/cumsum holdover equals the JAX scan: boxes, valid and the
    final carry, with and without an ``attempted`` cadence mask and with a
    carried-in state."""
    rng = np.random.default_rng(seed)
    T = 80
    hold = int(rng.integers(0, 6))
    boxes = rng.integers(0, 100, (T, 4)).astype(np.int32)
    valid = rng.random(T) < rng.uniform(0.05, 0.6)
    attempted = None if seed % 2 == 0 else (rng.random(T) < 0.5) | valid
    if seed >= 2:
        carry = (rng.integers(0, 100, 4).astype(np.int32),
                 np.int32(rng.integers(0, hold + 2)), np.bool_(seed % 3 != 0))
    else:
        carry = None
    jcarry = None if carry is None else (jnp.asarray(carry[0]),
                                         jnp.asarray(carry[1], jnp.int32),
                                         jnp.asarray(carry[2]))
    tcarry = None if carry is None else interop.holdover_carry_from_numpy(
        *carry)
    jatt = None if attempted is None else jnp.asarray(attempted)
    tatt = None if attempted is None else torch.as_tensor(attempted)

    jt, jfinal = vroi.holdover_with_carry(jnp.asarray(boxes),
                                          jnp.asarray(valid), hold, jcarry,
                                          jatt)
    tt, tfinal = troi.holdover_with_carry(torch.as_tensor(boxes),
                                          torch.as_tensor(valid), hold,
                                          tcarry, tatt)
    np.testing.assert_array_equal(tt.valid.numpy(), _np(jt.valid))
    np.testing.assert_array_equal(tt.box.numpy(), _np(jt.box))
    box, budget, has = interop.holdover_carry_to_numpy(tfinal)
    np.testing.assert_array_equal(box, _np(jfinal[0]))
    assert int(budget) == int(jfinal[1]) and bool(has) == bool(jfinal[2])
    # holdover() is the carry-less view of the same scan.
    np.testing.assert_array_equal(
        troi.holdover(torch.as_tensor(boxes), torch.as_tensor(valid), hold,
                      tcarry, tatt).valid.numpy(), _np(jt.valid))


def test_holdover_chunked_equals_whole():
    """Carrying the state across chunk boundaries equals one pass."""
    rng = np.random.default_rng(7)
    T = 90
    boxes = torch.as_tensor(rng.integers(0, 50, (T, 4)).astype(np.int32))
    valid = torch.as_tensor(rng.random(T) < 0.2)
    whole, _ = troi.holdover_with_carry(boxes, valid, 4)
    carry, parts = None, []
    for s in range(0, T, 25):
        tr, carry = troi.holdover_with_carry(boxes[s:s + 25],
                                             valid[s:s + 25], 4, carry)
        parts.append(tr.valid)
    np.testing.assert_array_equal(torch.cat(parts).numpy(),
                                  whole.valid.numpy())


def _rois(rng, T, H, W):
    x1 = rng.integers(-4, W - 2, T)
    y1 = rng.integers(0, H - 2, T)
    rois = np.stack([x1, y1, x1 + rng.integers(1, W, T),
                     y1 + rng.integers(1, H, T)], -1).astype(np.int32)
    rois[0] = 0                         # zero ROI (invalid frame)
    rois[1] = [7, 11, 13, 11]           # degenerate y-span
    rois[2] = [20, 5, 9, 30]            # x2 < x1
    return rois


@pytest.mark.parametrize("seed", [0, 1])
def test_roi_channel_means_matches_jax(seed):
    rng = np.random.default_rng(seed)
    T, H, W = 6, 48, 64
    frames = rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8)
    rois = _rois(rng, T, H, W)
    m_ref, c_ref = vreduce.roi_channel_means(jnp.asarray(frames),
                                             jnp.asarray(rois))
    m, c = treduce.roi_channel_means(torch.as_tensor(frames),
                                     torch.as_tensor(rois))
    np.testing.assert_allclose(m.numpy(), _np(m_ref), **MEANS_TOL)
    np.testing.assert_array_equal(c.numpy(), _np(c_ref))


@pytest.mark.parametrize("shape", [(4, 40, 56), (3, 130, 96)])
@pytest.mark.parametrize("flat", [False, True])
def test_k2_cpu_path_matches_pallas(shape, flat):
    """K2's wrapper on CPU tensors against the Pallas kernel in interpret
    mode (as ``tests/test_roi_ops.py`` runs it)."""
    T, H, W = shape
    rng = np.random.default_rng(T * H)
    frames = rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8)
    rois = _rois(rng, T, H, W)
    m_ref, c_ref = roi_channel_means_pallas(jnp.asarray(frames),
                                            jnp.asarray(rois), row_block=32,
                                            interpret=True)
    ft = torch.as_tensor(frames)
    if flat:
        ft = ft.reshape(T, H, W * 3)
    before = roi_means_cuda.LAUNCHES
    m, c = roi_means_cuda.roi_channel_means_cuda(ft, torch.as_tensor(rois))
    assert roi_means_cuda.LAUNCHES == before     # CPU: no kernel launch
    np.testing.assert_allclose(m.numpy(), _np(m_ref), **MEANS_TOL)
    np.testing.assert_array_equal(c.numpy(), _np(c_ref))


def test_k2_rejects_bad_shapes():
    with pytest.raises(ValueError):
        roi_means_cuda.roi_channel_means_cuda(
            torch.zeros((2, 8, 10), dtype=torch.uint8),
            torch.zeros((2, 4), dtype=torch.int32))      # 10 % 3 != 0
    with pytest.raises(ValueError):
        roi_means_cuda.roi_channel_means_cuda(
            torch.zeros((2, 8, 4, 3), dtype=torch.uint8),
            torch.zeros((3, 4), dtype=torch.int32))


@pytest.fixture(scope="module")
def face_clip():
    v = synthesize(SynthSpec(duration_s=0.4, height=48, width=64,
                             noise_std=6.0, motion_amplitude=3.0,
                             dropout_frames=(3,)))
    noise = np.random.default_rng(3).integers(0, 256, (2, 48, 64, 3),
                                              dtype=np.uint8)
    return np.concatenate([v.frames, noise])


@pytest.mark.parametrize("downsample", [1, 2])
@pytest.mark.parametrize("pool_mode", ["sample", "mean"])
def test_detect_faces_matches_jax(face_clip, downsample, pool_mode):
    cfg = dataclasses.replace(jdet.SkinDetectorConfig(),
                              downsample=downsample, pool_mode=pool_mode)
    tcfg = interop.skin_config_from_jax(dataclasses.asdict(cfg))
    jb, jv = jdet.detect_faces(jnp.asarray(face_clip), cfg)
    tb, tv = tdet.detect_faces(torch.as_tensor(face_clip), tcfg)
    np.testing.assert_array_equal(tb.numpy(), _np(jb))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    assert tv.numpy()[:3].all() and not tv.numpy()[3]   # dropout frame
