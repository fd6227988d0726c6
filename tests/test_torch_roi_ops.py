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
from vhr_tpu_torch.utils.profiling import counter

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)

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
    before = counter("k2.launches")
    m, c = roi_means_cuda.roi_channel_means_cuda(ft, torch.as_tensor(rois))
    assert counter("k2.launches") == before     # CPU: no kernel launch
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


# -- K2/K3 launch plan and the vectorised kernel's walk ----------------------
# The card's kernel cannot run here, so its geometry is held on the CPU:
# roi_plan's choices, and a model of csrc/roi_means.cu's vectorised walk
# (bands of rows, (row, group) items stepped by the block's threads, six
# loads a pass, the edge masks and the fixed channel of each group byte).

H100_SMS = 132


@pytest.mark.parametrize("shape,row_pitch,base_align,want", [
    ((960, 1080, 1920, 3), None, 16, "vector"),        # 1080p, 4-D
    ((64, 720, 1280, 3), None, 16, "vector"),          # the pool's slots
    ((5, 33, 20, 4), None, 16, "vector"),              # C = 4, 80-byte rows
    ((9, 40, 32, 1), None, 16, "vector"),              # C = 1
    ((7, 48, 64, 2), 64 * 2 + 64, 16, "vector"),       # C = 2, padded pitch
    ((7, 48, 64, 3), 64 * 3 + 5, 16, "generic"),       # pitch not aligned
    ((13, 75, 130, 3), None, 16, "generic"),           # 390-byte rows
    ((4, 40, 64, 3), None, 4, "generic"),              # base not aligned
    ((4, 40, 64, 3), None, 8, "generic"),
])
def test_roi_plan_instance(shape, row_pitch, base_align, want):
    """The vectorised instance exactly where the base, the row pitch and
    the frame stride are 16-byte aligned; forcing it elsewhere raises."""
    T, H, W, C = shape
    pitch = row_pitch or W * C
    plan = roi_means_cuda.roi_plan(T, H, W, C, H * pitch, pitch, base_align,
                                   H100_SMS)
    assert plan.instance == want
    if want == "generic":
        assert plan == (want, 1, 1024, -(-T // 8))
        with pytest.raises(ValueError, match="aligned"):
            roi_means_cuda.roi_plan(T, H, W, C, H * pitch, pitch, base_align,
                                    H100_SMS, instance="vector")
    generic = roi_means_cuda.roi_plan(T, H, W, C, H * pitch, pitch,
                                      base_align, H100_SMS,
                                      instance="generic")
    assert generic.instance == "generic"


@pytest.mark.parametrize("flat", [False, True])
def test_roi_plan_from_tensor_layouts(flat):
    """The wrappers' arguments: a 4-D and a flat padded tensor, and a view
    whose base is off the 16-byte grid."""
    T, H, W = 6, 24, 32
    x = torch.zeros((T, H, W * 3 + (16 if flat else 0)), dtype=torch.uint8)
    if not flat:
        x = x.reshape(T, H, W, 3)
    args = (T, H, W, 3, x.stride(0), x.stride(1))
    base = x.data_ptr()
    assert roi_means_cuda.roi_plan(
        *args, roi_means_cuda.alignment(base - base % 16), H100_SMS
    ).instance == "vector"
    assert roi_means_cuda.roi_plan(
        *args, roi_means_cuda.alignment(base - base % 16 + 3), H100_SMS
    ).instance == "generic"
    assert [roi_means_cuda.alignment(a) for a in (0, 48, 8, 12, 6, 7)] == \
        [16, 16, 8, 4, 2, 1]


@pytest.mark.parametrize("T,bands", [(1, 8), (3, 8), (20, 8), (64, 4),
                                     (100, 5), (256, 1), (960, 1),
                                     (2000, 1)])
def test_roi_plan_bands_fill_every_sm(T, bands):
    """At most 8 bands (a portable cluster), the grid a whole number of
    clusters, and every SM given blocks wherever 8 bands a frame allow."""
    plan = roi_means_cuda.roi_plan(T, 1080, 1920, 3, 1080 * 5760, 5760, 16,
                                   H100_SMS)
    assert plan.instance == "vector" and plan.bands == bands
    assert 1 <= plan.bands <= roi_means_cuda.MAX_BANDS
    assert plan.grid == T * plan.bands and plan.grid % plan.bands == 0
    assert plan.threads == roi_means_cuda.VEC_THREADS
    if T * roi_means_cuda.MAX_BANDS >= H100_SMS:
        assert plan.grid >= H100_SMS
    else:
        assert plan.bands == roi_means_cuda.MAX_BANDS


def test_roi_plan_refuses():
    with pytest.raises(ValueError, match="channels"):
        roi_means_cuda.roi_plan(2, 8, 8, 5, 320, 40, 16, H100_SMS)
    with pytest.raises(ValueError, match="instance"):
        roi_means_cuda.roi_plan(2, 8, 8, 3, 192, 24, 16, H100_SMS, "fast")
    with pytest.raises(ValueError, match="too large"):
        roi_means_cuda.roi_plan(1, 2 ** 22, 2 ** 12, 3, 0, 3 * 2 ** 12, 16,
                                H100_SMS)
    assert roi_means_cuda.roi_plan(0, 8, 16, 3, 384, 48, 16, H100_SMS) \
        == ("vector", 8, 256, 0)
    assert roi_means_cuda.plan_bands(64, 64) == 1


def _vector_walk(frames, roi, C, W, bands):
    """Model of the vectorised kernel on one frame (``(H, pitch)`` u8, ``W``
    pixels of ``C`` bytes a row): the per-channel sums and how often each
    byte was summed.  Every loaded vector must meet the ROI span, so no
    load reaches past the last aligned 16 bytes that hold a pixel byte."""
    H, pitch = frames.shape
    gb = roi_means_cuda.group_bytes(C)
    threads, unroll = roi_means_cuda.VEC_THREADS, 6 // (gb // 16)
    x1, y1, x2, y2 = (int(v) for v in roi)
    cx1, cx2, cy1, cy2 = max(x1, 0), min(x2, W), max(y1, 0), min(y2, H)
    sums = np.zeros(C, np.int64)
    seen = np.zeros((H, pitch), np.int64)
    if cx2 <= cx1 or cy2 <= cy1:
        return sums, seen
    n = cy2 - cy1
    b0, b1 = cx1 * C, cx2 * C
    g0 = b0 // gb
    ng = -(-b1 // gb) - g0
    lo, hi = b0 - g0 * gb, b1 - g0 * gb
    for band in range(bands):
        r0, r1 = cy1 + n * band // bands, cy1 + n * (band + 1) // bands
        items = (r1 - r0) * ng
        dr, dg = divmod(threads, ng)
        for tid in range(min(threads, items)):
            r, g = divmod(tid, ng)
            for it in range(tid, items, unroll * threads):
                for u in range(unroll):
                    off = g * gb
                    if it + u * threads < items:
                        row = frames[r0 + r]
                        a, e = lo - off, hi - off
                        for k in range(gb // 16):
                            o = off + 16 * k
                            if not (o < hi and o + 16 > lo):
                                continue
                            col = g0 * gb + o
                            assert col + 16 <= -(-W * C // 16) * 16
                            for i in range(16):
                                j = 16 * k + i       # byte of the group
                                if not (a > 0 or e < gb) or a <= j < e:
                                    sums[j % C] += int(row[col + i])
                                    seen[r0 + r, col + i] += 1
                    r, g = r + dr, g + dg
                    if g >= ng:
                        r, g = r + 1, g - ng
    return sums, seen


@pytest.mark.parametrize("C,W,roi,bands", [
    (3, 37, [-5, -7, 50, 60], 8),       # beyond every edge, whole frame
    (3, 37, [3, -5, 30, 36], 3),        # y1 < 0 across bands
    (3, 37, [10, 4, 11, 40], 8),        # one column
    (3, 37, [2, 28, 35, 31], 8),        # 3 rows in 8 bands
    (3, 37, [0, 0, 0, 0], 4),           # empty
    (3, 37, [20, 5, 9, 30], 2),         # inverted
    (3, 64, [5, 2, 60, 38], 1),         # interior groups, one band
    (1, 53, [7, 3, 50, 30], 5),         # odd width, C = 1
    (2, 41, [-3, 6, 39, 33], 3),        # C = 2
    (4, 21, [1, 1, 20, 31], 8),         # C = 4
    (3, 123, [17, 9, 118, 19], 8),      # wide span, ten rows in 8 bands
])
def test_vector_walk_counts_each_roi_byte_once(C, W, roi, bands):
    """The model of the kernel's walk sums every ROI byte inside the frame
    exactly once and no other byte, and its sums (channels fixed by a
    byte's place in its group) equal ``reduce.roi_channel_means``."""
    H = 31
    pitch = -(-W * C // 16) * 16            # an aligned row pitch
    rng = np.random.default_rng(W * C)
    frames = rng.integers(0, 256, (H, pitch), dtype=np.uint8)
    sums, seen = _vector_walk(frames, roi, C, W, bands)
    x1, y1, x2, y2 = roi
    want = np.zeros((H, pitch), np.int64)
    want[max(y1, 0):max(min(y2, H), 0),
         max(x1, 0) * C:max(min(x2, W), 0) * C] = 1
    np.testing.assert_array_equal(seen, want)
    t = torch.as_tensor(frames[None])
    means, count = treduce.roi_channel_means(
        t, torch.tensor([roi], dtype=torch.int32), channels=C, width=W)
    area = max(y2 - y1, 0) * max(x2 - x1, 0)
    assert float(count[0]) == area
    np.testing.assert_array_equal(
        means[0].numpy(),
        (torch.as_tensor(sums).to(torch.float32)
         / max(float(area), 1.0)).numpy())
