"""Kernels K1 to K7 against their plain PyTorch versions on a CUDA card.

These tests need the card (the CUDA kernels have no CPU mode) and skip
without one.  The file imports no JAX, so it also runs where JAX is not
installed; there, skip the JAX test configuration with

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Boxes, flags, counts and carries must be equal; means within
``rtol=1e-6, atol=1e-5`` (both sides sum exactly, then divide in float32;
K3's and K4's means are held equal).
K6 within ``atol=1e-6`` (an exact blur, then the same YIQ expression); K7
at most 1 u8 on at most 1e-3 of the values (the bilinear sum rounds as a
dot product, which cuBLAS may order otherwise), and K7's two instances
equal bit for bit.  K5 in float32 within
``1e-5 * max|y|`` (the same sums in another order, the kernel's 1x1 convs
in three TF32 passes that keep about 22 bits of each product, TF32 off in
the plain version); in bfloat16 within one bf16 ulp of each value, or ``1e-5 *
max|y|`` where that is larger (near zero the float32 rounding order alone
decides the last bit).
"""

import numpy as np
import pytest
import torch

from vhr_tpu.utils.synth import SynthSpec, synthesize

from vhr_tpu_torch.config import ROIConfig
from vhr_tpu_torch.models.mediapipe_face import default_task_path
from vhr_tpu_torch.models.tflite import load_task_models
from vhr_tpu_torch.models.tflite_exec import (_find_residual_stages,
                                              fold_dequantize)
from vhr_tpu_torch.ops import (evm_cuda, evm_recon_cuda, fused_cuda,
                               meshblocks_cuda, roi_means_cuda)
from vhr_tpu_torch.ops.reduce import roi_channel_means

TOL = dict(rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def gpu_clip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    v = synthesize(SynthSpec(duration_s=2.0, height=104, width=128,
                             bpm=80.0, motion_amplitude=1.0, noise_std=4.0,
                             dropout_frames=(20, 21)))
    return torch.as_tensor(v.frames).cuda(), torch.as_tensor(v.face_boxes)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _same(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    dict(row_block=64),
    dict(row_block=64, detect_every=4, gate_margin=0.5, rescan_every=3),
    dict(row_block=8, detect_row_pool=8, gate_margin=0.2),
    dict(row_block=128, detect_row_pool=2, detect_every=3, seq_len=25),
])
def test_k1_matches_plain(gpu_clip, kw):
    frames = gpu_clip[0]
    carry = fused_cuda.init_carry(frames.device)
    before = fused_cuda.LAUNCHES
    got, got_c = fused_cuda.fused_detect_roi_carry(frames, carry, **kw)
    assert fused_cuda.LAUNCHES == before + 1
    want, want_c = fused_cuda.fused_detect_roi_plain(frames, carry, **kw)
    torch.cuda.synchronize()
    _same(tuple(got) + (got_c,), tuple(want) + (want_c,))


@pytest.mark.gpu
def test_k1_chained_launches_match_plain(gpu_clip):
    frames = gpu_clip[0]
    kw = dict(row_block=64, detect_every=2, gate_margin=0.5)
    carry = fused_cuda.init_carry(frames.device)
    for s, n in [(0, 17), (17, 43)]:
        got, carry_g = fused_cuda.fused_detect_roi_carry(
            frames, carry, t_start=s, t_len=n, **kw)
        want, carry_w = fused_cuda.fused_detect_roi_plain(
            frames, carry, t_start=s, t_len=n, **kw)
        _same(tuple(got) + (carry_g,), tuple(want) + (carry_w,))
        carry = carry_g


@pytest.mark.gpu
@pytest.mark.parametrize("flat", [False, True])
def test_k2_matches_plain(gpu_clip, flat):
    frames, boxes = gpu_clip
    T, H, W, _ = frames.shape
    rng = np.random.default_rng(0)
    rois = np.concatenate([boxes.numpy(), rng.integers(-10, 140, (T, 4))])
    rois = torch.as_tensor(rois[::2].astype(np.int32)).cuda()
    rois[0] = 0
    rois[1] = torch.tensor([50, 60, 40, 90])
    x = frames.reshape(T, H, W * 3) if flat else frames
    got = roi_means_cuda.roi_channel_means_cuda(x, rois)
    want = roi_channel_means(frames, rois)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# A box whose cheek ROI (with ``_LONG_ROI``) runs from chunk 0 down into a
# row chunk that the gate leaves out, and one whose ROI is clipped at the
# frame's right and bottom edge (the clip is 104 x 128).
_LONG_ROI = ROIConfig(cheek_bottom=3.5)
_GATED_BOX = [40, 8, 90, 30, 15, 1]
_EDGE_BOX = [100, 70, 140, 130, 15, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    dict(row_block=64),
    dict(row_block=32, detect_every=4, gate_margin=0.5, rescan_every=3),
    dict(row_block=8, detect_row_pool=8, gate_margin=0.2, detect_every=3),
    dict(row_block=64, slots=1),
    dict(row_block=128),                       # larger than H: one chunk
    dict(row_block=64, detect_row_pool=8),     # clamped last chunk, q0 > 0
    dict(row_block=64, detect_row_pool=8, gate_margin=0.1),
    dict(row_block=32, gate_margin=0.1, rescan_every=7, roi=_LONG_ROI,
         box=_GATED_BOX),
    dict(row_block=32, detect_every=2, roi=_LONG_ROI, box=_GATED_BOX),
    dict(row_block=64, box=_EDGE_BOX),
    dict(row_block=16, detect_row_pool=4, gate_margin=0.3, box=_EDGE_BOX),
])
def test_k4_matches_plain(gpu_clip, kw):
    """Slots from random frames of the clip, with random carries (fresh,
    tracked and spent-budget rows) and random phases.  ``box`` puts a
    tracked carry row on slots 3 to 8, at phases 1 to 6.  Every output must
    equal the plain version's (the means are exact sums divided once), and
    a second launch on the same inputs must give the same bits: the first
    left the kernel's accumulators clean."""
    frames, boxes = gpu_clip
    kw = dict(kw)
    S, box = kw.pop("slots", 12), kw.pop("box", None)
    rng = np.random.default_rng(len(kw))
    pick = rng.integers(0, frames.shape[0], S)
    x1, y1 = rng.integers(0, 64, S), rng.integers(0, 52, S)
    carry = np.stack([x1, y1, x1 + rng.integers(10, 64, S),
                      y1 + rng.integers(10, 52, S), rng.integers(0, 16, S),
                      rng.integers(0, 2, S)], 1).astype(np.int32)
    phase = rng.integers(0, 100, S).astype(np.int32)
    carry[0] = 0
    if S > 2:
        carry[1, 4:] = [0, 1]
        carry[2] = boxes[pick[2]].tolist() + [15, 1]
    if box is not None:
        carry[3:9] = box
        phase[3:9] = np.arange(1, 7)
    slots = frames[torch.as_tensor(pick).cuda()].contiguous()
    carry = torch.as_tensor(carry).cuda()
    phase = torch.as_tensor(phase).cuda()
    before = fused_cuda.SLOT_LAUNCHES
    got, got_c = fused_cuda.fused_detect_roi_slots(slots, carry, phase, **kw)
    again, again_c = fused_cuda.fused_detect_roi_slots(slots, carry, phase,
                                                       **kw)
    assert fused_cuda.SLOT_LAUNCHES == before + 2
    want, want_c = fused_cuda.fused_detect_roi_slots_plain(slots, carry,
                                                           phase, **kw)
    torch.cuda.synchronize()
    for g, a, w in zip(tuple(got) + (got_c,), tuple(again) + (again_c,),
                       tuple(want) + (want_c,)):
        assert torch.equal(g, w)
        assert torch.equal(a, g)


@pytest.mark.gpu
def test_k4_takes_any_size_after_another(gpu_clip):
    """One scratch serves every slot count and frame size in turn."""
    frames = gpu_clip[0]
    for S, h in [(5, 104), (2, 64), (9, 104)]:
        slots = frames[:S, :h].contiguous()
        carry = torch.zeros((S, 6), dtype=torch.int32, device=slots.device)
        phase = torch.zeros((S,), dtype=torch.int32, device=slots.device)
        got, got_c = fused_cuda.fused_detect_roi_slots(slots, carry, phase,
                                                       row_block=32)
        want, want_c = fused_cuda.fused_detect_roi_slots_plain(
            slots, carry, phase, row_block=32)
        torch.cuda.synchronize()
        for g, w in zip(tuple(got) + (got_c,), tuple(want) + (want_c,)):
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 64, 256), (3, 91, 100), (1, 2, 2),
                                   (2, 35, 131), (1, 36, 1920),
                                   (2, 40, 1280), (2, 35, 1000),
                                   (1, 1080, 1920), (3, 40, 1280, "view")])
def test_k6_matches_plain(cuda, shape):
    """16-byte copies (widths 256, 1280, 1920; several strips, one and more
    segments, the 1080p frame of the EVM paths), 4-byte copies (width
    1000, 100) and byte loads (131, 2), odd heights, and a view whose base
    lies one frame into a contiguous batch."""
    T, H, W = shape[:3]
    rng = np.random.default_rng(H)
    frames = torch.as_tensor(rng.integers(0, 256, (T, H, W, 3), np.uint8),
                             device=cuda)
    if len(shape) > 3:
        frames = frames[1:]
        T -= 1
    before = evm_cuda.LAUNCHES
    got = evm_cuda.yiq_pyrdown(frames)
    assert evm_cuda.LAUNCHES == before + 1
    want = evm_cuda.yiq_pyrdown_plain(frames)
    torch.cuda.synchronize()
    assert got.shape == (T, 3, H // 2, W // 2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("max_steps", [3, 16])
@pytest.mark.parametrize("W", [1920, 1000, 131])
def test_k6_long_segments(cuda, monkeypatch, W, max_steps):
    """Segments longer than the ring (the host's ``max_steps`` only: the
    kernel is the same), so that the ring's slots are refilled while the
    block walks down."""
    monkeypatch.setitem(evm_cuda.KERNEL_SHAPE, "max_steps", max_steps)
    rng = np.random.default_rng(W + max_steps)
    frames = torch.as_tensor(rng.integers(0, 256, (2, 299, W, 3), np.uint8),
                             device=cuda)
    assert evm_cuda.k6_geometry(2, 299, W).seg_steps > 2
    got = evm_cuda.yiq_pyrdown(frames)
    want = evm_cuda.yiq_pyrdown_plain(frames)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1920, 1000, 131])
def test_k6_same_bits_twice(cuda, W):
    """Two launches on the same frames give the same bits (16-byte, 4-byte
    and byte copies)."""
    rng = np.random.default_rng(W)
    frames = torch.as_tensor(rng.integers(0, 256, (2, 67, W, 3), np.uint8),
                             device=cuda)
    first = evm_cuda.yiq_pyrdown(frames)
    again = evm_cuda.yiq_pyrdown(frames)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["planar", "interleaved"])
@pytest.mark.parametrize("amp", [0.04, 0.5])
def test_k7_matches_plain(cuda, layout, amp):
    rng = np.random.default_rng(int(amp * 100))
    T, H, W, hb, wb = 3, 75, 130, 9, 17
    frames = torch.as_tensor(rng.integers(0, 256, (T, H, W, 3), np.uint8),
                             device=cuda)
    band = torch.as_tensor(rng.uniform(-amp, amp, (T, 3, hb, wb))
                           .astype(np.float32), device=cuda)
    planar = evm_cuda.to_planar(frames)
    if layout == "planar":
        planar = planar.contiguous()
    before = evm_recon_cuda.LAUNCHES
    got = evm_recon_cuda.evm_reconstruct(planar, band)
    assert evm_recon_cuda.LAUNCHES == before + 1
    want = evm_recon_cuda.evm_reconstruct_plain(planar, band)
    torch.cuda.synchronize()
    assert got.stride() == planar.stride()
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) <= 1e-3


# (T, H, W, hb, wb), "view": K7's vectorised instance over several strips
# and segments, the 1080p frame of the EVM path with its band, a part strip
# (W = 1008) and a part segment, a view one frame into a batch, a band wider
# than the frame, one whose staged columns halve the segment, a pass tail.
_K7_VEC_SHAPES = [(2, 64, 256, 4, 16), (1, 1080, 1920, 68, 120),
                  (3, 75, 1008, 5, 63), (3, 40, 1280, 3, 80, "view"),
                  (2, 33, 16, 3, 40), (1, 70, 16, 5, 400),
                  (2, 129, 144, 9, 9)]


def _k7_input(cuda, shape, amp=0.5):
    T, H, W, hb, wb = shape[:5]
    rng = np.random.default_rng(H * W + hb)
    n = T + 1 if len(shape) > 5 else T
    frames = torch.as_tensor(rng.integers(0, 256, (n, H, W, 3), np.uint8),
                             device=cuda)[n - T:]
    band = torch.as_tensor(rng.uniform(-amp, amp, (T, 3, hb, wb))
                           .astype(np.float32), device=cuda)
    return evm_cuda.to_planar(frames), band


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _K7_VEC_SHAPES)
def test_k7_vector_matches_generic(cuda, shape):
    """The vectorised instance equals the generic one bit for bit."""
    planar, band = _k7_input(cuda, shape)
    before = evm_recon_cuda.VEC_LAUNCHES
    got = evm_recon_cuda.evm_reconstruct(planar, band)
    assert evm_recon_cuda.VEC_LAUNCHES == before + 1
    before = evm_recon_cuda.GENERIC_LAUNCHES
    want = evm_recon_cuda.evm_reconstruct(planar, band, instance="generic")
    assert evm_recon_cuda.GENERIC_LAUNCHES == before + 1
    torch.cuda.synchronize()
    assert got.stride() == planar.stride() or len(shape) > 5
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("amp", [0.04, 0.5])
@pytest.mark.parametrize("shape", _K7_VEC_SHAPES[:4])
def test_k7_vector_matches_plain(cuda, shape, amp):
    planar, band = _k7_input(cuda, shape, amp)
    got = evm_recon_cuda.evm_reconstruct(planar, band, instance="vector")
    want = evm_recon_cuda.evm_reconstruct_plain(planar, band)
    torch.cuda.synchronize()
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _K7_VEC_SHAPES[:3])
def test_k7_vector_same_bits_twice(cuda, shape):
    planar, band = _k7_input(cuda, shape)
    first = evm_recon_cuda.evm_reconstruct(planar, band, instance="vector")
    again = evm_recon_cuda.evm_reconstruct(planar, band, instance="vector")
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.gpu
def test_k7_vector_refuses_other_layouts(cuda):
    """Planar frames and a width of 1000 take the generic instance; asking
    for the vectorised one raises."""
    for shape in [(2, 40, 256, 3, 16), (2, 40, 1000, 3, 63)]:
        planar, band = _k7_input(cuda, shape)
        if shape[2] == 256:
            planar = planar.contiguous()
        before = evm_recon_cuda.GENERIC_LAUNCHES
        evm_recon_cuda.evm_reconstruct(planar, band)
        assert evm_recon_cuda.GENERIC_LAUNCHES == before + 1
        with pytest.raises(ValueError):
            evm_recon_cuda.evm_reconstruct(planar, band, instance="vector")


def _k3_rois(rng, T, H, W):
    """Random ROIs, some beyond the frame on every side, with an invalid,
    a degenerate, an inverted, a whole-frame and a negative-``y1`` box."""
    x1 = rng.integers(-20, W, T)
    y1 = rng.integers(-20, H, T)
    rois = np.stack([x1, y1, x1 + rng.integers(-5, W, T),
                     y1 + rng.integers(-5, H, T)], -1).astype(np.int32)
    rois[0] = 0
    rois[1] = [7, 11, 13, 11]
    rois[2] = [20, 5, 9, 30]
    rois[3] = [-9, -9, W + 9, H + 9]
    rois[4] = [3, -5, W // 2, H - 3]
    return rois


def _k3_check(frames, rois, **kw):
    before = roi_means_cuda.BATCHED_LAUNCHES
    got = roi_means_cuda.roi_channel_means_batched_cuda(frames, rois, **kw)
    assert roi_means_cuda.BATCHED_LAUNCHES == before + 1
    want = roi_channel_means(frames, rois, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


_COUNTERS = {"vector": "VEC_LAUNCHES", "generic": "GENERIC_LAUNCHES"}


def _instance_check(entry, instance, frames, rois, plain=None, **kw):
    """One launch of the K2 (``entry="k2"``) or K3 entry on ``instance``:
    its counter moves by one, and means and counts equal the plain
    version's bit for bit."""
    fn = (roi_means_cuda.roi_channel_means_cuda if entry == "k2"
          else roi_means_cuda.roi_channel_means_batched_cuda)
    counter = _COUNTERS[instance]
    before = getattr(roi_means_cuda, counter)
    got = fn(frames, rois, instance=instance, **kw)
    assert getattr(roi_means_cuda, counter) == before + 1
    want = plain if plain is not None else roi_channel_means(frames, rois,
                                                             **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 104, 128, 3), (13, 75, 130, 3),
                                   (9, 40, 37, 1), (5, 33, 21, 4),
                                   (6, 64, 1920, 3)])
def test_k3_matches_plain(cuda, shape):
    """Shapes whose rows are 16-byte aligned and not, every channel count,
    and ``T`` not a multiple of the generic instance's 8-frame batch."""
    T, H, W, C = shape
    rng = np.random.default_rng(T * W)
    frames = torch.as_tensor(rng.integers(0, 256, shape, np.uint8),
                             device=cuda)
    rois = torch.as_tensor(_k3_rois(rng, T, H, W), device=cuda)
    _k3_check(frames, rois)


@pytest.mark.gpu
@pytest.mark.parametrize("pad", [64, 5])
def test_k3_padded_pitch_matches_plain(cuda, pad):
    """Flat rows padded by ``pad`` bytes (a reader's staging buffer), and a
    strided view of every other frame: no copy, the same sums."""
    T, H, W = 21, 48, 64
    rng = np.random.default_rng(pad)
    padded = torch.as_tensor(rng.integers(0, 256, (T, H, W * 3 + pad),
                                          np.uint8), device=cuda)
    rois = torch.as_tensor(_k3_rois(rng, T, H, W), device=cuda)
    _k3_check(padded, rois, width=W)
    frames = padded[..., :W * 3].reshape(T, H, W, 3)
    got = roi_means_cuda.roi_channel_means_batched_cuda(padded, rois,
                                                        width=W)
    want = roi_means_cuda.roi_channel_means_batched_cuda(
        frames.contiguous(), rois)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    _k3_check(padded[::2], rois[::2].contiguous(), width=W)


@pytest.mark.gpu
@pytest.mark.parametrize("instance", ["vector", "generic"])
def test_k3_matches_k2_on_the_clip(gpu_clip, instance):
    """Each instance, through the K2 and the K3 entry, 4-D and flat, on
    the synthetic clip's face boxes, against the plain version."""
    frames, boxes = gpu_clip
    T, H, W, _ = frames.shape
    rois = boxes.cuda()
    want = roi_channel_means(frames, rois)
    for entry in ("k2", "k3"):
        for x in (frames, frames.reshape(T, H, W * 3)):
            _instance_check(entry, instance, x, rois, want)


@pytest.fixture(scope="module")
def full_size():
    """960 random 1080p frames and 64 of 720p, and their cheek-sized ROIs
    beside random, degenerate and edge ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(5)
    out = {}
    for name, (T, H, W) in {"1080p": (960, 1080, 1920),
                            "720p": (64, 720, 1280)}.items():
        frames = torch.randint(0, 256, (T, H, W, 3), generator=gen,
                               device=cuda, dtype=torch.uint8)
        rng = np.random.default_rng(T)
        rois = _k3_rois(rng, T, H, W)
        cheek = np.stack([rng.integers(W // 4, W // 3, T),
                          rng.integers(H // 3, H // 2, T)], 1)
        cheek = np.concatenate([cheek, cheek + [W // 3, H // 8]], 1)
        rois[8::2] = cheek[8::2]
        out[name] = (frames, torch.as_tensor(rois.astype(np.int32),
                                             device=cuda))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["k2", "k3"])
@pytest.mark.parametrize("instance", ["vector", "generic"])
@pytest.mark.parametrize("size,T", [("1080p", 1), ("1080p", 3),
                                    ("720p", 64), ("1080p", 256),
                                    ("1080p", 960)])
def test_k2_k3_instances_at_path_sizes(full_size, entry, instance, size, T):
    """Both instances through both entries at the frame counts the paths
    launch (the pool's 64 slots of 720p, a stream's 256-frame chunk, a
    960-frame clip of 1080p) and at 1 and 3 frames: equal bit for bit."""
    frames, rois = full_size[size]
    _instance_check(entry, instance, frames[:T], rois[:T].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("instance", ["vector", "generic"])
@pytest.mark.parametrize("shape,pad", [((9, 40, 32, 1), 0),
                                       ((5, 33, 20, 4), 0),
                                       ((7, 48, 64, 2), 0),
                                       ((13, 75, 130, 3), 10),
                                       ((11, 37, 61, 3), 73),
                                       ((6, 64, 1920, 3), 0)])
def test_k2_k3_channels_and_pitches(cuda, instance, shape, pad):
    """C = 1 to 4, odd widths in rows padded to an aligned pitch (both
    instances take them through K3), strided frames; the K2 entry where
    the frames are contiguous."""
    T, H, W, C = shape
    rng = np.random.default_rng(W * C + pad)
    pitch = W * C + pad
    buf = torch.as_tensor(rng.integers(0, 256, (2 * T, H, pitch), np.uint8),
                          device=cuda)
    rois = torch.as_tensor(_k3_rois(rng, T, H, W), device=cuda)
    aligned = pitch % 16 == 0
    if instance == "generic" or aligned:
        _instance_check("k3", instance, buf[:T], rois, channels=C, width=W)
        _instance_check("k3", instance, buf[::2], rois, channels=C, width=W)
    if pad == 0 and (instance == "generic" or aligned):
        _instance_check("k2", instance, buf[:T].reshape(T, H, W, C), rois)
    if not aligned:
        with pytest.raises(ValueError, match="aligned"):
            roi_means_cuda.roi_channel_means_batched_cuda(
                buf[:T], rois, channels=C, width=W, instance="vector")


@pytest.mark.gpu
def test_k2_k3_misaligned_base_takes_generic(cuda):
    """A contiguous view whose base is off the 16-byte grid: the plan takes
    the generic instance, and the sums are the plain version's."""
    T, H, W = 6, 40, 64
    buf = torch.randint(0, 256, (T * H * W * 3 + 1,), device=cuda,
                        dtype=torch.uint8)
    frames = buf[1:].view(T, H, W, 3)
    rois = torch.as_tensor(_k3_rois(np.random.default_rng(1), T, H, W),
                           device=cuda)
    for entry in ("k2", "k3"):
        _instance_check(entry, "generic", frames, rois)
        before = roi_means_cuda.GENERIC_LAUNCHES
        fn = (roi_means_cuda.roi_channel_means_cuda if entry == "k2"
              else roi_means_cuda.roi_channel_means_batched_cuda)
        fn(frames, rois)
        assert roi_means_cuda.GENERIC_LAUNCHES == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("kw", [dict(row_block=64),
                                dict(row_block=32, detect_every=3,
                                     gate_margin=0.5)])
def test_k1_roi_sums_bit_equal(gpu_clip, offset, kw):
    """K1's third launch is the K2 entry with ``roi_ok``: its means and
    counts equal the plain version's bit for bit (the plain version sums
    the same ROIs exactly and zeroes the count of an invalid ROI), on the
    vectorised instance and, from a base off the 16-byte grid, the
    generic one."""
    frames = gpu_clip[0]
    T, H, W, _ = frames.shape
    buf = torch.empty(frames.numel() + offset, dtype=torch.uint8,
                      device=frames.device)
    x = buf[offset:].view(T, H, W * 3)
    x.copy_(frames.reshape(T, H, W * 3))
    plan = roi_means_cuda.roi_plan(
        T, H, W, 3, H * W * 3, W * 3, roi_means_cuda.alignment(x.data_ptr()),
        roi_means_cuda.sm_count(0))
    assert plan.instance == ("vector" if offset == 0 else "generic")
    carry = fused_cuda.init_carry(frames.device)
    got, got_c = fused_cuda.fused_detect_roi_carry(x, carry, **kw)
    want, want_c = fused_cuda.fused_detect_roi_plain(x, carry, **kw)
    torch.cuda.synchronize()
    assert int(want.roi_valid.sum()) > 0
    for g, w in zip(tuple(got) + (got_c,), tuple(want) + (want_c,)):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def mesh_stages():
    """The face-mesh graph's four residual stages with their packed
    weights."""
    g = fold_dequantize(load_task_models(default_task_path())[
        "face_landmarks_detector.tflite"].graph)
    out = []
    for st in _find_residual_stages(g.operators, g.tensors):
        blocks = [{k: g.tensors[t].data for k, t in b.items()}
                  for b in st["blocks"]]
        out.append((st, meshblocks_cuda.pack_stage_weights(
            g.tensors[st["a0"]].data, blocks)))
    return out


def k5_close(got: torch.Tensor, want: torch.Tensor) -> None:
    """K5's tolerance (module docstring) in float32 and in bfloat16."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    err = (g - w).abs()
    if got.dtype == torch.float32:
        assert float(err.max()) <= 1e-5 * scale
        return
    big = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    assert bool((err <= torch.maximum(ulp, torch.tensor(1e-5 * scale,
                                                        device=err.device))
                 ).all())


def _k5_check(x, wts, w_row):
    before = meshblocks_cuda.LAUNCHES
    got = meshblocks_cuda.residual_stage(x, wts, w_row)
    assert meshblocks_cuda.LAUNCHES == before + 1
    want = meshblocks_cuda.residual_stage_plain(x, wts, w_row)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    k5_close(got, want)


def _k5_input(seed, B, C, S, dtype, device):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(0, 1, (B, C, S)).astype(np.float32),
                           device=device).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_k5_matches_plain(cuda, mesh_stages, stage, dtype):
    """K5 at each of the mesh net's four stage shapes with the bundled
    weights, on inputs spread like a stage's (entry maps of magnitude ~1)."""
    st, wts = mesh_stages[stage]
    wts = meshblocks_cuda.StageWeights(*(w.to(cuda) for w in wts))
    x = _k5_input(stage, 5, st["C"], st["H"] * st["W"], dtype, cuda)
    _k5_check(x, wts, st["W"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 65])
@pytest.mark.parametrize("stage", [0, 3])
def test_k5_batch_sizes(cuda, mesh_stages, stage, B, dtype):
    """One frame, and one more than the detector's slice of 64, at the
    largest and the smallest map."""
    st, wts = mesh_stages[stage]
    wts = meshblocks_cuda.StageWeights(*(w.to(cuda) for w in wts))
    x = _k5_input(B, B, st["C"], st["H"] * st["W"], dtype, cuda)
    _k5_check(x, wts, st["W"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_k5_multi_face_batch(cuda, mesh_stages, stage, dtype):
    """B=128, the batch the K=2 MediaPipe detector gives K5 (two crops a
    frame, slices of 64 frames), at each stage with the bundled weights."""
    st, wts = mesh_stages[stage]
    wts = meshblocks_cuda.StageWeights(*(w.to(cuda) for w in wts))
    x = _k5_input(128 + stage, 128, st["C"], st["H"] * st["W"], dtype, cuda)
    _k5_check(x, wts, st["W"])


def _random_stage(rng, C, Cm, n=4):
    """Stage weights scaled so the maps stay O(1)."""
    g = lambda *s, sc=1.0: rng.normal(0, sc, s).astype(np.float32)
    u = lambda n_: rng.uniform(0, 0.5, (1, 1, n_)).astype(np.float32)
    blocks = [dict(w1=g(Cm, 1, 1, C, sc=C ** -0.5), b1=g(Cm, sc=0.1),
                   a1=u(Cm), dw=g(1, 3, 3, Cm, sc=1 / 3), bdw=g(Cm, sc=0.1),
                   w2=g(C, 1, 1, Cm, sc=Cm ** -0.5), b2=g(C, sc=0.1),
                   a2=u(C)) for _ in range(n)]
    return meshblocks_cuda.pack_stage_weights(u(C), blocks)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,Cm", [(4, 32, 16, 8), (8, 16, 32, 16)])
def test_k5_all_edge_shapes(cuda, H, W, C, Cm, dtype):
    """Random weights (no symmetry for a transposed matrix to hide in) at
    shapes whose rows are all within the halo of both frame edges: every
    row and column meets the SAME padding, one band holds the frame."""
    rng = np.random.default_rng(H * W + C)
    wts = meshblocks_cuda.StageWeights(*(w.to(cuda)
                                         for w in _random_stage(rng, C, Cm)))
    x = _k5_input(H, 2, C, H * W, dtype, cuda)
    _k5_check(x, wts, W)


@pytest.mark.gpu
def test_k5_on_another_stream(cuda, mesh_stages):
    """A launch on a stream that is not the default one is ordered after
    that stream's earlier work and gives the default stream's result."""
    st, wts = mesh_stages[1]
    wts = meshblocks_cuda.StageWeights(*(w.to(cuda) for w in wts))
    x = _k5_input(7, 3, st["C"], st["H"] * st["W"], torch.bfloat16, cuda)
    want = meshblocks_cuda.residual_stage(x, wts, st["W"])
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(2_000_000)
        y = x * 2                      # the kernel must wait for this
        got = meshblocks_cuda.residual_stage(y, wts, st["W"])
    side.synchronize()
    ref = meshblocks_cuda.residual_stage(x * 2, wts, st["W"])
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and not torch.equal(got, want)


@pytest.mark.gpu
def test_k5_refuses_what_it_is_not_built_for(cuda, mesh_stages):
    wts = _random_stage(np.random.default_rng(0), 24, 8)
    wts = meshblocks_cuda.StageWeights(*(w.to(cuda) for w in wts))
    with pytest.raises(ValueError, match="C = 2 \\* Cm"):
        meshblocks_cuda.residual_stage(
            torch.zeros(1, 24, 256, device=cuda), wts, 16)
    st, wts = mesh_stages[0]
    wts = meshblocks_cuda.StageWeights(*(w.to(cuda) for w in wts))
    with pytest.raises(ValueError, match="w_row"):
        meshblocks_cuda.residual_stage(
            torch.zeros(1, 16, 128, device=cuda), wts, 2)


# -- the learned landmarker on the card (no repo kernel: cuDNN convs and
# einsum crops, the counterpart of the JAX package's XLA convs) -----------

@pytest.fixture(scope="module")
def landmarker_frames():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    v = synthesize(SynthSpec(duration_s=16 / 30, height=216, width=384,
                             noise_std=1.0))
    return v.frames


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,lm_tol,box_tol", [
    (torch.float32, 1e-4, 1), (torch.bfloat16, 1e-3, 1)])
def test_landmarker_card_matches_cpu(landmarker_frames, dtype, lm_tol,
                                     box_tol):
    """The port's landmarker on the card against itself on the CPU, 16
    frames: float32 landmarks within 1e-4 (TF32 convolutions would miss
    it), bf16 within 1e-3; boxes within 1 px (a truncation may flip)."""
    import dataclasses
    from vhr_tpu_torch.models import landmarker as tlmk
    cfg = dataclasses.replace(tlmk.LandmarkerConfig(), compute_dtype=dtype)
    out = {}
    for dev in ("cpu", "cuda"):
        model = tlmk.build_model(tlmk.load_params(device=dev), cfg, dev)
        frames = torch.as_tensor(landmarker_frames, device=dev)
        out[dev] = [t.cpu() for t in tlmk._landmarks(model, frames)]
        det = tlmk.make_detector(model.state_dict(), cfg, device=dev)
        out[dev] += [t.cpu() for t in det(frames)]
    lm_c, p_c, b_c, v_c = out["cpu"]
    lm_g, p_g, b_g, v_g = out["cuda"]
    torch.testing.assert_close(lm_g, lm_c, rtol=0, atol=lm_tol)
    assert torch.equal(v_g, v_c)
    assert int((b_g - b_c).abs().max()) <= box_tol


@pytest.mark.gpu
def test_cascade_card_matches_cpu(landmarker_frames):
    """The crops on the card within 1e-5 of the CPU's (full float32), and
    the float32 tiled and refined detectors' boxes equal."""
    import dataclasses
    from vhr_tpu_torch.models import cascade as tcas
    from vhr_tpu_torch.models import landmarker as tlmk
    fr = torch.as_tensor(landmarker_frames)
    boxes = torch.tensor([[100, 40, 260, 200]] * fr.shape[0],
                         dtype=torch.int32)
    c_cpu, o_cpu = tcas.crop_boxes_bilinear(fr, boxes, 96, 0.3)
    c_gpu, o_gpu = tcas.crop_boxes_bilinear(fr.cuda(), boxes.cuda(), 96, 0.3)
    torch.testing.assert_close(c_gpu.cpu(), c_cpu, rtol=0, atol=1e-5)
    torch.testing.assert_close(o_gpu.cpu(), o_cpu, rtol=0, atol=0)
    cfg = dataclasses.replace(tlmk.LandmarkerConfig(),
                              compute_dtype=torch.float32)
    params = tlmk.load_params(device="cpu")
    for make in (tcas.make_tiled_detector_multi, tcas.make_refined_detector):
        b_c, v_c = make(params, cfg, device="cpu")(fr)
        b_g, v_g = make(params, cfg, device="cuda")(fr.cuda())
        assert torch.equal(v_g.cpu(), v_c), make.__name__
        assert int((b_g.cpu() - b_c).abs().max()) <= 1, make.__name__
