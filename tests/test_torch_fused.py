"""Port parity for kernel K1 (fused skin detection + tracking + ROI means).

The K1 wrapper's CPU path (the plain PyTorch version) is held against
``vhr_tpu``'s Pallas kernel run in interpret mode, as
``tests/test_pallas_fused.py`` runs it.  Boxes, flags, counts and carries
are integers and must be equal; means within ``rtol=1e-6, atol=1e-5``
(the port sums exactly; at these sizes JAX's float32 sums are exact too).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhr_tpu.ops import pallas_fused as jfused
from vhr_tpu.utils.synth import SynthSpec, synthesize

from vhr_tpu_torch import interop
from vhr_tpu_torch.ops import fused_cuda
from vhr_tpu_torch.utils.profiling import counter

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)

MEANS_TOL = dict(rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def clip():
    # H=104 exercises the clamped-overlap last chunk; W*3=384 is 128-aligned.
    return synthesize(SynthSpec(duration_s=2.0, height=104, width=128,
                                bpm=80.0, motion_amplitude=1.0))


@pytest.fixture(scope="module")
def jump_frames():
    spec1 = SynthSpec(duration_s=1.0, height=104, width=128, bpm=70.0,
                      face_center=(0.5, 0.28), face_radii=(0.16, 0.14))
    spec2 = dataclasses.replace(spec1, face_center=(0.5, 0.75))
    return np.concatenate([synthesize(spec1).frames,
                           synthesize(spec2).frames])


def _assert_same(port: fused_cuda.FusedResult, ref: jfused.FusedResult):
    np.testing.assert_allclose(port.means.numpy(), np.asarray(ref.means),
                               **MEANS_TOL)
    for f in ("count", "boxes", "det_valid", "roi_valid"):
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


@pytest.mark.parametrize("detect_every", [1, 4])
@pytest.mark.parametrize("pool", [1, 8])
@pytest.mark.parametrize("gate_margin", [None, 0.5])
def test_k1_cpu_path_matches_pallas(clip, detect_every, pool, gate_margin):
    kw = dict(row_block=64, detect_every=detect_every,
              detect_row_pool=pool, gate_margin=gate_margin,
              rescan_every=3)
    ref = jfused.fused_detect_roi_pallas(jnp.asarray(clip.frames),
                                         interpret=True, **kw)
    before = counter("k1.launches")
    port, carry = fused_cuda.fused_detect_roi_carry(
        torch.as_tensor(clip.frames), fused_cuda.init_carry(), **kw)
    assert counter("k1.launches") == before        # CPU: no kernel launch
    _assert_same(port, ref)
    assert port.roi_valid.numpy()[1:].all()
    assert carry.dtype == torch.int32 and tuple(carry.shape) == (6,)


def test_k1_gated_jump_matches_pallas(jump_frames):
    """A face jumping out of the gate band: holdover drain, full rescans and
    reacquisition, with 8-row chunks."""
    kw = dict(row_block=8, gate_margin=0.2, rescan_every=10000)
    ref = jfused.fused_detect_roi_pallas(jnp.asarray(jump_frames),
                                         interpret=True, **kw)
    port = fused_cuda.fused_detect_roi_cuda(torch.as_tensor(jump_frames),
                                            **kw)
    _assert_same(port, ref)


def test_k1_seq_len_matches_pallas(clip, jump_frames):
    """Two concatenated streams: tracking resets at the stream boundary."""
    frames = np.concatenate([clip.frames[:40], jump_frames[20:60]])
    kw = dict(row_block=64, detect_every=3, seq_len=40)
    ref = jfused.fused_detect_roi_pallas(jnp.asarray(frames),
                                         interpret=True, **kw)
    port = fused_cuda.fused_detect_roi_cuda(torch.as_tensor(frames), **kw)
    _assert_same(port, ref)
    assert not bool(port.roi_valid[40])          # fresh stream: no box yet


def test_k1_chained_launches_match_pallas(clip):
    """Launches chained through t_start / t_len / carry equal the JAX
    launches part for part, and the single launch over the whole clip."""
    kw = dict(row_block=64, detect_every=2, gate_margin=0.5)
    frames_j, frames_t = jnp.asarray(clip.frames), torch.as_tensor(clip.frames)
    jc, tc = jfused.init_carry(), fused_cuda.init_carry()
    parts = []
    for s, n in [(0, 25), (25, 35)]:
        jr, jc = jfused.fused_detect_roi_carry(frames_j, jc, t_start=s,
                                               t_len=n, interpret=True, **kw)
        tr, tc = fused_cuda.fused_detect_roi_carry(frames_t, tc, t_start=s,
                                                   t_len=n, **kw)
        _assert_same(tr, jr)
        np.testing.assert_array_equal(interop.fused_carry_to_numpy(tc),
                                      np.asarray(jc))
        parts.append(tr)
    whole = fused_cuda.fused_detect_roi_cuda(frames_t, **kw)
    for f in fused_cuda.FusedResult._fields:
        np.testing.assert_array_equal(
            torch.cat([getattr(p, f) for p in parts]).numpy(),
            getattr(whole, f).numpy())


def test_k1_stream_continues_from_jax_carry(clip):
    """First half in JAX, carry handed over as numpy, second half in the
    port (its own frames array, cadence phase passed explicitly): the
    joined result equals JAX over the whole clip."""
    kw = dict(row_block=64, detect_every=4, detect_row_pool=8,
              gate_margin=0.5, rescan_every=2)
    half = 30
    ref = jfused.fused_detect_roi_pallas(jnp.asarray(clip.frames),
                                         interpret=True, **kw)
    first, jcarry = jfused.fused_detect_roi_carry(
        jnp.asarray(clip.frames), jfused.init_carry(), t_start=0,
        t_len=half, interpret=True, **kw)
    carry = interop.fused_carry_from_numpy(np.asarray(jcarry))
    second, _ = fused_cuda.fused_detect_roi_carry(
        torch.as_tensor(clip.frames[half:]), carry, phase=half, **kw)
    np.testing.assert_array_equal(second.boxes.numpy(),
                                  np.asarray(ref.boxes)[half:])
    np.testing.assert_array_equal(second.roi_valid.numpy(),
                                  np.asarray(ref.roi_valid)[half:])
    np.testing.assert_array_equal(second.det_valid.numpy(),
                                  np.asarray(ref.det_valid)[half:])
    np.testing.assert_allclose(second.means.numpy(),
                               np.asarray(ref.means)[half:], **MEANS_TOL)
    np.testing.assert_array_equal(np.asarray(first.boxes),
                                  np.asarray(ref.boxes)[:half])


def test_rejects_unaligned_width():
    with pytest.raises(ValueError):
        fused_cuda.fused_detect_roi_cuda(
            torch.zeros((2, 32, 100, 3), dtype=torch.uint8))
    with pytest.raises(ValueError):
        fused_cuda.fused_detect_roi_cuda(
            torch.zeros((2, 36, 128, 3), dtype=torch.uint8))
    with pytest.raises(ValueError):
        fused_cuda.fused_detect_roi_cuda(
            torch.zeros((2, 32, 128, 3), dtype=torch.uint8),
            detect_row_pool=3)


@pytest.mark.parametrize("row_bytes,address,want", [
    (1920 * 3, 0x7F0000000000, "vector"),
    (1920 * 3, 0x7F0000000000 + 104 * 384, "vector"),   # a later t_start
    (1920 * 3, 0x7F0000000001, "scalar"),                # a sliced base
    (1920 * 3, 0x7F0000000008, "scalar"),
    (130 * 3, 0x7F0000000000, "scalar"),                 # 3 W % 16 != 0
])
def test_k1_skin_instance(row_bytes, address, want):
    """K1's skin pass reads 16-byte groups only where every row of the
    launch starts on the 16-byte grid."""
    assert fused_cuda.skin_instance(row_bytes, address) == want


def speckled_clip(seed, pool, T=8, H=64, W=128):
    """A skin rectangle (rows 24-39) on black with single skin cells
    (``pool`` rows of one column) strewn beside it in its rows, so that a
    column holds none, one or more cells across the row chunks, and lone
    cells in the other pooled rows (at most one a row, so they never make
    a row of two).  Returns the frames and the cells ``(T, H/pool, W)``."""
    rng = np.random.default_rng(seed)
    cells = np.zeros((T, H // pool, W), bool)
    face = slice(24 // pool, 40 // pool)
    cells[:, face, 40:88] = True
    cells[:, face] |= rng.random(cells[:, face].shape) < 0.6 * pool / 16
    lone = rng.random(cells.shape[:2]) < 0.5
    lone[:, face] = False
    t, q = np.nonzero(lone)
    cells[t, q, rng.integers(0, W, t.size)] = True
    frames = np.zeros((T, H, W, 3), np.uint8)
    frames[np.repeat(cells, pool, axis=1)] = (120, 150, 200)
    return frames, cells


@pytest.mark.parametrize("pool", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_k1_speckled_occupancy_matches_pallas(pool, seed):
    """A box's columns are those whose skin cells in the scanned row
    chunks times the pool reach 2 (without pooling a column needs two
    cells, which may lie in two chunks): the port's CPU path equals the
    Pallas kernel on clips of sparse cells, 8-row chunks, gated, with full
    rescans."""
    frames, cells = speckled_clip(seed, pool)
    kw = dict(row_block=8, detect_row_pool=pool, gate_margin=0.15,
              rescan_every=5)
    ref = jfused.fused_detect_roi_pallas(jnp.asarray(frames),
                                         interpret=True, **kw)
    port = fused_cuda.fused_detect_roi_cuda(torch.as_tensor(frames), **kw)
    _assert_same(port, ref)
    boxes = port.boxes.numpy()
    assert port.det_valid.numpy().all()
    assert (boxes[:, 1] == 24).all() and (boxes[:, 3] == 39).all()
    if pool == 1:
        # Columns of one cell stay out of the box.
        any_cell = [np.nonzero(c.any(0))[0][[0, -1]] for c in cells]
        assert any((b[[0, 2]] != a).any() for b, a in zip(boxes, any_cell))
