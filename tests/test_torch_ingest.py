"""Port parity for streaming ingest: kernel K3's plain version, the port's
cv2 reader and read-ahead chunk reader, ``extract_signals_streaming`` and
``measure_green_avg_file``, against ``vhr_tpu`` on the CPU.

Both packages read the same MJPG clips through cv2 in this process; the JAX
side runs with its native framestore switched off (``prefer_native=False``,
or ``native.is_available`` patched to False where the JAX function has no
such argument).  Tolerances and why:

* K3's plain version against the Pallas K3 in interpret mode: means
  ``rtol=1e-5, atol=1e-4`` and counts equal (``tests/test_roi_ops.py``'s
  bounds: the Pallas sums are float32 matrix products); padded against
  unpadded rows: equal (the same exact sums);
* the streams: ``valid`` equal, ``bgr`` ``rtol=1e-6, atol=1e-5`` against
  JAX (exact sums on both sides, one float32 division) and equal against
  the port's own whole-clip pass (the same sums and division);
* the file measure: ``valid`` equal, BPM equal on at least 99% of valid
  frames and within one DFT bin on the rest against JAX (XLA:CPU and
  PyTorch round float32 FFTs differently); equal to the port's in-memory
  measure of the same decoded frames;
* the readers: decoded frames, fps and chunk start indices equal, for any
  number of decoders, on MJPG and ``mp4v`` clips; I420 chunks equal cv2's
  ``COLOR_BGR2YUV_I420`` of the BGR chunks;
* the I420 reconstruction: equal to JAX's and to ``cv2.COLOR_YUV2BGR_I420``;
  the plane-domain means: counts equal and means within ``atol=1e-4`` of
  JAX's (float32 affine map, which XLA may round as fmas), and within
  JAX's own bounds of reconstruct-then-reduce, 0.51 u8 for even boxes and
  1.5 u8 for odd edges (``tests/test_native_io.py``);
* the I420 streams: ``valid`` equal, means within ``atol=1e-4`` (detect,
  plane means) and ``rtol=1e-6`` (fused, K1 on rebuilt frames) of JAX's
  (whose native reader stages I420; those cases skip without it), equal to
  the port's whole-clip fused pass on the cv2-rebuilt frames, and within
  1.5 u8 of its whole-clip detect pass.
"""

import dataclasses

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vhr_tpu.io.native
from vhr_tpu.config import PipelineConfig as JaxPipelineConfig
from vhr_tpu.io import video as jvideo
from vhr_tpu.ops import color as jcolor
from vhr_tpu.ops import reduce as jreduce
from vhr_tpu.ops.pallas_roi import roi_channel_means_pallas_batched
from vhr_tpu.pipeline import offline as joffline
from vhr_tpu.utils.synth import SynthSpec, synthesize

from vhr_tpu_torch.config import PipelineConfig
from vhr_tpu_torch.io import video as tvideo
from vhr_tpu_torch.ops import color, roi_means_cuda
from vhr_tpu_torch.ops import roi as troi
from vhr_tpu_torch.ops import windows as twin
from vhr_tpu_torch.ops.reduce import roi_channel_means
from vhr_tpu_torch.pipeline import offline as toffline
from vhr_tpu_torch.utils.profiling import counter

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)

FPS = 30.0
# The same configuration built in each package from the same arguments.
_CFG_ARGS = dict(window_seconds=4.0, acquisition_seconds=2.0)
JCFG, CFG = JaxPipelineConfig(**_CFG_ARGS), PipelineConfig(**_CFG_ARGS)
MEANS_TOL = dict(rtol=1e-6, atol=1e-5)
RING_KEYS = {"host_wait_on_decode_s", "device_dispatch_fetch_s", "verdict",
             "decode_wait_fraction"}


def _write(path, frames):
    tvideo.write_video(frames, str(path), FPS, fourcc="MJPG")
    return str(path)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """MJPG clips: 48x64 for the detect-then-reduce form, 48x128 (the fused
    kernel needs W*3 % 128 == 0) for both forms, with a dropout."""
    d = tmp_path_factory.mktemp("clips")
    small = synthesize(SynthSpec(duration_s=3.0, height=48, width=64,
                                 bpm=75.0))
    wide = synthesize(SynthSpec(duration_s=6.0, height=48, width=128,
                                bpm=75.0, noise_std=1.0,
                                dropout_frames=(50, 51, 52)))
    return {"small": _write(d / "small.avi", small.frames),
            "wide": _write(d / "wide.avi", wide.frames)}


@pytest.fixture(scope="module")
def i420_clips(tmp_path_factory):
    """75 BPM clips at the fused kernel's width (128) and at 160, whose
    128-column padded width (256) the I420 stream's detector sees, and a
    6 s MJPG and ``mp4v`` pair for the multi-decoder reader."""
    d = tmp_path_factory.mktemp("i420")
    out = {}
    for w in (128, 160):
        clip = synthesize(SynthSpec(duration_s=3.0, height=48, width=w,
                                    bpm=75.0, noise_std=1.0,
                                    dropout_frames=(20, 21)))
        out[w] = _write(d / f"w{w}.avi", clip.frames)
    long = synthesize(SynthSpec(duration_s=6.0, height=48, width=64,
                                bpm=75.0, noise_std=2.0,
                                motion_amplitude=2.0))
    out["MJPG"] = _write(d / "long.avi", long.frames)
    mp4 = str(d / "long.mp4")
    tvideo.write_video(long.frames, mp4, FPS, fourcc="mp4v")
    out["mp4v"] = mp4
    return out


def _random_rois(rng, T, H, W):
    x1 = rng.integers(0, W - 2, T)
    y1 = rng.integers(0, H - 2, T)
    rois = np.stack([x1, y1, rng.integers(x1 + 1, W), rng.integers(y1 + 1, H)],
                    -1).astype(np.int32)
    rois[2] = 0                         # invalid frame
    rois[5] = [7, 11, 13, 11]           # degenerate y-span
    return rois


# -- K3 ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,batch", [((21, 48, 64), 8),
                                         ((16, 130, 96), 4)])
def test_k3_plain_matches_pallas_batched(shape, batch):
    """K3's wrapper on CPU tensors (its plain version) against the Pallas
    K3 in interpret mode, with an invalid box, a degenerate box and a
    ragged tail (21 frames in batches of 8; 16 in batches of 4 have none,
    so the second shape covers the batch boundary)."""
    T, H, W = shape
    rng = np.random.default_rng(T * H)
    frames = rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8)
    rois = _random_rois(rng, T, H, W)
    m_ref, c_ref = roi_channel_means_pallas_batched(
        jnp.asarray(frames.reshape(T, H, W * 3)), jnp.asarray(rois),
        batch=batch, row_block=16, interpret=True, channels=3)
    before = counter("k2.batched")
    m, c = roi_means_cuda.roi_channel_means_batched_cuda(
        torch.as_tensor(frames), torch.as_tensor(rois))
    assert counter("k2.batched") == before   # CPU: no launch
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


@pytest.mark.parametrize("shape,pad", [((7, 48, 64), 64), ((6, 37, 50), 7)])
def test_k3_padded_pitch_equals_unpadded(shape, pad):
    """Flat ``(T, H, row_bytes)`` rows with padding (a reader's padded
    staging buffer) give exactly the unpadded 4-D result, with ROIs
    reaching into the padding and above the frame."""
    T, H, W = shape
    rng = np.random.default_rng(pad)
    frames = rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8)
    rois = _random_rois(rng, T, H, W)
    rois[0] = [W - 5, -3, W + 9, H + 4]
    padded = rng.integers(0, 256, (T, H, W * 3 + pad), dtype=np.uint8)
    padded[..., :W * 3] = frames.reshape(T, H, W * 3)
    want = roi_means_cuda.roi_channel_means_batched_cuda(
        torch.as_tensor(frames), torch.as_tensor(rois))
    got = roi_means_cuda.roi_channel_means_batched_cuda(
        torch.as_tensor(padded), torch.as_tensor(rois), width=W)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    with pytest.raises(ValueError, match="width"):
        roi_means_cuda.roi_channel_means_batched_cuda(
            torch.as_tensor(padded), torch.as_tensor(rois),
            width=W + pad)


def test_pallas_k3_counts_rows_twice_above_the_frame():
    """A ROI that starts above the frame (``y1 < 0``) and spans more than
    one row chunk: the Pallas K3's row mask bounds each chunk from below
    only, so the rows of the first chunk that the next chunk overlaps are
    summed twice.  The port follows ``reduce.roi_channel_means``, which
    clamps reads to the frame."""
    rng = np.random.default_rng(11)
    T, H, W = 8, 48, 64
    frames = rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8)
    # One batch of 8 frames.  The others' ROIs start at row 16 or below, out
    # of the first chunk (row_block=16), so only frame 3 is summed twice.
    x1, y1 = rng.integers(0, W - 2, T), rng.integers(16, H - 2, T)
    rois = np.stack([x1, y1, rng.integers(x1 + 1, W), rng.integers(y1 + 1, H)],
                    -1).astype(np.int32)
    rois[3] = [3, -5, 30, 36]
    m_ref, c_ref = jreduce.roi_channel_means(jnp.asarray(frames),
                                             jnp.asarray(rois))
    m_pl, c_pl = roi_channel_means_pallas_batched(
        jnp.asarray(frames), jnp.asarray(rois), batch=8, row_block=16,
        interpret=True)
    m, c = roi_means_cuda.roi_channel_means_batched_cuda(
        torch.as_tensor(frames), torch.as_tensor(rois))
    np.testing.assert_array_equal(np.asarray(c_pl), np.asarray(c_ref))
    # Rows 8..15 are summed twice: the mean of frame 3 is too large.
    twice = frames[3, 8:16, 3:30].reshape(-1, 3).sum(0) / (41 * 27)
    np.testing.assert_allclose(np.asarray(m_pl)[3] - np.asarray(m_ref)[3],
                               twice, rtol=1e-5, atol=1e-4)
    keep = np.arange(T) != 3
    np.testing.assert_allclose(np.asarray(m_pl)[keep],
                               np.asarray(m_ref)[keep], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), **MEANS_TOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


# -- readers ----------------------------------------------------------------

def test_video_io_matches_jax(clips, tmp_path):
    """The port's copy of the cv2 reader and writer equals ``vhr_tpu``'s."""
    path = clips["small"]
    got, fps = tvideo.read_video(path)
    want, jfps = jvideo.read_video(path)
    np.testing.assert_array_equal(got, want)
    assert fps == jfps == FPS
    np.testing.assert_array_equal(tvideo.read_video(path, max_frames=7)[0],
                                  jvideo.read_video(path, max_frames=7)[0])
    assert tvideo.video_metadata(path) == jvideo.video_metadata(path)
    for (g, gf, gs), (w, wf, ws) in zip(tvideo.iter_video_chunks(path, 16),
                                        jvideo.iter_video_chunks(path, 16)):
        np.testing.assert_array_equal(g, w)
        assert (gf, gs) == (wf, ws)
    tvideo.write_video(got, str(tmp_path / "port.mp4"), fps)
    jvideo.write_video(got, str(tmp_path / "jax.mp4"), fps)
    np.testing.assert_array_equal(tvideo.read_video(str(tmp_path
                                                        / "port.mp4"))[0],
                                  jvideo.read_video(str(tmp_path
                                                        / "jax.mp4"))[0])
    with pytest.raises(FileNotFoundError):
        tvideo.read_video(str(tmp_path / "missing.avi"))


@pytest.mark.parametrize("chunk", [8, 7, 200])
def test_chunk_reader_matches_iter_video_chunks(clips, chunk):
    """The read-ahead reader yields ``iter_video_chunks``'s chunks and start
    indices, the last one ragged (90 frames in chunks of 8 or 7), or the
    whole clip in one chunk."""
    path = clips["small"]
    want = list(jvideo.iter_video_chunks(path, chunk))
    with tvideo.ChunkReader(path, chunk, "cpu") as reader:
        assert reader.fps == FPS
        got = list(reader)
    assert [s for _, s in got] == [s for _, _, s in want]
    assert got[-1][0].shape[0] == 90 - got[-1][1]
    for (g, _), (w, _, _) in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), w)


def test_chunk_reader_stops_on_early_exit_and_error(clips, tmp_path):
    path = clips["small"]
    with tvideo.ChunkReader(path, 4, "cpu") as reader:
        first, start = next(iter(reader))
    assert start == 0 and first.shape[0] == 4
    assert not any(th.is_alive() for th in reader._threads)
    with pytest.raises(RuntimeError, match="boom"):
        with tvideo.ChunkReader(path, 4, "cpu") as reader:
            for _ in reader:
                raise RuntimeError("boom")
    assert not any(th.is_alive() for th in reader._threads)
    with pytest.raises(FileNotFoundError):
        tvideo.ChunkReader(str(tmp_path / "missing.avi"), 4, "cpu")
    with pytest.raises(ValueError):
        tvideo.ChunkReader(path, 0, "cpu")


# -- I420: reconstruction and plane-domain means ----------------------------

def _bgr_to_i420(frames):
    return np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420) for f in frames])


@pytest.mark.parametrize("shape,w_out", [((5, 48, 70), None),
                                         ((5, 48, 70), 128),
                                         ((3, 30, 64), 256)])
def test_i420_to_bgr_flat_matches_jax_and_cv2(shape, w_out):
    """Random BGR frames through cv2's I420 forward conversion: the port's
    reconstruction equals JAX's and cv2's inverse bit for bit, with zero
    columns up to ``w_out``, from planar or flat rows."""
    T, H, W = shape
    rng = np.random.default_rng(W + (w_out or 0))
    raw = _bgr_to_i420(rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8))
    got = color.i420_to_bgr_flat(torch.as_tensor(raw), H, W, w_out).numpy()
    flat = color.i420_to_bgr_flat(torch.as_tensor(raw.reshape(T, -1)), H, W,
                                  w_out).numpy()
    want = np.asarray(jcolor.i420_to_bgr_flat(
        jnp.asarray(raw.reshape(T, -1)), H, W, w_out))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(flat, want)
    wo = w_out or W
    got = got.reshape(T, H, wo, 3)
    assert not got[:, :, W:].any()
    for i in range(T):
        np.testing.assert_array_equal(
            got[i, :, :W], cv2.cvtColor(raw[i], cv2.COLOR_YUV2BGR_I420))


_I420_ROIS = {"even": [8, 12, 72, 48], "odd": [9, 13, 71, 47],
              "empty": [0, 0, 0, 0], "above": [3, -5, 30, 36],
              "past the edge": [60, 40, 101, 70]}


@pytest.mark.parametrize("kind", list(_I420_ROIS))
def test_i420_roi_means_matches_jax(kind):
    """The plane-domain means on even, odd, empty, ``y1 < 0`` and
    past-the-edge boxes (and a random box per frame): counts equal, means
    within 1e-4 of JAX's."""
    T, H, W = 6, 64, 96
    rng = np.random.default_rng(len(kind))
    raw = _bgr_to_i420(rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8))
    rois = np.tile(np.int32(_I420_ROIS[kind]), (T, 1))
    rois[-1] = _random_rois(rng, 8, H, W)[-1]
    got, cnt = color.i420_roi_means(torch.as_tensor(raw),
                                    torch.as_tensor(rois), H, W)
    want, wcnt = jcolor.i420_roi_means(jnp.asarray(raw.reshape(T, -1)),
                                       jnp.asarray(rois), H, W)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    if kind == "empty":
        assert not got[:-1].any() and not cnt[:-1].any()


def test_i420_roi_means_within_reconstruction_bounds():
    """Against reconstruct-then-reduce on smooth, in-gamut frames: within
    0.51 u8 for even-aligned boxes and 1.5 u8 for odd edges (the JAX
    package's bounds), counts equal."""
    rng = np.random.default_rng(7)
    T, H, W = 6, 64, 96
    bgr = rng.integers(10, 246, (T, H, W, 3), np.uint8)
    bgr = np.stack([cv2.GaussianBlur(f, (9, 9), 3) for f in bgr])
    raw = torch.as_tensor(_bgr_to_i420(bgr))
    frames = color.i420_to_bgr_flat(raw, H, W).reshape(T, H, W, 3)
    for box, bound in (([8, 12, 72, 48], 0.51), ([9, 13, 71, 47], 1.5)):
        rois = torch.tensor([box] * T, dtype=torch.int32)
        ref, cnt_ref = roi_channel_means(frames, rois)
        got, cnt = color.i420_roi_means(raw, rois, H, W)
        np.testing.assert_array_equal(cnt.numpy(), cnt_ref.numpy())
        assert float((got - ref).abs().max()) < bound


# -- the reader: decoders and I420 staging ----------------------------------

def _read_all(path, chunk, **kw):
    with tvideo.ChunkReader(path, chunk, "cpu", **kw) as reader:
        got = [(c.numpy().copy(), s) for c, s in reader]
        return got, reader.n_workers


@pytest.mark.parametrize("codec", ["MJPG", "mp4v"])
@pytest.mark.parametrize("chunk", [7, 32])
@pytest.mark.parametrize("n_decoders", [2, 3, 4])
def test_chunk_reader_decoders_equal_one(i420_clips, codec, chunk,
                                         n_decoders):
    """``n_decoders`` workers over seeked segments of a 180-frame clip give
    one decoder's bytes and start indices, on an intra-frame (MJPG) and an
    inter-frame (``mp4v``) codec."""
    path = i420_clips[codec]
    ref, _ = _read_all(path, chunk)
    got, n_workers = _read_all(path, chunk, n_decoders=n_decoders)
    assert n_workers == n_decoders
    assert [s for _, s in got] == [s for _, s in ref]
    assert sum(len(c) for c, _ in got) == 180
    for (g, _), (r, _) in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("n_decoders", [1, 3])
def test_chunk_reader_i420_equals_cvtcolor(i420_clips, n_decoders):
    """``fmt="i420"`` chunks are cv2's ``COLOR_BGR2YUV_I420`` of the BGR
    chunks, ``(n, H*3//2, W)``."""
    path = i420_clips["MJPG"]
    ref, _ = _read_all(path, 32)
    got, _ = _read_all(path, 32, n_decoders=n_decoders, fmt="i420")
    assert [s for _, s in got] == [s for _, s in ref]
    for (g, _), (r, _) in zip(got, ref):
        assert g.shape == (len(r), 72, 64)
        np.testing.assert_array_equal(g, _bgr_to_i420(r))


def _write_y4m(path, frames):
    """An uncompressed 4:4:4 YUV4MPEG2 clip, which keeps odd frame sides
    (cv2's writers crop them to even)."""
    T, H, W, _ = frames.shape
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F30:1 Ip A1:1 C444\n".encode())
        for fr in frames:
            yuv = cv2.cvtColor(fr, cv2.COLOR_BGR2YUV)
            f.write(b"FRAME\n" + np.ascontiguousarray(
                yuv.transpose(2, 0, 1)).tobytes())
    return str(path)


def test_odd_clip_refuses_i420_and_streams_bgr(tmp_path):
    """An odd-sized clip: the I420 reader raises ``IOError``, and the I420
    stream stages BGR instead, equal to the BGR stream."""
    clip = synthesize(SynthSpec(duration_s=1.0, height=47, width=65,
                                bpm=75.0))
    path = _write_y4m(tmp_path / "odd.y4m", clip.frames)
    assert tvideo.video_metadata(path)[:2] == (65, 47)
    with pytest.raises(IOError, match="even"):
        tvideo.ChunkReader(path, 8, "cpu", fmt="i420")
    with pytest.raises(ValueError, match="fmt"):
        tvideo.ChunkReader(path, 8, "cpu", fmt="yuv")
    a = toffline.extract_signals_streaming(path, CFG, chunk_frames=8,
                                           transfer="i420", n_decoders=2,
                                           device="cpu")
    b = toffline.extract_signals_streaming(path, CFG, chunk_frames=8,
                                           device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# -- the I420 streams -------------------------------------------------------

_I420_STREAMS = [(form, de, w) for form in ("detect", "fused")
                 for de in (1, 4) for w in (128, 160)]


@pytest.mark.parametrize("form,detect_every,width", _I420_STREAMS)
def test_streaming_i420_matches_jax(i420_clips, form, detect_every, width):
    """``transfer="i420"`` in both forms against ``vhr_tpu``'s I420 stream
    (its native reader stages the planes): ``valid`` equal, means within
    1e-4 (detect: plane means) or ``rtol=1e-6`` (fused: K1 on the rebuilt
    chunk).  Skipped where the native reader does not build."""
    if not vhr_tpu.io.native.is_available():
        pytest.skip("vhr_tpu's native framestore is unavailable: the JAX "
                    "stream stages BGR without it")
    path = i420_clips[width]
    kw = dict(chunk_frames=32, detect_every=detect_every, transfer="i420",
              use_fused=form == "fused")
    jb, jv, jfps = joffline.extract_signals_streaming(path, JCFG, **kw)
    b, v, fps = toffline.extract_signals_streaming(path, CFG, n_decoders=2,
                                                   device="cpu", **kw)
    assert fps == jfps and v.mean() > 0.9
    np.testing.assert_array_equal(v, jv)
    tol = dict(rtol=0, atol=1e-4) if form == "detect" else MEANS_TOL
    np.testing.assert_allclose(b, jb, **tol)


@pytest.mark.parametrize("form,detect_every,width", _I420_STREAMS)
def test_streaming_i420_matches_whole_clip(i420_clips, form, detect_every,
                                           width):
    """The I420 stream against the port's whole-clip pass on the cv2-rebuilt
    frames at the 128-column padded width (what the stream's detector and
    K1 see): fused equal; detect ``valid`` equal and means within 1.5 u8
    (plane means against reconstruct-then-reduce), with no K3."""
    path = i420_clips[width]
    frames, _ = tvideo.read_video(path)
    rebuilt = np.stack([cv2.cvtColor(f, cv2.COLOR_YUV2BGR_I420)
                        for f in _bgr_to_i420(frames)])
    padded = np.zeros(rebuilt.shape[:2] + (256 if width == 160 else 128, 3),
                      np.uint8)
    padded[:, :, :width] = rebuilt
    b, v, _ = toffline.extract_signals_streaming(
        path, CFG, chunk_frames=32, detect_every=detect_every,
        transfer="i420", use_fused=form == "fused", device="cpu")
    if form == "fused":
        tr = toffline.extract_signals_fused(torch.as_tensor(padded), CFG,
                                            detect_every=detect_every)
        np.testing.assert_array_equal(b, tr.bgr.numpy())
    else:
        tr = toffline.extract_signals(torch.as_tensor(padded), CFG,
                                      detect_every=detect_every)
        assert float(np.abs(b - tr.bgr.numpy()).max()) < 1.5
        assert int(tr.rois[:, 2].max()) <= width
    np.testing.assert_array_equal(v, tr.valid.numpy())
    assert v.mean() > 0.9


# -- the streams ------------------------------------------------------------

@pytest.mark.parametrize("chunk,detect_every", [(8, 1), (8, 4), (64, 1)])
def test_streaming_detect_matches_jax(clips, chunk, detect_every):
    """The detect-then-reduce stream (K3's plain version on the CPU)
    against JAX's stream and against the port's whole-clip pass."""
    path = clips["small"]
    jbgr, jvalid, jfps = joffline.extract_signals_streaming(
        path, JCFG, chunk_frames=chunk, prefer_native=False,
        detect_every=detect_every)
    before = counter("k2.batched")
    bgr, valid, fps = toffline.extract_signals_streaming(
        path, CFG, chunk_frames=chunk, detect_every=detect_every,
        device="cpu")
    assert counter("k2.batched") == before
    assert fps == jfps == FPS and bgr.dtype == np.float32
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(bgr, jbgr, **MEANS_TOL)
    frames, _ = tvideo.read_video(path)
    whole = toffline.extract_signals(torch.as_tensor(frames), CFG,
                                     detect_every=detect_every)
    np.testing.assert_array_equal(valid, whole.valid.numpy())
    np.testing.assert_array_equal(bgr, whole.bgr.numpy())


@pytest.mark.parametrize("detect_every,gate_margin", [(1, None), (4, 0.5)])
def test_streaming_fused_matches_jax(clips, detect_every, gate_margin):
    """The fused stream (K1's plain version, carry and phase chained over
    chunks of 40) against JAX's fused stream and the port's whole-clip
    ``extract_signals_fused``."""
    path = clips["wide"]
    kw = dict(chunk_frames=40, use_fused=True, detect_row_pool=8,
              detect_every=detect_every, gate_margin=gate_margin)
    jbgr, jvalid, _ = joffline.extract_signals_streaming(
        path, JCFG, prefer_native=False, **kw)
    before = counter("k1.launches")
    rs = {}
    bgr, valid, _ = toffline.extract_signals_streaming(
        path, CFG, ring_stats=rs, device="cpu", **kw)
    assert counter("k1.launches") == before
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(bgr, jbgr, **MEANS_TOL)
    frames, _ = tvideo.read_video(path)
    whole = toffline.extract_signals_fused(
        torch.as_tensor(frames), CFG, detect_every=detect_every,
        gate_margin=gate_margin, detect_row_pool=8)
    np.testing.assert_array_equal(valid, whole.valid.numpy())
    np.testing.assert_array_equal(bgr, whole.bgr.numpy())
    assert set(rs) == RING_KEYS
    assert rs["verdict"] in ("decode-bound", "device-bound")
    assert 0.0 <= rs["decode_wait_fraction"] <= 1.0


def _assert_bpm_close(port, ref, valid, bin_bpm):
    """Equal on >= 99% of valid frames, within one bin on the rest."""
    same = port[valid] == ref[valid]
    assert same.mean() >= 0.99, same.mean()
    assert np.all(np.abs(port - ref)[valid] <= bin_bpm[valid] + 1e-4)


@pytest.mark.parametrize("use_fused", [False, True])
def test_measure_green_avg_file_matches_jax(clips, monkeypatch, use_fused):
    """The file measure against JAX's (native framestore off) and against
    the port's in-memory measure of the same decoded frames."""
    monkeypatch.setattr(vhr_tpu.io.native, "is_available", lambda: False)
    path = clips["wide"]
    kw = dict(chunk_frames=32, use_fused=use_fused, detect_row_pool=8)
    jts, jbpm, jvalid = joffline.measure_green_avg_file(path, JCFG, **kw)
    ts, bpm, valid = toffline.measure_green_avg_file(path, CFG, device="cpu",
                                                     **kw)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.mean() > 0.5
    win = CFG.window_len(FPS)
    bins = 60.0 * FPS / np.minimum(np.arange(len(bpm)) + 1, win)
    _assert_bpm_close(bpm, np.asarray(jbpm), valid, bins)

    frames, fps = tvideo.read_video(path)
    if use_fused:
        trace = toffline.extract_signals_fused(torch.as_tensor(frames), CFG,
                                               detect_row_pool=8)
        green = toffline._fill_invalid(trace.bgr[:, 1], trace.valid)
        rolling = twin.rolling_bpm_fft(green, fps, CFG.band, win,
                                       CFG.acquisition_len(fps))
        mem = (np.arange(len(frames)) / fps, rolling.bpm.numpy(),
               (rolling.valid & trace.valid).numpy())
    else:
        mem = toffline.measure_green_avg(torch.as_tensor(frames), fps, CFG)
    for g, w in zip((ts, bpm, valid), mem):
        np.testing.assert_array_equal(g, w)


def test_streaming_errors_and_empty(clips):
    path = clips["small"]
    with pytest.raises(ValueError, match="divide"):
        toffline.extract_signals_streaming(path, CFG, chunk_frames=10,
                                           detect_every=4, device="cpu")
    with pytest.raises(ValueError, match="detector"):
        toffline.extract_signals_streaming(
            path, CFG, use_fused=True, detector=lambda f: None, device="cpu")
    with pytest.raises(ValueError, match="transfer"):
        toffline.extract_signals_streaming(path, CFG, transfer="yuv",
                                           device="cpu")
    with pytest.raises(ValueError, match="divide"):
        toffline.measure_green_avg_file(path, CFG, chunk_frames=10,
                                        detect_every=4, device="cpu")
    # transfer="i420" takes the plane path: the planes' means each chunk,
    # no K3, the BGR stream's validity and means within 1.5 u8.
    calls = {"planes": 0, "k3": 0}

    def counted(fn, key):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    mp = pytest.MonkeyPatch()
    mp.setattr(toffline.color, "i420_roi_means",
               counted(color.i420_roi_means, "planes"))
    mp.setattr(toffline, "roi_channel_means_batched_cuda",
               counted(roi_means_cuda.roi_channel_means_batched_cuda, "k3"))
    try:
        a = toffline.extract_signals_streaming(path, CFG, chunk_frames=32,
                                               transfer="i420", device="cpu")
        assert calls == {"planes": 3, "k3": 0}
        b = toffline.extract_signals_streaming(path, CFG, chunk_frames=32,
                                               prefer_native=False,
                                               device="cpu")
        assert calls == {"planes": 3, "k3": 3}
    finally:
        mp.undo()
    np.testing.assert_array_equal(a[1], b[1])
    assert float(np.abs(a[0] - b[0]).max()) < 1.5 and a[2] == b[2]
    # A pluggable detector, as JAX's stream takes one.
    box = torch.tensor([4, 4, 60, 40], dtype=torch.int32)

    def det(fr):
        n = fr.shape[0]
        return box.expand(n, 4), torch.ones(n, dtype=torch.bool)

    bgr, valid, _ = toffline.extract_signals_streaming(
        path, CFG, detector=det, chunk_frames=16, device="cpu")
    frames, _ = tvideo.read_video(path)
    rois = troi.cheek_roi(box[None], CFG.roi, 64, 48)
    want, _ = roi_channel_means(torch.as_tensor(frames),
                                rois.expand(len(frames), 4))
    assert valid.all()
    np.testing.assert_allclose(bgr, want.numpy(), **MEANS_TOL)
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
