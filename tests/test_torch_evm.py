"""The port's EVM path against vhr_tpu's on the CPU: the same seeded numpy
inputs through both packages (the JAX Pallas kernels K6/K7 in interpret
mode, the port's kernels through their plain versions).

Tolerances: YIQ floats within 1e-6 and u8 equal (same op order); pyramid
and temporal band-pass ``atol=1e-5`` (float32 order of the shifted adds and
the FFT); K6 ``rtol=1e-4, atol=5e-7`` (the Pallas blur is two matrix
products); K7 at most 1 u8 on at most 0.5% of values (the bilinear sum is a
dot product on one side); ``magnify`` at most 1 u8 on at most 1% of values
(XLA fuses the jitted expression); ``magnified_pulse`` ``rtol=1e-3,
atol=1e-6`` (``tests/test_evm.py``'s bound); BPM to the bin.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vhr_tpu.io.video
from vhr_tpu import config as jconfig
from vhr_tpu.analysis.measurement import evm as jax_measure
from vhr_tpu.dsp import spectral as jspectral
from vhr_tpu.ops import color as jcolor
from vhr_tpu.ops import pallas_evm, pallas_evm_recon
from vhr_tpu.pipeline import evm as jevm
from vhr_tpu.utils.synth import SynthSpec, synthesize

import vhr_tpu_torch.io.video
from vhr_tpu_torch.analysis import context
from vhr_tpu_torch.analysis.measurement import evm as measure_evm
from vhr_tpu_torch.config import BAND_ANALYSIS, EVMConfig, HRBand
from vhr_tpu_torch.dsp import spectral
from vhr_tpu_torch.ops import color, evm_cuda, evm_recon_cuda
from vhr_tpu_torch.pipeline import evm

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _u8_close(got, want, max_frac):
    got, want = np.asarray(got).astype(int), np.asarray(want).astype(int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert (got != want).mean() <= max_frac


@pytest.mark.parametrize("fn", ["rgb_to_yiq", "yiq_to_rgb", "bgr_u8_to_yiq",
                                "yiq_to_bgr_u8"])
def test_color_matches_jax(fn):
    rng = np.random.default_rng(0)
    if fn == "bgr_u8_to_yiq":
        x = rng.integers(0, 256, (4, 8, 8, 3), np.uint8)
    elif fn == "yiq_to_bgr_u8":
        x = np.asarray(jcolor.bgr_u8_to_yiq(jnp.asarray(
            rng.integers(0, 256, (4, 8, 8, 3), np.uint8))))
        x = x + rng.normal(0, 0.01, x.shape).astype(np.float32)
    else:
        x = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    want = np.asarray(getattr(jcolor, fn)(jnp.asarray(x)))
    got = getattr(color, fn)(_t(x)).numpy()
    assert got.dtype == want.dtype
    if fn == "yiq_to_bgr_u8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["downsample", "pyramid_odd",
                                  "pyramid_sliced", "bandpass"])
def test_pyramid_and_bandpass_match_jax(case, monkeypatch):
    rng = np.random.default_rng(2)
    if case == "downsample":
        x = rng.normal(size=(2, 32, 48, 3)).astype(np.float32)
        want = jevm.gaussian_downsample(jnp.asarray(x))
        got = evm.gaussian_downsample(_t(x))
    elif case.startswith("pyramid"):
        x = rng.normal(size=(5, 37, 53, 3)).astype(np.float32)
        if case == "pyramid_sliced":     # two frames per slice
            monkeypatch.setattr(evm, "_SLICE_ELEMS", 2 * 37 * 53 * 3)
        want = jevm.gaussian_pyramid_level(jnp.asarray(x), 2)
        got = evm.gaussian_pyramid_level(_t(x), 2)
    else:
        t = np.arange(300) / 30.0
        x = (np.sin(2 * np.pi * 1.0 * t) + np.sin(2 * np.pi * 5.0 * t) + 3.0)
        x = (x[:, None, None, None]
             + rng.normal(size=(300, 4, 5, 3))).astype(np.float32)
        want = jevm.temporal_ideal_bandpass(jnp.asarray(x), 30.0,
                                            jconfig.HRBand(0.8, 1.2))
        got = evm.temporal_ideal_bandpass(_t(x), 30.0, HRBand(0.8, 1.2))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 64, 256), (1, 90, 384)])
def test_yiq_pyrdown_plain_matches_pallas(shape):
    T, H, W = shape
    frames = np.random.default_rng(9).integers(0, 256, (T, H, W, 3), np.uint8)
    want = np.asarray(pallas_evm.yiq_pyrdown_pallas(
        jnp.asarray(frames), rb_out=16, interpret=True))
    got = evm_cuda.yiq_pyrdown_plain(_t(frames))
    assert tuple(got.shape) == want.shape == (T, 3, H // 2, W // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=5e-7)
    # On a CPU tensor the wrapper is the plain version.
    torch.testing.assert_close(evm_cuda.yiq_pyrdown(_t(frames)), got,
                               rtol=0, atol=0)


def test_yiq_pyrdown_any_width_and_odd_height():
    """K6 takes widths the Pallas kernel refuses; with an odd height it
    keeps ``H//2`` rows, which equal the pyramid's first ``H//2``."""
    frames = np.random.default_rng(5).integers(0, 256, (2, 33, 100, 3),
                                               np.uint8)
    ref = jevm.gaussian_downsample(jcolor.bgr_u8_to_yiq(jnp.asarray(frames)))
    ref = np.moveaxis(np.asarray(ref), -1, 1)[:, :, :16, :50]
    got = evm_cuda.yiq_pyrdown(_t(frames))
    assert tuple(got.shape) == (2, 3, 16, 50)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=5e-7)
    np.testing.assert_array_equal(
        evm_cuda.to_planar(_t(frames)).numpy(),
        np.asarray(pallas_evm.to_planar(jnp.asarray(frames))))


# (T, H, W): strips, segments, steps a segment, blocks, copy bytes at an
# aligned base.  1080p and 720p are the EVM paths' frames.
_K6_GRIDS = {(64, 1080, 1920): (8, 34, 2, 17408, 16),
             (600, 1080, 1920): (8, 34, 2, 163200, 16),
             (64, 720, 1280): (5, 23, 2, 7360, 16),
             (64, 1080, 1000): (4, 34, 2, 8704, 4),
             (2, 35, 131): (1, 2, 2, 4, 1),
             (1, 2, 2): (1, 1, 1, 1, 1),
             (3, 91, 100): (1, 3, 2, 9, 4),
             (1, 2161, 3841): (15, 68, 2, 1020, 1)}


@pytest.mark.parametrize("shape", list(_K6_GRIDS))
def test_k6_geometry(shape):
    """K6's grid covers the output once: every strip and segment holds
    output pixels, and together they hold all ``H//2 x W//2`` of them."""
    T, H, W = shape
    geo = evm_cuda.k6_geometry(T, H, W, base_ptr=4096)
    assert (geo.strips, geo.segments, geo.seg_steps, geo.blocks,
            geo.copy_bytes) == _K6_GRIDS[shape]
    sh = evm_cuda.KERNEL_SHAPE
    h_out, w_out = H // 2, W // 2
    rows = geo.seg_steps * sh["warps"]
    assert geo.seg_steps <= sh["max_steps"]
    assert (geo.strips - 1) * sh["strip_cols"] < w_out \
        <= geo.strips * sh["strip_cols"]
    assert (geo.segments - 1) * rows < h_out <= geo.segments * rows


@pytest.mark.parametrize("base,W,want", [
    (0, 1920, 16), (4096, 1280, 16), (4096 + 8, 1920, 4), (4096 + 1, 1920, 1),
    (4096, 1000, 4), (4096, 131, 1), (4096, 100, 4), (4096, 2, 1),
    (13755, 131, 1),                  # frames[1:] of (2, 35, 131): 3HW in
    (4096 + 153600, 1280, 16)])       # frames[1:] of (T, 40, 1280)
def test_k6_copy_width(base, W, want):
    """16-byte copies need the base and the row pitch ``3W`` (and so the
    frame stride ``3HW``) 16-byte aligned; 4-byte copies 4-byte aligned;
    anything else is loaded a byte at a time."""
    assert evm_cuda.copy_width(base, W) == want
    if want > 1:
        assert base % want == 0 and (3 * W) % want == 0


def test_k6_ring_fits():
    """The ring holds every row a step reads plus the rows landing for the
    next ones, each ring row holds a strip's 16-byte chunks with the halo
    and each lane's 40-byte window, and four blocks fit on an SM within the
    48 KB a block may hold statically."""
    sh = evm_cuda.KERNEL_SHAPE
    geo = evm_cuda.k6_geometry(64, 1080, 1920)
    warps, depth = sh["warps"], sh["depth"]
    assert geo.ring_rows == 2 * warps * depth + 3
    assert sh["strip_cols"] == 4 * 32 and warps * 32 <= 1024
    win = 3 * (2 * sh["strip_cols"] + 4)          # needed bytes of a row
    assert sh["row_bytes"] % 16 == 0
    assert sh["row_bytes"] >= -(-(win + 16 - 6) // 16) * 16
    assert sh["row_bytes"] >= 24 * 31 + 8 + 40    # the last lane's window
    assert geo.smem_bytes == geo.ring_rows * sh["row_bytes"]
    assert geo.smem_bytes <= 48 * 1024            # static shared memory
    assert 4 * (geo.smem_bytes + 1024) <= 228 * 1024   # an H100 SM's


@pytest.mark.parametrize("H,W", [(35, 131), (36, 131), (35, 1920), (2, 3)])
def test_k6_odd_sizes_keep_floor_halves(H, W):
    frames = np.random.default_rng(H * W).integers(0, 256, (2, H, W, 3),
                                                   np.uint8)
    got = evm_cuda.yiq_pyrdown(_t(frames))
    assert tuple(got.shape) == (2, 3, H // 2, W // 2)
    geo = evm_cuda.k6_geometry(2, H, W)
    assert geo.strips * evm_cuda.KERNEL_SHAPE["strip_cols"] >= W // 2


@pytest.mark.parametrize("n_in,n_out", [(9, 72), (16, 128), (68, 1080),
                                        (5, 5), (7, 30)])
def test_resize_matrix_and_kernel_tables(n_in, n_out):
    """The port's resize_matrix is the JAX one, and the two-tap tables K7
    reads rebuild it exactly."""
    M = evm_recon_cuda.resize_matrix(n_in, n_out)
    np.testing.assert_array_equal(M, pallas_evm_recon.resize_matrix(n_in,
                                                                    n_out))
    lo, hi, w_lo, w_hi = (a.numpy() for a in evm_recon_cuda._tables(
        n_in, n_out, torch.device("cpu")))
    rebuilt = np.zeros_like(M)
    rows = np.arange(n_out)
    rebuilt[rows, lo] += w_lo
    rebuilt[rows, hi] += w_hi
    np.testing.assert_array_equal(rebuilt, M)
    assert (lo <= hi).all() and ((w_hi == 0) | (hi == lo + 1)).all()


@pytest.mark.parametrize("n_in,n_out", [(68, 1080), (120, 1920), (45, 720),
                                        (80, 1280), (63, 1000), (9, 130),
                                        (40, 16), (7, 7), (1, 5)])
def test_k7_tables_monotone(n_in, n_out):
    """The vectorised K7 stages, for a strip of columns, band columns
    ``lo[first]`` to ``min(lo[last] + 1, wb - 1)`` alone: that holds
    because ``lo`` never decreases and ``hi`` is ``lo`` or ``lo + 1``."""
    lo, hi, _, _ = evm_recon_cuda._tap_arrays(n_in, n_out)
    assert (np.diff(lo) >= 0).all()
    assert ((hi == lo) | (hi == lo + 1)).all()
    assert lo.min() >= 0 and hi.max() <= n_in - 1


_FRAME = 3 * 1080 * 1920


# (name, input base, input strides (t, c, h, w), output base, output
# strides, W, wb) -> the instance.  Output strides are empty_like's.
@pytest.mark.parametrize("case,want", [
    ((4096, (_FRAME, 1, 5760, 3), 8192, (_FRAME, 1, 5760, 3), 1920, 120),
     "vector"),                                        # 1080p interleaved
    ((4096, (3 * 720 * 1280, 1, 3840, 3), 8192, (3 * 720 * 1280, 1, 3840, 3),
      1280, 80), "vector"),                            # 720p
    ((4096, (_FRAME, 1, 5760, 3), 8192, (3 * 720 * 1280, 1, 3840, 3), 1280,
      80), "vector"),                        # a 720p slice of 1080p frames
    ((4096 + _FRAME, (_FRAME, 1, 5760, 3), 8192, (_FRAME, 1, 5760, 3), 1920,
      120), "vector"),                                 # frames[1:]
    ((4096, (3 * 1080 * 1000, 1, 3000, 3), 8192, (3 * 1080 * 1000, 1, 3000, 3),
      1000, 63), "generic"),                           # W = 1000
    ((4096, (3 * 75 * 130, 1, 390, 3), 8192, (3 * 75 * 130, 1, 390, 3), 130,
      9), "generic"),                                  # W = 130
    ((4096, (_FRAME, 1080 * 1920, 1920, 1), 8192,
      (_FRAME, 1080 * 1920, 1920, 1), 1920, 120), "generic"),     # planar
    ((4096 + 3, (_FRAME, 1, 5760, 3), 8192, (_FRAME, 1, 5760, 3), 1920, 120),
     "generic"),                                       # a misaligned base
    ((4096, (_FRAME, 1, 5760, 3), 8192 + 8, (_FRAME, 1, 5760, 3), 1920, 120),
     "generic"),                                       # a misaligned output
    ((4096, (3 * 1080 * 1928, 1, 5784, 3), 8192, (_FRAME, 1, 5760, 3), 1920,
      120), "generic"),                                # a 5784-byte pitch
    ((4096, (3 * 35 * 1008, 1, 3024, 3), 8192, (3 * 35 * 1008, 1, 3024, 3),
      1008, 63), "vector"),                            # a part strip
    ((4096, (3 * 33 * 16, 1, 48, 3), 8192, (3 * 33 * 16, 1, 48, 3), 16, 40),
     "vector"),                                        # a band wider than W
    ((4096, (3 * 33 * 16, 1, 48, 3), 8192, (3 * 33 * 16, 1, 48, 3), 16,
      20000), "generic"),                # its strip's band too wide to stage
])
def test_k7_instance(case, want):
    """The instance follows from the strides, the base pointers, W and the
    band's width alone."""
    assert evm_recon_cuda.k7_instance(*case) == want


def _band_width(n):
    for _ in range(4):
        n = -(-n // 2)
    return n


# (T, H, W, wb): strips, segments, segment rows, band columns, blocks.
_K7_GRIDS = {(64, 1080, 1920, 120): (15, 9, 128, 10, 8640),
             (600, 1080, 1920, 120): (15, 9, 128, 10, 81000),
             (64, 720, 1280, 80): (10, 6, 128, 10, 3840),
             (3, 35, 1008, 63): (8, 1, 128, 10, 24),
             (2, 33, 16, 40): (1, 1, 128, 40, 2),
             (1, 1, 16, 1): (1, 1, 128, 1, 1),
             (2, 129, 144, 9): (2, 2, 128, 9, 8),
             (1, 70, 16, 400): (1, 3, 32, 377, 3)}


@pytest.mark.parametrize("shape", list(_K7_GRIDS))
def test_k7_geometry(shape):
    """The vectorised K7's grid, walked block by block as the kernel walks
    it: every output pixel of every frame is written exactly once, tails
    included, and every column's two band columns lie among those its
    strip stages."""
    T, H, W, wb = shape
    geo = evm_recon_cuda.k7_geometry(T, H, W, wb)
    assert (geo.strips, geo.segments, geo.seg_rows, geo.band_cols,
            geo.blocks) == _K7_GRIDS[shape]
    sh = evm_recon_cuda.KERNEL_SHAPE
    seg, sc = geo.seg_rows, sh["strip_cols"]
    assert seg % sh["pass_rows"] == 0 and seg <= sh["seg_rows"]
    assert geo.smem_bytes == (sh["ring"] * sh["pass_rows"] * sh["pitch"]
                              + sc * sh["tap_bytes"]
                              + 12 * geo.band_cols * seg)
    assert geo.smem_bytes <= evm_recon_cuda.MAX_SMEM
    lo, hi, _, _ = evm_recon_cuda._tap_arrays(wb, W)
    walk_t = min(T, 2)
    written = np.zeros((walk_t, H, W), np.int32)
    for b in range(walk_t * geo.segments * geo.strips):
        strip, rest = b % geo.strips, b // geo.strips
        s, t = rest % geo.segments, rest // geo.segments
        x0, r0 = strip * sc, s * seg
        ncols, nr = min(sc, W - x0), min(seg, H - r0)
        assert ncols % 16 == 0 and nr >= 1
        passes = -(-nr // sh["pass_rows"])
        for p in range(passes):
            pr = min(sh["pass_rows"], nr - p * sh["pass_rows"])
            r = r0 + p * sh["pass_rows"]
            written[t, r:r + pr, x0:x0 + ncols] += 1
        cb0 = lo[x0]
        nb = min(lo[x0 + ncols - 1] + 1, wb - 1) - cb0 + 1
        assert 1 <= nb <= geo.band_cols
        cols = slice(x0, x0 + ncols)
        assert (lo[cols] >= cb0).all() and (hi[cols] - cb0 < nb).all()
    assert (written == 1).all()


@pytest.mark.parametrize("band_kind", ["small", "clamp"])
def test_evm_reconstruct_plain_matches_pallas(band_kind):
    rng = np.random.default_rng(3)
    T, H, W, hb, wb = 4, 72, 128, 9, 16
    frames = rng.integers(0, 255, (T, H, W, 3), np.uint8)
    if band_kind == "small":
        band = 0.04 * rng.standard_normal((T, 3, hb, wb))
    else:                                # drives many pixels past 0 and 255
        band = rng.uniform(-0.5, 0.5, (T, 3, hb, wb))
    band = band.astype(np.float32)
    planar = np.ascontiguousarray(np.transpose(frames, (0, 3, 1, 2)))
    want = np.asarray(pallas_evm_recon.evm_reconstruct_pallas(
        jnp.asarray(planar), jnp.asarray(band), rb=24, interpret=True))
    got = evm_recon_cuda.evm_reconstruct_plain(_t(planar), _t(band))
    _u8_close(got.numpy(), want, 0.005)
    # The wrapper on an interleaved view: the same values, laid out as the
    # frames are.
    view = evm_cuda.to_planar(_t(frames))
    out = evm_recon_cuda.evm_reconstruct(view, _t(band))
    assert out.stride() == view.stride()
    torch.testing.assert_close(out, got, rtol=0, atol=0)


def _pulse_frames(T, H, W, seed=4):
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 200, (1, H, W, 3), np.uint8).astype(np.float32)
    pulse = 1.5 * np.sin(2 * np.pi * 0.9 * np.arange(T) / 30.0)
    return np.clip(base + pulse[:, None, None, None], 0, 255).astype(np.uint8)


@pytest.mark.parametrize("route", ["plain", "kernel", "kernel_w100"])
def test_magnify_matches_jax(route):
    W = 100 if route == "kernel_w100" else 128   # W % 128 != 0: plain route
    frames = _pulse_frames(30, 50, W)
    cfg = EVMConfig(pyramid_levels=2, amplification=20.0)
    jcfg = jconfig.EVMConfig(pyramid_levels=2, amplification=20.0)
    kw = {} if route == "plain" else dict(use_pallas=True)
    jkw = {} if route == "plain" else dict(use_pallas=True, interpret=True)
    want = np.asarray(jevm.magnify(jnp.asarray(frames), 30.0, jcfg, **jkw))
    got = evm.magnify(_t(frames), 30.0, cfg, **kw)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    _u8_close(got.numpy(), want, 0.01)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_magnified_pulse_matches_jax(route):
    clip = synthesize(SynthSpec(duration_s=8.0, bpm=90.0, height=64,
                                width=128, pulse_amplitude=1.5))
    band, jband = HRBand(0.7, 3.0), jconfig.HRBand(0.7, 3.0)
    x = jnp.asarray(clip.frames)
    if route == "plain":
        want = jevm.magnified_pulse(x, clip.fps, jband, levels=2)
    else:   # JAX's kernel route, with the Pallas kernel in interpret mode
        low = jnp.moveaxis(pallas_evm.yiq_pyrdown_pallas(x, interpret=True),
                           1, -1)
        low = jevm.gaussian_pyramid_level(low, 1)
        want = jnp.mean(jevm.temporal_ideal_bandpass(low, clip.fps, jband),
                        axis=(1, 2))
    got = evm.magnified_pulse(_t(clip.frames), clip.fps, band, levels=2,
                              use_pallas=route == "kernel")
    assert tuple(got.shape) == (clip.frames.shape[0], 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-6)


def test_multichannel_estimators_match_jax():
    rng = np.random.default_rng(7)
    fs, T = 30.0, 300
    t = np.arange(T) / fs
    f = rng.uniform(0.8, 3.0, (6, 1, 3))
    sig = (np.sin(2 * np.pi * f * t[None, :, None])
           * rng.uniform(0.2, 2.0, (6, 1, 3))
           + 0.3 * rng.normal(size=(6, T, 3))).astype(np.float32)
    want = jspectral.estimate_bpm_multichannel(jnp.asarray(sig), fs,
                                               jconfig.BAND_ANALYSIS)
    got = spectral.estimate_bpm_multichannel(_t(sig), fs, BAND_ANALYSIS)
    np.testing.assert_array_equal(got.bpm.numpy(), np.asarray(want.bpm))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))

    # Exact ramp: zero-padded prefixes of one signal, some shorter than 8.
    prefix = sig[0]
    lengths = np.concatenate([[3, 7, 8], np.arange(100, T + 1, 7)])
    masked = np.where(np.arange(T)[None, :, None] < lengths[:, None, None],
                      prefix[None], 0.0).astype(np.float32)
    want = jax.vmap(lambda s, nv: jspectral.estimate_bpm_multichannel_exact(
        s, nv, fs, jconfig.BAND_ANALYSIS))(jnp.asarray(masked),
                                           jnp.asarray(lengths))
    got = spectral.estimate_bpm_multichannel_exact(_t(masked), _t(lengths),
                                                   fs, BAND_ANALYSIS)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.bpm.numpy(), np.asarray(want.bpm),
                               rtol=0, atol=1e-3)


def test_measure_matches_jax(monkeypatch):
    """Both packages' EVM measurement plugins on one synthetic clip, read
    through the same (patched) video reader: each package's own."""
    clip = synthesize(SynthSpec(height=32, width=64, fps=10.0,
                                duration_s=35.0, bpm=72.0, noise_std=1.0))
    for video in (vhr_tpu.io.video, vhr_tpu_torch.io.video):
        monkeypatch.setattr(video, "read_video",
                            lambda path: (clip.frames, clip.fps))
    want = jax_measure.measure("clip.mp4")
    context.set_device("cpu")
    try:
        got = measure_evm.measure("clip.mp4")
    finally:
        context.set_device(None)
    assert got.shape == want.shape and got.shape[0] > 200
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-3)
    assert abs(np.median(got[:, 1]) - 72.0) <= 4.0
