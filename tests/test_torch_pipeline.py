"""Port parity for the offline green-channel measure: forward-fill, the
spectral estimators and the whole slice in both forms, against ``vhr_tpu``.

Tolerances and why:

* valid masks, ROIs and boxes are integers: equal;
* channel means: ``rtol=1e-6, atol=1e-5`` (exact sums on both sides at
  these sizes, one float32 division);
* BPM: equal on at least 99% of valid frames and within one DFT bin
  (``60 * fps / N``) on the rest — XLA:CPU and PyTorch round float32
  ``cos``/``sin``/FFT and their sums differently, which can flip an argmax
  between two near-equal bins.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhr_tpu import config as jconfig
from vhr_tpu.dsp import filters as jfilters
from vhr_tpu.dsp import spectral as jspectral
from vhr_tpu.ops import windows as jwin
from vhr_tpu.pipeline import offline as joffline
from vhr_tpu.utils.synth import SynthSpec, synthesize
from vhr_tpu.validation import cpu_reference_green_avg

from vhr_tpu_torch.config import BAND_ANALYSIS, PipelineConfig
from vhr_tpu_torch.dsp import filters as tfilters
from vhr_tpu_torch.dsp import spectral as tspectral
from vhr_tpu_torch.ops import windows as twin
from vhr_tpu_torch.pipeline import offline as toffline
from vhr_tpu_torch.utils.profiling import counter

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)

FPS = 30.0
# The same configuration built in each package from the same arguments.
_CFG_ARGS = dict(window_seconds=4.0, acquisition_seconds=2.0)
JCFG, CFG = jconfig.PipelineConfig(**_CFG_ARGS), PipelineConfig(**_CFG_ARGS)
MEANS_TOL = dict(rtol=1e-6, atol=1e-5)


def _assert_bpm_close(port, ref, valid, bin_bpm):
    """Equal on >= 99% of valid frames, within one bin on the rest."""
    port, ref, valid = np.asarray(port), np.asarray(ref), np.asarray(valid)
    bin_bpm = np.broadcast_to(bin_bpm, port.shape)
    same = port[valid] == ref[valid]
    assert same.mean() >= 0.99, same.mean()
    assert np.all(np.abs(port - ref)[valid] <= bin_bpm[valid] + 1e-4)


def _bins(T, window_len):
    return 60.0 * FPS / np.minimum(np.arange(T) + 1, window_len)


@pytest.mark.parametrize("init", ["zeros", "first_valid"])
@pytest.mark.parametrize("channels", [0, 3])
def test_forward_fill_matches_jax(init, channels):
    rng = np.random.default_rng(channels)
    shape = (50,) if channels == 0 else (50, channels)
    x = rng.normal(size=shape).astype(np.float32)
    valid = rng.random(50) < 0.4
    valid[:3] = False
    ref = jfilters.forward_fill(jnp.asarray(x), jnp.asarray(valid), init)
    got = tfilters.forward_fill(torch.as_tensor(x), torch.as_tensor(valid),
                                init)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [64, 75, 7])
def test_estimate_bpm_matches_jax(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(64, n)).astype(np.float32)
    ref = jspectral.estimate_bpm(jnp.asarray(x), FPS, jconfig.BAND_ANALYSIS)
    got = tspectral.estimate_bpm(torch.as_tensor(x), FPS, BAND_ANALYSIS)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    _assert_bpm_close(got.bpm.numpy(), ref.bpm, np.ones(64, bool),
                      60.0 * FPS / n)
    np.testing.assert_allclose(got.peak_power.numpy(),
                               np.asarray(ref.peak_power), rtol=1e-4)


def test_rolling_bpm_fft_matches_jax():
    """Ramp (growing deque, exact masked DFT) and steady windows."""
    v = synthesize(SynthSpec(duration_s=6.0, height=32, width=32, bpm=75.0))
    rng = np.random.default_rng(5)
    sig = (v.pulse + 0.5 * rng.normal(size=v.pulse.shape)).astype(np.float32)
    W, A = CFG.window_len(FPS), CFG.acquisition_len(FPS)
    ref = jwin.rolling_bpm_fft(jnp.asarray(sig), FPS, JCFG.band, W, A)
    got = twin.rolling_bpm_fft(torch.as_tensor(sig), FPS, CFG.band, W, A)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    _assert_bpm_close(got.bpm.numpy(), ref.bpm, np.asarray(ref.valid),
                      _bins(len(sig), W))
    # The N < 8 rule and an acquisition longer than the clip.
    short = twin.rolling_bpm_fft(torch.as_tensor(sig[:20]), FPS, CFG.band,
                                 10, 3)
    ref_s = jwin.rolling_bpm_fft(jnp.asarray(sig[:20]), FPS, JCFG.band, 10,
                                 3)
    np.testing.assert_array_equal(short.valid.numpy(),
                                  np.asarray(ref_s.valid))
    assert not twin.rolling_bpm_fft(torch.as_tensor(sig[:5]), FPS, CFG.band,
                                    W, A).valid.any()
    # estimator="welch" dispatches to the rolling Welch estimate.
    welch = twin.rolling_bpm(torch.as_tensor(sig), FPS, CFG.band, W, A,
                             estimator="welch", segment_seconds=2.0)
    ref_w = jwin.rolling_bpm(jnp.asarray(sig), FPS, JCFG.band, W, A,
                             estimator="welch", segment_seconds=2.0)
    np.testing.assert_array_equal(welch.valid.numpy(),
                                  np.asarray(ref_w.valid))
    np.testing.assert_array_equal(welch.bpm.numpy(), np.asarray(ref_w.bpm))
    with pytest.raises(ValueError):
        twin.rolling_bpm(torch.as_tensor(sig), FPS, CFG.band, W, A,
                         estimator="music")


@pytest.mark.parametrize("shape,n_first,n_last", [
    ((120,), 3, 60), ((120, 3), 1, 90), ((64, 2, 2), 30, 64)])
def test_ramp_entry_writes_the_plain_ramp(shape, n_first, n_last):
    """The ramp's entry on a CPU tensor takes the plain version: its rows,
    fresh or written into given outputs, one ``N`` each, equal the plain
    ``_ramp_bpm``'s and a single length's own call; nothing waits on a
    card and no kernel launches."""
    rng = np.random.default_rng(n_last)
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    want = twin._ramp_bpm(x, FPS, BAND_ANALYSIS, n_first, n_last)
    waits, launches = counter("waits"), counter("ramp.launches")
    got = twin.ramp_bpm(x, FPS, BAND_ANALYSIS, n_first, n_last)
    bpm = torch.full((n_last - n_first + 1,) + shape[1:], -1.0)
    valid = torch.ones(bpm.shape, dtype=torch.bool)
    twin.ramp_bpm(x, FPS, BAND_ANALYSIS, n_first, n_last, out=(bpm, valid))
    assert counter("waits") == waits
    assert counter("ramp.launches") == launches
    for b, v in (got, (bpm, valid)):
        assert torch.equal(b, want[0]) and torch.equal(v, want[1])
    assert not want[1][:max(0, 8 - n_first)].any()
    N = (n_first + n_last) // 2
    one = twin._ramp_bpm(x[:N], FPS, BAND_ANALYSIS, N, N)
    assert torch.equal(one[1][0], want[1][N - n_first])
    assert torch.equal(one[0][0], want[0][N - n_first])


@pytest.mark.parametrize("S,n_last,plan", [
    (1, 900, (1, 1, 1, 900)), (2, 299, (2, 2, 1, 300)),
    (8, 900, (8, 8, 1, 900)), (12, 900, (16, 12, 1, 900)),
    (40, 900, (16, 14, 3, 900)), (8, 3000, (4, 4, 2, 3000)),
    (3, 16384, (1, 1, 3, 16384))])
def test_ramp_plan_fits_shared_memory(S, n_last, plan):
    """The ramp kernel's launch from the stream count and the longest
    length alone: a power of two of shared rows that fits a block,
    balanced tiles of streams, a pitch of whole 16-byte vectors."""
    from vhr_tpu_torch.ops.ramp_cuda import SMEM_BYTES, ramp_plan

    got = ramp_plan(S, n_last)
    assert tuple(got) == plan
    assert got.tile * got.tiles >= S > got.tile * (got.tiles - 1)
    assert got.rows * got.pitch * 4 <= SMEM_BYTES


def test_ramp_kernel_refuses_what_it_cannot_take():
    """The ramp kernel takes CUDA tensors only (no fallback) and lengths
    that fit a block's shared memory."""
    from vhr_tpu_torch.ops.ramp_cuda import ramp_bpm_cuda, ramp_plan

    x = torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA"):
        ramp_bpm_cuda(x, FPS, BAND_ANALYSIS, 1, 16, torch.zeros(16),
                      torch.zeros(16, dtype=torch.bool))
    for n_last in (16385, 60000):
        with pytest.raises(ValueError, match="shared memory"):
            ramp_plan(1, n_last)


@pytest.mark.parametrize("case", ["one pulse", "two equal pulses", "zeros"])
def test_ramp_near_ties_marks_what_a_reordered_sum_may_swap(case):
    """``_ramp_near_ties`` (the ramp kernel's checks on the card) marks the
    lengths whose plain top two in-band magnitudes lie within the relative
    tolerance: none for one clean pulse, every one for all-zero traces
    (every magnitude 0), and where two pulses of one amplitude meet."""
    T, n_first, n_last = 300, 60, 300
    t = np.arange(T)[:, None] / FPS
    x = np.sin(2 * np.pi * 1.2 * t) + np.zeros((T, 2))
    if case == "two equal pulses":
        x = x + np.sin(2 * np.pi * 2.4 * t)
    if case == "zeros":
        x = np.zeros((T, 2))
    x = torch.as_tensor(x.astype(np.float32))
    ties = twin._ramp_near_ties(x, FPS, BAND_ANALYSIS, n_first, n_last, 1e-5)
    assert ties.shape == (n_last - n_first + 1, 2) and ties.dtype == torch.bool
    if case == "one pulse":
        assert not ties.any()
    elif case == "zeros":
        assert ties.all()
    else:
        # Lengths of whole periods of both pulses put their bins' energy
        # alike: N = 150, 175, 200, ... (multiples of 25 frames).
        assert ties[[150 - n_first, 250 - n_first]].all()
        assert not ties.all()


@pytest.fixture(scope="module")
def synth_clip():
    return synthesize(SynthSpec(duration_s=6.0, height=96, width=128,
                                bpm=75.0, noise_std=1.0,
                                dropout_frames=(50, 51, 52)))


@pytest.fixture(scope="module")
def jax_measures(synth_clip):
    frames = jnp.asarray(synth_clip.frames)
    out = {}
    for de in (1, 3):
        out[("xla", de)] = (
            joffline.extract_signals(frames, JCFG, detect_every=de),
            joffline.measure_green_avg(frames, FPS, JCFG, detect_every=de))
    out[("fused", 1)] = (
        joffline.extract_signals(frames, JCFG, use_pallas="fused"),
        joffline.measure_green_avg(frames, FPS, JCFG, use_pallas="fused"))
    return out


# The JAX "roi" form runs the Pallas ROI kernel compiled for the TPU; its
# equality with the plain form is pinned by tests/test_roi_ops.py, so the
# port's "roi" form is held against JAX's plain form.
@pytest.mark.parametrize("use_pallas,detect_every,ref_key", [
    (False, 1, ("xla", 1)), (False, 3, ("xla", 3)),
    ("roi", 1, ("xla", 1)), ("roi", 3, ("xla", 3)),
    ("fused", 1, ("fused", 1)),
])
def test_measure_green_avg_matches_jax(synth_clip, jax_measures, use_pallas,
                                       detect_every, ref_key):
    frames = torch.as_tensor(synth_clip.frames)
    jtrace, (jts, jbpm, jvalid) = jax_measures[ref_key]
    counts = (counter("k2.launches"), counter("k1.launches"))
    trace = toffline.extract_signals(frames, CFG, use_pallas=use_pallas,
                                     detect_every=detect_every)
    np.testing.assert_array_equal(trace.valid.numpy(),
                                  np.asarray(jtrace.valid))
    np.testing.assert_array_equal(trace.rois.numpy(), np.asarray(jtrace.rois))
    np.testing.assert_array_equal(trace.boxes.numpy(),
                                  np.asarray(jtrace.boxes))
    np.testing.assert_allclose(trace.bgr.numpy(), np.asarray(jtrace.bgr),
                               **MEANS_TOL)

    ts, bpm, valid = toffline.measure_green_avg(
        frames, FPS, CFG, use_pallas=use_pallas, detect_every=detect_every)
    assert (counter("k2.launches"), counter("k1.launches")) == counts
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.sum() > 0.5 * len(valid)
    _assert_bpm_close(bpm, jbpm, valid, _bins(len(bpm), CFG.window_len(FPS)))
    np.testing.assert_array_equal(
        toffline.to_measurement_array(ts, bpm, valid),
        joffline.to_measurement_array(ts, bpm, valid))


# Other ROI sites and frame rates than the flagship's 30 fps cheek: the
# forehead ROI, and 24 and 15 fps clips (the windows, the acquisition and
# the DFT bins scale with the rate).  Each JAX measure runs once per case.
_SITE_RATES = [("forehead", 30.0), ("cheek", 24.0), ("cheek", 15.0)]


@functools.cache
def _site_rate_case(site, fps):
    clip = synthesize(SynthSpec(duration_s=5.0, fps=fps, height=96,
                                width=128, bpm=75.0, noise_std=1.0,
                                dropout_frames=(30, 31)))
    jcfg = jconfig.PipelineConfig(roi_site=site, **_CFG_ARGS)
    frames = jnp.asarray(clip.frames)
    return (clip.frames, joffline.extract_signals(frames, jcfg),
            joffline.measure_green_avg(frames, fps, jcfg))


@pytest.mark.parametrize("site,fps", _SITE_RATES)
@pytest.mark.parametrize("use_pallas", [False, "roi"])
def test_measure_green_avg_sites_and_rates_match_jax(site, fps, use_pallas):
    """The plain and ``"roi"`` forms on the forehead site and at 24 and 15
    fps against ``vhr_tpu``'s XLA form, as the 30 fps cheek case above."""
    clip, jtrace, (jts, jbpm, jvalid) = _site_rate_case(site, fps)
    cfg = PipelineConfig(roi_site=site, **_CFG_ARGS)
    frames = torch.as_tensor(clip)
    trace = toffline.extract_signals(frames, cfg, use_pallas=use_pallas)
    np.testing.assert_array_equal(trace.valid.numpy(),
                                  np.asarray(jtrace.valid))
    np.testing.assert_array_equal(trace.rois.numpy(), np.asarray(jtrace.rois))
    np.testing.assert_allclose(trace.bgr.numpy(), np.asarray(jtrace.bgr),
                               **MEANS_TOL)
    ts, bpm, valid = toffline.measure_green_avg(frames, fps, cfg,
                                                use_pallas=use_pallas)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.sum() > 0.5 * len(valid)
    bins = 60.0 * fps / np.minimum(np.arange(len(bpm)) + 1,
                                   cfg.window_len(fps))
    _assert_bpm_close(bpm, jbpm, valid, bins)


@pytest.mark.parametrize("use_pallas", [False, "fused"])
def test_port_bpm_against_truth_and_cpu_reference(use_pallas):
    """The port's green trace through the frame-at-a-time numpy reference
    gives the port's BPM (MAE <= 0.5), and both recover the clip's 75 BPM
    (a DFT bin of the 4 s window).  No dropouts here: a held box over an
    empty frame puts a background spike into the trace."""
    clip = synthesize(SynthSpec(duration_s=6.0, height=96, width=128,
                                bpm=75.0, noise_std=1.0))
    frames = torch.as_tensor(clip.frames)
    trace = toffline.extract_signals(frames, CFG, use_pallas=use_pallas)
    green = toffline._fill_invalid(trace.bgr[:, CFG.channel], trace.valid)
    ts, bpm, valid = toffline.measure_green_avg(frames, FPS, CFG,
                                                use_pallas=use_pallas)
    ref = cpu_reference_green_avg(green.numpy(), FPS, CFG.window_seconds,
                                  CFG.acquisition_seconds, CFG.band)
    idx = [i for i in ref if valid[i]]
    assert len(idx) >= 0.9 * valid.sum()
    assert np.abs(bpm[idx] - np.array([ref[i] for i in idx])).mean() <= 0.5
    steady = valid & (np.arange(len(bpm)) >= CFG.window_len(FPS))
    assert np.abs(bpm[steady] - 75.0).mean() <= 1.0
