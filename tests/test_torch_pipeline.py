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
