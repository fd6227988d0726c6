"""Port parity for the offline measures beyond the green mean: the
chrominance projections, the adaptive selector, FastICA, the interactive
app's filtered Welch loop and the Welch estimator, in the plain and
``"roi"`` forms, and the fidelity validation, against ``vhr_tpu``.

The clip is small (8 s of 64 x 80 at 30 fps, with a detection dropout) and
the windows shortened through ``PipelineConfig`` (4 s / 2 s; 5 s for the
app loop, whose 41-tap FIR pads by 123 samples).  Each JAX measure runs
once, in its XLA form (its ``"roi"`` form runs the Pallas ROI kernel
compiled for the TPU; ``tests/test_roi_ops.py`` pins it equal to the plain
form).  Tolerances:

* valid masks and the adaptive ``choice``: equal;
* BPM: equal on at least 99% of valid frames, within one DFT bin on the
  rest (float32 rounding can flip an argmax between near-equal bins);
* the adaptive SNR: ``rtol=5e-3`` (a ratio of float32 band powers, whose
  denominator can be small);
* the validation rows: ``frames_compared`` equal, MAEs within ``1e-4``.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhr_tpu import config as jconfig
from vhr_tpu import validation as jvalidation
from vhr_tpu.pipeline import offline as joffline
from vhr_tpu.utils.synth import SynthSpec, synthesize

from vhr_tpu_torch import config, validation
from vhr_tpu_torch.pipeline import offline
from vhr_tpu_torch.utils import synth as tsynth
from vhr_tpu_torch.utils.profiling import counter

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)

FPS = 30.0
_ARGS = dict(window_seconds=4.0, acquisition_seconds=2.0)
_APP_ARGS = dict(window_seconds=5.0, acquisition_seconds=2.0)
_FORMS = [False, "roi"]


@functools.cache
def _clip():
    return synthesize(SynthSpec(duration_s=8.0, height=64, width=80,
                                bpm=75.0, noise_std=1.0,
                                dropout_frames=(50, 51, 52))).frames


def _cfgs(args=_ARGS, **kw):
    """The same configuration built in each package."""
    jkw = {k: (jconfig.FilterConfig(**v) if k == "filter" else v)
           for k, v in kw.items()}
    tkw = {k: (config.FilterConfig(**v) if k == "filter" else v)
           for k, v in kw.items()}
    return (jconfig.PipelineConfig(**args, **jkw),
            config.PipelineConfig(**args, **tkw))


def _bin_bpm(n):
    return 60.0 * FPS / n


def _assert_bpm_close(port, ref, valid, bin_bpm):
    """Equal on >= 99% of valid frames, within one bin on the rest."""
    port, ref, valid = np.asarray(port), np.asarray(ref), np.asarray(valid)
    same = port[valid] == ref[valid]
    assert same.mean() >= 0.99, same.mean()
    assert np.all(np.abs(port - ref)[valid] <= bin_bpm + 1e-4)


@functools.cache
def _jax(name, *key):
    frames = jnp.asarray(_clip())
    if name == "projection":
        method, = key
        return joffline.measure_projection(frames, FPS, method, _cfgs()[0])
    if name == "adaptive":
        return joffline.measure_adaptive(frames, FPS, _cfgs()[0])
    if name == "ica":
        return joffline.measure_ica(frames, FPS, _cfgs()[0],
                                    jconfig.ICAConfig(**_ARGS))
    if name == "app":
        kind, = key
        return joffline.measure_app_welch(
            frames, FPS, _cfgs(_APP_ARGS, filter=dict(kind=kind))[0])
    return joffline.measure_green_avg(frames, FPS,
                                      _cfgs(estimator="welch")[0])


def _run(fn, *args, **kw):
    """Run a port measure on the clip; the CPU launches no kernel."""
    counts = (counter("k2.launches"), counter("k1.launches"))
    out = fn(torch.as_tensor(_clip()), FPS, *args, **kw)
    assert (counter("k2.launches"), counter("k1.launches")) == counts
    return out


def _check(got, ref, window_len):
    ts, bpm, valid = got[:3]
    np.testing.assert_array_equal(ts, ref[0])
    np.testing.assert_array_equal(valid, np.asarray(ref[2]))
    assert valid.sum() > 0.5 * (len(valid) - window_len)
    _assert_bpm_close(bpm, ref[1], valid, _bin_bpm(window_len))


@pytest.mark.parametrize("use_pallas", _FORMS)
@pytest.mark.parametrize("method", ["chrom", "pos", "omit"])
def test_measure_projection_matches_jax(method, use_pallas):
    got = _run(offline.measure_projection, method, _cfgs()[1],
               use_pallas=use_pallas)
    _check(got, _jax("projection", method), _cfgs()[1].window_len(FPS))


@pytest.mark.parametrize("use_pallas", _FORMS)
def test_measure_adaptive_matches_jax(use_pallas):
    ref = _jax("adaptive")
    got = _run(offline.measure_adaptive, _cfgs()[1], use_pallas=use_pallas)
    _check(got, ref, _cfgs()[1].window_len(FPS))
    np.testing.assert_array_equal(got.choice, ref.choice)
    assert len(set(got.choice[got.valid].tolist())) > 1
    np.testing.assert_array_equal(np.isneginf(got.snr), np.isneginf(ref.snr))
    fin = np.isfinite(ref.snr)
    np.testing.assert_allclose(got.snr[fin], ref.snr[fin], rtol=5e-3)


@pytest.mark.parametrize("use_pallas", _FORMS)
def test_measure_ica_matches_jax(use_pallas):
    got = _run(offline.measure_ica, _cfgs()[1], config.ICAConfig(**_ARGS),
               use_pallas=use_pallas)
    # The ramp's windows grow from the acquisition length: bins of 2 s.
    _check(got, _jax("ica"), 2 * FPS)


@pytest.mark.parametrize("use_pallas", _FORMS)
@pytest.mark.parametrize("kind", ["butterworth", "cheby2", "fir"])
def test_measure_app_welch_matches_jax(kind, use_pallas):
    cfg = _cfgs(_APP_ARGS, filter=dict(kind=kind))[1]
    got = _run(offline.measure_app_welch, cfg, use_pallas=use_pallas)
    _check(got, _jax("app", kind), cfg.window_len(FPS))
    assert not got[2][:cfg.window_len(FPS)].any()


@pytest.mark.parametrize("use_pallas", _FORMS)
def test_measure_green_avg_welch_matches_jax(use_pallas):
    """``estimator="welch"`` through the green measure: the rolling Welch
    estimate, valid once a full window exists."""
    cfg = _cfgs(estimator="welch")[1]
    got = _run(offline.measure_green_avg, cfg, use_pallas=use_pallas)
    _check(got, _jax("welch"), cfg.window_len(FPS))
    assert not got[2][:cfg.window_len(FPS) - 1].any()


def test_validate_green_avg_matches_jax():
    spec = dict(duration_s=8.0, bpm=72.0, height=64, width=80,
                noise_std=1.0, motion_amplitude=2.0)
    ref = jvalidation.validate_green_avg([SynthSpec(**spec)],
                                         _cfgs()[0])
    got = validation.validate_green_avg([tsynth.SynthSpec(**spec)],
                                        _cfgs()[1], device="cpu")
    assert len(got) == len(ref) == 1
    assert got[0]["spec"] == ref[0]["spec"]
    assert got[0]["frames_compared"] == ref[0]["frames_compared"] > 0
    for k, v in ref[0].items():
        if k.startswith("mae_"):
            assert abs(got[0][k] - v) <= 1e-4, k
    assert got[0]["mae_tpu_vs_cpu_reference"] <= 0.5


def test_measures_reject_unknown_forms():
    with pytest.raises(KeyError):
        _run(offline.measure_projection, "ica", _cfgs()[1])
    with pytest.raises(ValueError, match="use_pallas"):
        _run(offline.measure_app_welch, _cfgs()[1], use_pallas="grid")
    cfg = dataclasses.replace(_cfgs()[1], roi_site="forehead")
    with pytest.raises(ValueError, match="cheek"):
        _run(offline.measure_ica, cfg, use_pallas=True)
