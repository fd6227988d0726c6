"""Port parity for the DSP: zero-phase and causal filters, the in-band SNR,
Welch, the rolling Welch and SNR, the chrominance projections and FastICA
(``vhr_tpu_torch.dsp``, ``ops.windows``), against ``vhr_tpu`` and scipy /
sklearn on the same seeded numpy inputs.

Tolerances and why:

* float32 causal filters (``sosfilt``, ``lfilter`` and the zero-phase
  filters on them): within ``1e-5`` of the input's scale (the states carry
  the input's level).  The port rounds each step as XLA:CPU rounds the JAX
  scan (the FIR path and most SOS designs come out equal bit for bit);
  XLA's vectorised loop rounds an occasional step of one batch lane
  otherwise, which the recurrence then carries at float32's scale;
* ``sosfilt_parallel``: within ``2e-5`` of the scale (another association
  order of the same float32 products than ``lax.associative_scan``);
* float64 against scipy: the JAX package's own golden bounds;
* Welch PSD and SNR: ``rtol=1e-4`` (float32 FFTs and sums in another
  order); the BPM peaks equal;
* projections: within ``1e-4`` of the pulse's scale (float32 means and
  cancellations of channel values near 100), the pulses' FFT peaks equal;
* FastICA in float64: ``n_iter`` and ``converged`` equal, sources within
  ``1e-9``; against sklearn within ``1e-5`` up to sign, as
  ``tests/test_ica.py``.
"""

import numpy as np
import pytest
import scipy.signal as sp
import torch

import jax.numpy as jnp

from vhr_tpu import config as jconfig
from vhr_tpu.dsp import design as jdesign
from vhr_tpu.dsp import filters as jfilters
from vhr_tpu.dsp import ica as jica
from vhr_tpu.dsp import projections as jproj
from vhr_tpu.dsp import spectral as jspectral
from vhr_tpu.ops import windows as jwin

from vhr_tpu_torch.config import BAND_ANALYSIS, BAND_LIVE, BAND_VIDEO
from vhr_tpu_torch.dsp import design, filters, ica, projections, spectral
from vhr_tpu_torch.ops import windows as twin

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)

FPS = 30.0
_DESIGNS = {"butterworth2": ("butterworth", 2), "cheby2": ("cheby2", 4),
            "butterworth4": ("butterworth", 4)}


def _sos(name):
    kind, order = _DESIGNS[name]
    sos = design.sos_design(kind, FPS, 0.7, 4.0, order, 40.0)
    np.testing.assert_array_equal(
        sos, jdesign.sos_design(kind, FPS, 0.7, 4.0, order, 40.0))
    return sos


def _trace(T, batch=(), dtype=np.float32, seed=0):
    """A pulse, a slow drift and noise around a skin-like level of 100."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / FPS
    base = 100 + 2 * np.sin(2 * np.pi * 1.2 * t) + 5 * np.sin(0.4 * t)
    x = base[(...,) + (None,) * len(batch)] \
        + rng.standard_normal((T,) + batch)
    return x.astype(dtype)


def _close(got, want, rel, scale=None):
    """Within ``rel`` of ``scale`` (default: the largest |want|)."""
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * scale)


# --- filters --------------------------------------------------------------

@pytest.mark.parametrize("with_zi", [False, True])
@pytest.mark.parametrize("name", list(_DESIGNS))
def test_sosfilt_matches_jax(name, with_zi):
    sos = _sos(name)
    x = _trace(240, (5,))
    zi = (np.random.default_rng(1).normal(size=(sos.shape[0], 2, 5))
          .astype(np.float32) if with_zi else None)
    y_ref, zf_ref = jfilters.sosfilt(sos, jnp.asarray(x),
                                     None if zi is None else jnp.asarray(zi))
    y, zf = filters.sosfilt(sos, torch.as_tensor(x),
                            None if zi is None else torch.as_tensor(zi))
    assert y.dtype == torch.float32 and zf.shape == zf_ref.shape
    _close(y, y_ref, 1e-5, np.abs(x).max())
    _close(zf, zf_ref, 1e-5, np.abs(x).max())
    # The parallel scan against both JAX forms.
    yp_ref, _ = jfilters.sosfilt_parallel(
        sos, jnp.asarray(x), None if zi is None else jnp.asarray(zi))
    yp, zp = filters.sosfilt_parallel(
        sos, torch.as_tensor(x), None if zi is None else torch.as_tensor(zi))
    assert zp is None
    _close(yp, yp_ref, 2e-5, np.abs(x).max())
    _close(yp, y_ref, 2e-5, np.abs(x).max())


def test_filters_float64_match_scipy():
    """float64 against scipy: sosfilt with and without zi, the parallel
    scan, an unbatched signal and the final state."""
    sos = _sos("butterworth2")
    x = _trace(300, (3,), np.float64)
    zi = sp.sosfilt_zi(sos)[:, :, None] * x[0]
    y_ref, zf_ref = sp.sosfilt(sos, x, axis=0, zi=zi)
    y, zf = filters.sosfilt(sos, torch.as_tensor(x), torch.as_tensor(zi))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(zf.numpy(), zf_ref, rtol=1e-9, atol=1e-9)
    y1, _ = filters.sosfilt(sos, torch.as_tensor(x[:, 0]))
    np.testing.assert_allclose(y1.numpy(), sp.sosfilt(sos, x[:, 0]),
                               rtol=1e-9, atol=1e-9)
    yp, _ = filters.sosfilt_parallel(sos, torch.as_tensor(x))
    np.testing.assert_allclose(yp.numpy(), sp.sosfilt(sos, x, axis=0),
                               rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("parallel", [False, True])
@pytest.mark.parametrize("name", ["butterworth2", "cheby2"])
def test_sosfiltfilt_matches_jax_and_scipy(name, parallel):
    sos = _sos(name)
    x = _trace(200, (4,))
    ref = jfilters.sosfiltfilt(sos, jnp.asarray(x), parallel=parallel)
    got = filters.sosfiltfilt(sos, torch.as_tensor(x), parallel=parallel)
    _close(got, ref, 2e-5 if parallel else 1e-5, np.abs(x).max())
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(
        filters.sosfiltfilt(sos, torch.as_tensor(x64),
                            parallel=parallel).numpy(),
        sp.sosfiltfilt(sos, x64, axis=0),
        rtol=1e-6 if parallel else 1e-8, atol=1e-6 if parallel else 1e-8)
    with pytest.raises(ValueError, match="padlen"):
        filters.sosfiltfilt(sos, torch.as_tensor(x[:5]))


def test_lfilter_and_filtfilt_fir_match_jax_and_scipy():
    b = design.firwin_bandpass(41, 0.7 / (0.5 * FPS), 4.0 / (0.5 * FPS))
    np.testing.assert_array_equal(
        b, jdesign.firwin_bandpass(41, 0.7 / (0.5 * FPS), 4.0 / (0.5 * FPS)))
    x = _trace(200, (3,))
    zi = np.random.default_rng(2).normal(size=40).astype(np.float32)
    for z in (None, zi):
        y_ref, zf_ref = jfilters.lfilter(b, [1.0], jnp.asarray(x),
                                         None if z is None else jnp.asarray(z))
        y, zf = filters.lfilter(b, [1.0], torch.as_tensor(x),
                                None if z is None else torch.as_tensor(z))
        _close(y, y_ref, 1e-5, np.abs(x).max())
        _close(zf, zf_ref, 1e-5, np.abs(x).max())
    _close(filters.filtfilt_fir(b, torch.as_tensor(x)),
           jfilters.filtfilt_fir(b, jnp.asarray(x)), 1e-5, np.abs(x).max())
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(
        filters.lfilter(b, [1.0], torch.as_tensor(x64))[0].numpy(),
        sp.lfilter(b, [1.0], x64, axis=0), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(
        filters.filtfilt_fir(b, torch.as_tensor(x64)).numpy(),
        sp.filtfilt(b, [1.0], x64, axis=0), rtol=1e-8, atol=1e-8)
    # An IIR transfer function through lfilter, a[0] != 1 normalised.
    bb, aa = sp.butter(2, [0.1, 0.3], btype="band")
    np.testing.assert_allclose(
        filters.lfilter(2 * bb, 2 * aa, torch.as_tensor(x64))[0].numpy(),
        sp.lfilter(bb, aa, x64, axis=0), rtol=1e-9, atol=1e-9)


def test_odd_ext_matches_jax():
    x = _trace(30, (2,))
    for n in (0, 1, 7):
        np.testing.assert_array_equal(
            filters.odd_ext(torch.as_tensor(x), n).numpy(),
            np.asarray(jfilters.odd_ext(jnp.asarray(x), n)))


# --- spectral -------------------------------------------------------------

@pytest.mark.parametrize("band", [BAND_VIDEO, BAND_LIVE, BAND_ANALYSIS],
                         ids=["video", "live", "analysis"])
@pytest.mark.parametrize("fps", [30.0, 29.97])
@pytest.mark.parametrize("n", [3, 8, 9, 255, 256, 900])
def test_band_grid_equals_the_hosts_bit_for_bit(n, fps, band):
    """The peak pick's grid built where the spectrum lies
    (``spectral._band_grid``) is ``_band_freqs``' numpy grid bit for bit:
    the frequencies in float64 and cast to float32, the mask (Welch's
    keeping the Nyquist bin), and whether any bin is in band."""
    host_f, host_m = spectral._band_freqs(n, fps, band)
    dev = torch.device("cpu")
    f64, mask, in_band = spectral._band_grid(n, fps, band, dev, torch.float64)
    assert torch.equal(f64.view(torch.int64),
                       torch.as_tensor(host_f).view(torch.int64))
    f32, mask32, _ = spectral._band_grid(n, fps, band, dev, torch.float32)
    want = torch.as_tensor(host_f.astype(np.float32))
    assert torch.equal(f32.view(torch.int32), want.view(torch.int32))
    assert torch.equal(mask, torch.as_tensor(host_m))
    assert torch.equal(mask32, mask)
    assert in_band == bool(host_m.any())
    welch_m = (host_f >= band.low_hz) & (host_f <= band.high_hz)
    _, mask_w, in_band_w = spectral._band_grid(n, fps, band, dev,
                                               torch.float32,
                                               keep_nyquist=True)
    assert torch.equal(mask_w, torch.as_tensor(welch_m))
    assert in_band_w == bool(welch_m.any())


@pytest.mark.parametrize("band", [BAND_VIDEO, BAND_LIVE, BAND_ANALYSIS],
                         ids=["video", "live", "analysis"])
def test_band_grid_in_band_at_every_length(band):
    """Whether any bin is in band, worked out from scalars in
    ``spectral._band_grid``, is the host mask's ``any()`` at every length
    up to 1,200 samples and at frame rates from 7.5 to 60 fps, for the FFT
    grid and for Welch's (which keeps the Nyquist bin)."""
    dev = torch.device("cpu")
    for fps in (7.5, 10.0, 29.97, 30.0, 60.0):
        for n in range(1, 1201):
            host_f, host_m = spectral._band_freqs(n, fps, band)
            welch_m = (host_f >= band.low_hz) & (host_f <= band.high_hz)
            for keep, want in ((False, host_m), (True, welch_m)):
                got = spectral._band_grid(n, fps, band, dev, torch.float32,
                                          keep_nyquist=keep)[2]
                assert got == bool(want.any()), (fps, n, keep)


@pytest.mark.parametrize("targeted", [False, True])
def test_band_snr_matches_jax(targeted):
    rng = np.random.default_rng(4)
    x = _trace(150, (), seed=4)[None] + rng.normal(size=(6, 150)).astype(
        np.float32)
    tgt = np.array([60, 72, 75, 90, 111, 150], np.float32) if targeted \
        else None
    ref = jspectral.band_snr(jnp.asarray(x), FPS, jconfig.BAND_ANALYSIS,
                             target_bpm=None if tgt is None
                             else jnp.asarray(tgt))
    got = spectral.band_snr(torch.as_tensor(x), FPS, BAND_ANALYSIS,
                            target_bpm=None if tgt is None
                            else torch.as_tensor(tgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4)


@pytest.mark.parametrize("average", ["mean", "median"])
def test_welch_psd_matches_jax_and_scipy(average):
    """Four segments: an even count, where the median averages the two
    middle values."""
    x = _trace(300, (), seed=5)[None].repeat(2, 0)
    x[1] += np.random.default_rng(5).normal(size=300).astype(np.float32)
    f_ref, ref = jspectral.welch_psd(jnp.asarray(x), FPS, 120,
                                     average=average)
    f, got = spectral.welch_psd(torch.as_tensor(x), FPS, 120,
                                average=average)
    np.testing.assert_array_equal(f, f_ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-6 * float(np.abs(ref).max()))
    x64 = x.astype(np.float64)
    _, want = sp.welch(x64, fs=FPS, window="hann", nperseg=120,
                       noverlap=60, detrend="constant", scaling="density",
                       average=average)
    _, got64 = spectral.welch_psd(torch.as_tensor(x64), FPS, 120,
                                  average=average)
    np.testing.assert_allclose(got64.numpy(), want, rtol=1e-9,
                               atol=1e-12 * want.max())
    # An odd segment length doubles the last bin too.
    _, want = sp.welch(x64[0], fs=FPS, nperseg=91, noverlap=45)
    np.testing.assert_allclose(
        spectral.welch_psd(torch.as_tensor(x64[0]), FPS, 91)[1].numpy(),
        want, rtol=1e-9, atol=1e-12 * want.max())


def test_estimate_bpm_welch_matches_jax():
    x = np.stack([_trace(330, (), seed=s) for s in range(4)])
    ref = jspectral.estimate_bpm_welch(jnp.asarray(x), FPS,
                                       jconfig.BAND_ANALYSIS)
    got = spectral.estimate_bpm_welch(torch.as_tensor(x), FPS, BAND_ANALYSIS)
    np.testing.assert_array_equal(got.bpm.numpy(), np.asarray(ref.bpm))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.peak_power.numpy(),
                               np.asarray(ref.peak_power), rtol=1e-4)


@pytest.mark.parametrize("targeted", [False, True])
def test_rolling_welch_and_band_snr_match_jax(targeted):
    sig = _trace(240, (), seed=6)
    W = 150
    ref = jwin.rolling_bpm_welch(jnp.asarray(sig), FPS,
                                 jconfig.BAND_ANALYSIS, W, 4.0)
    got = twin.rolling_bpm_welch(torch.as_tensor(sig), FPS, BAND_ANALYSIS, W,
                                 4.0)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.bpm.numpy(), np.asarray(ref.bpm))
    tgt = np.full(240, 75.0, np.float32) if targeted else None
    snr_ref = np.asarray(jwin.rolling_band_snr(
        jnp.asarray(sig), FPS, jconfig.BAND_ANALYSIS, W,
        None if tgt is None else jnp.asarray(tgt)))
    snr = twin.rolling_band_snr(torch.as_tensor(sig), FPS, BAND_ANALYSIS, W,
                                None if tgt is None
                                else torch.as_tensor(tgt)).numpy()
    assert np.isneginf(snr[:W - 1]).all()
    assert np.isneginf(snr_ref[:W - 1]).all()
    np.testing.assert_allclose(snr[W - 1:], snr_ref[W - 1:], rtol=1e-4)
    # Shorter than a window: nothing valid, every SNR -inf.
    short = torch.as_tensor(sig[:W - 1])
    assert not twin.rolling_bpm_welch(short, FPS, BAND_ANALYSIS, W).valid.any()
    assert torch.isneginf(twin.rolling_band_snr(short, FPS, BAND_ANALYSIS,
                                                W)).all()


def test_nanmedian_follows_jax_even_count_rule():
    """Even counts average the two middle values, NaNs are skipped, an
    all-NaN column gives NaN: equal to ``jnp.nanmedian`` / ``jnp.median``,
    where ``torch.nanmedian`` takes the lower middle value."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 200)).astype(np.float32)
    x[rng.random((4, 200)) < 0.3] = np.nan
    x[:, 0] = np.nan
    x[:, 1] = [60.0, 66.0, 72.0, 78.0]
    got = spectral.nanmedian(torch.as_tensor(x), 0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.nanmedian(
        jnp.asarray(x), axis=0)))
    assert np.isnan(got[0]) and got[1] == 69.0
    assert float(torch.nanmedian(torch.as_tensor(x[:, 1]))) == 66.0
    y = rng.normal(size=(6, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        spectral.nanmedian(torch.as_tensor(y), -2).numpy(),
        np.asarray(jnp.median(jnp.asarray(y), axis=-2)))


def test_even_median_consensus_picks_the_jax_bin():
    """The trap: four methods at 60, 66, 72 and 78 BPM.  The consensus is
    69 BPM, bin 11.5 of a 10 s window, which rounds to bin 12: its +-1-bin
    neighbourhood holds the window's 78 BPM pulse (bin 13), and the window
    scores high.  ``torch.nanmedian``'s 66 BPM centres the targeted SNR on
    bin 11 and misses the pulse."""
    t = np.arange(300) / FPS
    sig = (np.sin(2 * np.pi * 1.3 * t)
           + 0.1 * np.random.default_rng(8).normal(size=300))
    sig = sig.astype(np.float32)[None]
    bpms = np.array([[60.0], [66.0], [72.0], [78.0]], np.float32)
    consensus = spectral.nanmedian(torch.as_tensor(bpms), 0)
    ref = jspectral.band_snr(jnp.asarray(sig), FPS, jconfig.BAND_ANALYSIS,
                             target_bpm=jnp.nanmedian(jnp.asarray(bpms),
                                                      axis=0))
    got = spectral.band_snr(torch.as_tensor(sig), FPS, BAND_ANALYSIS,
                            target_bpm=consensus)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4)
    lower = spectral.band_snr(torch.as_tensor(sig), FPS, BAND_ANALYSIS,
                              target_bpm=torch.nanmedian(
                                  torch.as_tensor(bpms), 0).values)
    assert float(ref[0]) > 10.0 and float(lower[0]) < 0.1 * float(ref[0])


# --- projections ----------------------------------------------------------

def _bvp_traces(case, T=300, seed=0):
    """Skin-reflection BGR means (``tests/test_projections.py``): a 72 BPM
    pulse, with an in-band common-mode flicker or a detection dropout."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / FPS
    p = np.sin(2 * np.pi * 1.2 * t)
    i = np.ones(T)
    if case == "flicker":
        i = i + 0.2 * np.sin(2 * np.pi * 2.0 * t)
    bgr = np.stack([105 * i * (1 + 0.006 * p), 135 * i * (1 + 0.01 * p),
                    180 * i * (1 + 0.004 * p)], 1) + rng.normal(0, 0.05,
                                                                (T, 3))
    valid = np.ones(T, bool)
    if case == "dropout":
        valid[:4] = False
        valid[100:115] = False
    return bgr.astype(np.float32), valid


def _peak_bpm(x):
    x = np.asarray(x, np.float64) - np.mean(x)
    f = np.fft.rfftfreq(len(x), 1 / FPS) * 60
    band = (f >= 40) & (f <= 200)
    return f[band][np.argmax(np.abs(np.fft.rfft(x))[band])]


@pytest.mark.parametrize("case", ["clean", "flicker", "dropout"])
@pytest.mark.parametrize("method", ["chrom", "pos", "omit"])
def test_projection_matches_jax(method, case):
    bgr, valid = _bvp_traces(case)
    ref = np.asarray(getattr(jproj, f"{method}_pulse")(
        jnp.asarray(bgr), jnp.asarray(valid), FPS))
    fn = getattr(projections, f"{method}_pulse")
    got = fn(torch.as_tensor(bgr), torch.as_tensor(valid), FPS).numpy()
    _close(got, ref, 1e-4)
    assert _peak_bpm(got) == _peak_bpm(ref) and abs(_peak_bpm(got) - 72) <= 2
    # A leading batch axis (the pool's rings): each row is its own call.
    bgr2, valid2 = _bvp_traces(case, seed=1)
    batch = fn(torch.as_tensor(np.stack([bgr, bgr2])),
               torch.as_tensor(np.stack([valid, valid2[::-1].copy()])), FPS)
    np.testing.assert_array_equal(batch[0].numpy(), got)
    np.testing.assert_array_equal(
        batch[1].numpy(), fn(torch.as_tensor(bgr2),
                             torch.as_tensor(valid2[::-1].copy()),
                             FPS).numpy())


def test_projection_overlap_plan_covers_every_frame():
    """The gather table of the overlap-add lists every (window, offset)
    sample of each frame once, in increasing order, and the host-summed
    Hann weights equal the JAX scatter's."""
    for T, L, stride in [(300, 48, 24), (301, 48, 24), (40, 48, 24),
                         (100, 16, 1)]:
        idx, cover, win, norm = projections._overlap_plan(T, L, stride, True)
        np.testing.assert_array_equal(idx, jproj._windows(T, L, stride))
        pad = idx.size
        for t in range(T):
            row = cover[t][cover[t] < pad]
            np.testing.assert_array_equal(row, np.nonzero(idx.reshape(-1)
                                                          == t)[0])
        want = jnp.zeros((T,), jnp.float32).at[idx.reshape(-1)].add(
            jnp.broadcast_to(jnp.asarray(win), idx.shape).reshape(-1))
        np.testing.assert_array_equal(norm, np.asarray(want))


# --- FastICA --------------------------------------------------------------

def _mixed_window(T=300, bpm=72.0, seed=3):
    """Pulse, drift and noise mixed into three std-normalised channels
    (``tests/test_ica.py``)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / FPS
    S = np.stack([np.sin(2 * np.pi * bpm / 60 * t),
                  0.7 * np.sin(2 * np.pi * 0.15 * t),
                  rng.standard_normal(T)], axis=1)
    A = np.array([[0.6, 0.3, 0.05], [1.0, 0.2, 0.05], [0.4, 0.5, 0.05]])
    X = S @ A.T
    return X / np.std(X, axis=0, ddof=1)


def _same_up_to_sign(got, want, tol):
    err = np.minimum(np.abs(got - want).max(-2), np.abs(got + want).max(-2))
    assert err.max() < tol, err


def test_fastica_matches_jax_and_sklearn():
    from sklearn.decomposition import FastICA

    X = _mixed_window()
    w = ica.default_w_init(3, seed=0)
    np.testing.assert_array_equal(w, jica.default_w_init(3, seed=0))
    ref = jica.fastica(jnp.asarray(X), w)
    got = ica.fastica(torch.as_tensor(X), w)
    assert int(got.n_iter) == int(ref.n_iter)
    assert bool(got.converged) == bool(ref.converged)
    _same_up_to_sign(got.sources.numpy(), np.asarray(ref.sources), 1e-9)
    S = FastICA(n_components=3, algorithm="parallel", fun="logcosh",
                max_iter=300, tol=1e-6, whiten="unit-variance",
                random_state=0).fit_transform(X)
    _same_up_to_sign(got.sources.numpy(), S, 1e-5)
    # A budget too small to converge reports it.
    short = ica.fastica(torch.as_tensor(X), w, max_iter=2)
    assert int(short.n_iter) == 2 and not bool(short.converged)


@pytest.mark.parametrize("padded", [False, True])
def test_ica_sources_batched_matches_jax(padded):
    """Eight windows, each with its own iteration count; with ``n_valid``
    each also with its own length (padded rows zero)."""
    wins = np.stack([_mixed_window(bpm=60 + 6 * k, seed=k) for k in range(8)])
    w = ica.default_w_init(3)
    nv = np.array([300, 250, 200, 299, 150, 300, 220, 180])
    if padded:
        for k, n in enumerate(nv):
            wins[k, n:] = 0.0
        ref = jica.ica_sources(jnp.asarray(wins), w, n_valid=jnp.asarray(nv))
        got = ica.ica_sources(torch.as_tensor(wins), w,
                              n_valid=torch.as_tensor(nv))
    else:
        ref = jica.ica_sources(jnp.asarray(wins), w)
        got = ica.ica_sources(torch.as_tensor(wins), w)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(ref.n_iter))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    assert len(set(got.n_iter.tolist())) > 1
    _same_up_to_sign(got.sources.numpy(), np.asarray(ref.sources), 1e-9)
    if padded:
        for k, n in enumerate(nv):
            assert not got.sources[k, n:].any()
            one = ica.fastica(torch.as_tensor(wins[k, :n]), w)
            _same_up_to_sign(got.sources[k, :n].numpy()[None],
                             one.sources.numpy()[None], 1e-9)

