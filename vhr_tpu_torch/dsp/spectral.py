"""Spectral BPM estimation: FFT peak picking in a heart-rate band.

Port of ``vhr_tpu/dsp/spectral.py``: the FFT peak (``estimate_bpm``,
``estimate_bpm_multichannel``, ``estimate_bpm_multichannel_exact``), the
in-band SNR (``band_snr``) and the Welch PSD (``welch_psd``,
``estimate_bpm_welch``).  Frequency grids, masks, windows and scales are
worked out on the host, as in the JAX package.  The reference's ``None``
returns stay a ``valid`` mask so the functions work on whole batches.

``nanmedian`` takes the mean of the two middle values of an even count, as
``jnp.nanmedian`` and ``jnp.median`` do (``torch.median`` returns the lower
one).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import HRBand

__all__ = ["BPMEstimate", "bpm_peak_from_spectrum", "estimate_bpm",
           "estimate_bpm_multichannel", "estimate_bpm_multichannel_exact",
           "band_snr", "welch_psd", "estimate_bpm_welch", "nanmedian"]


class BPMEstimate(NamedTuple):
    """Batched BPM result; ``valid`` is False where the reference returns None."""

    bpm: torch.Tensor
    valid: torch.Tensor
    peak_power: torch.Tensor


def _band_freqs(n: int, fs: float, band: HRBand) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side positive FFT frequencies and in-band mask.

    ``np.fft.fftfreq`` stores the Nyquist bin of an even-length FFT as
    ``-fs/2``, so the reference's positive band mask never selects it;
    ``rfftfreq`` returns ``+fs/2``, hence the last bin is dropped for even
    ``n``.
    """
    freqs = np.fft.rfftfreq(n, d=1.0 / fs)
    mask = (freqs >= band.low_hz) & (freqs <= band.high_hz)
    mask &= np.arange(freqs.shape[0]) <= (n - 1) // 2
    return freqs, mask


def bpm_peak_from_spectrum(power: torch.Tensor, freqs: np.ndarray,
                           mask: np.ndarray) -> BPMEstimate:
    """Pick the dominant in-band frequency from a ``(..., F)`` power tensor."""
    freqs_t = torch.as_tensor(freqs, dtype=power.dtype, device=power.device)
    mask_t = torch.as_tensor(mask, device=power.device)
    banded = torch.where(mask_t, power,
                         torch.full_like(power, float("-inf")))
    idx = torch.argmax(banded, dim=-1)
    peak = torch.gather(banded, -1, idx[..., None])[..., 0]
    bpm = freqs_t[idx] * 60.0
    valid = torch.full(bpm.shape, bool(mask.any()), device=power.device)
    return BPMEstimate(bpm=bpm, valid=valid, peak_power=peak)


def estimate_bpm(signal: torch.Tensor, fs: float, band: HRBand) -> BPMEstimate:
    """Single-channel FFT peak pick over the last axis of ``(..., T)``."""
    n = signal.shape[-1]
    freqs, mask = _band_freqs(n, fs, band)
    spectrum = torch.abs(torch.fft.rfft(signal, dim=-1))
    est = bpm_peak_from_spectrum(spectrum, freqs, mask)
    if n < 8:  # the reference returns None below 8 samples
        est = est._replace(valid=torch.zeros_like(est.valid))
    return est


def estimate_bpm_multichannel(signal: torch.Tensor, fs: float,
                              band: HRBand) -> BPMEstimate:
    """Multichannel FFT peak over ``(..., T, C)``: per-channel in-band peak,
    the channel with the largest peak decides the BPM."""
    T = signal.shape[-2]
    freqs, mask = _band_freqs(T, fs, band)
    mags = torch.abs(torch.fft.rfft(signal, dim=-2))             # (..., F, C)
    per_chan = bpm_peak_from_spectrum(mags.transpose(-2, -1), freqs, mask)
    best = torch.argmax(per_chan.peak_power, dim=-1, keepdim=True)
    bpm = torch.gather(per_chan.bpm, -1, best)[..., 0]
    peak = torch.gather(per_chan.peak_power, -1, best)[..., 0]
    valid = torch.full(bpm.shape, bool(mask.any()) and T >= 8,
                       device=signal.device)
    return BPMEstimate(bpm=bpm, valid=valid, peak_power=peak)


def estimate_bpm_multichannel_exact(signal: torch.Tensor, n_valid,
                                    fs: float, band: HRBand) -> BPMEstimate:
    """Multichannel FFT peak on zero-padded ``(..., T_pad, C)`` signals whose
    true lengths are ``n_valid`` (a number, or a tensor of the leading
    shape).

    Evaluates the DFT on each true length-N frequency grid ``k*fs/N``
    explicitly -- the acquisition-ramp companion of
    :func:`estimate_bpm_multichannel`.  Padded rows must be zero.  The
    float32 expressions keep the JAX order of operations.
    """
    T = signal.shape[-2]
    dt, dev = signal.dtype, signal.device
    N = torch.as_tensor(n_valid, dtype=dt, device=dev)
    n = torch.arange(T, dtype=dt, device=dev)
    k_max = int(np.floor(band.high_hz * T / fs))
    k = torch.arange(k_max + 1, dtype=dt, device=dev)

    # scalar / tensor in PyTorch is a multiplication by the reciprocal; a
    # true division rounds like the JAX expression.
    step = torch.full_like(N, -2.0 * math.pi) / N
    ang = step[..., None, None] * k[:, None] * n[None, :]        # (..., K, T)
    re = torch.cos(ang) @ signal                                 # (..., K, C)
    im = torch.sin(ang) @ signal
    mags = torch.sqrt(re * re + im * im)

    freq = k * (torch.full_like(N, fs) / N)[..., None]          # (..., K)
    half = torch.floor((N - 1.0) / 2.0)[..., None]
    mask = ((freq >= band.low_hz) & (freq <= band.high_hz)
            & (k >= 1.0) & (k <= half))
    banded = torch.where(mask[..., None], mags,
                         torch.full_like(mags, float("-inf")))   # (..., K, C)
    peak_idx = torch.argmax(banded, dim=-2, keepdim=True)        # (..., 1, C)
    peak_mag = torch.gather(banded, -2, peak_idx)[..., 0, :]     # (..., C)
    best = torch.argmax(peak_mag, dim=-1, keepdim=True)          # (..., 1)
    bpm = torch.gather(freq, -1, torch.gather(peak_idx[..., 0, :], -1,
                                              best))[..., 0] * 60.0
    valid = mask.any(-1) & (N >= 8)
    return BPMEstimate(bpm=bpm, valid=valid,
                       peak_power=torch.gather(peak_mag, -1, best)[..., 0])


def nanmedian(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Median over ``dim`` of the values that are not NaN (NaN where all
    are): the two middle values of an even count averaged, as
    ``jnp.nanmedian`` computes it (``(low + high) * 0.5``)."""
    v = torch.sort(x, dim=dim).values        # NaN sorts last
    count = (~torch.isnan(x)).sum(dim, keepdim=True)
    low = ((count - 1).clamp(min=0)) // 2
    high = (count // 2).clamp(max=x.shape[dim] - 1)
    out = (torch.gather(v, dim, low) + torch.gather(v, dim, high)) * 0.5
    out = torch.where(count > 0, out, torch.full_like(out, float("nan")))
    return out.squeeze(dim)


def band_snr(signal: torch.Tensor, fs: float, band: HRBand,
             guard_bins: int = 1,
             target_bpm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-band spectral SNR of ``(..., T)`` windows (a power ratio).

    Power within ``guard_bins`` bins of a peak over the remaining in-band
    power.  The peak is the window's own dominant in-band bin, or with
    ``target_bpm`` (broadcastable to the leading shape) the rfft bin
    nearest that frequency: how much of the window's band energy backs a
    given hypothesis (the adaptive selector's score).
    """
    n = signal.shape[-1]
    freqs, mask = _band_freqs(n, fs, band)
    mask_t = torch.as_tensor(mask, device=signal.device)
    x = signal - signal.mean(-1, keepdim=True)
    power = torch.abs(torch.fft.rfft(x, dim=-1)) ** 2
    banded = torch.where(mask_t, power, torch.zeros_like(power))
    if target_bpm is None:
        idx = torch.argmax(torch.where(mask_t, power,
                                       torch.full_like(power, -math.inf)),
                           dim=-1)
    else:
        # Nearest rfft bin to the hypothesis frequency: k = f * n / fs.
        idx = torch.clamp(torch.round(target_bpm / 60.0 * n / fs), 0,
                          power.shape[-1] - 1).to(torch.int64)
        idx = idx.expand(power.shape[:-1])
    bins = torch.arange(power.shape[-1], device=signal.device)
    near = (bins - idx[..., None]).abs() <= guard_bins
    peak = torch.where(near, banded, torch.zeros_like(banded)).sum(-1)
    rest = banded.sum(-1) - peak
    return peak / torch.clamp(rest, min=1e-12)


def _hann(n: int) -> np.ndarray:
    """Periodic Hann window of ``n`` samples (scipy's ``welch`` window)."""
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)


def welch_psd(x: torch.Tensor, fs: float, nperseg: int,
              noverlap: Optional[int] = None,
              average: str = "mean") -> Tuple[np.ndarray, torch.Tensor]:
    """Welch power spectral density over the last axis of ``(..., T)``.

    ``scipy.signal.welch(x, fs, window='hann', nperseg, noverlap,
    detrend='constant', scaling='density', average=...)``: segments
    gathered at once, demeaned, windowed, one batched rfft; ``"median"``
    with scipy's bias correction.  Returns ``(freqs (host), psd)``.
    """
    T = x.shape[-1]
    nperseg = int(min(nperseg, T))
    if noverlap is None:
        noverlap = nperseg // 2
    step = nperseg - noverlap
    n_segments = (T - noverlap) // step
    win = _hann(nperseg)
    dt, dev = x.dtype, x.device
    idx = (np.arange(n_segments) * step)[:, None] + np.arange(nperseg)
    segs = x[..., torch.as_tensor(idx, device=dev)]
    segs = segs - segs.mean(-1, keepdim=True)             # detrend
    segs = segs * torch.as_tensor(win, dtype=dt, device=dev)
    spec = torch.fft.rfft(segs, dim=-1)
    psd = spec.real ** 2 + spec.imag ** 2
    scale = 1.0 / (fs * float(np.sum(win * win)))
    psd = psd * torch.as_tensor(scale, dtype=dt, device=dev)
    # One-sided doubling: every bin but DC, and the Nyquist bin only for an
    # odd segment.
    doubling = np.ones(psd.shape[-1])
    if nperseg % 2 == 0:
        doubling[1:-1] = 2.0
    else:
        doubling[1:] = 2.0
    psd = psd * torch.as_tensor(doubling, dtype=dt, device=dev)
    if average == "median":
        ii = np.arange(1, (psd.shape[-2] - 1) // 2 + 1)
        bias = 1.0 + np.sum(1.0 / (2 * ii + 1) - 1.0 / (2 * ii))
        psd = nanmedian(psd, -2) / bias      # jnp.median: psd has no NaN
    else:
        psd = psd.mean(-2)
    return np.fft.rfftfreq(nperseg, d=1.0 / fs), psd


def estimate_bpm_welch(signal: torch.Tensor, fs: float, band: HRBand,
                       segment_seconds: float = 9.0) -> BPMEstimate:
    """Welch-PSD BPM over the last axis of ``(..., T)``: demean,
    ``segment_seconds`` Hann segments with 50% overlap, in-band peak."""
    T = signal.shape[-1]
    x = signal - signal.mean(-1, keepdim=True)
    freqs, psd = welch_psd(x, fs, int(min(T, fs * segment_seconds)))
    mask = (freqs >= band.low_hz) & (freqs <= band.high_hz)
    return bpm_peak_from_spectrum(psd, freqs, mask)
