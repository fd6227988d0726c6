"""Spectral BPM estimation: FFT peak picking in a heart-rate band.

Port of ``vhr_tpu/dsp/spectral.py`` (``BPMEstimate``, ``_band_freqs``,
``bpm_peak_from_spectrum``, ``estimate_bpm``,
``estimate_bpm_multichannel`` and ``estimate_bpm_multichannel_exact``).
The reference's ``None`` returns stay a ``valid`` mask so the functions
work on whole batches.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import HRBand

__all__ = ["BPMEstimate", "bpm_peak_from_spectrum", "estimate_bpm",
           "estimate_bpm_multichannel", "estimate_bpm_multichannel_exact"]


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
