"""Spectral BPM estimation: FFT peak picking in a heart-rate band.

Port of ``vhr_tpu/dsp/spectral.py`` (``BPMEstimate``, ``_band_freqs``,
``bpm_peak_from_spectrum``, ``estimate_bpm``).  The reference's ``None``
returns stay a ``valid`` mask so the functions work on whole batches.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from vhr_tpu.config import HRBand

__all__ = ["BPMEstimate", "bpm_peak_from_spectrum", "estimate_bpm"]


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
