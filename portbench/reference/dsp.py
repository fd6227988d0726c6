"""The estimate's reference: forward fill over dropouts and the per-frame
FFT-peak BPM over the reference's growing, then sliding, window.

Written from the semantics the port documents
(``vhr_tpu_torch/ops/windows.py::rolling_bpm_fft``,
``dsp/spectral.py::_band_freqs``, ``pipeline/offline.py::_fill_invalid``
at commit 523c5c8), in float64 NumPy, one window at a time: frame ``i``
sees ``signal[max(0, i - W + 1) : i + 1]`` demeaned once at least ``A``
samples exist; the peak is taken over the bins ``k`` with ``1 <= k <=
(N - 1) // 2`` whose frequency ``k * fps / N`` lies in the band; fewer than
8 samples, or no bin in the band, is no estimate.
"""

from __future__ import annotations

import numpy as np


def round_to(x: np.ndarray, precision: str) -> np.ndarray:
    """``x`` rounded to ``precision`` and back to float64 (the control's
    arithmetic); float32 and float64 leave it as it is."""
    if precision in ("float32", "float64"):
        return x
    import torch

    dtype = {"bfloat16": torch.bfloat16,
             "float8": torch.float8_e4m3fn}[precision]
    t = torch.from_numpy(np.ascontiguousarray(x, np.float64))
    if precision == "float8":
        t = t.clamp(-448.0, 448.0)
    return t.to(dtype).to(torch.float64).numpy()


def fill_invalid(x: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Carry the last valid sample forward along the last axis; samples
    before the first valid one are 0."""
    out = np.zeros_like(x, dtype=np.float64)
    for idx in np.ndindex(x.shape[:-1]):
        last = 0.0
        for t in range(x.shape[-1]):
            if valid[idx + (t,)]:
                last = float(x[idx + (t,)])
            out[idx + (t,)] = last
    return out


def rolling_bpm(signal: np.ndarray, fps: float, band, window: int,
                acquisition: int, precision: str = "float64"):
    """``(S, T)`` signals -> ``(bpm (S, T), valid (S, T))``; ``band`` is
    ``(low_hz, high_hz)``.  ``precision`` rounds each demeaned window and
    its magnitudes (the control)."""
    x = np.asarray(signal, np.float64)
    S, T = x.shape
    bpm = np.zeros((S, T))
    valid = np.zeros((S, T), bool)
    lo, hi = band
    for i in range(acquisition - 1, T):
        N = min(i + 1, window)
        w = x[:, i - N + 1:i + 1]
        w = round_to(w - w.mean(-1, keepdims=True), precision)
        mag = round_to(np.abs(np.fft.rfft(w, axis=-1)), precision)
        k = np.arange(mag.shape[-1])
        freq = k * fps / N
        mask = (freq >= lo) & (freq <= hi) & (k >= 1) & (k <= (N - 1) // 2)
        if not mask.any() or N < 8:
            continue
        banded = np.where(mask, mag, -np.inf)
        bpm[:, i] = freq[np.argmax(banded, -1)] * 60.0
        valid[:, i] = True
    return bpm, valid
