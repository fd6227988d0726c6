"""Sliding-window BPM estimation over a whole signal at once.

Port of ``vhr_tpu/ops/windows.py``.  Frame ``i`` sees the deque
``signal[max(0, i-W+1) : i+1]``: while the deque grows (lengths A..W-1)
an exact masked DFT evaluates every growing-length spectrum on its own
frequency grid (the ramp); once full, one batched rfft over all length-W
windows (the steady part).  The Welch estimate and the in-band SNR run on
full-length windows only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import HRBand
from ..dsp import spectral

__all__ = ["sliding_windows", "RollingBPM", "rolling_bpm_fft",
           "rolling_bpm_welch", "rolling_bpm", "rolling_band_snr"]


def sliding_windows(x: torch.Tensor, length: int) -> torch.Tensor:
    """All length-``length`` windows of ``(T, ...)`` -> ``(T-L+1, L, ...)``."""
    T = x.shape[0]
    idx = (torch.arange(T - length + 1, device=x.device)[:, None]
           + torch.arange(length, device=x.device)[None, :])
    return x[idx]


class RollingBPM(NamedTuple):
    bpm: torch.Tensor     # (T,) per-frame estimate (0 where invalid)
    valid: torch.Tensor   # (T,) bool — False during acquisition / empty band


def _ramp_bpm(x: torch.Tensor, fps: float, band: HRBand,
              lengths: np.ndarray, chunk: int = 64) -> tuple:
    """Exact DFT peak for growing windows ``x[:N]`` for each N in lengths.

    ``x`` is ``(T, *batch)``; returns ``(bpm (L, *batch), valid (L,
    *batch))``.  Evaluated ``chunk`` lengths at a time, so the ``(chunk, K,
    N)`` angle tensor stays small.  The float32 expressions keep the JAX
    order of operations.
    """
    w_max = int(lengths.max())
    xs = x[:w_max].movedim(0, -1)                                  # (*b, n)
    bdims = (1,) * (xs.dim() - 1)
    dt, dev = x.dtype, x.device
    n = torch.arange(w_max, dtype=dt, device=dev)
    k_max = int(np.floor(band.high_hz * w_max / fps))
    k = torch.arange(k_max + 1, dtype=dt, device=dev)
    bpms, valids = [], []
    for s in range(0, len(lengths), chunk):
        N = torch.as_tensor(lengths[s:s + chunk], dtype=dt,
                            device=dev)[:, None]                  # (B, 1)
        Nb = N.reshape((-1,) + bdims + (1,))                      # (B, 1*, 1)
        keep = n < Nb                                              # (B,1*,n)
        mean = torch.where(keep, xs, 0.0).sum(-1, keepdim=True) / Nb
        xm = torch.where(keep, xs - mean, 0.0)                     # (B,*b,n)
        # scalar / tensor in PyTorch is a multiplication by the reciprocal;
        # a true division rounds like the JAX expression.
        ang = (torch.full_like(N, -2.0 * math.pi) / N)[:, :, None] \
            * k[None, :, None] * n[None, None, :]                  # (B, K, n)
        cos_a = torch.cos(ang).reshape((-1,) + bdims + ang.shape[1:])
        sin_a = torch.sin(ang).reshape((-1,) + bdims + ang.shape[1:])
        re = (cos_a * xm[..., None, :]).sum(-1)                    # (B,*b,K)
        im = (sin_a * xm[..., None, :]).sum(-1)
        mag = torch.sqrt(re * re + im * im)
        freq = k[None, :] * (torch.full_like(N, fps) / N)          # (B, K)
        half = torch.floor((N - 1.0) / 2.0)
        mask = ((freq >= band.low_hz) & (freq <= band.high_hz)
                & (k[None, :] >= 1.0) & (k[None, :] <= half))
        mask_b = mask.reshape((-1,) + bdims + mask.shape[1:])
        banded = torch.where(mask_b, mag, torch.full_like(mag, float("-inf")))
        idx = torch.argmax(banded, dim=-1)                         # (B, *b)
        freq_b = freq.reshape((-1,) + bdims + freq.shape[1:])
        bpms.append(torch.gather(freq_b.expand(banded.shape), -1,
                                 idx[..., None])[..., 0] * 60.0)
        valids.append(mask_b.any(-1).expand(idx.shape))
    return torch.cat(bpms), torch.cat(valids)


def _windows_last(x: torch.Tensor, length: int) -> torch.Tensor:
    """All length-``length`` windows of ``(T, *batch)`` with the window
    axis last: ``(T-L+1, *batch, L)``."""
    wins = sliding_windows(x, length)
    return wins if x.dim() == 1 else wins.movedim(1, -1).contiguous()


def _as_float(signal: torch.Tensor) -> torch.Tensor:
    return signal if signal.is_floating_point() else signal.to(torch.float32)


def rolling_bpm_fft(signal: torch.Tensor, fps: float, band: HRBand,
                    window_len: int, acquisition_len: int) -> RollingBPM:
    """Per-frame FFT-peak BPM with the reference's deque semantics.

    Frame ``i`` sees ``signal[max(0, i-window_len+1) : i+1]`` demeaned and
    produces an estimate once at least ``acquisition_len`` samples exist.
    ``signal`` is ``(T,)``, or ``(T, *batch)`` for independent traces
    (the multi-face measure's K faces) estimated in one batch.
    """
    T = signal.shape[0]
    x = _as_float(signal)
    bpm = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    valid = torch.zeros(x.shape, dtype=torch.bool, device=x.device)

    first = acquisition_len - 1
    if first >= T:
        return RollingBPM(bpm, valid)

    ramp_end = min(window_len - 1, T - 1)
    if ramp_end >= first:
        lengths = np.arange(first + 1, ramp_end + 2)
        r_bpm, r_valid = _ramp_bpm(x, fps, band, lengths)
        # The reference's estimate_bpm returns None for N < 8.
        r_valid = r_valid & torch.as_tensor(
            lengths >= 8, device=x.device).reshape(
                (-1,) + (1,) * (x.dim() - 1))
        bpm[first:ramp_end + 1] = r_bpm
        valid[first:ramp_end + 1] = r_valid

    if T >= window_len:
        wins = _windows_last(x, window_len)                    # (T-W+1,*b,W)
        wins = wins - wins.mean(-1, keepdim=True)
        est = spectral.estimate_bpm(wins, fps, band)
        bpm[window_len - 1:] = est.bpm
        valid[window_len - 1:] = est.valid & (window_len >= 8)

    return RollingBPM(bpm=bpm, valid=valid)


def rolling_bpm_welch(signal: torch.Tensor, fps: float, band: HRBand,
                      window_len: int,
                      segment_seconds: float = 9.0) -> RollingBPM:
    """Per-frame Welch-PSD BPM over full-length sliding windows; frames
    before ``window_len - 1`` are invalid (Welch's segments need the whole
    window)."""
    T = signal.shape[0]
    x = _as_float(signal)
    bpm = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    valid = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if T >= window_len:
        est = spectral.estimate_bpm_welch(_windows_last(x, window_len),
                                          fps, band, segment_seconds)
        bpm[window_len - 1:] = est.bpm
        valid[window_len - 1:] = est.valid
    return RollingBPM(bpm=bpm, valid=valid)


def rolling_band_snr(signal: torch.Tensor, fps: float, band: HRBand,
                     window_len: int,
                     target_bpm=None) -> torch.Tensor:
    """Per-frame in-band SNR over full-length sliding windows -> ``(T,)``:
    frame ``i >= window_len - 1`` scores ``signal[i-W+1 : i+1]`` at its own
    dominant bin, or at ``target_bpm[i]``; earlier frames get ``-inf`` (no
    quality information yet)."""
    T = signal.shape[0]
    x = _as_float(signal)
    out = torch.full((T,), -math.inf, dtype=x.dtype, device=x.device)
    if T >= window_len:
        tgt = None if target_bpm is None else target_bpm[window_len - 1:]
        out[window_len - 1:] = spectral.band_snr(
            sliding_windows(x, window_len), fps, band, target_bpm=tgt)
    return out


def rolling_bpm(signal: torch.Tensor, fps: float, band: HRBand,
                window_len: int, acquisition_len: int,
                estimator: str = "fft",
                segment_seconds: float = 9.0) -> RollingBPM:
    """Dispatch on ``PipelineConfig.estimator``: ``"fft"`` | ``"welch"``."""
    if estimator == "fft":
        return rolling_bpm_fft(signal, fps, band, window_len, acquisition_len)
    if estimator == "welch":
        return rolling_bpm_welch(signal, fps, band, window_len,
                                 segment_seconds)
    raise ValueError(f"unknown estimator {estimator!r} (fft | welch)")
