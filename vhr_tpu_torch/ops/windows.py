"""Sliding-window BPM estimation over a whole signal at once.

Port of ``vhr_tpu/ops/windows.py``.  Frame ``i`` sees the deque
``signal[max(0, i-W+1) : i+1]``: while the deque grows (lengths A..W-1)
an exact masked DFT evaluates every growing-length spectrum on its own
frequency grid (the ramp, one CUDA launch on the card:
``ops/ramp_cuda.py``); once full, one batched rfft over all length-W
windows (the steady part).  The Welch estimate and the in-band SNR run on
full-length windows only.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import HRBand
from ..dsp import spectral
from ..utils.profiling import span
from .ramp_cuda import ramp_bpm_cuda

__all__ = ["sliding_windows", "RollingBPM", "ramp_bpm", "rolling_bpm_fft",
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


def _ramp_chunks(x: torch.Tensor, fps: float, band: HRBand, n_first: int,
                 n_last: int, chunk: int = 64):
    """The plain ramp's spectra, ``chunk`` lengths at a time, so that the
    ``(chunk, K, N)`` angle tensor stays small: yields the chunk's lengths
    ``N`` ``(B, 1)``, ``banded`` ``(B, *batch, K)`` (the in-band bins'
    magnitudes, ``-inf`` elsewhere), each bin's ``freq`` and whether it is
    in band (``mask``), both ``(B, K)``.  The float32 expressions keep the
    JAX order of operations."""
    xs = x[:n_last].movedim(0, -1)                                 # (*b, n)
    bdims = (1,) * (xs.dim() - 1)
    dt, dev = x.dtype, x.device
    n = torch.arange(n_last, dtype=dt, device=dev)
    k_max = int(np.floor(band.high_hz * n_last / fps))
    k = torch.arange(k_max + 1, dtype=dt, device=dev)
    for s in range(n_first, n_last + 1, chunk):
        N = torch.arange(s, min(s + chunk, n_last + 1), dtype=dt,
                         device=dev)[:, None]                      # (B, 1)
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
        yield N, banded, freq, mask


def _ramp_bpm(x: torch.Tensor, fps: float, band: HRBand, n_first: int,
              n_last: int) -> tuple:
    """Exact DFT peak for growing windows ``x[:N]``, ``N = n_first ..
    n_last``: the plain version of the ramp kernel
    (``ops/ramp_cuda.py``), on any device.

    ``x`` is ``(T, *batch)``; returns ``(bpm (L, *batch), valid (L,
    *batch))``, ``valid`` False below 8 samples (the reference's
    estimate_bpm returns None there).
    """
    bdims = (1,) * (x.dim() - 1)
    bpms, valids = [], []
    for N, banded, freq, mask in _ramp_chunks(x, fps, band, n_first, n_last):
        idx = torch.argmax(banded, dim=-1)                         # (B, *b)
        freq_b = freq.reshape((-1,) + bdims + freq.shape[1:])
        bpms.append(torch.gather(freq_b.expand(banded.shape), -1,
                                 idx[..., None])[..., 0] * 60.0)
        ok = mask.any(-1) & (N[:, 0] >= 8.0)
        valids.append(ok.reshape((-1,) + bdims).expand(idx.shape))
    return torch.cat(bpms), torch.cat(valids)


def _ramp_near_ties(x: torch.Tensor, fps: float, band: HRBand, n_first: int,
                    n_last: int, rtol: float) -> torch.Tensor:
    """``(L, *batch)``: where the plain ramp's top two in-band magnitudes
    lie within a relative ``rtol`` of each other (or it has fewer than two
    bins), the estimates that sums taken in another order, as the ramp
    kernel takes them, may pick otherwise."""
    out = []
    for _, banded, _, _ in _ramp_chunks(x, fps, band, n_first, n_last):
        if banded.shape[-1] < 2:
            out.append(torch.ones(banded.shape[:-1], dtype=torch.bool,
                                  device=x.device))
            continue
        top = torch.topk(banded, 2, dim=-1).values
        out.append(top[..., 0] - top[..., 1] <= rtol * top[..., 0].abs())
    return torch.cat(out)


def ramp_bpm(x: torch.Tensor, fps: float, band: HRBand, n_first: int,
             n_last: int, out: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None) -> tuple:
    """The growing windows' estimates ``(bpm, valid)``, each ``(L,
    *batch)`` for ``N = n_first .. n_last``, written into ``out`` when
    given: the ramp kernel on a CUDA tensor (one launch, no host wait), the
    plain :func:`_ramp_bpm` on a CPU one."""
    L = n_last - n_first + 1
    if out is None:
        shape = (L,) + tuple(x.shape[1:])
        out = (torch.empty(shape, dtype=x.dtype, device=x.device),
               torch.empty(shape, dtype=torch.bool, device=x.device))
    bpm, valid = out
    if x.device.type == "cpu":
        r_bpm, r_valid = _ramp_bpm(x, fps, band, n_first, n_last)
        bpm.copy_(r_bpm)
        valid.copy_(r_valid)
    elif x.device.type == "cuda":
        ramp_bpm_cuda(x, fps, band, n_first, n_last, bpm, valid)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return bpm, valid


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
        with span("vhr.estimate.ramp", lengths=ramp_end - first + 1):
            ramp_bpm(x, fps, band, first + 1, ramp_end + 1,
                     out=(bpm[first:ramp_end + 1], valid[first:ramp_end + 1]))

    if T >= window_len:
        with span("vhr.estimate.steady", windows=T - window_len + 1):
            wins = _windows_last(x, window_len)                # (T-W+1,*b,W)
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
