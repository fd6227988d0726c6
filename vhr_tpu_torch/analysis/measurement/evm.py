"""EVM measurement: detection-free Eulerian pulse extraction.

Port of ``vhr_tpu/analysis/measurement/evm.py``: Gaussian-pyramid coarse
level, temporal ideal band-pass, whole-frame pooled YIQ pulse, rolling
multichannel FFT peak -- no face detector anywhere in the loop.  On a CUDA
card the first pyramid level runs on kernel K6.
"""

from __future__ import annotations

import numpy as np
import torch

from . import read_frames
from ...config import BAND_ANALYSIS, HRBand
from ...dsp import spectral
from ...ops import windows as vwin
from ...pipeline import evm, offline

WINDOW_SIZE = 30.0
ACQUISITION_TIME = 10.0
LEVELS = 3


def measure(video_path: str) -> np.ndarray:
    """``(N, 2)`` ``[t_sec, bpm]`` rows of the EVM measure of a video file,
    on the sweep's device (``analysis.context``): the CUDA card (raises
    without one) unless the sweep asked for the CPU."""
    frames, fps = read_frames(video_path)
    return _measure_frames(frames, fps)


def _measure_frames(frames: torch.Tensor, fps: float) -> np.ndarray:
    """The measure of ``(T, H, W, 3)`` u8 BGR frames already in memory."""
    T = frames.shape[0]
    if T == 0:
        return np.empty((0, 2))
    sig = evm.magnified_pulse(frames, fps, HRBand(0.65, 3.4), levels=LEVELS,
                              use_pallas=frames.device.type == "cuda")

    window_len = int(WINDOW_SIZE * fps)
    acq_len = int(ACQUISITION_TIME * fps)
    ts = np.arange(T) / fps
    bpm = np.zeros(T, np.float32)
    valid = np.zeros(T, bool)

    # Rolling multichannel estimate over the pulse trace: the growing ramp
    # windows through the exact masked DFT, the steady windows as one batch.
    first = acq_len - 1
    if first >= T:
        return np.empty((0, 2))
    ramp_end = min(window_len - 1, T - 1)
    if ramp_end >= first:
        lengths = torch.arange(first + 1, ramp_end + 2, device=sig.device)
        prefix = sig[: ramp_end + 1]
        keep = (torch.arange(prefix.shape[0], device=sig.device)[None, :]
                < lengths[:, None])                              # (L, P)
        est = spectral.estimate_bpm_multichannel_exact(
            torch.where(keep[..., None], prefix, 0.0), lengths, fps,
            BAND_ANALYSIS)
        bpm[first:ramp_end + 1] = est.bpm.cpu().numpy()
        valid[first:ramp_end + 1] = est.valid.cpu().numpy()
    if T >= window_len:
        wins = vwin.sliding_windows(sig, window_len)             # (N, W, 3)
        est = spectral.estimate_bpm_multichannel(wins, fps, BAND_ANALYSIS)
        bpm[window_len - 1:] = est.bpm.cpu().numpy()
        valid[window_len - 1:] = est.valid.cpu().numpy()

    return offline.to_measurement_array(ts, bpm, valid)
