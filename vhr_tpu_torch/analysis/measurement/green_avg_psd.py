"""green_avg with per-stage PSD capture and an ROI-mean signal cache.

Port of ``vhr_tpu/analysis/measurement/green_avg_psd.py``: the same BPM
trace as ``green_avg`` plus, over the steady windows, Welch PSDs of the four
processing variants the reference compares (raw / z-scored / bandpassed /
z-scored+bandpassed), and an ``.npz`` cache of the per-frame green ROI
means keyed by video and detector configuration so the detection pass runs
once.  Stage PSDs are saved to ``cache/psd_stages/<stem>.npz`` for offline
plotting (``vhr_tpu_torch.utils.psd_plot``).  Both caches live under
``VHR_CACHE_DIR`` (default ``cache``) and have the JAX package's names and
layout.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from . import read_frames
from .. import context
from ...config import PipelineConfig
from ...dsp import design, filters, spectral
from ...ops import windows as vwin
from ...pipeline import offline

WINDOW_SIZE = 30.0
ACQUISITION_TIME = 10.0


def _cache_dir() -> Path:
    """Read VHR_CACHE_DIR at call time (an import-time binding would pin
    the first process-wide value and ignore later env changes)."""
    return Path(os.environ.get("VHR_CACHE_DIR", "cache"))


def _cached_green(video_path: str):
    """Per-frame (green, valid, fps), cached as .npz keyed by the video
    AND the harness detector configuration (a skin-detector cache entry
    must never serve a `--detector mediapipe` sweep)."""
    key = Path(video_path).stem
    det_key = context.current_detector_name()
    if context.current_detect_every() > 1:
        det_key += f"-e{context.current_detect_every()}"
    if det_key != "skin":
        key = f"{key}.{det_key}"
    cache = _cache_dir() / "roi_mean_data" / f"{key}.npz"
    if cache.exists():
        z = np.load(cache)
        return z["green"], z["valid"], float(z["fps"])
    frames, fps = read_frames(video_path)
    if frames.shape[0] == 0:
        return np.zeros(0, np.float32), np.zeros(0, bool), fps
    trace = offline.extract_signals(
        frames, detector=context.current_detector(),
        detect_every=context.current_detect_every())
    green = trace.bgr[:, 1].cpu().numpy()
    valid = trace.valid.cpu().numpy()
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.savez(cache, green=green, valid=valid, fps=fps)
    return green, valid, fps


def _demean(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(-1, keepdim=True)


def measure(video_path: str) -> np.ndarray:
    device = context.current_device()
    green, valid, fps = _cached_green(video_path)
    T = green.shape[0]
    if T == 0:
        return np.empty((0, 2))
    cfg = PipelineConfig(window_seconds=WINDOW_SIZE,
                         acquisition_seconds=ACQUISITION_TIME)
    g = torch.as_tensor(green, device=device)
    rolling = vwin.rolling_bpm_fft(g, fps, cfg.band, cfg.window_len(fps),
                                   cfg.acquisition_len(fps))
    ok = rolling.valid.cpu().numpy() & valid

    # Stage PSDs over steady-state windows (the reference's 4-variant
    # comparison), computed as one batch and saved for replay.  Clips
    # shorter than the 30 s window capture one full-length window.
    W = min(cfg.window_len(fps), T)
    wins = vwin.sliding_windows(g, W)                            # (N, W)
    z = _demean(wins) / (wins.std(-1, keepdim=True, correction=0) + 1e-12)
    sos = design.sos_design("butterworth", fps, cfg.band.low_hz,
                            cfg.band.high_hz, 2)
    bp = filters.sosfiltfilt(sos, wins.T).T
    zbp = filters.sosfiltfilt(sos, z.T).T
    nperseg = int(min(W, fps * 9))
    stages = {}
    for name, sig in [("raw", wins), ("zscore", z),
                      ("bandpass", bp), ("zscore_bandpass", zbp)]:
        f, p = spectral.welch_psd(_demean(sig), fps, nperseg)
        stages[name] = p.cpu().numpy()
    out = _cache_dir() / "psd_stages" / f"{Path(video_path).stem}.npz"
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, freqs=f, **stages)

    ts = np.arange(T) / fps
    return offline.to_measurement_array(ts, rolling.bpm.cpu().numpy(), ok)
