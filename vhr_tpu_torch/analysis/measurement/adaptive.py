"""Adaptive measurement plugin: per-window SNR-ranked method selection.

Port of ``vhr_tpu/analysis/measurement/adaptive.py``: each rolling
window's BPM comes from whichever pulse construction (raw green mean or the
CHROM/POS/OMIT projections) scores the highest in-band spectral SNR on that
window.  Same sweep contract as ``green_avg.py``.
"""

from __future__ import annotations

import numpy as np

from . import read_frames
from .. import context
from ...config import PipelineConfig
from ...pipeline import offline

WINDOW_SIZE = 30.0
ACQUISITION_TIME = 10.0


def measure(video_path: str) -> np.ndarray:
    frames, fps = read_frames(video_path)
    if frames.shape[0] == 0:
        return np.empty((0, 2))
    cfg = PipelineConfig(window_seconds=WINDOW_SIZE,
                         acquisition_seconds=ACQUISITION_TIME)
    res = offline.measure_adaptive(
        frames, fps, cfg,
        detector=context.current_detector(),
        detect_every=context.current_detect_every())
    return offline.to_measurement_array(res.ts, res.bpm, res.valid)
