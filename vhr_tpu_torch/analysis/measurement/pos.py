"""POS measurement plugin: plane-orthogonal-to-skin pulse -> rolling BPM.

Port of ``vhr_tpu/analysis/measurement/pos.py``: POS (Wang et al. 2017)
projects the RGB means onto the plane orthogonal to the skin tone.  Same
sweep contract as ``green_avg.py``.
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
    ts, bpm, valid = offline.measure_projection(
        frames, fps, "pos", cfg,
        detector=context.current_detector(),
        detect_every=context.current_detect_every())
    return offline.to_measurement_array(ts, bpm, valid)
