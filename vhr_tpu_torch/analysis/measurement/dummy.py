"""Test fake: plausible random BPM at real frame timestamps.

The port's copy of ``vhr_tpu/analysis/measurement/dummy.py``, line for line
below this docstring: N(72, 3) BPM per frame, seeded, on the host.
"""

from __future__ import annotations

import numpy as np

from ...io import video as vio


def measure(video_path: str) -> np.ndarray:
    frames, fps = vio.read_video(video_path)
    n = frames.shape[0]
    if n == 0:
        return np.empty((0, 2), dtype=float)
    t = np.arange(n, dtype=float) / float(fps)
    hr = np.random.default_rng(72).normal(loc=72.0, scale=3.0, size=n)
    return np.column_stack([t, hr])
