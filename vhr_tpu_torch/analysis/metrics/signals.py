"""BPM time-series overlay metric.

The port's copy of ``vhr_tpu/analysis/metrics/signals.py``, line for line
below this docstring: one line per (method, degradation) plus the truth
step curve, saved as ``signals_<x_label>.png``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ...io.video import align_truth_to_measurement


def plot(truth, results: Dict[str, Dict[str, np.ndarray]],
         x_label: str, output_dir: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    truth = np.asarray(truth)
    os.makedirs(output_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(11, 6))

    truth_aligned = None
    for method, by_deg in results.items():
        for label, measured in by_deg.items():
            if measured.shape[0] == 0:
                continue
            if truth_aligned is None:
                truth_aligned = align_truth_to_measurement(truth, measured)
            ax.plot(measured[:, 0], measured[:, 1], linewidth=1.25,
                    label=f"{method} - {label}")

    if truth_aligned is not None:
        ax.plot(truth_aligned[:, 0], truth_aligned[:, 1], linewidth=1.6,
                label="Truth")

    ax.set_xlabel("Time (s)")
    ax.set_ylabel("BPM")
    ax.set_title("BPM over Time")
    ax.grid(True, alpha=0.3)
    ax.legend(ncol=2)
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, f"signals_{x_label}.png"), dpi=150)
    plt.close(fig)
