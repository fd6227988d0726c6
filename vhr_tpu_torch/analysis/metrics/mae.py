"""MAE-vs-degradation metric.

The port's copy of ``vhr_tpu/analysis/metrics/mae.py``, line for line below
this docstring: per method and degradation level, the mean absolute error
between the predicted BPM and the zero-order-hold-aligned truth, plotted as
``mae_vs_<x_label>.png`` and written as ``mae_vs_<x_label>.csv``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ...io.video import align_truth_to_measurement


def compute(truth: np.ndarray,
            results: Dict[str, Dict[str, np.ndarray]]
            ) -> Dict[str, Dict[str, float]]:
    """{method: {degradation: mae}} — the metric's pure core."""
    out: Dict[str, Dict[str, float]] = {}
    for method, by_deg in results.items():
        out[method] = {}
        for label, measured in by_deg.items():
            if measured.shape[0] == 0:
                out[method][label] = float("nan")
                continue
            aligned = align_truth_to_measurement(truth, measured)
            out[method][label] = float(
                np.mean(np.abs(measured[:, 1] - aligned[:, 1])))
    return out


def plot(truth, results, x_label: str, output_dir: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    truth = np.asarray(truth)
    maes = compute(truth, results)
    os.makedirs(output_dir, exist_ok=True)

    fig, ax = plt.subplots(figsize=(9, 5))
    for method, by_deg in maes.items():
        labels = list(by_deg)
        ax.plot(labels, [by_deg[k] for k in labels], marker="o", label=method)
    ax.set_xlabel(x_label)
    ax.set_ylabel("MAE (|predicted HR - truth HR|)")
    ax.set_title(f"Mean Absolute Error vs {x_label}")
    ax.grid(True, alpha=0.3)
    ax.legend(title="Method")
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, f"mae_vs_{x_label}.png"), dpi=150)
    plt.close(fig)

    with open(os.path.join(output_dir, f"mae_vs_{x_label}.csv"), "w") as f:
        f.write("method,degradation,mae\n")
        for method, by_deg in maes.items():
            for label, v in by_deg.items():
                f.write(f"{method},{label},{v}\n")
