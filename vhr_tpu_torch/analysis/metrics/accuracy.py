"""Accuracy metric family: RMSE, PTE5/PTE10, Pearson r vs truth.

The port's copy of ``vhr_tpu/analysis/metrics/accuracy.py``, line for line
below this docstring: a pure ``compute`` plus a ``plot`` that saves one PNG
and one CSV (``accuracy_vs_<x_label>``) per sweep axis.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ...io.video import align_truth_to_measurement


def _stats(truth: np.ndarray, measured: np.ndarray) -> Dict[str, float]:
    if measured.shape[0] == 0:
        return {k: float("nan") for k in ("rmse", "pte5", "pte10", "corr")}
    aligned = align_truth_to_measurement(truth, measured)
    err = measured[:, 1] - aligned[:, 1]
    out = {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "pte5": float(np.mean(np.abs(err) <= 5.0) * 100.0),
        "pte10": float(np.mean(np.abs(err) <= 10.0) * 100.0),
    }
    if len(err) >= 2 and np.std(measured[:, 1]) > 0 \
            and np.std(aligned[:, 1]) > 0:
        out["corr"] = float(np.corrcoef(measured[:, 1], aligned[:, 1])[0, 1])
    else:
        out["corr"] = float("nan")
    return out


def compute(truth: np.ndarray,
            results: Dict[str, Dict[str, np.ndarray]]
            ) -> Dict[str, Dict[str, Dict[str, float]]]:
    """{method: {degradation: {rmse, pte5, pte10, corr}}}."""
    truth = np.asarray(truth)
    return {method: {label: _stats(truth, measured)
                     for label, measured in by_deg.items()}
            for method, by_deg in results.items()}


def plot(truth, results, x_label: str, output_dir: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    stats = compute(np.asarray(truth), results)
    os.makedirs(output_dir, exist_ok=True)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(13, 5))
    for method, by_deg in stats.items():
        labels = list(by_deg)
        ax1.plot(labels, [by_deg[k]["rmse"] for k in labels],
                 marker="o", label=method)
        ax2.plot(labels, [by_deg[k]["pte5"] for k in labels],
                 marker="o", label=method)
    ax1.set_xlabel(x_label)
    ax1.set_ylabel("RMSE (BPM)")
    ax1.set_title(f"RMSE vs {x_label}")
    ax1.grid(True, alpha=0.3)
    ax1.legend(title="Method")
    ax2.set_xlabel(x_label)
    ax2.set_ylabel("PTE5 (% within 5 BPM)")
    ax2.set_ylim(0, 105)
    ax2.set_title(f"PTE5 vs {x_label}")
    ax2.grid(True, alpha=0.3)
    ax2.legend(title="Method")
    fig.tight_layout()
    fig.savefig(os.path.join(output_dir, f"accuracy_vs_{x_label}.png"),
                dpi=150)
    plt.close(fig)

    with open(os.path.join(output_dir, f"accuracy_vs_{x_label}.csv"),
              "w") as f:
        f.write("method,degradation,rmse,pte5,pte10,corr\n")
        for method, by_deg in stats.items():
            for label, s in by_deg.items():
                f.write(f"{method},{label},{s['rmse']:.4f},{s['pte5']:.2f},"
                        f"{s['pte10']:.2f},{s['corr']:.4f}\n")
