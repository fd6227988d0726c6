"""Analysis sweep CLI: degradations x measurement methods x metrics.

Port of ``vhr_tpu/analysis/main.py``, with orchestration parity with the
reference's ``analysis/main.py``: resolve a video and its
ground-truth CSV, run every (degradation level, method) combination, persist
each measurement as ``.npy`` under
``results/<stem>/measurements/<method>/<degradation>/<label>.npy``, then run
every registered metric over the collected results.

Usage::

    python -m vhr_tpu_torch.analysis.main --video face.mp4 \
        --degradation colour_noise --methods green_avg ica [--device cpu]

Differences from the reference: plugins resolve through a registry (plus
filesystem paths for user plugins), multiple degradations can be swept in one
invocation, and a machine-readable ``summary.json`` records the run.

The degradations' device ops and the measurements run on ``--device`` (the
CUDA card by default; ``--device cpu`` runs on the CPU), which
``analysis.context`` hands to the plugins.  A metric that needs matplotlib
where it is not installed writes no files: the sweep logs that and goes
on.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Dict

import numpy as np

from . import registry
from ..io import video as vio
from ..utils.logging import get_logger
from ..utils.profiling import StageTimer

ORIGINAL = "original"


def apply_degradation(name: str, video_path: str):
    """Yield (degraded_path, label) tuples (``analysis/main.py:20-26``)."""
    if name == ORIGINAL:
        return [(video_path, ORIGINAL)]
    return registry.get_degradation(name).apply(video_path)


def apply_measurement(video_path: str, method: str) -> np.ndarray:
    return registry.get_measurement(method).measure(video_path)


def run_sweep(video_path: str, truth_path: str, degradations, methods,
              results_dir: str = "results", metrics_dir: str = None
              ) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """Programmatic entry: returns {degradation: {method: {label: (N,2)}}}."""
    base = Path(video_path).stem
    log = get_logger("vhr_tpu_torch.analysis",
                     jsonl_path=os.path.join(results_dir, base, "run.jsonl")
                     if os.path.isdir(os.path.join(results_dir, base))
                     else None)
    timer = StageTimer()
    truth = vio.read_truth_csv(truth_path)
    all_results = {}

    for degradation in degradations:
        log.info("applying degradation: %s", degradation)
        results: Dict[str, Dict[str, np.ndarray]] = {m: {} for m in methods}
        with timer.stage(f"degrade:{degradation}"):
            levels = list(apply_degradation(degradation, video_path))
        for degraded_path, label in levels:
            log.info("  level: %s", label)
            for method in methods:
                log.info("    measuring with %s", method)
                with timer.stage(f"measure:{method}", sync=True):
                    measurement = apply_measurement(degraded_path, method)
                results[method][label] = measurement
                out_dir = Path(results_dir) / base / "measurements" / \
                    method / degradation
                out_dir.mkdir(parents=True, exist_ok=True)
                np.save(out_dir / f"{label}.npy", measurement)

        plots_dir = os.path.join(results_dir, base, "plots")
        for name, module in registry.iter_metrics(metrics_dir):
            log.info("  metric: %s", name)
            with timer.stage(f"metric:{name}"):
                try:
                    module.plot(truth, results, x_label=degradation,
                                output_dir=plots_dir)
                except ModuleNotFoundError as e:
                    if e.name != "matplotlib":
                        raise
                    log.warning("  metric %s: matplotlib is not installed; "
                                "its files for %s were not written", name,
                                degradation)
        all_results[degradation] = results
    log.info("stage timings: %s", timer.json())

    summary = {
        "video": str(video_path),
        "truth": str(truth_path),
        "degradations": list(degradations),
        "methods": list(methods),
        "rows": {d: {m: {lbl: int(arr.shape[0])
                         for lbl, arr in by_label.items()}
                     for m, by_label in by_m.items()}
                 for d, by_m in all_results.items()},
        "stage_timings": timer.report(),
    }
    with open(os.path.join(results_dir, base, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return all_results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="HR estimation under degradation (PyTorch port)")
    parser.add_argument("--video", required=True,
                        help="input video filename (in --videos-dir or a path)")
    parser.add_argument("--degradation", nargs="*", default=[ORIGINAL],
                        help="degradation technique(s); default original only")
    parser.add_argument("--methods", nargs="+", required=True,
                        help="measurement methods to apply")
    parser.add_argument("--videos-dir", default="videos")
    parser.add_argument("--results-dir", default="results")
    parser.add_argument("--truth", default=None,
                        help="ground-truth CSV (default <video stem>.csv)")
    parser.add_argument("--metrics-dir", default=None,
                        help="extra directory of metric plugin files")
    parser.add_argument("--detector", default="skin",
                        choices=["skin", "landmarker", "landmarker-real",
                                 "refined", "mediapipe", "mediapipe-bf16",
                                 "mediapipe-exact"],
                        help="face localization used by every measurement "
                             "in the sweep (the reference's harness "
                             "hard-codes MediaPipe, analysis/utils/roi.py"
                             ":17-20; threaded via analysis.context so the "
                             "plugin contract stays measure(video_path))")
    parser.add_argument("--detect-every", type=int, default=1, metavar="N",
                        help="detection cadence for the sweep's "
                             "measurements (holdover tracking in between)")
    parser.add_argument("--device", default=None,
                        help="torch device of the sweep's device ops and "
                             "measurements (default: the CUDA card; 'cpu' "
                             "runs on the CPU)")
    args = parser.parse_args(argv)

    from . import context
    context.set_detector(args.detector)
    context.set_detect_every(args.detect_every)
    context.set_device(args.device)
    context.current_device()    # without a card, fail before the sweep

    video_path = args.video if os.path.exists(args.video) else \
        os.path.join(args.videos_dir, args.video)
    log = get_logger("vhr_tpu_torch.analysis")
    if not os.path.exists(video_path):
        log.error("video not found: %s", args.video)
        return 1

    truth_path = args.truth or os.path.join(
        os.path.dirname(video_path), f"{Path(video_path).stem}.csv")
    if not os.path.exists(truth_path):
        log.error("ground truth not found: %s", truth_path)
        return 1

    os.environ.setdefault("VHR_RESULTS_DIR", args.results_dir)
    run_sweep(video_path, truth_path, args.degradation, args.methods,
              results_dir=args.results_dir, metrics_dir=args.metrics_dir)
    log.info("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
