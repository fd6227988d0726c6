#!/usr/bin/env python3
"""Time the MediaPipe measure (1080p, T=960, the mesh net's residual stages
on kernel K5) on one CUDA card, and say how busy the card is in it.

    python3 tools/mediapipe_measure_time.py [label] [--root DIR]

It drives ``chip_smoke.py``'s MediaPipe configuration: the drawn face clip,
``load_face_models(activation_dtype=bfloat16, fuse_stages=True)``,
``measure_green_avg(detector=..., use_pallas="roi")`` with
``PipelineConfig()``.  It times the package of the checkout it lies in, or
with ``--root DIR`` the ``vhr_tpu_torch`` of another checkout (the clip and
the timers stay this checkout's ``chip_smoke.py``).  To compare two commits
on one card, unpack the other one (``git archive``) into a git-ignored
directory and run both in turns inside one job: other, this, this, other.

Prints the card's name and power limit, then one line of JSON: the
measure's milliseconds (CUDA events, median of 3 after a warm-up) and
frames/s, and from one run under ``torch.profiler`` the card's busy
milliseconds, the idle share of the measure's time, K5's milliseconds and
launches, and the eight kernels that take most of the busy time.  Needs a
CUDA card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", default="this")
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch
    from vhr_tpu_torch.config import PipelineConfig
    from vhr_tpu_torch.models import mediapipe_face as mpf
    from vhr_tpu_torch.pipeline import offline

    if not torch.cuda.is_available():
        print("mediapipe_measure_time: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True).stdout.strip()
    cfg = PipelineConfig()
    frames, _ = cs.make_face_clip(dev, cs.T, cs.H, cs.W, seed=cs.SEED + 8)
    params, det_apply, lm_fused = mpf.load_face_models(
        activation_dtype=torch.bfloat16, fuse_stages=True)

    def det(x):
        return mpf._detect_single(params, det_apply, lm_fused, x)

    def measure():
        return offline.measure_green_avg(frames, cs.FPS, cfg, detector=det,
                                         use_pallas="roi")

    _, _, valid = measure()
    ms = cs.cuda_ms(measure)
    busy = None
    for _ in range(3):       # an empty trace is taken again
        busy, top = cs.device_profile(measure, top=1000)
        if busy is not None:
            break
    if busy is None:
        raise AssertionError("the profiler traced no device work")
    k5 = [(m, n) for name, m, n in top if "residual_stage" in name]
    print(card)
    print(json.dumps({
        "label": args.label,
        "package": str(Path(mpf.__file__).resolve().parents[2]),
        "valid_frames": int(valid.sum()),
        "measure_ms": ms, "frames_per_s": cs.T / (ms / 1e3),
        "busy_ms": busy, "idle_share": 1 - busy / ms,
        "k5_ms": sum(m for m, _ in k5), "k5_launches": sum(n for _, n in k5),
        "kernels": sum(n for _, _, n in top),
        "top": [(name[:60], round(m, 3), n) for name, m, n in top[:8]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
