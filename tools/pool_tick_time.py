#!/usr/bin/env python3
"""Time the serving pool's fused tick (64 slots of 720p, kernel K4 inside)
on one CUDA card, for the checkout this file lies in.

    python3 tools/pool_tick_time.py [label]

To compare two commits on one card, unpack the other one (``git archive``)
into a git-ignored directory, copy this file into its ``tools/`` and run
both in turns inside one job: other, this, this, other.

The pool is ``BpmServer(LiveConfig(fps=30, use_fused=True), n_slots=64)``;
every slot is attached and ticked 40 times on frames made on the card, so
that every slot tracks a face.  Then, on one more set of frames:

- the tick's device time: ``tick_async`` on frames resident on the card,
  CUDA events around 10 ticks, median of 5;
- the tick's wall time with the upload of numpy frames and the fetch;
- one tick under ``torch.profiler``: the card's busy time, the number of
  kernels, and the kernels of K4 (their names hold ``slot_`` or
  ``roi_means``) with their time.

Prints the card's name and power limit, then one line of JSON.
"""

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vhr_tpu_torch import serving  # noqa: E402
from vhr_tpu_torch.pipeline import live  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("pool_tick_time: needs a CUDA card", file=sys.stderr)
        return 2
    label = sys.argv[1] if len(sys.argv) > 1 else "this"
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True).stdout.strip()
    S = cs.SLOTS
    pool = serving.BpmServer(live.LiveConfig(fps=cs.FPS, use_fused=True),
                             n_slots=S)
    subj = cs.Subjects(dev, S, cs.PH, cs.PW, cs.SEED + 4)
    for s in range(S):
        if pool.attach() != s:
            raise AssertionError("slots attach in order")
    for k in range(40):
        frames = subj.frames(range(S), [k] * S)
        pool.tick({s: frames[s] for s in range(S)})
    frames = subj.frames(range(S), [40] * S)
    on_card = {s: frames[s] for s in range(S)}
    host = {s: f for s, f in enumerate(frames.cpu().numpy())}
    dev_ms = cs.cuda_ms(lambda: pool.tick_async(on_card), reps=5, inner=10)
    wall_ms = cs.wall_ms(lambda: pool.tick(host), reps=5, inner=10)
    busy = None
    for _ in range(3):       # an empty trace is taken again
        busy, top = cs.device_profile(lambda: pool.tick_async(on_card),
                                      top=1000)
        if busy is not None:
            break
    if busy is None:
        raise AssertionError("the profiler traced no device work")
    k4 = {n[:48]: round(ms, 4) for n, ms, _ in top
          if "slot_" in n or "roi_means" in n}
    print(card)
    print(json.dumps({
        "label": label, "tick_device_ms": dev_ms, "tick_wall_ms": wall_ms,
        "tick_busy_ms": busy, "tick_kernels": sum(n for _, _, n in top),
        "k4_kernels_ms": k4}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
