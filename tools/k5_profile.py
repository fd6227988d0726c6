#!/usr/bin/env python3
"""Check and time kernel K5 (``residual_stage``) alone on one CUDA card, at
the face-mesh net's four stages with the bundled weights, 64 frames a
launch (the MediaPipe detector's slice).

    python3 tools/k5_profile.py [label] [--root DIR] [--nocheck]
                                [--define NAME[=VALUE]]...
                                [--tiling CM:MT:WARPS]...

Run it from the root of the checkout; it builds the kernels, which takes
seconds, against minutes for the whole of ``chip_smoke.py``.  It times the
package of the checkout it lies in, or with ``--root DIR`` the
``vhr_tpu_torch`` of another checkout (the checks and timers stay this
file's and this checkout's ``chip_smoke.py``).  To compare two commits on
one card, unpack the other one (``git archive``) into a git-ignored
directory and run both in turns inside one job: other, this, this, other.
``--define`` adds ``-DNAME[=VALUE]`` to the compiler's flags (a probe build
of the kernel, which need not be right: give ``--nocheck`` with it).
``--tiling`` launches the stage of mid width ``CM`` with ``MT`` m-tiles a
warp and ``WARPS`` warps a thread block, where the kernel is compiled for
that shape, instead of ``meshblocks_cuda.KERNEL_TILING``'s.

1. The ``-Xptxas -v`` lines of K5: registers, spills and shared memory of
   every instantiation.
2. ``chip_smoke.check_k5``: K5 against its plain version at each stage in
   float32 and bfloat16, at ``chip_smoke.py``'s own tolerances (skipped
   with ``--nocheck``).
3. Per stage and dtype: milliseconds a launch by CUDA events with the
   card's queue filled ahead (the card alone), by events paced by the host
   (what a caller sees where the host is slower), and the kernel's time
   under ``torch.profiler``; then two launches on the same input, which
   must give the same bits.

Prints the card's name and power limit first, and last one line of JSON:
per stage the times, and ``run_ms``, the bfloat16 times with the queue
filled ahead summed over the 15 slices of a 960-frame measure.  Needs a
CUDA card.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SLICES = 15          # 960 frames in slices of 64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", default="this")
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--nocheck", action="store_true")
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--tiling", action="append", default=[])
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch
    from vhr_tpu_torch import _build
    from vhr_tpu_torch.models import mediapipe_face as mpf
    from vhr_tpu_torch.models import tflite, tflite_exec
    from vhr_tpu_torch.ops import meshblocks_cuda as mb

    if not torch.cuda.is_available():
        print("k5_profile: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True).stdout.strip(),
        flush=True)
    print(f"[k5] {args.label}: package {Path(mb.__file__).parent.parent}")
    _build.NVCC_FLAGS.extend(f"-D{d}" for d in args.define)
    for spec in args.tiling:
        cm, mt, warps = (int(v) for v in spec.split(":"))
        mb.KERNEL_TILING[cm] = (mt, warps)
    print(f"[k5] tiling {getattr(mb, 'KERNEL_TILING', None)}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    text = lib.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(text):
        if "error" in line:
            print(f"[build] {line.strip()[:200]}")
        if "Compiling" in line and "residual_stage" in line:
            used = " ".join(s.strip().replace("ptxas info    : ", "")
                            for s in text[i + 1:i + 4]
                            if "Used" in s or "spill" in s)
            name = line.split("residual_stage_kernel")[-1].split("'")[0]
            print(f"[build] residual_stage_kernel{name[:24]}: {used}")

    g = tflite_exec.fold_dequantize(tflite.load_task_models(
        mpf.default_task_path())["face_landmarks_detector.tflite"].graph)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 9)
    B = mpf._SLICE
    stages, ok, run_ms = [], True, 0.0
    for st in tflite_exec._find_residual_stages(g.operators, g.tensors):
        blocks = [{k: g.tensors[t].data for k, t in b.items()}
                  for b in st["blocks"]]
        wts = mb.pack_stage_weights(g.tensors[st["a0"]].data, blocks,
                                    device=dev)
        C, Hs, Ws = st["C"], st["H"], st["W"]
        x32 = torch.randn((B, C, Hs * Ws), generator=gen, device=dev)
        rec = {"stage": f"{Hs}x{Ws} C={C} Cm={st['Cm']} x {B}"}
        for name, x in (("f32", x32), ("bf16", x32.to(torch.bfloat16))):
            if not args.nocheck:
                err, scale = cs.check_k5(x, wts, Ws)
                rec[f"{name}_err"], rec["max_y"] = err, scale

            def fn():
                return mb.residual_stage(x, wts, Ws)
            rec[f"{name}_ms"] = cs.cuda_ms(fn, reps=5, inner=20,
                                           queue_ahead=True)
            rec[f"{name}_host_paced_ms"] = cs.cuda_ms(fn, reps=5, inner=20)
            _, top = cs.device_profile(lambda: [fn() for _ in range(10)], 4)
            rec[f"{name}_profiler_ms"] = next(
                (ms / n for k, ms, n in top if "residual_stage" in k), None)
            a, b = fn(), fn()
            torch.cuda.synchronize()
            same = torch.equal(a, b) and bool(np.isfinite(
                a.float().cpu().numpy()).all())
            rec[f"{name}_same_bits"] = same
            ok = ok and same
        run_ms += rec["bf16_ms"] * SLICES
        print(f"[k5] {json.dumps(rec)}", flush=True)
        stages.append(rec)
    print(json.dumps({"label": args.label, "run_ms": run_ms,
                      "stages": stages}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
