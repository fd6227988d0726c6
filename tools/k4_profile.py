#!/usr/bin/env python3
"""Check and time kernel K4 (``fused_detect_roi_slots``) alone on one CUDA
card, at the serving pool's size: 64 slots of 720p.

    python3 tools/k4_profile.py [--nocheck]

Run it from the root of the checkout; it builds the kernels, which takes a
few seconds, against minutes for the whole of ``chip_smoke.py``.

1. ``chip_smoke.check_k4``: K4 against its plain version over row pooling,
   detection cadence and gating, on random, tracked, chunk-straddling and
   edge-clipped carries (skipped with ``--nocheck``).
2. 64 tracked slots (each slot's carry is K4's own output on a fresh slot),
   then for the default arguments, ``detect_row_pool=8``, ``gate_margin=
   0.5``, a tick off the ``detect_every=4`` cadence, and pooling with
   gating: milliseconds a call by CUDA events (20 calls back to back, so a
   slow host shows here), and under ``torch.profiler`` the card's busy time
   and every kernel of one call with its time.
3. The same two first cases on frames of zeros (no skin: what the counting
   costs), ``torch.sum`` over as many bytes (what the card reads in that
   time with a library reduction), the host's enqueue time of one call, and
   two calls on the same inputs, which must give the same bits.

Prints the card's name and power limit first.  Needs a CUDA card.
"""

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vhr_tpu_torch import _build  # noqa: E402
from vhr_tpu_torch.ops import fused_cuda as fc  # noqa: E402

CASES = [("default", {}), ("detect_row_pool=8", dict(detect_row_pool=8)),
         ("gate_margin=0.5", dict(gate_margin=0.5)),
         ("off the detect_every=4 cadence", dict(detect_every=4)),
         ("detect_row_pool=8, gate_margin=0.5",
          dict(detect_row_pool=8, gate_margin=0.5))]


def kernels_of(fn, calls: int = 10):
    """Busy milliseconds and (name, ms, launches) per call of ``fn``."""
    busy, top = cs.device_profile(lambda: [fn() for _ in range(calls)], 6)
    return busy / calls, [(n, ms / calls, c / calls) for n, ms, c in top]


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_profile: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True).stdout.strip(),
        flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "slot_" in line and "Compiling" in line or "error" in line:
            print(f"[build] {line.strip()[:160]}")
    if "--nocheck" not in sys.argv:
        print(f"[check] max |err| {cs.check_k4(dev)}", flush=True)

    S = cs.SLOTS
    subj = cs.Subjects(dev, S, cs.PH, cs.PW, cs.SEED + 4)
    frames = subj.frames(range(S), list(range(700, 700 + S)))
    phase = torch.full((S,), 701, dtype=torch.int32, device=dev)
    _, carry = fc.fused_detect_roi_slots(
        frames, torch.zeros((S, 6), dtype=torch.int32, device=dev), phase)
    torch.cuda.synchronize()
    print(f"[k4] tracked carry of slot 0: {carry[0].tolist()}")

    def report(tag, x, kw):
        def fn():
            return fc.fused_detect_roi_slots(x, carry, phase, **kw)
        ms = cs.cuda_ms(fn, reps=5, inner=20)
        busy, top = kernels_of(fn)
        print(f"[k4] {tag}: {ms:.4f} ms a call by events; busy {busy:.4f} "
              f"ms; " + "; ".join(f"{n[:44]} {m:.4f} ms x{c:g}"
                                  for n, m, c in top), flush=True)

    for name, kw in CASES:
        report(name, frames, kw)
    zeros = torch.zeros_like(frames)
    for name, kw in CASES[:2]:
        report(f"frames of zeros, {name}", zeros, kw)
    flat = zeros.view(-1).view(torch.float32)
    _, top = kernels_of(flat.sum)
    print(f"[ref] torch.sum over {flat.numel() * 4 / 1e6:.1f} MB: "
          + "; ".join(f"{n[:44]} {m:.4f} ms" for n, m, _ in top))

    kw = dict(detect_every=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        fc.fused_detect_roi_slots(frames, carry, phase, **kw)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    print(f"[host] {(t1 - t0) / 2000 * 1e6:.1f} us to enqueue a call")

    a = fc.fused_detect_roi_slots(frames, carry, phase)
    b = fc.fused_detect_roi_slots(frames, carry, phase)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(tuple(a[0]) + (a[1],),
                                                 tuple(b[0]) + (b[1],)))
    print(f"[k4] two calls, same bits: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
