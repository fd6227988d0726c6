#!/usr/bin/env python3
"""Check and time kernel K6 (``yiq_pyrdown``, the EVM front-end) alone on
one CUDA card, on ``chip_smoke.py``'s seeded 1080p face clip, at 64 frames
and at the EVM paths' own launch sizes (600 frames for ``magnify``'s 20 s
chunk, 960 for the EVM measure).

    python3 tools/k6_profile.py [label] [--root DIR] [--parent DIR]
                                [--nocheck] [--define NAME[=VALUE]]...
                                [--max-steps N] [--paths]

Run it from the root of the checkout; it builds the kernels, which takes
seconds.  It times the package of the checkout it lies in, or with
``--root DIR`` the ``vhr_tpu_torch`` of another checkout (the checks and
timers stay this file's and this checkout's ``chip_smoke.py``).
``--parent DIR`` builds ``DIR/vhr_tpu_torch/csrc/evm_pyrdown.cu`` alone, a
K6 with the C interface ``vhr_yiq_pyrdown(frames, out, T, H, W, stream)``,
holds the package's K6 equal to it bit for bit at 1080p x 64, and times the
two in turns inside this process (parent, this, this, parent).  To compare
two commits end to end on one card, unpack the other one (``git
archive``) into a git-ignored directory and run both with ``--paths`` in
turns inside one job: other (``--root``), this, this, other.
``--define`` adds ``-DNAME[=VALUE]`` to the compiler's flags (a probe build
of the kernel, such as ``K6_PROBE_LOAD_ONLY``, ``K6_PROBE_NO_STORE`` or
``K6_PROBE_NO_LOAD`` of ``csrc/evm_pyrdown.cu``, which need not be right:
give ``--nocheck`` with it).  ``--max-steps`` launches segments of at most
``N`` steps of 8 output rows instead of ``evm_cuda.KERNEL_SHAPE``'s (the
host's choice alone: the kernel is the same).

1. The ``-Xptxas -v`` lines of K6: registers, spills and shared memory of
   every instantiation.
2. K6 against ``yiq_pyrdown_plain`` within ``chip_smoke.K6_ATOL`` at 1080p,
   at 720p, at widths 1000 and 131 and at an odd width and height, and two
   launches on the same input, which must give the same bits (skipped with
   ``--nocheck``).
3. At 64, 600 and 960 frames: milliseconds a launch by CUDA events with the
   card's queue filled ahead (the card alone), by events paced by the host,
   and under ``torch.profiler``; the bound (each input byte read once, each
   output byte written once, over 3.35 TB/s); and a device-to-device
   ``copy_`` of the same bytes, the practical ceiling.
4. With ``--paths``: ``magnify`` at T=600 on the kernel route and the EVM
   measure at T=960 (``_measure_frames``), by events, and the card's busy
   time with K6's share of it under ``torch.profiler``.

Prints the card's name and power limit first, and last one line of JSON
with every time.  Needs a CUDA card.
"""

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SIZES = (64, 600, 960)


def parent_kernel(root: Path, flags):
    """The K6 of checkout ``root``, built alone: ``fn(frames) -> out``."""
    import torch

    src = root / "vhr_tpu_torch" / "csrc" / "evm_pyrdown.cu"
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out_dir = HERE / "build" / "k6_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libk6_{tag.hexdigest()[:16]}.so"
    if not lib.exists():
        from vhr_tpu_torch import _build
        subprocess.run([_build._nvcc(), *flags, "-shared", "-o", str(lib),
                        str(src)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    fn = so.vhr_yiq_pyrdown
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(frames):
        T, H, W, _ = frames.shape
        out = torch.empty((T, 3, H // 2, W // 2), dtype=torch.float32,
                          device=frames.device)
        err = fn(frames.data_ptr(), out.data_ptr(), T, H, W,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K6: CUDA error {err}")
        return out
    return run


def kernel_ms(cs, name: str, fn, inner: int) -> dict:
    """Queue-ahead, host-paced and profiler milliseconds of one launch."""
    rec = {"ms": cs.cuda_ms(fn, reps=5, inner=inner, queue_ahead=True),
           "host_paced_ms": cs.cuda_ms(fn, reps=5, inner=inner)}
    def calls():
        for _ in range(2 * inner):
            fn()
    _, top = cs.device_profile(calls, 4)
    rec["profiler_ms"] = next((ms / n for k, ms, n in top if name in k),
                              None)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", default="this")
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--parent", default=None)
    ap.add_argument("--nocheck", action="store_true")
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--paths", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch
    from vhr_tpu_torch import _build
    from vhr_tpu_torch.ops import evm_cuda

    if not torch.cuda.is_available():
        print("k6_profile: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(f"[k6] {args.label}: package "
          f"{Path(evm_cuda.__file__).parent.parent}")
    _build.NVCC_FLAGS.extend(f"-D{d}" for d in args.define)
    if args.max_steps:
        evm_cuda.KERNEL_SHAPE["max_steps"] = args.max_steps
    print(f"[k6] shape {getattr(evm_cuda, 'KERNEL_SHAPE', None)}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    text = lib.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(text):
        if "error" in line or "warning" in line:
            print(f"[build] {line.strip()[:200]}")
        if "Compiling" in line and "yiq_pyrdown" in line:
            used = " ".join(s.strip().replace("ptxas info    : ", "")
                            for s in text[i + 1:i + 4]
                            if "Used" in s or "spill" in s)
            name = line.split("yiq_pyrdown_kernel")[-1].split("'")[0]
            print(f"[build] yiq_pyrdown_kernel{name[:40]}: {used}")
    parent = (parent_kernel(Path(args.parent).resolve(), _build.NVCC_FLAGS)
              if args.parent else None)

    frames, _ = cs.make_clip(dev, max(SIZES), cs.H, cs.W)
    torch.cuda.synchronize()
    res = {"label": args.label, "card": card}
    ok = True
    if not args.nocheck:
        n = cs.EVM_CHECK_T
        # The last case is a view whose base lies one frame into the clip.
        cases = {"1920x1080": frames[:n], "1280x720": frames[:n, :720, :1280],
                 "1000x1080": frames[:n, :, :1000],
                 "1920x1079": frames[:8, :1079],
                 "131x35": frames[:4, :35, :131],
                 "1917x1079": frames[:8, :1079, :1917],
                 "1920x1080 frames[1:]": frames[1:n]}
        checks = {}
        for name, x in cases.items():
            x = x.contiguous()
            got = evm_cuda.yiq_pyrdown(x)
            want = evm_cuda.yiq_pyrdown_plain(x)
            again = evm_cuda.yiq_pyrdown(x)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            good = (got.shape == want.shape and err <= cs.K6_ATOL
                    and torch.equal(got, again))
            checks[name] = {"max_abs_err": err, "same_bits": good}
            ok = ok and good
            print(f"[check] K6 == plain at {name} x {x.shape[0]}: max |err| "
                  f"{err:.3g}, a second launch the same bits: "
                  f"{torch.equal(got, again)}", flush=True)
        if parent is not None:
            x = frames[:n]
            same = torch.equal(evm_cuda.yiq_pyrdown(x), parent(x))
            checks["parent_bit_equal"] = same
            ok = ok and same
            print(f"[check] K6 == the parent's K6 bit for bit at 1920x1080 "
                  f"x {n}: {same}", flush=True)
        res["checks"] = checks

    frame_bytes = cs.H * cs.W * 3
    times = {}
    for n in SIZES:
        x = frames[:n]
        inner = 10 if n <= 64 else 3
        nbytes = 2 * n * frame_bytes
        rec = {"bound_ms": cs.bound(nbytes, 170 * n * (cs.H // 2)
                                    * (cs.W // 2))[0]}
        runs = [("this", lambda: evm_cuda.yiq_pyrdown(x))]
        if parent is not None:
            runs = ([("parent", lambda: parent(x))] + runs + runs
                    + [("parent", lambda: parent(x))])
        for who, fn in runs:
            rec.setdefault(who, []).append(kernel_ms(cs, "yiq_pyrdown", fn,
                                                     inner))
        dst = torch.empty_like(x)
        rec["copy_ms"] = cs.cuda_ms(lambda: dst.copy_(x), reps=5,
                                    inner=inner, queue_ahead=True)
        del dst
        best = min(r["ms"] for r in rec["this"])
        rec["share_of_bound"] = rec["bound_ms"] / best
        rec["GBps"] = nbytes / best / 1e6
        print(f"[time] K6 at {cs.W}x{cs.H} x {n}: {json.dumps(rec)}",
              flush=True)
        times[n] = rec
    res["k6"] = times

    if args.paths:
        from vhr_tpu_torch.analysis.measurement import evm as measure_evm
        from vhr_tpu_torch.config import EVMConfig
        from vhr_tpu_torch.pipeline import evm

        cfg = EVMConfig()
        clip, _ = cs.make_clip(dev, cs.EVM_T, cs.H, cs.W, seed=cs.SEED + 6,
                               bpm=cs.EVM_BPM)
        paths = {"magnify T=600": lambda: evm.magnify(clip, cs.FPS, cfg,
                                                       use_pallas=True),
                 "EVM measure T=960": lambda: measure_evm._measure_frames(
                     frames, cs.FPS)}
        res["paths"] = {}
        for name, fn in paths.items():
            ms = cs.cuda_ms(fn)
            busy, top = cs.device_profile(fn, 40)
            k6 = sum(t for k, t, _ in top if "yiq_pyrdown" in k)
            rec = {"ms": ms, "busy_ms": busy, "k6_ms": k6,
                   "k6_share_of_busy": k6 / busy if busy else None}
            print(f"[time] {name}: {json.dumps(rec)}", flush=True)
            res["paths"][name] = rec
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
