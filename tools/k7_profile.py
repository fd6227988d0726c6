#!/usr/bin/env python3
"""Check and time kernel K7 (``evm_reconstruct``, the EVM output stage)
alone on one CUDA card, on ``chip_smoke.py``'s seeded 1080p face clip and
the band the pipeline makes from it, at 64 frames and at ``magnify``'s own
launch size (600 frames, the app's 20 s chunk).

    python3 tools/k7_profile.py [label] [--root DIR] [--parent DIR]
                                [--nocheck] [--define NAME[=VALUE]]...
                                [--seg-rows N] [--sass] [--paths]

Run it from the root of the checkout; it builds the kernels, which takes
seconds.  It times the package of the checkout it lies in, or with
``--root DIR`` the ``vhr_tpu_torch`` of another checkout (the checks and
timers stay this file's and this checkout's ``chip_smoke.py``).
``--parent DIR`` builds ``DIR/vhr_tpu_torch/csrc/evm_recon.cu`` alone, a
K7 whose C interface ends ``(..., T, H, W, hb, wb, stream)``, holds the
package's K7 equal to it bit for bit at 1080p x 64 on the pipeline's band
and on a random band of +-0.5, with interleaved and planar frames, and
times the two in turns inside this process (parent, this, this, parent).
``--define`` adds ``-DNAME[=VALUE]`` to the compiler's flags (a probe build,
such as ``K7_PROBE_LOAD_ONLY``, ``K7_PROBE_STORE_ONLY``,
``K7_PROBE_NO_MATH`` or ``K7_PROBE_MATH_ONLY`` of ``csrc/evm_recon.cu``,
which need not be right: give ``--nocheck`` with it).  ``--seg-rows``
launches segments of ``N`` rows instead of
``evm_recon_cuda.KERNEL_SHAPE``'s (the host's choice alone: the kernel is
the same).  ``--sass`` prints a count of the vectorised kernel's machine
instructions by opcode (``cuobjdump``).

1. The ``-Xptxas -v`` lines of every K7 instance: registers, spills and
   shared memory.
2. K7 against ``evm_reconstruct_plain`` (at most 1 u8 on at most
   ``chip_smoke.K7_MAX_FRAC`` of the values) at 1080p, 720p, widths 1000
   and 130 and an odd size, interleaved and planar, with the instance each
   took; where it is the vectorised one, equal bit for bit to the generic
   one; two launches on the same input give the same bits (skipped with
   ``--nocheck``).
3. At 64 and 600 frames: milliseconds a launch by CUDA events with the
   card's queue filled ahead (the card alone), by events paced by the
   host, and under ``torch.profiler``; the bound (each input byte read
   once, each output byte written once, over 3.35 TB/s); and a
   device-to-device ``copy_`` of the frames, the practical ceiling.
4. With ``--paths``: ``magnify`` at T=600 on the kernel route by events,
   the card's busy time and K7's share of it under ``torch.profiler``;
   with ``--parent`` also with the parent's K7 in its place, in turns.

Prints the card's name and power limit first, and last one line of JSON
with every time.  Needs a CUDA card.
"""

import argparse
import collections
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SIZES = (64, 600)


def parent_kernel(root: Path, flags):
    """The K7 of checkout ``root``, built alone: ``fn(planar, band) ->
    out``."""
    import torch
    from vhr_tpu_torch.ops import evm_recon_cuda

    src = root / "vhr_tpu_torch" / "csrc" / "evm_recon.cu"
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out_dir = HERE / "build" / "k7_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libk7_{tag.hexdigest()[:16]}.so"
    if not lib.exists():
        from vhr_tpu_torch import _build
        subprocess.run([_build._nvcc(), *flags, "-shared", "-o", str(lib),
                        str(src)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    fn = so.vhr_evm_reconstruct
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [P] + [L] * 4 + [P] + [L] * 4 + [P] * 9 + [I] * 5 + [P]
    fn.restype = ctypes.c_int

    def run(planar, band):
        T, _, H, W = planar.shape
        hb, wb = band.shape[2:]
        band = band.contiguous()
        out = torch.empty_like(planar)
        tabs = (evm_recon_cuda._tables(hb, H, planar.device)
                + evm_recon_cuda._tables(wb, W, planar.device))
        err = fn(planar.data_ptr(), *planar.stride(), out.data_ptr(),
                 *out.stride(), band.data_ptr(),
                 *(a.data_ptr() for a in tabs), T, H, W, hb, wb,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K7: CUDA error {err}")
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


def build_report(lib: Path) -> None:
    """The compiler's errors, warnings and each K7 instance's registers,
    spills and shared memory."""
    text = lib.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(text):
        if "error" in line or "warning" in line:
            print(f"[build] {line.strip()[:200]}")
        m = re.search(r"(evm_reconstruct\w*_kernel)", line)
        if "Compiling" in line and m:
            used = " ".join(s.strip().replace("ptxas info    : ", "")
                            for s in text[i + 1:i + 4]
                            if "Used" in s or "spill" in s)
            print(f"[build] {m.group(1)}: {used}")


def sass_histogram(lib: Path) -> dict:
    """Machine instructions of the vectorised K7 by opcode."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, inside = collections.Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            inside = "evm_reconstruct_vec_kernel" in line
        elif inside:
            m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", line)
            if m:
                counts[m.group(1).split(".")[0]] += 1
    return dict(counts.most_common())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", default="this")
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--parent", default=None)
    ap.add_argument("--nocheck", action="store_true")
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--seg-rows", type=int, default=None)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--paths", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch
    from vhr_tpu_torch import _build
    from vhr_tpu_torch.config import EVMConfig
    from vhr_tpu_torch.ops import evm_cuda, evm_recon_cuda as k7
    from vhr_tpu_torch.utils.profiling import counter

    if not torch.cuda.is_available():
        print("k7_profile: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(f"[k7] {args.label}: package {Path(k7.__file__).parent.parent}")
    _build.NVCC_FLAGS.extend(f"-D{d}" for d in args.define)
    shape = getattr(k7, "KERNEL_SHAPE", None)
    if args.seg_rows:
        shape["seg_rows"] = args.seg_rows
    print(f"[k7] shape {shape}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    build_report(lib)
    res = {"label": args.label, "card": card, "shape": shape}
    if args.sass:
        res["sass"] = sass_histogram(lib)
        print(f"[sass] vectorised K7, {sum(res['sass'].values())} "
              f"instructions: {json.dumps(res['sass'])}", flush=True)
    parent = (parent_kernel(Path(args.parent).resolve(), _build.NVCC_FLAGS)
              if args.parent else None)

    cfg = EVMConfig()
    frames, _ = cs.make_clip(dev, max(SIZES), cs.H, cs.W, seed=cs.SEED + 6,
                             bpm=cs.EVM_BPM)
    n = cs.EVM_CHECK_T
    band64 = cs.evm_band(evm_cuda.yiq_pyrdown(frames[:n]), cfg)
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    ok = True
    if not args.nocheck:
        checks = {}
        cases = {"1920x1080": frames[:n], "1280x720": frames[:n, :720, :1280],
                 "1000x1080": frames[:n, :, :1000],
                 "130x75": frames[:4, :75, :130],
                 "1917x1079": frames[:8, :1079, :1917]}
        for name, x in cases.items():
            x = x.contiguous()
            band = cs.evm_band(evm_cuda.yiq_pyrdown(x), cfg)
            rand = torch.rand(band.shape, generator=gen, device=dev) - 0.5
            for bname, b in (("pipeline", band), ("random +-0.5", rand)):
                for layout in ("interleaved", "planar"):
                    planar = evm_cuda.to_planar(x)
                    if layout == "planar":
                        planar = planar.contiguous()
                    vec = counter("k7.vec")
                    got = k7.evm_reconstruct(planar, b)
                    vec = counter("k7.vec") > vec
                    again = k7.evm_reconstruct(planar, b)
                    want = k7.evm_reconstruct_plain(planar, b)
                    generic = (k7.evm_reconstruct(planar, b,
                                                  instance="generic")
                               if vec else got)
                    torch.cuda.synchronize()
                    mx, frac = cs.u8_diff(got, want)
                    same = torch.equal(got, generic)
                    twice = torch.equal(got, again)
                    good = mx <= 1 and frac <= cs.K7_MAX_FRAC and same \
                        and twice
                    key = f"{name} {bname} {layout}"
                    checks[key] = {"vectorised": vec, "max_diff": mx,
                                   "share": frac, "equal_to_generic": same,
                                   "same_bits_twice": twice}
                    ok = ok and good
                    print(f"[check] K7 {'vectorised' if vec else 'generic'}"
                          f" == plain at {key} x {x.shape[0]}: max |diff| "
                          f"{mx} u8 on {frac:.3g}; == generic bit for bit "
                          f"{same}; a second launch the same bits {twice}",
                          flush=True)
        if parent is not None:
            x = frames[:n]
            rand = torch.rand(band64.shape, generator=gen, device=dev) - 0.5
            for bname, b in (("pipeline", band64), ("random +-0.5", rand)):
                for layout in ("interleaved", "planar"):
                    planar = evm_cuda.to_planar(x)
                    if layout == "planar":
                        planar = planar.contiguous()
                    same = torch.equal(k7.evm_reconstruct(planar, b),
                                       parent(planar, b))
                    checks[f"parent_bit_equal {bname} {layout}"] = same
                    ok = ok and same
                    print(f"[check] K7 == the parent's K7 bit for bit at "
                          f"1920x1080 x {n}, {bname} band, {layout}: {same}",
                          flush=True)
        res["checks"] = checks

    frame_bytes = cs.H * cs.W * 3
    times = {}
    for t in SIZES:
        x = frames[:t]
        band = band64 if t == n else cs.evm_band(evm_cuda.yiq_pyrdown(x),
                                                 cfg)
        planar = evm_cuda.to_planar(x)
        inner = 10 if t <= 64 else 3
        nbytes = 2 * t * frame_bytes + band.numel() * 4
        rec = {"bound_ms": cs.bound(nbytes, 70 * t * cs.H * cs.W)[0]}
        runs = [("this", lambda: k7.evm_reconstruct(planar, band))]
        if parent is not None:
            runs = ([("parent", lambda: parent(planar, band))] + runs + runs
                    + [("parent", lambda: parent(planar, band))])
        for who, fn in runs:
            rec.setdefault(who, []).append(kernel_ms(cs, "evm_reconstruct",
                                                     fn, inner))
        dst = torch.empty_like(x)
        rec["copy_ms"] = cs.cuda_ms(lambda: dst.copy_(x), reps=5,
                                    inner=inner, queue_ahead=True)
        del dst
        best = min(r["ms"] for r in rec["this"])
        rec["share_of_bound"] = rec["bound_ms"] / best
        rec["GBps"] = nbytes / best / 1e6
        print(f"[time] K7 at {cs.W}x{cs.H} x {t}: {json.dumps(rec)}",
              flush=True)
        times[t] = rec
        del band
    res["k7"] = times

    if args.paths:
        from vhr_tpu_torch.pipeline import evm

        clip = frames[:cs.EVM_T]
        own = evm.evm_reconstruct
        runs = [("this", own)]
        if parent is not None:
            runs = [("parent", parent)] + runs + runs + [("parent", parent)]
        res["paths"] = {}
        for who, recon in runs:
            evm.evm_reconstruct = recon

            def mag():
                return evm.magnify(clip, cs.FPS, cfg, use_pallas=True)
            ms = cs.cuda_ms(mag)
            busy, top = cs.device_profile(mag, 40)
            k7_ms = sum(t for k, t, _ in top if "evm_reconstruct" in k)
            rec = {"ms": ms, "busy_ms": busy, "k7_ms": k7_ms,
                   "k7_share_of_busy": k7_ms / busy if busy else None}
            print(f"[time] magnify T={cs.EVM_T} with {who}'s K7: "
                  f"{json.dumps(rec)}", flush=True)
            res["paths"].setdefault(who, []).append(rec)
        evm.evm_reconstruct = own
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
