#!/usr/bin/env python3
"""Check and time kernel K1 (``fused_detect_roi_carry``, the fused form's
kernel) alone on one CUDA card, on ``chip_smoke.py``'s seeded 1080p face
clip: at 960 frames (the flagship's launch) and on one 256-frame chunk (a
stream's launch), with the flagship's knobs (``detect_row_pool=8``,
ungated) and gated (``gate_margin=0.15``, the fused farm's).

    python3 tools/k1_profile.py [label] [--parent DIR] [--paths]
                                [--nocheck]

Run it from the root of the checkout; it builds the kernels, which takes
seconds.  ``--parent DIR`` builds ``DIR/vhr_tpu_torch/csrc``'s
``fused_detect.cu``, ``roi_means.cu`` and ``fused_slots.cu`` alone (a K1
whose scratch is the column counts ``(t_len, n_chunks, W)``, the chunk
stats and the frame extents), holds this checkout's K1, and K4 on the
serving pool's 64 slots of 720p, equal to it bit for bit, and times the
two K1s in turns inside this process (parent, this, this, parent), each
through this checkout's wrappers.

1. The ``-Xptxas -v`` lines of K1's and K4's kernels: registers, spills
   and shared memory.
2. (Unless ``--nocheck``.)  K1 against its plain version, every output bit
   for bit, at 1080p over row pooling 1, 2, 4 and 8, gated and not, on a
   256-frame chunk, on two chained launches, and from a base off the
   16-byte grid; with ``--parent`` the parent's K1 on the same cases.
3. Each launch of a call under ``torch.profiler`` (the split of K1's
   time among its kernels), for each build.
4. Milliseconds a call by CUDA events with the card's queue filled ahead
   (the card alone) and paced by the host, also without row pooling (the
   other measures' and ``entry()``'s launch), beside the bound (every frame
   byte read once over 3.35 TB/s) and a ``torch.sum`` over as many bytes,
   the practical ceiling.
5. With ``--paths``: the fused form of the offline measure at 1080p x 960
   (``extract_signals_fused`` and the rolling BPM) by events, paced by the
   host and with the queue filled ahead, and the card's busy time under
   the profiler, over four rounds of turns with the parent's K1 where
   ``--parent`` is given; every run is printed.

Prints the card's name and power limit first, and last one line of JSON
with every time.  Needs a CUDA card.
"""

import argparse
import contextlib
import ctypes
import hashlib
import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
CHUNK = 256
PATH_ROUNDS = 4     # turns of (parent, this, this, parent) for --paths


class ParentLib:
    """The parent's K1 behind this checkout's C interface: the skin pass's
    instance, summary and ready counts give way to the parent's column
    counts, chunk stats and frame extents, made here.  K4's interface is
    the same in both."""

    def __init__(self, so: ctypes.CDLL):
        from vhr_tpu_torch import _build

        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = so.vhr_fused_detect_roi
        fn.argtypes = [P] + [I] * 11 + [F, I] + [F] * 9 + [I] * 5 + [P] * 11
        fn.restype = I
        self.vhr_fused_detect_roi_slots = so.vhr_fused_detect_roi_slots
        self.vhr_fused_detect_roi_slots.argtypes = _build._SIGNATURES[
            "vhr_fused_detect_roi_slots"]
        self.vhr_fused_detect_roi_slots.restype = I
        self.so = so

    def vhr_fused_detect_roi(self, *a):
        import torch

        t_len, W, n_chunks = a[2], a[5], a[7]
        scratch = [torch.empty(n, dtype=torch.int32, device="cuda")
                   for n in (t_len * n_chunks * W, t_len * n_chunks * 3,
                             t_len * 5)]
        # This interface adds the skin instance after ``hold`` (argument
        # 23), and the summary and ready counts after the carries.
        return self.so.vhr_fused_detect_roi(
            *a[:24], *a[25:31], *(s.data_ptr() for s in scratch), *a[33:])


def build_alone(sources, flags, tag: str) -> ctypes.CDLL:
    """``sources`` compiled into one library under ``build/``."""
    from vhr_tpu_torch import _build

    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.read_bytes())
    out_dir = HERE / "build" / "k1_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{tag}_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        proc = subprocess.run([_build._nvcc(), *flags, "-Xptxas", "-v",
                               "-shared", "-o", str(lib),
                               *map(str, sources)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{tag} build failed:\n{proc.stdout[-3000:]}"
                               f"{proc.stderr[-3000:]}")
        lines = (proc.stdout + proc.stderr).splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m and ("kernel" in m.group(1)):
                used = " ".join(x.strip() for x in lines[i + 1:i + 3])
                print(f"[build] {tag} {m.group(1)[:110]}: {used}",
                      flush=True)
    return ctypes.CDLL(str(lib))


@contextlib.contextmanager
def using(lib):
    """Route K1's launches to ``lib`` (None: this checkout's library)."""
    from vhr_tpu_torch import _build
    from vhr_tpu_torch.ops import fused_cuda

    if lib is None:
        yield
        return
    saved = fused_cuda._build
    fused_cuda._build = types.SimpleNamespace(library=lambda: lib,
                                              check=_build.check)
    try:
        yield
    finally:
        fused_cuda._build = saved


def build_report(lib: Path) -> list:
    """Registers, spills and shared memory of fused_detect.cu's and
    fused_slots.cu's kernels."""
    text = lib.with_suffix(".log").read_text().splitlines()
    out, inside = [], False
    for i, line in enumerate(text):
        if line.startswith(("/", "nvcc")) or " -c -o " in line:
            inside = "fused_detect" in line or "fused_slots" in line
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if inside and m:
            used = " ".join(s.strip().replace("ptxas info    : ", "")
                            for s in text[i + 1:i + 4]
                            if "Used" in s or "spill" in s)
            out.append(f"{m.group(1)}: {used}")
            print(f"[build] {out[-1]}", flush=True)
    return out


def kernel_split(fn, calls: int = 10) -> dict:
    """Each kernel's milliseconds and launches a call of ``fn`` under the
    profiler, and the card's busy time a call."""
    import chip_smoke as cs

    def run():
        for _ in range(calls):
            fn()

    busy, top = cs.device_profile(run, top=12)
    if busy is None:
        return {"traced": False}
    return {"busy_ms": busy / calls,
            "kernels": {name[:80]: [ms / calls, n / calls]
                        for name, ms, n in top}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", default="this")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--nocheck", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    import torch
    from vhr_tpu_torch import _build
    from vhr_tpu_torch.config import PipelineConfig
    from vhr_tpu_torch.ops import fused_cuda as fc

    if not torch.cuda.is_available():
        print("k1_profile: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    res = {"label": args.label, "card": card,
           "build": build_report(lib_path)}
    libs = {"this": None}
    if args.parent:
        src = Path(args.parent).resolve() / "vhr_tpu_torch" / "csrc"
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        libs["parent"] = ParentLib(build_alone(
            [src / "fused_detect.cu", src / "roi_means.cu",
             src / "fused_slots.cu"], flags, "parent"))
    order = (["parent", "this", "this", "parent"] if "parent" in libs
             else ["this"])

    frames, _ = cs.make_clip(dev, cs.T, cs.H, cs.W)
    carry = fc.init_carry(dev)
    flag = dict(detect_row_pool=8)
    gated = dict(detect_row_pool=8, gate_margin=0.15)
    torch.cuda.synchronize()

    def k1(x, **kw):
        return fc.fused_detect_roi_carry(x, carry, **kw)

    ok = True
    if not args.nocheck:
        # A base off the 16-byte grid takes the scalar skin pass.
        n_off = 64
        buf = torch.empty(n_off * cs.H * cs.W * 3 + 1, dtype=torch.uint8,
                          device=dev)
        off = buf[1:].view(n_off, cs.H, cs.W * 3)
        off.copy_(frames[:n_off].reshape(n_off, cs.H, cs.W * 3))
        cases = [(f"{cs.T} x 1080p pool {p}{' gated' if g else ''}", frames,
                  dict(detect_row_pool=p, gate_margin=g))
                 for p in (1, 2, 4, 8) for g in (None, 0.15)]
        cases += [(f"{CHUNK} x 1080p pool 8", frames[:CHUNK], flag),
                  (f"{cs.T} x 1080p every 4, seq_len 480", frames,
                   dict(detect_row_pool=8, gate_margin=0.5, detect_every=4,
                        seq_len=480)),
                  (f"{n_off} x 1080p off the 16-byte grid", off, gated)]
        checks = {}

        def two_launches(fn, x, kw):
            """``fn`` over the first third of ``x``, then the rest from
            its carry."""
            s = x.shape[0] // 3
            r1, c1 = fn(x, carry, t_start=0, t_len=s, **kw)
            r2, c2 = fn(x, c1, t_start=s, **kw)
            return tuple(torch.cat([a, b]) for a, b in zip(r1, r2)) + (c2,)

        for name, x, kw in cases:
            want = fc.fused_detect_roi_plain(x, carry, **kw)
            want = tuple(want[0]) + (want[1],)
            want2 = two_launches(fc.fused_detect_roi_plain, x, kw)
            for who in libs:
                with using(libs[who]):
                    got = fc.fused_detect_roi_carry(x, carry, **kw)
                    got2 = two_launches(fc.fused_detect_roi_carry, x, kw)
                torch.cuda.synchronize()
                checks[f"{who} {name} == plain"] = all(
                    torch.equal(g, w) for g, w in zip(
                        tuple(got[0]) + (got[1],), want))
                checks[f"{who} {name}, two launches == plain"] = all(
                    torch.equal(g, w) for g, w in zip(got2, want2))
        del buf, off
        if "parent" in libs:
            # K4 on the pool's slots: fresh, then tracked by its own carry.
            subj = cs.Subjects(dev, cs.SLOTS, cs.PH, cs.PW, cs.SEED + 4)
            slots = subj.frames(range(cs.SLOTS), [0] * cs.SLOTS)
            c4 = torch.zeros((cs.SLOTS, 6), dtype=torch.int32, device=dev)
            ph = torch.arange(cs.SLOTS, dtype=torch.int32, device=dev)
            c4 = fc.fused_detect_roi_slots(slots, c4, ph)[1]
            for kw in ({}, dict(detect_row_pool=8),
                       dict(gate_margin=0.5, detect_every=2)):
                outs = {}
                for who in ("this", "parent"):
                    with using(libs[who]):
                        r, c = fc.fused_detect_roi_slots(slots, c4, ph, **kw)
                    outs[who] = tuple(r) + (c,)
                torch.cuda.synchronize()
                checks[f"K4 {cs.SLOTS} x 720p {kw} == parent"] = all(
                    torch.equal(g, w)
                    for g, w in zip(outs["this"], outs["parent"]))
            del slots
        for key, same in checks.items():
            print(f"[check] {key}: {same}", flush=True)
        ok = all(checks.values())
        res["checks"] = checks

    settings = {f"{cs.T} x 1080p, pool 8": (frames, flag),
                f"{CHUNK} x 1080p, pool 8": (frames[:CHUNK], flag),
                f"{cs.T} x 1080p, pool 8, gate 0.15": (frames, gated),
                f"{CHUNK} x 1080p, pool 8, gate 0.15": (frames[:CHUNK],
                                                         gated),
                f"{cs.T} x 1080p, pool 1": (frames, {})}
    split, times = {}, {}
    for name, (x, kw) in settings.items():
        split[name] = {}
        for who in libs:
            with using(libs[who]):
                split[name][who] = kernel_split(lambda: k1(x, **kw))
            print(f"[split] {name}, {who}: {json.dumps(split[name][who])}",
                  flush=True)
    for name, (x, kw) in settings.items():
        n = x.shape[0]
        nbytes = x.numel()
        pool = kw.get("detect_row_pool", 1)
        # Every frame byte read once, the small outputs written once; a
        # pooling add a byte and ~20 operations a pooled cell's test.
        rec = {"bound_ms": cs.bound(
            nbytes + n * (12 + 4 + 16 + 2) + 48,
            nbytes + 20 * n * (cs.H // pool) * cs.W)}
        for who in order:
            with using(libs[who]):
                rec.setdefault(who, []).append(cs.cuda_ms(
                    lambda: k1(x, **kw), reps=5, inner=10,
                    queue_ahead=True))
        for who in libs:
            with using(libs[who]):
                rec[f"{who}_paced"] = cs.cuda_ms(lambda: k1(x, **kw),
                                                 reps=5, inner=10)
        flat = torch.ones(nbytes // 4, dtype=torch.float32, device=dev)
        rec["torch_sum_ms"] = cs.cuda_ms(flat.sum, reps=5, inner=10,
                                         queue_ahead=True)
        del flat
        rec["share_of_bound"] = rec["bound_ms"][0] / min(rec["this"])
        print(f"[time] {name}: {json.dumps(rec)}", flush=True)
        times[name] = rec
    res["split"], res["times"] = split, times

    if args.paths:
        from vhr_tpu_torch.ops import windows as vwin
        from vhr_tpu_torch.pipeline import offline

        cfg = PipelineConfig()
        acq, win = cfg.acquisition_len(cs.FPS), cfg.window_len(cs.FPS)

        def fused_form():
            trace = offline.extract_signals_fused(frames, cfg,
                                                  detect_row_pool=8)
            green = offline._fill_invalid(trace.bgr[:, cfg.channel],
                                          trace.valid)
            return vwin.rolling_bpm_fft(green, cs.FPS, cfg.band, win, acq)

        # Each turn: events paced by the host, events with the queue
        # filled ahead, and the card's busy time under the profiler (its
        # work alone, whatever the host's pace).
        paths = {}
        for _ in range(PATH_ROUNDS):
            for who in order:
                with using(libs[who]):
                    rec = paths.setdefault(who, {"paced": [], "ahead": [],
                                                 "busy": []})
                    rec["paced"].append(cs.cuda_ms(fused_form, reps=5))
                    rec["ahead"].append(cs.cuda_ms(fused_form, reps=5,
                                                   queue_ahead=True))
                    rec["busy"].append(kernel_split(fused_form, calls=3)
                                       .get("busy_ms"))
        print(f"[time] fused form, {cs.T} x 1080p: {json.dumps(paths)}",
              flush=True)
        res["paths"] = paths
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
