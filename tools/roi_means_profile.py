#!/usr/bin/env python3
"""Check and time kernels K2 and K3 (``csrc/roi_means.cu``, the ROI channel
means) alone on one CUDA card, at the sizes the paths launch them:
``chip_smoke.py``'s seeded 1080p face clip and its cheek ROIs at 960
frames (K2 in the detect-then-reduce form, K3 on a whole clip) and 256
(a stream's chunk, K3), and the skin-detector pool's 64 slots of 720p with
the cheek ROIs the pool tick takes from them (K2); and K1 at 960 frames,
whose third launch is the K2 entry.

    python3 tools/roi_means_profile.py [label] [--parent DIR]
                                       [--probe NAME]... [--sweep]
                                       [--paths] [--nocheck]

Run it from the root of the checkout; it builds the kernels, which takes
seconds.  ``--parent DIR`` builds ``DIR/vhr_tpu_torch/csrc``'s
``roi_means.cu``, ``roi_means_batched.cu`` and ``fused_detect.cu`` alone
into one library whose C interfaces take no launch plan (K2's ends
``(..., T, H, W, C, stream)``), holds this checkout's K2, K3 and K1 equal to
it bit for bit, and times the two in turns inside this process (parent,
this, this, parent), each through this checkout's wrappers.  ``--probe
NAME`` also builds this checkout's ``roi_means.cu`` alone with ``-DNAME``
and times it in the same turns: ``ROI_PROBE_NO_CLUSTER`` (the bands of a
frame not combined: not right) bounds what any combine costs,
``ROI_PROBE_ATOMICS`` combines them by 64-bit atomics instead of a
cluster, ``ROI_PROBE_L2_256B`` adds an L2 prefetch hint to the loads (both
right, and checked).  ``--sweep`` times every case at 1, 2, 3, 4, 6 and 8
bands a frame on this build and the probes.  ``--paths`` times the detect-then-reduce form of the offline
measure at 1080p x 960 and the skin pool's tick at 64 x 720p by events,
with the parent's kernels in turns where ``--parent`` is given.

1. The ``-Xptxas -v`` lines of every K2/K3 instance: registers, spills and
   shared memory.
2. (Unless ``--nocheck``.)  Each case on the vectorised and the generic
   instance, through the K2 and the K3 entry, against the plain version,
   means and counts bit for bit; with ``--parent`` the parent's K2 and K3
   and K1's outputs too.
3. Milliseconds a launch by CUDA events with the card's queue filled ahead
   (the card alone), and once paced by the host; the generic instance
   beside the vectorised one; the bound (the ROI bytes over 3.35 TB/s); a
   contiguous ``torch.sum`` over as many bytes, the practical ceiling.

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


class ParentLib:
    """The parent's kernels behind this checkout's C interfaces: the launch
    plan's four arguments are dropped."""

    def __init__(self, so: ctypes.CDLL):
        P, L, I, F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float)
        sigs = {"vhr_roi_means_u8": [P, P, P, I, P, P, I, I, I, I, P],
                "vhr_roi_means_batched_u8": [P, L, L, P, P, P, I, I, I, I,
                                             P],
                "vhr_fused_detect_roi": ([P] + [I] * 11 + [F, I] + [F] * 9
                                         + [I] + [P] * 11)}
        for name, argtypes in sigs.items():
            fn = getattr(so, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        self.so = so

    def vhr_roi_means_u8(self, *a):
        return self.so.vhr_roi_means_u8(*a[:10], a[-1])

    def vhr_roi_means_batched_u8(self, *a):
        return self.so.vhr_roi_means_batched_u8(*a[:10], a[-1])

    def vhr_fused_detect_roi(self, *a):
        # The plan follows ``hold`` (argument 23).
        return self.so.vhr_fused_detect_roi(*a[:24], *a[28:])


def build_alone(sources, flags, tag: str) -> ctypes.CDLL:
    """``sources`` compiled into one library under ``build/``."""
    from vhr_tpu_torch import _build

    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.read_bytes())
    out_dir = HERE / "build" / "roi_means_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{tag}_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        proc = subprocess.run([_build._nvcc(), *flags, "-shared", "-o",
                               str(lib), *map(str, sources)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{tag} build failed:\n{proc.stdout[-3000:]}"
                               f"{proc.stderr[-3000:]}")
    return ctypes.CDLL(str(lib))


@contextlib.contextmanager
def using(lib):
    """Route the K1/K2/K3 wrappers' launches to ``lib`` (None: this
    checkout's library)."""
    from vhr_tpu_torch import _build
    from vhr_tpu_torch.ops import fused_cuda, roi_means_cuda

    if lib is None:
        yield
        return
    ns = types.SimpleNamespace(library=lambda: lib, check=_build.check)
    saved = roi_means_cuda._build, fused_cuda._build
    roi_means_cuda._build = fused_cuda._build = ns
    try:
        yield
    finally:
        roi_means_cuda._build, fused_cuda._build = saved


def build_report(lib: Path) -> list:
    """Each K2/K3 instance's registers, spills and shared memory."""
    text = lib.with_suffix(".log").read_text().splitlines()
    out = []
    for i, line in enumerate(text):
        m = re.search(r"(roi_means_\w+_kernelILi(\d)E)", line)
        if "Compiling" in line and m:
            used = " ".join(s.strip().replace("ptxas info    : ", "")
                            for s in text[i + 1:i + 4]
                            if "Used" in s or "spill" in s)
            out.append(f"{m.group(1)[:-5]}<{m.group(2)}>: {used}")
            print(f"[build] {out[-1]}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", default="this")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--probe", action="append", default=[])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--nocheck", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    import torch
    from vhr_tpu_torch import _build
    from vhr_tpu_torch.config import PipelineConfig
    from vhr_tpu_torch.ops import fused_cuda, roi, roi_means_cuda as rm
    from vhr_tpu_torch.ops.reduce import roi_channel_means
    from vhr_tpu_torch.pipeline.live import LiveConfig

    if not torch.cuda.is_available():
        print("roi_means_profile: needs a CUDA card", file=sys.stderr)
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
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    libs = {"this": None}
    if args.parent:
        src = Path(args.parent).resolve() / "vhr_tpu_torch" / "csrc"
        libs["parent"] = ParentLib(build_alone(
            [src / "roi_means.cu", src / "roi_means_batched.cu",
             src / "fused_detect.cu"], flags, "parent"))
    for define in args.probe:
        probe = build_alone([_build.CSRC / "roi_means.cu"],
                            flags + [f"-D{define}"], define.lower())
        for name, argtypes in _build._SIGNATURES.items():
            if name.startswith("vhr_roi_means"):
                fn = getattr(probe, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[define] = probe
    probes = list(args.probe)

    cfg = PipelineConfig()
    frames, truth = cs.make_clip(dev, cs.T, cs.H, cs.W)
    clip_rois = roi.cheek_roi(truth, cfg.roi, cs.W, cs.H)
    subj = cs.Subjects(dev, cs.SLOTS, cs.PH, cs.PW, cs.SEED + 4)
    slots = subj.frames(range(cs.SLOTS), [0] * cs.SLOTS)
    slot_rois = cs.pool_rois(slots, LiveConfig(fps=cs.FPS))
    chunk = cs.STREAM_CHUNK
    k2, k3 = rm.roi_channel_means_cuda, rm.roi_channel_means_batched_cuda
    cases = {
        f"K3 {chunk} x 1080p": (k3, frames[:chunk], clip_rois[:chunk]),
        f"K3 {cs.T} x 1080p": (k3, frames, clip_rois),
        f"K2 {cs.T} x 1080p": (k2, frames, clip_rois),
        f"K2 {cs.SLOTS} x 720p pool": (k2, slots, slot_rois)}
    torch.cuda.synchronize()
    ok = True
    if not args.nocheck:
        checks = {}
        for name, (fn, x, rois) in cases.items():
            want = roi_channel_means(x, rois)
            for entry in (k2, k3):
                for instance in ("vector", "generic"):
                    got = entry(x, rois, instance=instance)
                    torch.cuda.synchronize()
                    same = all(torch.equal(g, w) for g, w in zip(got, want))
                    key = (f"{name} via {entry.__name__} {instance} == "
                           f"plain")
                    checks[key] = same
            if "parent" in libs:
                got = fn(x, rois)
                with using(libs["parent"]):
                    old = fn(x, rois)
                torch.cuda.synchronize()
                checks[f"{name} == parent"] = all(
                    torch.equal(g, w) for g, w in zip(got, old))
            for define in probes:
                if "NO_CLUSTER" not in define:
                    with using(libs[define]):
                        got = fn(x, rois)
                        again = fn(x, rois)
                    torch.cuda.synchronize()
                    checks[f"{name} {define} == plain, twice"] = all(
                        torch.equal(g, w) and torch.equal(a, w)
                        for g, a, w in zip(got, again, want))
        flag = dict(detect_row_pool=8)
        carry = fused_cuda.init_carry(dev)
        if "parent" in libs:
            got = fused_cuda.fused_detect_roi_carry(frames, carry, **flag)
            with using(libs["parent"]):
                old = fused_cuda.fused_detect_roi_carry(frames, carry,
                                                        **flag)
            torch.cuda.synchronize()
            checks[f"K1 {cs.T} x 1080p == parent"] = all(
                torch.equal(g, w) for g, w in zip(tuple(got[0]) + (got[1],),
                                                  tuple(old[0]) + (old[1],)))
        for key, same in checks.items():
            print(f"[check] {key}: {same}", flush=True)
        ok = all(checks.values())
        res["checks"] = checks

    order = ["this"]
    if "parent" in libs:
        order = ["parent", "this", "this", "parent"]
    for define in probes:
        order += [define, define]
    times = {}
    for name, (fn, x, rois) in cases.items():
        T = x.shape[0]
        h, w = x.shape[1:3]
        nbytes = cs.roi_bytes(rois, h, w)
        rec = {"roi_MB": nbytes / 1e6,
               "bound_ms": cs.bound(nbytes + T * 32, nbytes)[0],
               "plan": rm.roi_plan(T, h, w, 3, x.stride(0), x.stride(1), 16,
                                   rm.sm_count(0))._asdict()}
        for who in order:
            with using(libs[who]):
                rec.setdefault(who, []).append(cs.cuda_ms(
                    lambda: fn(x, rois), reps=5, inner=10,
                    queue_ahead=True))
        rec["this_paced"] = cs.cuda_ms(lambda: fn(x, rois), reps=5,
                                       inner=10)
        rec["generic"] = cs.cuda_ms(lambda: fn(x, rois, instance="generic"),
                                    reps=5, inner=10, queue_ahead=True)
        flat = torch.ones(nbytes // 4, dtype=torch.float32, device=dev)
        rec["torch_sum_ms"] = cs.cuda_ms(flat.sum, reps=5, inner=10,
                                         queue_ahead=True)
        del flat
        best = min(rec["this"])
        rec["share_of_bound"] = rec["bound_ms"] / best
        rec["GBps"] = nbytes / best / 1e6
        if args.sweep:
            rec["sweep"] = {}
            plan_fn = rm.roi_plan
            for who in ["this"] + probes:
                for b in (1, 2, 3, 4, 6, 8):
                    rm.roi_plan = (lambda *a, b=b, **k: plan_fn(*a, **k)
                                   ._replace(bands=b, grid=a[0] * b))
                    try:
                        with using(libs[who]):
                            rec["sweep"][f"{who} bands={b}"] = cs.cuda_ms(
                                lambda: fn(x, rois), reps=5, inner=10,
                                queue_ahead=True)
                    finally:
                        rm.roi_plan = plan_fn
        print(f"[time] {name}: {json.dumps(rec)}", flush=True)
        times[name] = rec
    flag = dict(detect_row_pool=8)
    carry = fused_cuda.init_carry(dev)
    rec = {}
    for who in [o for o in order if o not in probes]:
        with using(libs[who]):
            rec.setdefault(who, []).append(cs.cuda_ms(
                lambda: fused_cuda.fused_detect_roi_carry(frames, carry,
                                                          **flag),
                reps=5, inner=10, queue_ahead=True))
    print(f"[time] K1 {cs.T} x 1080p, detect_row_pool=8: {json.dumps(rec)}",
          flush=True)
    times[f"K1 {cs.T} x 1080p"] = rec
    res["times"] = times

    if args.paths:
        from vhr_tpu_torch import serving
        from vhr_tpu_torch.pipeline import offline

        pool = serving.BpmServer(LiveConfig(fps=cs.FPS, use_fused=False),
                                 n_slots=cs.SLOTS)
        for _ in range(cs.SLOTS):
            pool.attach()
        on_card = {s: slots[s] for s in range(cs.SLOTS)}
        for _ in range(3):
            pool.tick(on_card)
        paths = {}
        for who in [o for o in order if o not in probes]:
            with using(libs[who]):
                ms = cs.cuda_ms(lambda: offline.measure_green_avg(
                    frames, cs.FPS, cfg, use_pallas="roi"))
                tick = cs.cuda_ms(lambda: pool.tick_async(on_card),
                                  inner=10)
            paths.setdefault(who, []).append(
                {"detect_then_reduce_ms": ms, "skin_tick_ms": tick})
            print(f"[time] paths with {who}'s kernels: "
                  f"{json.dumps(paths[who][-1])}", flush=True)
        res["paths"] = paths
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
