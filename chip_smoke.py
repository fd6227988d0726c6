#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``vhr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. build the CUDA kernels from ``vhr_tpu_torch/csrc`` (nvcc, sm_90a);
2. make a 1080p, T=960 (32 s at 30 fps) face clip on the card from a
   seeded ``torch.Generator``: a skin ellipse on a dark background whose
   green channel pulses at 72 BPM, with a small sway and sensor noise;
3. hold each kernel against its plain PyTorch version on that clip: K2 on
   the clip's cheek ROIs plus random and degenerate ROIs, K1 over its knobs
   (row pooling, detection cadence, gating, multi-stream ``seq_len``);
   integer outputs must be equal, means within ``rtol=1e-6``;
4. drive the offline green-channel measure at the flagship configuration
   (30 s window / 10 s acquisition) in both forms — fused (K1,
   ``detect_row_pool=8``) and detect-then-reduce with the K2 ROI kernel —
   with the launch counters reset just before: every kernel must have been
   launched, >= 95% of post-acquisition frames valid, and the BPM within
   0.5 BPM (MAE) of the frame-at-a-time numpy reference run on the port's
   own green trace;
5. time both forms and each kernel against its plain version with CUDA
   events (median of 3 after a warm-up, frames resident on the card).

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

SEED = 0
FPS = 30.0
T, H, W = 960, 1080, 1920
TRUTH_BPM = 72.0
MEANS_RTOL, MEANS_ATOL = 1e-6, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def make_clip(device, t: int, h: int, w: int, seed: int = SEED,
              chunk: int = 64):
    """``(t, h, w, 3)`` u8 BGR face clip made on ``device`` from a seed,
    and its ``(t, 4)`` int32 ground-truth face boxes (inclusive ends)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    frames = torch.empty((t, h, w, 3), dtype=torch.uint8, device=device)
    boxes = torch.empty((t, 4), dtype=torch.int32, device=device)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    rx, ry, cy = 0.16 * w, 0.26 * h, 0.45 * h
    bg = torch.tensor([60.0, 60.0, 60.0], device=device)
    skin = torch.tensor([105.0, 135.0, 180.0], device=device)
    for s in range(0, t, chunk):
        n = min(chunk, t - s)
        ts = torch.arange(s, s + n, device=device, dtype=torch.float32) / FPS
        cx = 0.5 * w + 4.0 * torch.sin(2 * math.pi * 0.1 * ts)   # sway, px
        pulse = 2.0 * torch.sin(2 * math.pi * TRUTH_BPM / 60.0 * ts)
        face = (((xx - cx[:, None, None]) / rx) ** 2
                + ((yy - cy) / ry) ** 2) <= 1.0                    # (n, h, w)
        color = skin.expand(n, 3).clone()
        color[:, 1] += pulse
        img = torch.where(face[..., None], color[:, None, None, :], bg)
        img += torch.randint(0, 8, (n, h, w, 3), generator=gen,
                             device=device).to(torch.float32)
        frames[s:s + n] = img.clamp(0, 255).to(torch.uint8)
        col_any, row_any = face.any(1), face.any(2)
        ci = torch.arange(w, device=device).expand(n, w)
        ri = torch.arange(h, device=device).expand(n, h)
        boxes[s:s + n] = torch.stack([
            torch.where(col_any, ci, w).amin(1),
            torch.where(row_any, ri, h).amin(1),
            torch.where(col_any, ci, -1).amax(1),
            torch.where(row_any, ri, -1).amax(1)], -1).to(torch.int32)
    return frames, boxes


def compare(name: str, got, want) -> float:
    """Equal integer/bool fields, means within tolerance; max |err|."""
    import torch

    err = 0.0
    for g, w_ in zip(got, want):
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w_, rtol=MEANS_RTOL,
                                       atol=MEANS_ATOL, msg=name)
            err = max(err, float((g - w_).abs().max()))
        elif not torch.equal(g, w_):
            bad = (g != w_).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: integer outputs differ at {bad}")
    return err


def cuda_ms(fn, reps: int = 3, inner: int = 1) -> float:
    """Median milliseconds per call over ``reps`` timed runs of ``inner``
    calls each, after one warm-up call, from CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    from vhr_tpu.config import PipelineConfig
    from vhr_tpu.validation import cpu_reference_green_avg
    from vhr_tpu_torch import _build
    from vhr_tpu_torch.ops import fused_cuda, roi, roi_means_cuda
    from vhr_tpu_torch.ops import windows as vwin
    from vhr_tpu_torch.ops.reduce import roi_channel_means
    from vhr_tpu_torch.pipeline import offline

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}")

    # 1. Build.
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    # 2. The clip, on the card.
    t0 = time.perf_counter()
    frames, truth_boxes = make_clip(dev, T, H, W)
    torch.cuda.synchronize()
    log(f"[clip] {tuple(frames.shape)} u8 made on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    # 3. Kernels against their plain versions, on the card.
    cfg = PipelineConfig()
    clip_rois = roi.cheek_roi(truth_boxes, cfg.roi, W, H)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x1 = torch.randint(-20, W, (T,), generator=gen, device=dev)
    y1 = torch.randint(-20, H, (T,), generator=gen, device=dev)
    rand_rois = torch.stack([x1, y1,
                             x1 + torch.randint(-5, 800, (T,), generator=gen,
                                                device=dev),
                             y1 + torch.randint(-5, 400, (T,), generator=gen,
                                                device=dev)], -1)
    rand_rois[:8] = torch.tensor([0, 0, 0, 0], device=dev)
    rand_rois[8:16] = torch.tensor([100, 200, 50, 300], device=dev)
    rand_rois[16:24] = torch.tensor([-50, -40, W + 50, H + 40], device=dev)
    k2_err = 0.0
    for name, rois_ in [("clip", clip_rois), ("random", rand_rois)]:
        got = roi_means_cuda.roi_channel_means_cuda(frames, rois_)
        want = roi_channel_means(frames, rois_)
        torch.cuda.synchronize()
        k2_err = max(k2_err, compare(f"K2 {name} rois", got, want))
    log(f"[check] K2 == plain on clip and random/degenerate ROIs "
        f"(max |err| {k2_err:.3g})")

    k1_err = 0.0
    configs = [dict(detect_row_pool=p, detect_every=d, gate_margin=g)
               for p in (1, 8) for d in (1, 4) for g in (None, 0.5)]
    configs.append(dict(detect_row_pool=8, gate_margin=0.5, seq_len=480))
    for kw in configs:
        carry = fused_cuda.init_carry(dev)
        got, got_c = fused_cuda.fused_detect_roi_carry(frames, carry, **kw)
        want, want_c = fused_cuda.fused_detect_roi_plain(frames, carry, **kw)
        torch.cuda.synchronize()
        k1_err = max(k1_err, compare(f"K1 {kw}", tuple(got) + (got_c,),
                                     tuple(want) + (want_c,)))
        log(f"[check] K1 == plain {kw}: det_valid {int(got.det_valid.sum())}"
            f"/{T}, roi_valid {int(got.roi_valid.sum())}/{T}")

    # 4. The main path at the flagship configuration, counters from 0.
    acq, win = cfg.acquisition_len(FPS), cfg.window_len(FPS)
    roi_means_cuda.LAUNCHES = 0
    fused_cuda.LAUNCHES = 0

    def fused_form():
        trace = offline.extract_signals_fused(frames, cfg,
                                              detect_row_pool=8)
        green = offline._fill_invalid(trace.bgr[:, cfg.channel], trace.valid)
        rolling = vwin.rolling_bpm_fft(green, FPS, cfg.band, win, acq)
        return (green, rolling.bpm.cpu().numpy(),
                (rolling.valid & trace.valid).cpu().numpy())

    def xla_form():
        _, bpm, valid = offline.measure_green_avg(frames, FPS, cfg,
                                                  use_pallas="roi")
        return bpm, valid

    results = {"fused": fused_form(), "roi": xla_form()}
    # The green trace that measure_green_avg estimated from, for the
    # numpy reference below.
    trace = offline.extract_signals(frames, cfg, use_pallas="roi")
    results["roi"] = (offline._fill_invalid(trace.bgr[:, cfg.channel],
                                            trace.valid),) + results["roi"]
    torch.cuda.synchronize()
    launches = {"K1": fused_cuda.LAUNCHES, "K2": roi_means_cuda.LAUNCHES}
    log(f"[main] kernel launches in the main-path run: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    for form, (green, bpm, valid) in results.items():
        n_valid, expect = int(valid.sum()), T - acq
        if n_valid < 0.95 * expect:
            raise AssertionError(f"{form}: {n_valid} valid of {expect}")
        if not all(map(math.isfinite, bpm.tolist())):
            raise AssertionError(f"{form}: non-finite BPM")
        ref = cpu_reference_green_avg(green.cpu().numpy(), FPS,
                                      cfg.window_seconds,
                                      cfg.acquisition_seconds, cfg.band)
        idx = [i for i in ref if valid[i]]
        mae_ref = sum(abs(float(bpm[i]) - ref[i]) for i in idx) / len(idx)
        mae_truth = float(abs(bpm[valid] - TRUTH_BPM).mean())
        log(f"[main] {form}: valid {n_valid}/{expect} post-acquisition "
            f"frames; BPM MAE vs numpy reference {mae_ref:.4f} over "
            f"{len(idx)} frames; vs {TRUTH_BPM:g} BPM truth {mae_truth:.4f}")
        if len(idx) < 0.95 * n_valid or mae_ref > 0.5:
            raise AssertionError(f"{form}: MAE vs reference {mae_ref} "
                                 f"over {len(idx)} frames")

    # 5. Timing (CUDA events, frames resident on the card).
    log(f"[time] card: {card}")
    ms = {"fused": cuda_ms(fused_form), "roi": cuda_ms(xla_form)}
    for form, t_ms in ms.items():
        log(f"[time] {form} form end to end: {t_ms:.3f} ms / {T} frames = "
            f"{T / (t_ms / 1e3):.1f} frames/s, {t_ms * 1e3 / T:.3f} us/frame")
    flag = dict(detect_row_pool=8)
    carry0 = fused_cuda.init_carry(dev)
    k1_ms = cuda_ms(lambda: fused_cuda.fused_detect_roi_carry(
        frames, carry0, **flag), inner=10)
    k1_plain = cuda_ms(lambda: fused_cuda.fused_detect_roi_plain(
        frames, carry0, **flag))
    k2_ms = cuda_ms(lambda: roi_means_cuda.roi_channel_means_cuda(
        frames, clip_rois), inner=10)
    k2_plain = cuda_ms(lambda: roi_channel_means(frames, clip_rois))
    for k, a, b in [("K1", k1_ms, k1_plain), ("K2", k2_ms, k2_plain)]:
        log(f"[time] {k}: kernel {a:.3f} ms ({a * 1e3 / T:.3f} us/frame), "
            f"plain {b:.3f} ms ({b * 1e3 / T:.3f} us/frame)")

    if "jax" in sys.modules:
        raise AssertionError("the port's smoke run imported jax")
    record = {"kernels": [
        {"name": "fused_detect_roi (K1)", "route": "cuda",
         "source": "vhr_tpu_torch/csrc/fused_detect.cu",
         "replaces": "vhr_tpu/ops/pallas_fused.py:385",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "roi_channel_means (K2)", "route": "cuda",
         "source": "vhr_tpu_torch/csrc/roi_means.cu",
         "replaces": "vhr_tpu/ops/pallas_roi.py:167",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
