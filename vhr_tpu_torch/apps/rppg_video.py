"""Offline video heart-rate app, the ``rppg_VIDEO.py`` equivalent.

Port of ``vhr_tpu/apps/rppg_video.py``.  The whole video is processed as one
batch on the device: the signal trace once, then the reference's three
filters (Butterworth-2, Cheby2-4, FIR-41) over every 10 s window at once,
and the results are rendered on the host: an annotated output video (face
box, cheek and forehead ROI, BPM text), a signal/BPM plot, a console trace,
and with ``--live-panels`` the reference's in-loop signal and PSD panels,
every trailing window's filters and Welch PSD computed in one batch.
``--faces K`` monitors K subjects (the chroma multi-face path, the tiled
learned detector with ``--detector landmarker*``, the skin-proposal cascade
with ``--detector refined``, or the MediaPipe multi-face detector with
``--detector mediapipe*``).

Usage::

    python -m vhr_tpu_torch.apps.rppg_video VIDEO [--out-dir DIR] [--show]
        [--live-panels] [--faces K] [--detect-every N]
        [--detector skin|landmarker|landmarker-real|refined|mediapipe
        [-bf16|-exact]] [--profile-trace DIR]
        [--device cpu]
    python -m vhr_tpu_torch.apps.rppg_video --videos-dir videos   # picker

``--device`` defaults to the CUDA card.  A host without matplotlib (the
card's machine has none) gets the video and the numbers; the PNGs are
skipped with a line in the log.  Every detector serves one face and
``--faces K``.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from ..config import BAND_VIDEO, FilterConfig, PipelineConfig, ROIConfig
from ..device import resolve_device
from ..io import video as vio
from ..pipeline import offline

_MEDIAPIPE = ("mediapipe", "mediapipe-bf16", "mediapipe-exact")
_CHOICES = ("skin|landmarker|landmarker-real|refined|mediapipe|"
            "mediapipe-bf16|mediapipe-exact")
_FILTERS = (("butterworth", 2), ("cheby2", 4), ("fir", 41))


def _resolve_detector(name: str, device=None):
    """CLI detector choice -> pipeline detector callable (or None for the
    skin detector), on ``device`` (the CUDA card by default).  The
    learned choices load the landmarker's weights: ``landmarker`` the
    synthetic-face ones, ``landmarker-real`` the real-photo-distilled ones,
    ``refined`` the synthetic-face ones with one crop refinement pass.  The
    MediaPipe choices build the bundled FaceLandmarker
    (``models.mediapipe_face.make_mediapipe_detector``): ``-bf16`` rounds
    the convs' operands to bfloat16, ``-exact`` crops with the exact
    rotation."""
    if name == "skin":
        return None
    if name == "landmarker":
        from ..models.landmarker import load_default_detector
        return load_default_detector(device=device)
    if name == "landmarker-real":
        from ..models.landmarker import load_real_distilled_detector
        return load_real_distilled_detector(device=device)
    if name == "refined":
        from ..models.cascade import load_default_refined_detector
        return load_default_refined_detector(device=device)
    if name in _MEDIAPIPE:
        from ..models.mediapipe_face import make_mediapipe_detector
        cd = torch.bfloat16 if name.endswith("bf16") else None
        cm = "exact" if name.endswith("exact") else "axis"
        return make_mediapipe_detector(compute_dtype=cd, crop_mode=cm,
                                       device=device)
    raise SystemExit(f"unknown detector {name!r} ({_CHOICES})")


def _resolve_detector_multi(name: str, k_faces: int, device=None):
    """CLI detector choice -> multi-face detector callable, or None for the
    skin chroma multiface detector (``models.multiface``), which the
    pipelines use by default.  On ``device`` (the CUDA card by default):
    ``landmarker`` and ``landmarker-real`` build the fully learned tiled
    detector (``models.cascade.make_tiled_detector_multi``) on the
    synthetic-face or the distilled weights, ``refined`` the skin-proposal
    cascade (``make_cascade_detector_multi``), and the MediaPipe choices
    ``models.mediapipe_face.make_mediapipe_detector_multi`` with the
    single-face choices' options."""
    if name == "skin":
        return None
    if name in _MEDIAPIPE:
        from ..models.mediapipe_face import make_mediapipe_detector_multi
        cd = torch.bfloat16 if name.endswith("bf16") else None
        cm = "exact" if name.endswith("exact") else "axis"
        return make_mediapipe_detector_multi(k_faces=k_faces,
                                             compute_dtype=cd, crop_mode=cm,
                                             device=device)
    if name in ("landmarker", "landmarker-real", "refined"):
        from ..models import cascade
        det = _resolve_detector("landmarker-real" if name.endswith("-real")
                                else "landmarker", device)
        make = (cascade.make_cascade_detector_multi if name == "refined"
                else cascade.make_tiled_detector_multi)
        return make(det.params, det.cfg, k_faces=k_faces, device=device)
    raise SystemExit(f"unknown detector {name!r} ({_CHOICES})")


def _read(video_path: str, device) -> tuple:
    frames, fps = vio.read_video(video_path)
    if frames.shape[0] == 0:
        raise ValueError(f"empty video: {video_path}")
    return frames, fps, torch.from_numpy(frames).to(device)


def analyze(video_path: str, detector=None, detect_every: int = 1,
            device=None) -> dict:
    """The app's three-filter analysis on ``device`` (the CUDA card by
    default) -> a dict of host numpy traces, keyed as the JAX app's:
    ``fps``, ``frames``, ``green``, ``boxes``, ``rois``, ``valid``,
    ``rois_forehead``, ``ts``, and ``bpm_<filter>``, ``valid_<filter>`` for
    ``butterworth``, ``cheby2`` and ``fir``.

    The trace is extracted once, and each filter's Welch loop
    (``offline.measure_app_welch``'s DSP) runs on it: the JAX app calls
    ``measure_app_welch`` three times, which extracts the same trace three
    times.  ``detect_every`` runs the detector on every N-th frame, with
    holdover tracking in between."""
    dev = resolve_device(device)
    frames, fps, fr = _read(video_path, dev)
    results = {"fps": fps, "frames": frames}
    trace = offline.extract_signals(fr, detector=detector,
                                    detect_every=detect_every)
    results["green"] = trace.bgr[:, 1].cpu().numpy()
    results["boxes"] = trace.boxes.cpu().numpy()
    results["rois"] = trace.rois.cpu().numpy()
    results["valid"] = trace.valid.cpu().numpy()
    # The reference's second ROI, for display (rppg_VIDEO.py:102).
    from ..ops import roi as vroi
    H, W = frames.shape[1:3]
    results["rois_forehead"] = vroi.forehead_roi(
        trace.boxes, ROIConfig(), W, H).cpu().numpy()
    # The reference's three filters over the 10 s window, Welch estimate
    # (rppg_VIDEO.py:402-409).
    for kind, order in _FILTERS:
        cfg = PipelineConfig(
            window_seconds=10.0, band=BAND_VIDEO,
            filter=FilterConfig(kind=kind, order=order, fir_numtaps=41))
        ts, bpm, valid = offline._host(fps, *offline._app_welch_bpm(
            trace.bgr, trace.valid, fps, cfg))
        results[f"bpm_{kind}"] = bpm
        results[f"valid_{kind}"] = valid
        results["ts"] = ts
    return results


def analyze_multi(video_path: str, k_faces: int, detector=None,
                  detect_every: int = 1, device=None) -> dict:
    """K-subject analysis on ``device``: per-face cheek-green traces and
    Welch BPM, as host numpy arrays keyed as the JAX app's (``green (T,
    K)``, ``boxes``/``rois (T, K, 4)``, ``valid``, ``bpm``, ``bpm_valid (T,
    K)``, ``ts``, ``fps``, ``frames``)."""
    dev = resolve_device(device)
    frames, fps, fr = _read(video_path, dev)
    cfg = PipelineConfig(window_seconds=10.0, acquisition_seconds=5.0,
                         band=BAND_VIDEO, estimator="welch")
    trace = offline.extract_signals_multi(fr, k_faces, cfg,
                                          detector=detector,
                                          detect_every=detect_every)
    ts, bpm, ok = offline.measure_green_avg_multi(fr, fps, k_faces, cfg,
                                                  trace=trace)
    return {"fps": fps, "frames": frames, "ts": ts,
            "green": trace.bgr[..., 1].cpu().numpy(),        # (T, K)
            "boxes": trace.boxes.cpu().numpy(),              # (T, K, 4)
            "rois": trace.rois.cpu().numpy(),
            "valid": trace.valid.cpu().numpy(),
            "bpm": bpm, "bpm_valid": ok}


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def render_multi(results, out_dir: str) -> None:
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    frames, fps = results["frames"], results["fps"]
    K = results["boxes"].shape[1]

    annotated = frames.copy()
    for i in range(frames.shape[0]):
        for k in range(K):
            if results["valid"][i, k]:
                x1, y1, x2, y2 = (int(v) for v in results["boxes"][i, k])
                cv2.rectangle(annotated[i], (x1, y1), (x2, y2),
                              (0, 255, 0), 2)
                rx1, ry1, rx2, ry2 = (int(v) for v in results["rois"][i, k])
                cv2.rectangle(annotated[i], (rx1, ry1), (rx2, ry2),
                              (255, 0, 0), 2)
            if results["bpm_valid"][i, k]:
                cv2.putText(annotated[i],
                            f"face{k}: {results['bpm'][i, k]:.1f} BPM",
                            (8, 20 * (k + 1)), cv2.FONT_HERSHEY_SIMPLEX,
                            0.5, (255, 255, 255), 1)
    out_path = os.path.join(out_dir, "annotated_multi.mp4")
    vio.write_video(annotated, out_path, fps)

    plt = _pyplot()
    if plt is None:
        print(f"wrote {out_path} to {out_dir}; no matplotlib, "
              f"signals_multi.png skipped")
        return
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 7), sharex=True)
    ts = results["ts"]
    for k in range(K):
        ax1.plot(ts, results["green"][:, k], lw=0.8, label=f"face{k}")
        v = results["bpm_valid"][:, k]
        ax2.plot(ts[v], results["bpm"][v, k], lw=1.2, label=f"face{k}")
    ax1.set_ylabel("cheek green mean")
    ax1.legend()
    ax2.set_xlabel("time (s)")
    ax2.set_ylabel("BPM (Welch)")
    ax2.legend()
    ax2.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "signals_multi.png"), dpi=150)
    plt.close(fig)
    print(f"wrote {out_path} and signals_multi.png to {out_dir}")


def live_panel_data(results, window_seconds: float = 10.0, device=None):
    """Every trailing window's panels for the in-loop display
    (``rppg_VIDEO.py:305-328, 385-411``, which re-filters and re-Welchs the
    trailing window each frame), computed in one batch on ``device``: all
    ``T - W + 1`` windows demeaned, through the Butterworth-2 and
    Chebyshev-II-4 ``sosfiltfilt`` and the Welch PSD at once.

    Returns ``(W, freqs, psd_butter (T', F), psd_cheby2 (T', F),
    bpm_butter (T',), bpm_cheby2 (T',))`` as host numpy, where row ``j``
    covers frames ``[j, j+W)`` (replay frame ``i`` shows row ``i - W +
    1``), or None when the clip is shorter than one window.
    """
    from ..dsp import design, filters, spectral
    from ..ops.windows import sliding_windows

    fps = float(results["fps"])
    W = int(round(window_seconds * fps))
    T = len(results["green"])
    if T < W:          # T == W still yields one full window
        return None
    g = torch.as_tensor(np.asarray(results["green"], np.float32),
                        device=resolve_device(device))
    lo, hi = BAND_VIDEO.low_hz, BAND_VIDEO.high_hz
    sos_b = design.sos_design("butterworth", fps, lo, hi, order=2)
    sos_c = design.sos_design("cheby2", fps, lo, hi, order=4)
    nperseg = min(W, int(round(4.0 * fps)))

    win = sliding_windows(g, W)                                 # (T-W+1, W)
    win = win - win.mean(-1, keepdim=True)
    fb = filters.sosfiltfilt(sos_b, win.T).T
    fc = filters.sosfiltfilt(sos_c, win.T).T
    _, pb = spectral.welch_psd(fb, fps, nperseg)
    _, pc = spectral.welch_psd(fc, fps, nperseg)
    freqs = np.fft.rfftfreq(nperseg, 1.0 / fps)
    pb, pc = pb.cpu().numpy(), pc.cpu().numpy()
    inband = (freqs >= lo) & (freqs <= hi)
    bpm_b = 60.0 * freqs[inband][np.argmax(pb[:, inband], axis=1)]
    bpm_c = 60.0 * freqs[inband][np.argmax(pc[:, inband], axis=1)]
    return W, freqs, pb, pc, bpm_b, bpm_c


def render(results, out_dir: str, show: bool = False,
           live_panels: bool = False, device=None) -> None:
    """The annotated video, the signal plot and, with ``live_panels``, the
    in-loop panels (:func:`live_panel_data` on ``device``): a
    ``live_panels.png`` snapshot when headless, drawn per frame with
    ``show``."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    frames = results["frames"]
    fps = results["fps"]

    # Annotated video: face box (green), cheek ROI (blue), BPM text.
    annotated = frames.copy()
    for i in range(frames.shape[0]):
        if results["valid"][i]:
            x1, y1, x2, y2 = (int(v) for v in results["boxes"][i])
            cv2.rectangle(annotated[i], (x1, y1), (x2, y2), (0, 255, 0), 2)
            rx1, ry1, rx2, ry2 = (int(v) for v in results["rois"][i])
            cv2.rectangle(annotated[i], (rx1, ry1), (rx2, ry2), (255, 0, 0), 2)
            fx1, fy1, fx2, fy2 = (int(v) for v in results["rois_forehead"][i])
            cv2.rectangle(annotated[i], (fx1, fy1), (fx2, fy2), (255, 0, 0), 2)
        if results["valid_butterworth"][i]:
            txt = (f"BPM butter {results['bpm_butterworth'][i]:.1f} "
                   f"cheby2 {results['bpm_cheby2'][i]:.1f} "
                   f"fir {results['bpm_fir'][i]:.1f}")
            cv2.putText(annotated[i], txt, (8, 20),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
    out_path = os.path.join(out_dir, "annotated.mp4")
    vio.write_video(annotated, out_path, fps)

    plt = _pyplot()
    if plt is None:
        print(f"wrote {out_path} to {out_dir}; no matplotlib, signals.png"
              + (" and the live panels" if live_panels else "")
              + " skipped")
        if show:
            _replay(annotated, fps)
        return

    # Signal + BPM plot.
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 7), sharex=True)
    ts = results["ts"]
    ax1.plot(ts, results["green"], color="green", lw=0.8)
    ax1.set_ylabel("cheek green mean")
    for kind, _ in _FILTERS:
        v = results[f"valid_{kind}"]
        ax2.plot(ts[v], results[f"bpm_{kind}"][v], lw=1.2, label=kind)
    ax2.set_xlabel("time (s)")
    ax2.set_ylabel("BPM (Welch)")
    ax2.legend()
    ax2.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "signals.png"), dpi=150)
    plt.close(fig)
    print(f"wrote {out_path} and signals.png to {out_dir}")

    panels = live_panel_data(results, device=device) if live_panels else None
    if panels is not None and not show:
        # Headless: the reference's three in-loop panels (signal +
        # butter-PSD + cheby2-PSD with BPM annotations) as the last replay
        # frame's snapshot.
        W0, freqs, pb, pc, bpm_b, bpm_c = panels
        fig, (axs, axb, axc) = plt.subplots(3, 1, figsize=(9, 10))
        axs.plot(results["green"], color="green", lw=0.8)
        axs.set_title("Heart Rate bpm")
        axs.set_xlabel("frame")
        axs.set_ylabel("signal value")
        axs.text(0.95, 0.95, f"BPM Chebyshev II: {bpm_c[-1]:.2f}",
                 transform=axs.transAxes, ha="right", va="top")
        axs.text(0.95, 0.88, f"BPM Butterworth: {bpm_b[-1]:.2f}",
                 transform=axs.transAxes, ha="right", va="top")
        for ax, p, lbl in ((axb, pb, "Butterworth PSD"),
                           (axc, pc, "Chebyshev-II PSD")):
            ax.plot(freqs, p[-1], lw=1.0)
            ax.set_xlim(0, 5.0)
            ax.set_xlabel("Hz")
            ax.set_title(lbl)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "live_panels.png"), dpi=130)
        plt.close(fig)
        print(f"wrote live_panels.png to {out_dir}")

    if show:
        _replay(annotated, fps, plt, panels, results["green"])


def _replay(annotated, fps, plt=None, panels=None, green=None) -> None:
    """Interactive replay (needs a display): the annotated frames, and with
    ``panels`` the reference's in-loop display (``rppg_VIDEO.py:305-328``):
    a growing signal line and two PSD panels updated per frame from the
    precomputed panel data; the loop only draws."""
    import cv2
    pfig = None
    if panels is not None and plt is not None:
        W0, freqs, pb, pc, bpm_b, bpm_c = panels
        plt.ion()
        pfig, (axs, axb, axc) = plt.subplots(3, 1, figsize=(8, 9))
        sig_line, = axs.plot([], [], color="green")
        axs.set_title("Heart Rate bpm")
        txt_c = axs.text(0.95, 0.95, "", transform=axs.transAxes,
                         ha="right", va="top")
        txt_b = axs.text(0.95, 0.88, "", transform=axs.transAxes,
                         ha="right", va="top")
        lb, = axb.plot(freqs, pb[0], lw=1.0)
        lc, = axc.plot(freqs, pc[0], lw=1.0)
        axb.set_title("Butterworth PSD")
        axc.set_title("Chebyshev-II PSD")
        for ax in (axb, axc):
            ax.set_xlim(0, 5.0)
    for i in range(annotated.shape[0]):
        cv2.imshow("vhr_tpu_torch rppg_video", annotated[i])
        if pfig is not None:
            sig_line.set_data(np.arange(i + 1), green[:i + 1])
            axs.relim()
            axs.autoscale_view()
            if i >= W0 - 1:
                # the window ending at frame i is row i - W + 1
                j = min(i - W0 + 1, pb.shape[0] - 1)
                lb.set_ydata(pb[j])
                lc.set_ydata(pc[j])
                axb.relim()
                axb.autoscale_view()
                axc.relim()
                axc.autoscale_view()
                txt_b.set_text(f"BPM Butterworth: {bpm_b[j]:.2f}")
                txt_c.set_text(f"BPM Chebyshev II: {bpm_c[j]:.2f}")
            pfig.canvas.draw_idle()
            pfig.canvas.flush_events()
        key = cv2.waitKey(max(1, int(1000 / fps))) & 0xFF
        if key == ord("q"):
            break
        if key == ord(" "):
            cv2.waitKey(0)
    cv2.destroyAllWindows()
    if pfig is not None:
        plt.ioff()
        plt.close(pfig)


def pick_video(videos_dir: str) -> str:
    files = [f for f in sorted(os.listdir(videos_dir))
             if not f.startswith(".")]
    print("Select input video file:")
    for i, f in enumerate(files):
        print(f"[{i + 1}] {f}")
    choice = int(input().strip()) - 1
    if not 0 <= choice < len(files):
        print("Invalid choice, exiting...")
        raise SystemExit(1)
    return os.path.join(videos_dir, files[choice])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Offline video heart-rate (CUDA)")
    p.add_argument("video", nargs="?", help="video path (omit for picker)")
    p.add_argument("--videos-dir", default="videos")
    p.add_argument("--out-dir", default="rppg_out")
    p.add_argument("--show", action="store_true",
                   help="interactive replay window")
    p.add_argument("--live-panels", action="store_true",
                   help="the reference's in-loop panels (signal + "
                        "butter/cheby2 PSD + BPM text) alongside the "
                        "replay; headless runs write live_panels.png")
    p.add_argument("--faces", type=int, default=1,
                   help="analyze up to K subjects (annotated video + "
                        "per-face BPM traces)")
    p.add_argument("--detector", default="skin",
                   choices=["skin", "landmarker", "landmarker-real",
                            "refined", "mediapipe", "mediapipe-bf16",
                            "mediapipe-exact"],
                   help="face localization: weight-free skin chroma "
                        "(fastest), the learned landmarker (-real: the "
                        "real-photo-distilled weights; refined: with crop "
                        "refinement) or the bundled MediaPipe "
                        "FaceLandmarker, one face or --faces K")
    p.add_argument("--detect-every", type=int, default=1, metavar="N",
                   help="run face detection every N frames, holdover "
                        "tracking in between")
    p.add_argument("--profile-trace", default=None, metavar="DIR",
                   help="record a torch.profiler trace of the run into DIR "
                        "(a Chrome trace: chrome://tracing or Perfetto)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "on the host)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)   # no card: fail before the picker
    stack = contextlib.ExitStack()
    if args.profile_trace:
        from ..utils.profiling import device_trace
        stack.enter_context(device_trace(args.profile_trace))

    with stack:
        path = args.video or pick_video(args.videos_dir)
        if args.faces > 1:
            results = analyze_multi(
                path, args.faces,
                detector=_resolve_detector_multi(args.detector, args.faces,
                                                 device),
                detect_every=args.detect_every, device=device)
            ok = results["bpm_valid"]
            for k in range(args.faces):
                idx = np.nonzero(ok[:, k])[0]
                if len(idx):
                    print(f"face{k} BPM: {results['bpm'][idx[-1], k]:.2f}")
            render_multi(results, args.out_dir)
            return 0
        results = analyze(path,
                          detector=_resolve_detector(args.detector, device),
                          detect_every=args.detect_every, device=device)
        last = np.nonzero(results["valid_butterworth"])[0]
        if len(last):
            i = last[-1]
            print(f"BPM Butterworth: {results['bpm_butterworth'][i]:.2f} | "
                  f"Cheby2: {results['bpm_cheby2'][i]:.2f} | "
                  f"FIR: {results['bpm_fir'][i]:.2f}")
        render(results, args.out_dir, show=args.show,
               live_panels=args.live_panels, device=device)
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
