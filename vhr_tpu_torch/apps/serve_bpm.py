"""Serve live BPM over TCP: many camera clients, one card.

Port of ``vhr_tpu/apps/serve_bpm.py``, the CLI front-end of
:mod:`vhr_tpu_torch.serving`: ``n_slots`` clients connect over TCP (or
WebSocket, on the same port), their frames batch into one pool tick on the
card, and each gets its own per-frame JSON BPM line back (the wire
protocol is the JAX package's, byte for byte).

    python -m vhr_tpu_torch.apps.serve_bpm --height 720 --width 1280 \
        --slots 16 --transfer i420 --port 7117

The same app is also the camera side: ``--connect HOST:PORT`` switches to
client mode, streaming a video file or webcam (resized to the pool's
geometry, paced at the source's fps, planar I420 when the pool asks for
it) and printing the returned BPM lines:

    python -m vhr_tpu_torch.apps.serve_bpm --connect gpuhost:7117 --camera 0
    python -m vhr_tpu_torch.apps.serve_bpm --connect gpuhost:7117 --video f.mp4

``--device`` places the pool (default: the CUDA card; ``cpu`` runs on the
host).  ``--faces K`` monitors K subjects a slot with any detector's
multi-face form (skin, the tiled landmarker, the refined cascade or
MediaPipe), and the lines carry one entry per subject.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="vhr_tpu_torch multi-client live BPM server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7117,
                   help="0 picks an ephemeral port (printed at startup)")
    p.add_argument("--connect", default=None, metavar="HOST:PORT",
                   help="CLIENT mode: stream --video/--camera to a running "
                        "pool and print its BPM lines")
    p.add_argument("--video", default=None, help="client mode: video file")
    p.add_argument("--camera", type=int, default=None,
                   help="client mode: webcam index")
    p.add_argument("--resume-slot", type=int, default=None,
                   help="client mode: reclaim a warm slot after a server "
                        "--restore restart")
    p.add_argument("--max-frames", type=int, default=None,
                   help="client mode: stop after N frames")
    p.add_argument("--height", type=int, default=None,
                   help="pool frame height (clients resize to this); "
                        "server mode: required")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--slots", type=int, default=8,
                   help="concurrent clients per card")
    p.add_argument("--fps", type=float, default=30.0,
                   help="nominal client frame rate (Welch timebase)")
    p.add_argument("--detector", default="skin",
                   help="skin|landmarker|landmarker-real|refined|mediapipe|"
                        "mediapipe-bf16|mediapipe-exact")
    p.add_argument("--detect-every", type=int, default=1,
                   help="pool-tick detection cadence (the whole batched "
                        "detector pass cond-skips off-phase ticks; "
                        "tracking holds between attempts)")
    p.add_argument("--faces", type=int, default=1,
                   help="subjects monitored per client slot (K > 1: the "
                        "chosen detector's multi-face form; the lines "
                        "carry one entry per subject)")
    p.add_argument("--transfer", choices=("bgr", "i420"), default="bgr",
                   help="wire format clients must send (i420 = 2x fewer "
                        "bytes; BGR is rebuilt on the card)")
    p.add_argument("--method",
                   choices=("green", "chrom", "pos", "omit", "adaptive"),
                   default="green",
                   help="pulse construction per tick: green (reference "
                        "streaming parity), a motion-robust projection "
                        "(chrom/pos/omit), or adaptive SNR-ranked "
                        "selection (adds a 'method' field per output)")
    p.add_argument("--auth-token", default=None,
                   help="shared secret: every client hello must carry a "
                        "matching {'token': ...} (BPM is physiological "
                        "data; set this on any non-loopback bind)")
    p.add_argument("--ws-origin", action="append", default=None,
                   metavar="ORIGIN",
                   help="allow-listed browser Origin for WebSocket "
                        "upgrades (repeatable; '*' allows any). Default: "
                        "all browser origins rejected")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="serve for a bounded time then exit (smoke tests, "
                        "draining deploys); default: forever")
    p.add_argument("--restore", default=None, metavar="NPZ",
                   help="restore pool state from a snapshot (.npz) — "
                        "clients resume mid-acquisition after a restart")
    p.add_argument("--snapshot-on-exit", default=None, metavar="NPZ",
                   help="save pool state on shutdown (pair with --restore)")
    p.add_argument("--device", default=None,
                   help="server mode: torch device of the pool (default: "
                        "the CUDA card; 'cpu' runs on the host)")
    args = p.parse_args(argv)

    if args.connect:
        return _run_client(p, args)
    if args.height is None or args.width is None:
        p.error("server mode requires --height/--width")

    from ..pipeline import live
    from ..serving import BpmServer, serve_forever
    from .rppg_video import _resolve_detector, _resolve_detector_multi

    detector = (_resolve_detector(args.detector, args.device)
                if args.faces == 1 else
                _resolve_detector_multi(args.detector, args.faces,
                                        args.device))
    cfg = live.LiveConfig(fps=args.fps, detect_every=args.detect_every,
                          method=args.method)
    pool = BpmServer(cfg, n_slots=args.slots, detector=detector,
                     transfer=args.transfer, k_faces=args.faces,
                     device=args.device)
    if args.restore:
        import numpy as np
        with np.load(args.restore) as snap:
            pool.restore(snap)
        print(f"restored pool state from {args.restore} "
              f"({len(pool.active_slots)} live slots)")
    srv = serve_forever(args.host, args.port, pool,
                        frame_shape=(args.height, args.width),
                        auth_token=args.auth_token,
                        ws_origins=tuple(args.ws_origin)
                        if args.ws_origin else None)
    host, port = srv.server_address[:2]
    print(f"serving {args.slots} slots of {args.width}x{args.height} "
          f"({args.transfer}, detector={args.detector}) on {host}:{port}")
    try:
        import threading
        threading.Event().wait(args.max_seconds)   # None = forever
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        if args.snapshot_on_exit:
            import numpy as np
            np.savez(args.snapshot_on_exit, **pool.snapshot())
            print(f"pool state -> {args.snapshot_on_exit}")
    return 0


def _run_client(p, args) -> int:
    """Stream a video file / webcam to a pool; print returned BPM lines.

    Frames are resized host-side to the pool's geometry (the pool batch is
    a static shape) and sent at the source's own fps; the receive side
    runs on a thread so TCP backpressure, not answer latency, paces the
    stream.  The printed lines mirror the reference live app's per-frame
    "Bpm" prints (``rppg_LIVESTREAM.py:347-353``)."""
    import json
    import socket
    import threading
    import time

    import cv2
    import numpy as np

    from ..pipeline.live import bgr_to_i420_host
    from ..serving import BpmClient

    if (args.video is None) == (args.camera is None):
        p.error("client mode needs exactly one of --video/--camera")
    host, _, port = args.connect.rpartition(":")
    if not host or not port.isdigit():
        p.error("--connect must be HOST:PORT")

    # The pool dictates geometry; ask it via the stats hello.
    st = socket.create_connection((host, int(port)), timeout=30)
    st.sendall(b'{"stats": true}\n')
    stats = json.loads(st.makefile("rb").readline().decode())
    st.close()
    transfer = stats["transfer"]
    geometry = (stats["width"], stats["height"])   # pool dictates shape

    cam = cv2.VideoCapture(args.camera if args.video is None else args.video)
    if not cam.isOpened():
        print("cannot open source")
        return 1
    src_fps = cam.get(cv2.CAP_PROP_FPS) or 30.0

    c = BpmClient(host, int(port), transfer=transfer,
                  resume_slot=args.resume_slot)
    print(f"slot {c.slot} ({transfer}), pacing at {src_fps:.1f} fps")
    n_sent = 0
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                line = c.recv()
            except (OSError, ValueError):
                break
            if not line:
                break
            if line.get("error"):
                print(f"server error: {line['error']}")
                break
            valid = line["bpm_valid"]
            if any(valid) if isinstance(valid, list) else valid:
                print(f"Bpm: {line['bpm']} (frame {line['seq']})")

    rt = threading.Thread(target=reader, daemon=True)
    rt.start()
    try:
        while not stop.is_set():
            ok, frame = cam.read()
            if not ok:
                break
            if (frame.shape[1], frame.shape[0]) != geometry:
                frame = cv2.resize(frame, geometry,
                                   interpolation=cv2.INTER_AREA)
            c.send(bgr_to_i420_host(frame) if transfer == "i420"
                   else np.ascontiguousarray(frame))
            n_sent += 1
            if args.max_frames and n_sent >= args.max_frames:
                break
            if args.video is not None:
                time.sleep(1.0 / src_fps)       # pace files like a camera
    except KeyboardInterrupt:
        pass
    finally:
        cam.release()
        time.sleep(0.5)                          # drain in-flight answers
        stop.set()
        c.close()
    print(f"sent {n_sent} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
