"""The port's live and serving apps, driven through their CLI entry points
on the CPU (``--device cpu``), as ``tests/test_apps.py`` and
``tests/test_serving.py`` drive the JAX package's: the livestream app's
late BPM on a 75 BPM clip within 8 BPM (the Welch bins are 6.7 BPM apart
at 9 s segments), its plot and trace outputs, the served pool's CLI in
server and client mode over both transfers, the detector choices, and
``StageTimer``.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from vhr_tpu_torch import serving
from vhr_tpu_torch.apps import rppg_livestream, rppg_video, serve_bpm
from vhr_tpu_torch.io import video as tvideo
from vhr_tpu_torch.pipeline import live
from vhr_tpu_torch.utils.profiling import StageTimer
from vhr_tpu_torch.utils.synth import SynthSpec, synthesize

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clip_file(tmp_path_factory):
    """A 24 s, 75 BPM MJPG clip at the fused kernel's width (W*3 % 128 ==
    0).  The Welch is valid from the 270th frame (9 s segments), but the
    band-pass's start-up transient holds the peak at the band's low edge
    until the 500-sample ring has moved past it (about frame 510): the
    late BPM needs the whole clip."""
    root = tmp_path_factory.mktemp("live_apps")
    clip = synthesize(SynthSpec(duration_s=24.0, bpm=75.0, height=64,
                                width=128, noise_std=0.5))
    path = root / "clip.avi"
    tvideo.write_video(clip.frames, str(path), clip.fps, fourcc="MJPG")
    return {"path": str(path), "root": root, "clip": clip}


def _bpms(out: str):
    return [float(line.split(":")[1]) for line in out.splitlines()
            if line.startswith("Bpm after filtering")]


# The late-BPM check needs the whole clip; the batching variants, which
# tests/test_torch_live.py holds equal to the 1-deep pipeline, run on 60
# frames.
@pytest.mark.parametrize("flags,max_frames", [
    pytest.param([], None, id="flags0"),
    pytest.param(["--fused"], 60, id="flags1"),
    pytest.param(["--transfer", "i420", "--ingest-downsample", "2"], None,
                 id="flags2"),
    pytest.param(["--fused", "--transfer", "i420", "--frames-per-call", "4"],
                 None, id="flags3"),
    pytest.param(["--fetch-every", "3", "--detect-every", "2"], 60,
                 id="flags4")])
def test_livestream_app_on_file(clip_file, capsys, flags, max_frames):
    """The app replays the clip headless: exit 0 and the reference's line
    format; over the whole clip, the median of the last 60 printed BPM
    within 8 of 75."""
    cap = [] if max_frames is None else ["--max-frames", str(max_frames)]
    rc = rppg_livestream.main(["--video", clip_file["path"], "--no-display",
                               "--device", "cpu"] + flags + cap)
    assert rc == 0
    out = capsys.readouterr().out
    assert f"processed {max_frames or 720} frames" in out
    if max_frames is None:
        bpms = _bpms(out)
        assert len(bpms) >= 60
        assert abs(np.median(bpms[-60:]) - 75.0) <= 8.0


def test_livestream_sync_equals_pipelined(clip_file, capsys):
    """``--sync`` reads each frame's output before the next: the same BPM
    lines as the pipelined loop, which prints each one a frame later."""
    args = ["--video", clip_file["path"], "--no-display", "--device", "cpu",
            "--max-frames", "300"]
    assert rppg_livestream.main(args) == 0
    piped = _bpms(capsys.readouterr().out)
    assert rppg_livestream.main(args + ["--sync"]) == 0
    synced = _bpms(capsys.readouterr().out)
    assert synced and synced == piped


def test_livestream_plot_out(clip_file, tmp_path):
    """``--plot --no-display --plot-out`` writes the signal summary PNG."""
    out = tmp_path / "signals.png"
    rc = rppg_livestream.main(["--video", clip_file["path"], "--max-frames",
                               "20", "--no-display", "--plot", "--plot-out",
                               str(out), "--device", "cpu"])
    assert rc == 0
    assert out.exists() and out.stat().st_size > 5000


def test_livestream_profile_trace(clip_file, tmp_path):
    """``--profile-trace`` records a torch.profiler trace of the run."""
    trace_dir = tmp_path / "trace"
    rc = rppg_livestream.main(["--video", clip_file["path"], "--no-display",
                               "--max-frames", "12", "--profile-trace",
                               str(trace_dir), "--device", "cpu"])
    assert rc == 0
    files = [p for p in trace_dir.rglob("*") if p.is_file()]
    assert files and files[0].stat().st_size > 0


def test_livestream_unported_choices_raise(clip_file, capsys):
    """``--faces 2`` runs the multi-face step, with the skin detector and
    with the refined cascade; ``--detector landmarker`` runs the live step
    on the learned detector.  ``--fused`` with a detector still errors."""
    base = ["--video", clip_file["path"], "--no-display", "--device", "cpu"]
    assert rppg_livestream.main(base + ["--faces", "2", "--max-frames",
                                        "20"]) == 0
    assert "processed 20 frames" in capsys.readouterr().out
    assert rppg_livestream.main(base + ["--faces", "2", "--detector",
                                        "refined", "--max-frames", "6"]) == 0
    assert "processed 6 frames" in capsys.readouterr().out
    assert rppg_livestream.main(base + ["--detector", "landmarker",
                                        "--max-frames", "6"]) == 0
    assert "processed 6 frames" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        rppg_livestream.main(base + ["--fused", "--detector", "mediapipe"])


def test_resolve_detector_choices():
    assert rppg_video._resolve_detector("skin") is None
    frame = torch.zeros((1, 64, 128, 3), dtype=torch.uint8)
    for name in ("landmarker", "landmarker-real", "refined"):
        boxes, valid = rppg_video._resolve_detector(name, "cpu")(frame)
        assert tuple(boxes.shape) == (1, 4) and valid.dtype == torch.bool
    # The skin choice's multi-face detector is the pipelines' default.
    assert rppg_video._resolve_detector_multi("skin", 2) is None
    for name in ("landmarker", "refined"):
        boxes, valid = rppg_video._resolve_detector_multi(name, 2,
                                                          "cpu")(frame)
        assert tuple(boxes.shape) == (1, 2, 4) and not valid.any(), name
    assert callable(rppg_video._resolve_detector_multi("mediapipe", 2,
                                                       device="cpu"))
    with pytest.raises(SystemExit):
        rppg_video._resolve_detector("nope")
    det = rppg_video._resolve_detector("mediapipe-bf16", device="cpu")
    boxes, valid = det(torch.zeros((1, 64, 128, 3), dtype=torch.uint8))
    assert tuple(boxes.shape) == (1, 4) and not bool(valid[0])


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("transfer", ["bgr", "i420"])
def test_serve_bpm_cli_smoke(clip_file, transfer):
    """The server CLI end to end: a bounded serve on the CPU, one client of
    the pool's transfer, ordered answers equal to the live step's."""
    clip = clip_file["clip"]
    port = _free_port()
    h, w = clip.frames[0].shape[:2]
    th = threading.Thread(target=serve_bpm.main, daemon=True, args=(
        ["--host", "127.0.0.1", "--port", str(port), "--height", str(h),
         "--width", str(w), "--slots", "2", "--fps", str(clip.fps),
         "--transfer", transfer, "--max-seconds", "120", "--device",
         "cpu"],))
    th.start()
    c = None
    for _ in range(300):
        try:
            c = serving.BpmClient("127.0.0.1", port, transfer=transfer,
                                  timeout=60.0)
            break
        except OSError:
            time.sleep(0.1)
    assert c is not None, "server never came up"
    n = 12
    frames = clip.frames[:n]
    if transfer == "i420":
        frames = [live.bgr_to_i420_host(f) for f in frames]
    for f in frames:
        c.send(f)
    outs = [c.recv() for _ in range(n)]
    c.close()
    assert [o["seq"] for o in outs] == list(range(n))
    cfg = live.LiveConfig(fps=clip.fps)
    st, stp = live.init_state(cfg), live.make_step(cfg, transfer=transfer)
    for o, f in zip(outs, frames):
        st, ref = stp(st, torch.as_tensor(f))
        assert o["box"] == [int(x) for x in ref.box]
        assert o["face_valid"] == bool(ref.face_valid)


@pytest.mark.parametrize("transfer", ["bgr", "i420"])
def test_serve_bpm_client_mode(clip_file, capsys, transfer):
    """``--connect`` streams the file to a running pool, in the wire format
    the pool's stats hello advertises (I420 through ``bgr_to_i420_host``),
    and drains the answers cleanly."""
    clip = clip_file["clip"]
    pool = serving.BpmServer(live.LiveConfig(fps=clip.fps), n_slots=2,
                             transfer=transfer, device="cpu")
    srv = serving.serve_forever("127.0.0.1", 0, pool,
                                frame_shape=clip.frames[0].shape[:2])
    port = srv.server_address[1]
    try:
        rc = serve_bpm.main(["--connect", f"127.0.0.1:{port}", "--video",
                             clip_file["path"], "--max-frames", "40"])
    finally:
        srv.shutdown()
    out = capsys.readouterr().out
    assert rc == 0
    assert f"({transfer})" in out and "sent 40 frames" in out
    assert "server error" not in out


def test_serve_bpm_snapshot_and_restore(clip_file, tmp_path, capsys):
    """``--snapshot-on-exit`` writes the pool's state and ``--restore``
    reads it back into a new server."""
    snap = tmp_path / "pool.npz"
    args = ["--host", "127.0.0.1", "--port", "0", "--height", "64",
            "--width", "128", "--slots", "3", "--max-seconds", "0",
            "--device", "cpu"]
    assert serve_bpm.main(args + ["--snapshot-on-exit", str(snap)]) == 0
    assert snap.exists()
    assert serve_bpm.main(args + ["--restore", str(snap)]) == 0
    out = capsys.readouterr().out
    assert "restored pool state" in out and "serving 3 slots" in out
    with pytest.raises(SystemExit):
        serve_bpm.main(["--host", "127.0.0.1", "--device", "cpu"])


def test_stage_timer_report():
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("decode"):
            time.sleep(0.002)
    with timer.stage("step", sync=True):
        torch.ones(8).sum()
    rep = timer.report()
    assert rep["decode"]["count"] == 3 and rep["step"]["count"] == 1
    assert rep["decode"]["total_s"] >= 0.006
    assert rep["decode"]["mean_ms"] == pytest.approx(
        1e3 * rep["decode"]["total_s"] / 3)
    assert '"decode"' in timer.json()
