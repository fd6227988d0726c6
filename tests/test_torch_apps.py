"""The port's offline apps against the JAX package's, on the CPU.

Both packages see the same numpy inputs (clips from ``utils.synth`` made
from a seed, written with cv2 into pytest's tmp dir): ``reduce.video_stats``
and the ``bpp`` tool; ``rppg_video``'s ``analyze``, ``live_panel_data``,
``main`` (single- and multi-face) and the renders; ``evm_magnify``;
``validation.main``; and the ``entry()`` counterpart of
``__graft_entry__.py``.  Tolerances: integers equal, the green trace within
``rtol=1e-6``, the statistics within ``rtol=1e-5``, BPM equal on >= 99 % of
valid frames (the filters are float32 in both packages, held within 1e-5 of
the input's scale, ROADMAP queue 3).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp

from vhr_tpu import validation as jvalidation
from vhr_tpu.apps import bpp as jbpp
from vhr_tpu.apps import evm_magnify as jevm
from vhr_tpu.apps import rppg_video as jvideo
from vhr_tpu.io import video as jvio
from vhr_tpu.ops import reduce as jreduce
from vhr_tpu.utils.synth import FaceSpec, SynthSpec, synthesize, \
    synthesize_multi

from vhr_tpu_torch import entry as tentry
from vhr_tpu_torch import validation as tvalidation
from vhr_tpu_torch.apps import bpp as tbpp
from vhr_tpu_torch.apps import evm_magnify as tevm
from vhr_tpu_torch.apps import rppg_video as tvideo
from vhr_tpu_torch.config import PipelineConfig
from vhr_tpu_torch.ops import reduce as treduce
from vhr_tpu_torch.pipeline import offline as toffline
from vhr_tpu_torch.utils.synth import SynthSpec as TSynthSpec

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)

BPM_SHARE = 0.99


@pytest.fixture(scope="module")
def clip_file(tmp_path_factory):
    """``tests/test_apps.py``'s clip: 24 s at 75 BPM, 64 x 80, mp4v."""
    root = tmp_path_factory.mktemp("torch_apps")
    clip = synthesize(SynthSpec(duration_s=24.0, bpm=75.0, height=64,
                                width=80, noise_std=0.5))
    path = root / "clip.mp4"
    jvio.write_video(clip.frames, str(path), clip.fps)
    return {"path": str(path), "root": root, "clip": clip}


@pytest.fixture(scope="module")
def analyses(clip_file):
    """``analyze`` of both packages on the clip."""
    return (jvideo.analyze(clip_file["path"]),
            tvideo.analyze(clip_file["path"], device="cpu"))


@pytest.fixture(scope="module")
def duo_file(tmp_path_factory):
    """``tests/test_apps.py``'s two-face clip: 60 and 96 BPM, 144 x 256."""
    root = tmp_path_factory.mktemp("torch_apps_duo")
    duo = synthesize_multi(
        (FaceSpec(center=(0.25, 0.45), bpm=60.0),
         FaceSpec(center=(0.72, 0.5), bpm=96.0)),
        height=144, width=256, duration_s=16.0, noise_std=1.0)
    path = root / "duo.mp4"
    jvio.write_video(duo.frames, str(path), duo.fps)
    return {"path": str(path), "root": root, "duo": duo}


def _bpm_share(jb, tb, valid):
    v = np.asarray(valid, bool)
    return float((np.asarray(jb)[v] == np.asarray(tb)[v]).mean()) \
        if v.any() else 1.0


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


# -- reduce.video_stats and bpp ---------------------------------------------

@pytest.mark.parametrize("shape", [(5, 64, 80), (3, 144, 256)])
def test_video_stats_match_jax_and_cv2(shape):
    """Gray and the per-frame histograms equal JAX's and cv2's exactly;
    entropy, noise variance and NSR within ``rtol=1e-5`` of JAX's."""
    rng = np.random.default_rng(sum(shape))
    frames = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    frames[0] = 0                       # a black frame: NSR 0
    gray = treduce.grayscale_u8(torch.from_numpy(frames)).numpy()
    cv = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in frames])
    np.testing.assert_array_equal(gray, cv)
    np.testing.assert_array_equal(
        gray, np.asarray(jreduce.grayscale_u8(jnp.asarray(frames))))
    hist = treduce._histogram256(torch.from_numpy(gray)).numpy()
    np.testing.assert_array_equal(
        hist, np.asarray(jreduce._histogram256(jnp.asarray(gray))))
    np.testing.assert_array_equal(
        hist, np.stack([np.bincount(g.ravel(), minlength=256) for g in cv]))
    got = treduce.video_stats(torch.from_numpy(frames))
    want = jreduce.video_stats(jnp.asarray(frames))
    for name in ("entropy", "noise_variance", "nsr"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # The single-statistic functions agree with the batch.
    g = torch.from_numpy(gray)
    np.testing.assert_array_equal(treduce.frame_nsr(g).numpy(),
                                  got.nsr.numpy())
    np.testing.assert_array_equal(treduce.frame_noise_variance(g).numpy(),
                                  got.noise_variance.numpy())
    np.testing.assert_array_equal(treduce.frame_entropy(g).numpy(),
                                  got.entropy.numpy())


def _frames_1080p(content, n=2):
    """``n`` 1080p frames of noise, of a near-flat field (128 with +-1
    noise) or of gradients, from a seed."""
    rng = np.random.default_rng(len(content))
    if content == "noise":
        return rng.integers(0, 256, (n, 1080, 1920, 3), dtype=np.uint8)
    if content == "near_flat":
        return (128 + rng.integers(-1, 2, (n, 1080, 1920, 3))).astype(
            np.uint8)
    yy, xx = np.mgrid[0:1080, 0:1920]
    ramp = np.stack([xx * 255 // 1919, yy * 255 // 1079,
                     (xx + yy) * 255 // 2998], -1)
    return np.stack([np.roll(ramp, 97 * i, axis=1) for i in range(n)]
                    ).astype(np.uint8)


@pytest.mark.parametrize("content", ["noise", "near_flat", "gradient"])
def test_video_stats_1080p_match_jax(content):
    """At 1080p (2 million pixels a frame, where JAX's float32 variance
    is furthest from exact): entropy, noise variance and NSR within
    2.5e-7 relative of JAX's; the histograms equal."""
    frames = _frames_1080p(content)
    got = treduce.video_stats(torch.from_numpy(frames))
    want = jreduce.video_stats(jnp.asarray(frames))
    for name in ("entropy", "noise_variance", "nsr"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=2.5e-7, atol=0, err_msg=name)
    gray = treduce.grayscale_u8(torch.from_numpy(frames))
    np.testing.assert_array_equal(
        treduce._histogram256(gray).numpy(),
        np.asarray(jreduce._histogram256(jreduce.grayscale_u8(
            jnp.asarray(frames)))))


def test_bpp_json_matches_jax(clip_file):
    """``bpp --json``: JAX's ints, its floats within ``rtol=1e-5``."""
    rc_j, out_j = _stdout(jbpp.main, [clip_file["path"], "--json"])
    rc_t, out_t = _stdout(tbpp.main, [clip_file["path"], "--json",
                                      "--device", "cpu"])
    assert rc_j == rc_t == 0
    want, got = json.loads(out_j), json.loads(out_t)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, int):
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-5), k
    assert got["frames"] == clip_file["clip"].frames.shape[0]


def test_bpp_text_report(clip_file):
    rc, out = _stdout(tbpp.main, [clip_file["path"], "--device", "cpu"])
    assert rc == 0
    assert "Average Entropy of the Video" in out and "BPP:" in out


# -- rppg_video -------------------------------------------------------------

def test_analyze_matches_jax(analyses):
    """Boxes, ROIs, forehead ROIs and validity equal; green within
    ``rtol=1e-6``; each filter's validity equal, its BPM equal on >= 99 %
    of valid frames."""
    want, got = analyses
    assert set(got) == set(want)
    for k in ("boxes", "rois", "rois_forehead", "valid", "ts"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["green"], want["green"], rtol=1e-6)
    assert got["fps"] == want["fps"]
    for kind in ("butterworth", "cheby2", "fir"):
        v = want[f"valid_{kind}"]
        np.testing.assert_array_equal(got[f"valid_{kind}"], v)
        assert v.sum() > 0
        assert _bpm_share(want[f"bpm_{kind}"], got[f"bpm_{kind}"],
                          v) >= BPM_SHARE, kind


def test_analyze_detect_every_matches_jax(clip_file):
    """``detect_every=2``: the cadence's holdover equal, the trace too."""
    want = jvideo.analyze(clip_file["path"], detect_every=2)
    got = tvideo.analyze(clip_file["path"], detect_every=2, device="cpu")
    for k in ("boxes", "rois", "valid", "valid_butterworth"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["green"], want["green"], rtol=1e-6)


def test_live_panel_data_matches_jax(analyses):
    """``W`` and ``freqs`` equal, the panel BPM equal on >= 99 % of rows,
    and the late panels on the injected rate to the Welch bin."""
    want, got = analyses
    jw, jf, jpb, jpc, jbb, jbc = jvideo.live_panel_data(want)
    tw, tf, tpb, tpc, tbb, tbc = tvideo.live_panel_data(got, device="cpu")
    assert tw == jw
    np.testing.assert_array_equal(tf, jf)
    assert tpb.shape == jpb.shape == (len(got["green"]) - tw + 1, len(tf))
    assert (tbb == jbb).mean() >= BPM_SHARE
    assert (tbc == jbc).mean() >= BPM_SHARE
    np.testing.assert_allclose(tpb, jpb, rtol=1e-3,
                               atol=1e-4 * float(np.abs(jpb).max()))
    assert abs(float(np.median(tbb[-20:])) - 75.0) <= 8.0
    assert abs(float(np.median(tbc[-20:])) - 75.0) <= 8.0
    short = dict(got, green=got["green"][:tw - 1])
    assert tvideo.live_panel_data(short, device="cpu") is None


@pytest.mark.parametrize("flags", [[], ["--live-panels"]],
                         ids=["plain", "live-panels"])
def test_rppg_video_main_matches_jax(clip_file, tmp_path, flags):
    """Headless ``main``: the same files as JAX's app and the same printed
    BPM line; the annotated video has every frame."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    rc_j, out_j = _stdout(jvideo.main, [clip_file["path"], "--out-dir",
                                        str(jdir)] + flags)
    rc_t, out_t = _stdout(tvideo.main, [clip_file["path"], "--out-dir",
                                        str(tdir), "--device", "cpu"]
                          + flags)
    assert rc_j == rc_t == 0
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    line = [ln for ln in out_j.splitlines() if ln.startswith("BPM ")]
    assert line and line == [ln for ln in out_t.splitlines()
                             if ln.startswith("BPM ")]
    frames, _ = jvio.read_video(str(tdir / "annotated.mp4"))
    assert frames.shape == clip_file["clip"].frames.shape


def test_render_without_matplotlib(analyses, tmp_path, monkeypatch, capsys):
    """A host without matplotlib (the card's machine) still gets the video;
    the PNGs are skipped with a line in the log."""
    monkeypatch.setattr(tvideo, "_pyplot", lambda: None)
    _, got = analyses
    tvideo.render(got, str(tmp_path), live_panels=True, device="cpu")
    assert os.listdir(tmp_path) == ["annotated.mp4"]
    assert "no matplotlib" in capsys.readouterr().out


def test_rppg_video_profile_trace(clip_file, tmp_path):
    """``--profile-trace`` records a torch.profiler trace of the run."""
    trace_dir = tmp_path / "trace"
    rc, _ = _stdout(tvideo.main, [clip_file["path"], "--out-dir",
                                  str(tmp_path / "out"), "--profile-trace",
                                  str(trace_dir), "--device", "cpu"])
    assert rc == 0
    files = [p for p in trace_dir.rglob("*") if p.is_file()]
    assert files and files[0].stat().st_size > 0


def test_pick_video(tmp_path, monkeypatch):
    for name in ("b.mp4", "a.mp4", ".hidden"):
        (tmp_path / name).write_bytes(b"")
    monkeypatch.setattr("builtins.input", lambda: "2")
    assert tvideo.pick_video(str(tmp_path)) == str(tmp_path / "b.mp4")
    monkeypatch.setattr("builtins.input", lambda: "9")
    with pytest.raises(SystemExit):
        tvideo.pick_video(str(tmp_path))


def test_analyze_multi_matches_jax(duo_file):
    """``analyze_multi``: boxes, ROIs and validity equal, green within
    ``rtol=1e-6``, BPM equal on >= 99 % of valid frames."""
    want = jvideo.analyze_multi(duo_file["path"], 2)
    got = tvideo.analyze_multi(duo_file["path"], 2, device="cpu")
    assert set(got) == set(want)
    for k in ("boxes", "rois", "valid", "bpm_valid", "ts"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["green"], want["green"], rtol=1e-6)
    assert want["bpm_valid"].sum() > 0
    assert _bpm_share(want["bpm"], got["bpm"],
                      want["bpm_valid"]) >= BPM_SHARE


def test_rppg_video_main_faces_matches_jax(duo_file, tmp_path):
    """``--faces 2``: the same per-face BPM lines and files as JAX's app;
    each subject on its own rate."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    rc_j, out_j = _stdout(jvideo.main, [duo_file["path"], "--out-dir",
                                        str(jdir), "--faces", "2"])
    rc_t, out_t = _stdout(tvideo.main, [duo_file["path"], "--out-dir",
                                        str(tdir), "--faces", "2",
                                        "--device", "cpu"])
    assert rc_j == rc_t == 0
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    lines = [ln for ln in out_t.splitlines() if ln.startswith("face")]
    assert lines == [ln for ln in out_j.splitlines()
                     if ln.startswith("face")]
    vals = dict(ln.split(" BPM: ") for ln in lines)
    assert abs(float(vals["face0"]) - 60.0) <= 8.0
    assert abs(float(vals["face1"]) - 96.0) <= 8.0


def test_rppg_video_detector_choices(clip_file, tmp_path):
    """The learned choices resolve on the CPU, one face and two, and run a
    few frames; the multi-face skin choice is the default chroma detector,
    the MediaPipe choices build the multi-face MediaPipe detector, and the
    app runs end to end with ``--detector refined``."""
    frames = torch.as_tensor(clip_file["clip"].frames[:3])
    assert tvideo._resolve_detector_multi("skin", 2) is None
    for name in ("landmarker", "landmarker-real", "refined"):
        b, v = tvideo._resolve_detector(name, "cpu")(frames)
        assert tuple(b.shape) == (3, 4) and tuple(v.shape) == (3,), name
        b, v = tvideo._resolve_detector_multi(name, 2, "cpu")(frames)
        assert tuple(b.shape) == (3, 2, 4) and tuple(v.shape) == (3, 2)
    assert callable(tvideo._resolve_detector_multi("mediapipe", 2, "cpu"))
    rc, out = _stdout(tvideo.main, [clip_file["path"], "--out-dir",
                                    str(tmp_path), "--detector", "refined",
                                    "--device", "cpu"])
    assert rc == 0 and "BPM Butterworth" in out
    with pytest.raises(SystemExit):
        tvideo._resolve_detector_multi("nope", 2)


# -- evm_magnify ------------------------------------------------------------

def test_evm_magnify_matches_jax(clip_file, tmp_path):
    """``--device cpu`` takes the plain route, as the JAX app off a TPU:
    the decoded output within 1 u8 mean absolute difference of JAX's, and
    the pulse amplified more than 4x (``tests/test_apps.py``'s check)."""
    args = ["--alpha", "25", "--low-hz", "1.0", "--high-hz", "1.5",
            "--levels", "2"]
    jout, tout = str(tmp_path / "j.mp4"), str(tmp_path / "t.mp4")
    assert _stdout(jevm.main, [clip_file["path"], jout] + args)[0] == 0
    rc, out = _stdout(tevm.main, [clip_file["path"], tout] + args
                      + ["--device", "cpu"])
    assert rc == 0 and f"wrote {tout}" in out
    clip = clip_file["clip"]
    jmag, _ = jvio.read_video(jout)
    tmag, _ = jvio.read_video(tout)
    assert tmag.shape == jmag.shape == clip.frames.shape
    assert np.abs(tmag.astype(np.int16) - jmag.astype(np.int16)).mean() <= 1.0

    def pulse_amp(frames):
        g = frames[:, 20:44, 28:52, 1].astype(float).mean((1, 2))
        s = np.abs(np.fft.rfft(g - g.mean()))
        f = np.fft.rfftfreq(len(g), 1 / clip.fps)
        return s[np.argmin(np.abs(f - 1.25))]     # 75 BPM

    assert pulse_amp(tmag) > 4.0 * pulse_amp(clip.frames)


# -- validation.main --------------------------------------------------------

_SPECS = [dict(duration_s=14.0, bpm=72.0, noise_std=1.0, height=48,
               width=64),
          dict(duration_s=14.0, bpm=95.0, noise_std=1.0, height=48,
               width=64, drift_amplitude=4.0)]


def test_validation_main_matches_jax(tmp_path, monkeypatch):
    """``main`` on two short clips (its five 45 s clips take minutes on
    the CPU): the rows equal JAX's ``validate_green_avg`` in
    ``frames_compared``, the MAEs within 1e-3; it writes
    ``VALIDATION_TORCH.md`` in the working directory, naming the device,
    and no ``VALIDATION.md``."""
    from vhr_tpu.config import PipelineConfig as JaxPipelineConfig
    monkeypatch.setattr(tvalidation, "DEFAULT_SPECS",
                        [TSynthSpec(**s) for s in _SPECS])
    monkeypatch.chdir(tmp_path)
    rc, out = _stdout(tvalidation.main, ["--device", "cpu"])
    assert rc == 0
    assert os.listdir(tmp_path) == ["VALIDATION_TORCH.md"]
    text = (tmp_path / "VALIDATION_TORCH.md").read_text()
    assert "the CPU (`cpu`)" in text and "Worst-case MAE" in text
    cfg = JaxPipelineConfig(window_seconds=10.0, acquisition_seconds=5.0)
    want = jvalidation.validate_green_avg([SynthSpec(**s) for s in _SPECS],
                                          cfg)
    got = tvalidation.validate_green_avg(
        [TSynthSpec(**s) for s in _SPECS],
        PipelineConfig(window_seconds=10.0, acquisition_seconds=5.0),
        device="cpu")
    for g, w in zip(got, want):
        assert g["spec"] == w["spec"]
        assert g["frames_compared"] == w["frames_compared"] > 0
        for k in ("mae_tpu_vs_cpu_reference", "mae_tpu_vs_truth",
                  "mae_cpu_reference_vs_truth", "mae_detector_vs_truth_roi"):
            assert abs(g[k] - w[k]) <= 1e-3, k
    # The table's rows are main's own validate_green_avg run.
    assert text.count("| 72bpm") == 1 and text.count("| 95bpm") == 1


# -- entry() ----------------------------------------------------------------

def test_entry_matches_jax_and_measure():
    """``entry(device="cpu")`` equals JAX's ``entry()`` forward on its
    clip (whose trace is all valid, so the fill is the identity) and the
    port's ``measure_green_avg`` exactly."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "graft_entry", Path(__file__).resolve().parent.parent
        / "__graft_entry__.py")
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    jfn, jargs = graft.entry()
    jbpm, jvalid = (np.asarray(x) for x in jfn(*jargs))
    fn, args = tentry.entry(device="cpu")
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    bpm, valid = (x.numpy() for x in fn(*args))
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(bpm[valid], jbpm[valid])
    cfg = PipelineConfig(window_seconds=4.0, acquisition_seconds=2.0)
    trace = toffline.extract_signals(args[0], cfg)
    assert bool(trace.valid.all())
    _, mbpm, mvalid = toffline.measure_green_avg(args[0], 30.0, cfg)
    np.testing.assert_array_equal(valid, mvalid)
    np.testing.assert_array_equal(bpm, mbpm)


def test_entry_main(capsys):
    assert tentry.main(["--device", "cpu"]) == 0
    assert "entry() ran" in capsys.readouterr().out
