"""The PyTorch port imports neither JAX nor the JAX package, and its own
copies of the JAX package's jax-free modules and helpers (configuration,
filter design, the MediaPipe nets' numpy helpers, the analysis harness's
host-side plugins and utilities) equal the originals."""

import dataclasses
import inspect
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vhr_tpu import config as jconfig
from vhr_tpu.dsp import design as jdesign
from vhr_tpu.models import mediapipe_face as jmp
from vhr_tpu.models import tflite_exec as jexec
from vhr_tpu.ops import pallas_meshblocks as jmb
from vhr_tpu.models.skin_detector import SkinDetectorConfig as JaxSkinConfig
from vhr_tpu.utils import live_plot as jlive_plot
from vhr_tpu.utils import synth as jsynth
from vhr_tpu.validation import cpu_reference_green_avg as jax_reference

import vhr_tpu_torch
from vhr_tpu_torch import config, interop, serving
from vhr_tpu_torch.analysis import context, main as analysis_main
from vhr_tpu_torch.analysis.measurement import evm as measure_evm
from vhr_tpu_torch import entry as tentry
from vhr_tpu_torch import validation as tvalidation
from vhr_tpu_torch.apps import (bpp, evm_magnify, rppg_livestream,
                                rppg_video, serve_bpm)
from vhr_tpu_torch.dsp import design
from vhr_tpu_torch.models import mediapipe_face as tmp
from vhr_tpu_torch.models import tflite_exec as texec
from vhr_tpu_torch.models.skin_detector import SkinDetectorConfig
from vhr_tpu_torch.ops import meshblocks_cuda as tmb
from vhr_tpu_torch.pipeline import live, offline
from vhr_tpu_torch.utils import live_plot, synth
from vhr_tpu_torch.validation import cpu_reference_green_avg

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vhr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vhr_tpu_torch.__path__,
                                               'vhr_tpu_torch.')]
for n in names:
    importlib.import_module(n)
import chip_smoke
ref = [m for m in sys.modules if m == 'vhr_tpu' or m.startswith('vhr_tpu.')]
print(len(names), 'jax' in sys.modules, 'torch' in sys.modules, len(ref))
"""


def test_port_imports_without_jax():
    """Every module of the port, and ``chip_smoke.py``, imports in a fresh
    interpreter without loading jax (the GPU machine has none) or any
    module of ``vhr_tpu``."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, check=True)
    n, has_jax, has_torch, n_ref = out.stdout.split()
    assert int(n) >= 30
    assert has_jax == "False" and has_torch == "True"
    assert n_ref == "0"


def test_serving_modules_import_without_jax():
    """The serving slice's entry modules load no jax in a fresh
    interpreter (the filter design is the port's own copy)."""
    code = ("import sys; import vhr_tpu_torch.serving, "
            "vhr_tpu_torch.pipeline.live, vhr_tpu_torch.dsp.design; "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False"]


def test_evm_modules_import_without_jax():
    """The EVM slice's entry modules load no jax in a fresh interpreter."""
    code = ("import sys; import vhr_tpu_torch.pipeline.evm, "
            "vhr_tpu_torch.analysis.measurement.evm; "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False"]


def test_mediapipe_modules_import_without_jax():
    """The MediaPipe slice's modules load neither jax, nor any module of
    ``vhr_tpu``, nor ``flatbuffers`` (the card's machine has none of them:
    the port reads the flatbuffer with ``struct``)."""
    code = ("import sys; import vhr_tpu_torch.models.mediapipe_face, "
            "vhr_tpu_torch.models.tflite, vhr_tpu_torch.models.tflite_exec, "
            "vhr_tpu_torch.ops.meshblocks_cuda, vhr_tpu_torch.interop; "
            "print('jax' in sys.modules, 'flatbuffers' in sys.modules, "
            "any(m == 'vhr_tpu' or m.startswith('vhr_tpu.') "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False", "False"]


def test_live_slice_modules_import_without_jax():
    """The live slice's modules (the I420 ops, the profiling and plot
    utilities, the apps) load neither jax nor any module of ``vhr_tpu`` in
    a fresh interpreter."""
    code = ("import sys; import vhr_tpu_torch.ops.color, "
            "vhr_tpu_torch.utils.profiling, vhr_tpu_torch.utils.live_plot, "
            "vhr_tpu_torch.apps.rppg_video, "
            "vhr_tpu_torch.apps.rppg_livestream, "
            "vhr_tpu_torch.apps.serve_bpm, vhr_tpu_torch.io.video; "
            "print('jax' in sys.modules, any(m == 'vhr_tpu' or "
            "m.startswith('vhr_tpu.') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]


_APP_SLICE = ["vhr_tpu_torch.entry", "vhr_tpu_torch.models.multiface",
              "vhr_tpu_torch.apps.bpp", "vhr_tpu_torch.apps.evm_magnify",
              "vhr_tpu_torch.apps.rppg_video", "vhr_tpu_torch.validation"]


@pytest.mark.parametrize("module", _APP_SLICE)
def test_app_slice_modules_import_without_jax(module):
    """Each module of the apps and multi-face slice (``entry``, the
    multi-face detector, the ``bpp`` and ``evm_magnify`` apps, the video
    app and ``validation``) loads neither jax nor any module of
    ``vhr_tpu`` in a fresh interpreter, on its own."""
    code = (f"import sys; import {module}; "
            "print('jax' in sys.modules, any(m == 'vhr_tpu' or "
            "m.startswith('vhr_tpu.') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]


_LANDMARK_SLICE = ["vhr_tpu_torch.ops.polyroi", "vhr_tpu_torch.ops.roi",
                   "vhr_tpu_torch.models.mediapipe_face",
                   "vhr_tpu_torch.pipeline.offline"]


@pytest.mark.parametrize("module", _LANDMARK_SLICE)
def test_landmark_slice_modules_import_without_jax(module):
    """Each module of the multi-face MediaPipe and landmark-ROI slice (the
    polygon means, the landmark ROIs, the detectors, the two measures)
    loads neither jax nor any module of ``vhr_tpu`` in a fresh
    interpreter, on its own."""
    code = (f"import sys; import {module}; "
            "print('jax' in sys.modules, any(m == 'vhr_tpu' or "
            "m.startswith('vhr_tpu.') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]


_ANALYSIS = ["vhr_tpu_torch.analysis." + m for m in (
    "main", "context", "registry", "metrics.mae", "metrics.accuracy",
    "metrics.signals", "degradation.common", "degradation.dummy",
    "degradation.temporal_resolution", "degradation.crf",
    "degradation.encoding", "degradation.colour_quantisation",
    "degradation.colour_noise", "degradation.spatial_resolution",
    "measurement.green_avg", "measurement.chrom", "measurement.pos",
    "measurement.omit", "measurement.adaptive", "measurement.ica",
    "measurement.app_welch", "measurement.green_avg_psd",
    "measurement.evm", "measurement.dummy")] + [
    "vhr_tpu_torch.utils.logging", "vhr_tpu_torch.utils.psd_plot"]


def test_analysis_modules_import_without_jax():
    """Every module of the analysis harness, its plugins and utilities
    loads neither jax nor any module of ``vhr_tpu`` in a fresh
    interpreter."""
    code = ("import importlib, sys\n"
            f"for m in {_ANALYSIS!r}: importlib.import_module(m)\n"
            "print('jax' in sys.modules, "
            "any(m == 'vhr_tpu' or m.startswith('vhr_tpu.') "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False", "False"]


_LEARNED = ["vhr_tpu_torch.models.landmarker", "vhr_tpu_torch.models.cascade",
            "vhr_tpu_torch.utils.realface", "vhr_tpu_torch.interop",
            "vhr_tpu_torch.apps.rppg_video"]


def test_learned_detector_modules_import_without_jax():
    """The learned landmarker, the cascades, the real-face corpus and the
    weight conversion load neither jax, flax, orbax nor any module of
    ``vhr_tpu`` in a fresh interpreter, and the detectors load their
    weights from ``checkpoints/*.npz`` with numpy alone."""
    code = ("import importlib, sys\n"
            f"for m in {_LEARNED!r}: importlib.import_module(m)\n"
            "from vhr_tpu_torch.apps.rppg_video import _resolve_detector\n"
            "for n in ('landmarker', 'landmarker-real', 'refined'):\n"
            "    _resolve_detector(n, 'cpu')\n"
            "print(*[any(m == p or m.startswith(p + '.') for m in "
            "sys.modules) for p in ('jax', 'flax', 'orbax', 'vhr_tpu')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False"] * 4


# The port's verbatim copies of the JAX package's jax-free modules: each
# equals its original line for line below the module docstring.
_COPIES = ["utils/logging.py", "utils/psd_plot.py",
           "analysis/metrics/mae.py", "analysis/metrics/accuracy.py",
           "analysis/metrics/signals.py", "analysis/degradation/common.py",
           "analysis/degradation/dummy.py",
           "analysis/degradation/temporal_resolution.py",
           "analysis/degradation/crf.py", "analysis/degradation/encoding.py",
           "analysis/measurement/dummy.py", "utils/realface.py"]


@pytest.mark.parametrize("rel", _COPIES + ["align_truth_to_measurement"])
def test_verbatim_copy_equals_jax_package(rel):
    if rel == "align_truth_to_measurement":
        from vhr_tpu.io import video as jvio
        from vhr_tpu_torch.io import video as tvio
        assert inspect.getsource(tvio.align_truth_to_measurement) == \
            inspect.getsource(jvio.align_truth_to_measurement)
        return

    def body(root):
        # A citation of the reference is compared by its path inside it.
        text = (REPO / root / rel).read_text()
        return [re.sub(r"``/\S*?/reference/", "the reference's ``", line)
                for line in text.split('"""', 2)[2].splitlines()]

    assert body("vhr_tpu_torch") == body("vhr_tpu")


def test_live_plot_copy_equals_jax_package():
    """The port's ``utils/live_plot.py`` is the JAX package's line for line
    below its docstring."""
    def body(mod):
        text = Path(mod.__file__).read_text()
        return text[text.index("from __future__"):].splitlines()

    assert body(live_plot) == body(jlive_plot)


def _stage_blocks(rng, C=8, Cm=4, n=2):
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    return r(1, 1, C), [dict(w1=r(Cm, 1, 1, C), b1=r(Cm), a1=r(1, 1, Cm),
                             dw=r(1, 3, 3, Cm), bdw=r(Cm), w2=r(C, 1, 1, Cm),
                             b2=r(C), a2=r(1, 1, C)) for _ in range(n)]


@pytest.mark.parametrize("helper", ["resize_matrix", "anchors",
                                    "letterbox_geometry", "pad_amount",
                                    "np_conv", "pack_stage_weights"])
def test_mediapipe_numpy_helpers_equal_jax(helper):
    """The port's copies of the MediaPipe slice's numpy helpers give the
    JAX package's values exactly."""
    rng = np.random.default_rng(0)
    if helper == "resize_matrix":
        for n_src, n_dst in [(1920, 128), (1080, 72), (90, 128), (7, 7)]:
            np.testing.assert_array_equal(tmp._resize_matrix(n_src, n_dst),
                                          jmp._resize_matrix(n_src, n_dst))
    elif helper == "anchors":
        np.testing.assert_array_equal(tmp.blazeface_anchors(),
                                      jmp.blazeface_anchors())
    elif helper == "letterbox_geometry":
        for H, W in [(1080, 1920), (720, 1280), (256, 320), (333, 200)]:
            assert tmp._letterbox_geometry(H, W, 128) == \
                jmp._letterbox_geometry(H, W, 128)
    elif helper == "pad_amount":
        for args in [(128, 3, 2, "SAME"), (64, 5, 2, "SAME"),
                     (7, 2, 2, "VALID"), (16, 3, 1, "SAME")]:
            assert texec._np_pad_amount(*args) == jexec._np_pad_amount(*args)
    elif helper == "np_conv":
        x = rng.normal(size=(2, 9, 7, 4)).astype(np.float32)
        for filt, stride, pad, groups in [
                (rng.normal(size=(6, 3, 3, 4)), (2, 2), "SAME", 1),
                (rng.normal(size=(1, 3, 3, 4)), (1, 1), "SAME", 4),
                (rng.normal(size=(5, 2, 2, 4)), (2, 2), "VALID", 1)]:
            b = rng.normal(size=filt.shape[0] if groups == 1 else 4)
            np.testing.assert_array_equal(
                texec._np_conv(x, filt, b, stride, pad, groups),
                jexec._np_conv(x, filt, b, stride, pad, groups))
    else:
        a0, blocks = _stage_blocks(rng)
        for got, want in zip(tmb.pack_stage_weights(a0, blocks),
                             jmb.pack_stage_weights(a0, blocks)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_skin_config_equals_jax_field_for_field():
    ours = dataclasses.asdict(SkinDetectorConfig())
    ref = dataclasses.asdict(JaxSkinConfig())
    assert ours == ref
    assert [f.name for f in dataclasses.fields(SkinDetectorConfig)] == \
        [f.name for f in dataclasses.fields(JaxSkinConfig)]
    custom = JaxSkinConfig(cb_min=80.0, downsample=2, pool_mode="mean")
    assert dataclasses.asdict(interop.skin_config_from_jax(
        dataclasses.asdict(custom))) == dataclasses.asdict(custom)


def test_config_types_are_shared():
    """The port's ``config`` is the JAX package's, field for field: every
    dataclass with the same field names in the same order and the same
    defaults, the same methods, and the same three bands."""
    classes = [n for n, v in vars(jconfig).items()
               if dataclasses.is_dataclass(v) and isinstance(v, type)]
    assert sorted(classes) == sorted(
        n for n, v in vars(config).items()
        if dataclasses.is_dataclass(v) and isinstance(v, type))
    assert len(classes) == 7
    for name in classes:
        ours, ref = getattr(config, name), getattr(jconfig, name)
        assert ours is not ref
        assert [(f.name, f.type) for f in dataclasses.fields(ours)] == \
            [(f.name, f.type) for f in dataclasses.fields(ref)], name
        if name != "HRBand":        # the one class without defaults
            assert dataclasses.asdict(ours()) == dataclasses.asdict(ref()), \
                name
    for band in ("BAND_VIDEO", "BAND_LIVE", "BAND_ANALYSIS"):
        assert dataclasses.asdict(getattr(config, band)) == \
            dataclasses.asdict(getattr(jconfig, band))
        assert getattr(vhr_tpu_torch, band) == getattr(config, band)
        assert getattr(config, band).high_bpm == \
            getattr(jconfig, band).high_bpm
    assert dataclasses.asdict(config.DEFAULT_CONFIG) == \
        dataclasses.asdict(jconfig.DEFAULT_CONFIG)
    ours = config.PipelineConfig(window_seconds=12.0,
                                 acquisition_seconds=3.5)
    ref = jconfig.PipelineConfig(window_seconds=12.0,
                                 acquisition_seconds=3.5)
    for fps in (10.0, 29.97, 30.0):
        assert ours.window_len(fps) == ref.window_len(fps)
        assert ours.acquisition_len(fps) == ref.acquisition_len(fps)
    assert vhr_tpu_torch.PipelineConfig is config.PipelineConfig
    assert vhr_tpu_torch.ROIConfig is config.ROIConfig


@pytest.mark.parametrize("fps", [10.0, 30.0])
@pytest.mark.parametrize("kind", ["butterworth", "cheby2", "fir"])
def test_design_equals_jax(kind, fps):
    """The port's copy of the filter design gives the JAX package's
    coefficients exactly, and the same initial conditions and padding."""
    band = config.BAND_ANALYSIS
    if kind == "fir":
        args = (41, band.low_hz / (0.5 * fps), band.high_hz / (0.5 * fps))
        got, want = design.firwin_bandpass(*args), \
            jdesign.firwin_bandpass(*args)
        np.testing.assert_array_equal(got, want)
        assert design.filtfilt_padlen(got, [1.0]) == \
            jdesign.filtfilt_padlen(want, [1.0])
        return
    args = (kind, fps, band.low_hz, band.high_hz, 2, 40.0)
    got, want = design.sos_design(*args), jdesign.sos_design(*args)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(design.sosfilt_zi(got),
                                  jdesign.sosfilt_zi(want))
    assert design.sosfiltfilt_padlen(got) == jdesign.sosfiltfilt_padlen(want)


def test_synth_copy_equals_jax_package():
    """The port's ``utils/synth.py`` is the JAX package's line for line
    below its docstring, and makes the same clips."""
    def body(mod):
        text = Path(mod.__file__).read_text()
        return text[text.index("from __future__"):].splitlines()

    assert body(synth) == body(jsynth)
    spec = dict(duration_s=1.0, height=24, width=32, motion_amplitude=1.0,
                dropout_frames=(3,), flicker_bpm=120.0, flicker_amp=0.1)
    ours, ref = synth.synthesize(synth.SynthSpec(**spec)), \
        jsynth.synthesize(jsynth.SynthSpec(**spec))
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(ours, f.name),
                                      getattr(ref, f.name), err_msg=f.name)


def test_cpu_reference_equals_jax_package():
    """The port's copy of the frame-at-a-time numpy reference gives the JAX
    package's ``{frame: bpm}``, including the N < 8 rule and a band with no
    bin."""
    rng = np.random.default_rng(3)
    t = np.arange(400) / 20.0
    green = (np.sin(2 * np.pi * 1.3 * t) + 0.5 * rng.normal(size=t.shape)
             ).astype(np.float32)
    for args in [(20.0, 10.0, 3.0), (20.0, 0.3, 0.2)]:
        assert cpu_reference_green_avg(green, *args) == \
            jax_reference(green, *args)
    narrow = config.HRBand(1.01, 1.02)
    assert cpu_reference_green_avg(green, 20.0, band=narrow) == \
        jax_reference(green, 20.0, band=jconfig.HRBand(1.01, 1.02))


def _app(main, *argv):
    """An app's ``main`` as an entry point taking ``device=``."""
    def call(device=None):
        return main(list(argv) + ([] if device is None
                                  else ["--device", device]))
    return call


def _plugin(measure, path):
    """A measurement plugin's ``measure(path)`` as an entry point taking
    ``device=``, which travels through ``analysis.context``."""
    def call(device=None):
        if device is None:
            return measure(path)
        context.set_device(device)
        try:
            return measure(path)
        finally:
            context.set_device(None)
    return call


@pytest.mark.parametrize("entry", ["BpmServer", "evm.measure",
                                   "extract_signals_streaming",
                                   "measure_green_avg_file",
                                   "make_mediapipe_detector",
                                   "make_mediapipe_detector_multi",
                                   "make_mediapipe_roi_detector",
                                   "make_mediapipe_poly_detector",
                                   "LivePipeline", "rppg_livestream",
                                   "serve_bpm", "analysis.main",
                                   "rppg_video", "bpp", "evm_magnify",
                                   "validation.main", "entry"])
def test_entry_points_need_a_card_or_cpu(entry, monkeypatch, tmp_path):
    """Without a CUDA card an entry point refuses to start unless the
    caller passes ``device="cpu"`` (``--device cpu`` for an app); it never
    falls back on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "missing.avi")
    call = {"BpmServer": lambda **kw: serving.BpmServer(n_slots=2, **kw),
            "evm.measure": _plugin(measure_evm.measure, path),
            "extract_signals_streaming":
                lambda **kw: offline.extract_signals_streaming(path, **kw),
            "measure_green_avg_file":
                lambda **kw: offline.measure_green_avg_file(path, **kw),
            "make_mediapipe_detector":
                lambda **kw: tmp.make_mediapipe_detector(path, **kw),
            "make_mediapipe_detector_multi":
                lambda **kw: tmp.make_mediapipe_detector_multi(path, **kw),
            "make_mediapipe_roi_detector":
                lambda **kw: tmp.make_mediapipe_roi_detector(path, **kw),
            "make_mediapipe_poly_detector":
                lambda **kw: tmp.make_mediapipe_poly_detector(path, **kw),
            "LivePipeline": lambda **kw: live.LivePipeline(**kw),
            "rppg_livestream": _app(rppg_livestream.main, "--video", path,
                                    "--no-display"),
            "serve_bpm": _app(serve_bpm.main, "--host", "127.0.0.1",
                              "--port", "0", "--height", "48", "--width",
                              "128", "--max-seconds", "0"),
            "analysis.main": _app(analysis_main.main, "--video", path,
                                  "--methods", "green_avg"),
            "rppg_video": _app(rppg_video.main, path, "--out-dir",
                               str(tmp_path / "out")),
            "bpp": _app(bpp.main, path, "--json"),
            "evm_magnify": _app(evm_magnify.main, path,
                                str(tmp_path / "out.mp4")),
            "validation.main": _app(tvalidation.main),
            "entry": lambda **kw: tentry.entry(**kw)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    if entry in ("validation.main", "entry"):
        return      # with device="cpu" they run (tests/test_torch_apps.py)
    if entry in ("bpp", "evm_magnify"):     # cv2 cannot open the file
        with pytest.raises(OSError, match="failed to open"):
            call(device="cpu")
        return
    if entry in ("BpmServer", "LivePipeline"):
        assert call(device="cpu").device == torch.device("cpu")
    elif entry in ("rppg_livestream", "analysis.main"):
        try:                             # it starts, and finds no file
            assert call(device="cpu") == 1
        finally:
            context.set_device(None)
    elif entry == "serve_bpm":           # it serves, for no time
        assert call(device="cpu") == 0
    else:       # with device="cpu" it starts, and finds no file
        with pytest.raises(FileNotFoundError):
            call(device="cpu")
