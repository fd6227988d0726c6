"""Port parity for the analysis harness (``vhr_tpu_torch.analysis``) and
the truth-CSV helpers of ``vhr_tpu_torch.io.video``, against ``vhr_tpu``.

The workspace is ``tests/test_analysis.py``'s: a 15 s mp4v clip of 64 x 80
at 78 BPM with a truth CSV sampled every 0.5 s; both packages decode the
same file with cv2, so their frames are equal.  The port's plugins run on
the CPU (``context.set_device("cpu")``); each package writes its results
and caches into a directory of its own.  Tolerances:

* ``read_truth_csv``, ``align_truth_to_measurement``, the ``dummy``
  sweep's ``.npy`` files, ``summary.json`` rows and metric CSVs, the level
  labels and the ffmpeg argv: equal;
* a measurement plugin's rows: timestamps and row count equal, BPM equal on
  >= 99 % of rows and within one DFT bin of the shortest window on the rest
  (``ica`` under the same rule as ``tests/test_torch_measures.py``);
* ``green_avg_psd``'s stage PSDs: ``rtol=1e-4``, and ``1e-7`` of the
  stage's peak in absolute terms for the bins at float32's floor;
* the device ops: quantise and the noise's add-and-clip step bit-equal;
  the port's own noise draw the same on two calls, with sample std within
  2 % of sigma; the resize within 1 u8 of JAX's and equal on >= 99.9 % of
  values (XLA contracts in an order of its own).
"""

import json
import os
import stat
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from vhr_tpu.analysis import context as jcontext
from vhr_tpu.analysis import main as jmain
from vhr_tpu.analysis import registry as jregistry
from vhr_tpu.analysis.degradation import colour_noise as jnoise
from vhr_tpu.analysis.degradation import colour_quantisation as jquant
from vhr_tpu.analysis.degradation import spatial_resolution as jspatial
from vhr_tpu.io import video as jvio

from vhr_tpu_torch.analysis import context, main as amain, registry
from vhr_tpu_torch.analysis.degradation import colour_noise as tnoise
from vhr_tpu_torch.analysis.degradation import colour_quantisation as tquant
from vhr_tpu_torch.analysis.degradation import spatial_resolution as tspatial
from vhr_tpu_torch.analysis.measurement import green_avg_psd
from vhr_tpu_torch.io import video as vio
from vhr_tpu_torch.utils.synth import SynthSpec, synthesize

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)

BPM = 78.0


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A videos/ dir with a synthetic clip + matching truth CSV."""
    root = tmp_path_factory.mktemp("analysis_ws")
    clip = synthesize(SynthSpec(duration_s=15.0, bpm=BPM, height=64,
                                width=80, noise_std=0.5))
    video = root / "subject.mp4"
    vio.write_video(clip.frames, str(video), clip.fps)
    csv_path = root / "subject.csv"
    csv_path.write_text("timestamp,heart_rate\n" + "\n".join(
        f"{x},{BPM}" for x in np.arange(0, 15.0, 0.5)))
    return {"root": root, "video": str(video), "csv": str(csv_path)}


@pytest.fixture()
def port_cpu():
    """The port's harness context on the CPU, restored afterwards."""
    context.set_device("cpu")
    try:
        yield
    finally:
        context.set_device(None)
        context.set_detector("skin")
        context.set_detect_every(1)
        jcontext.set_detector("skin")
        jcontext.set_detect_every(1)


def _dirs(monkeypatch, root: Path, pkg: str) -> Path:
    """Point the results and cache directories at ``root/pkg``."""
    base = root / pkg
    monkeypatch.setenv("VHR_RESULTS_DIR", str(base / "results"))
    monkeypatch.setenv("VHR_CACHE_DIR", str(base / "cache"))
    return base


# --- truth CSV helpers ------------------------------------------------------

_CSVS = {
    "clean": "timestamp,heart_rate\n0.0,70\n0.5,71.5\n1.0,72\n",
    "nan_and_blank": ("timestamp,heart_rate\n0.0,70\n0.5,\n,71\n1.0,NaN\n"
                      "1.5,nan\n2.0,73\nNA,74\n2.5,75\n"),
    "duplicates": ("timestamp,heart_rate\n0.0,70\n0.5,71\n0.5,99\n1.0,72\n"
                   "0.0,55\n1.0,\n1.0,80\n"),
    "unsorted": "timestamp,heart_rate\n2.0,73\n0.0,70\n1.5,72\n0.5,71\n",
    "extra_reordered": ("subject,heart_rate,quality,timestamp\n"
                        "a,70,0.9,1.0\nb,71,0.8,0.0\nc,72,,0.5\n"
                        "d,,0.7,1.5\n"),
    "mixed": ("heart_rate,timestamp,note\n72,3.0,x\n70,1.0,\n71,1.0,dup\n"
              "\n69,0.5,y\n,2.0,z\n73,2.5,\n"),
}


@pytest.mark.parametrize("name", sorted(_CSVS))
def test_read_truth_csv_matches_jax(name, tmp_path):
    path = tmp_path / f"{name}.csv"
    path.write_text(_CSVS[name])
    got, want = vio.read_truth_csv(str(path)), jvio.read_truth_csv(str(path))
    assert got.dtype == np.float64 and got.shape[1] == 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("text", [
    "timestamp,bpm\n0.0,70\n", "timestamp,heart_rate\n0.0,\nnan,71\n,\n"],
    ids=["missing_column", "no_valid_row"])
def test_read_truth_csv_rejects_like_jax(text, tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text(text)
    for read in (vio.read_truth_csv, jvio.read_truth_csv):
        with pytest.raises(ValueError):
            read(str(path))


def test_align_truth_matches_jax():
    rng = np.random.default_rng(5)
    truth = np.column_stack([np.sort(rng.uniform(0, 30, 40)),
                             rng.uniform(50, 110, 40)])
    measured = np.column_stack([rng.uniform(-2, 35, 200),
                                rng.normal(size=200)])
    np.testing.assert_array_equal(
        vio.align_truth_to_measurement(truth, measured),
        jvio.align_truth_to_measurement(truth, measured))


# --- measurement plugins ----------------------------------------------------

# The shortest window of each plugin's estimate, in seconds: its DFT bin is
# the widest one its rows can differ by.
_SHORTEST_S = {"green_avg": 10.0, "chrom": 10.0, "pos": 10.0, "omit": 10.0,
               "adaptive": 10.0, "green_avg_psd": 10.0, "evm": 10.0,
               "app_welch": 10.0, "ica": 5.0, "dummy": None}


@pytest.mark.parametrize("method", sorted(_SHORTEST_S))
def test_measurement_plugin_matches_jax(method, workspace, port_cpu,
                                        monkeypatch, tmp_path):
    _dirs(monkeypatch, tmp_path, "jax")
    want = jregistry.get_measurement(method).measure(workspace["video"])
    _dirs(monkeypatch, tmp_path, "port")
    got = registry.get_measurement(method).measure(workspace["video"])
    assert got.shape == want.shape and got.shape[0] > 100
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    shortest = _SHORTEST_S[method]
    if shortest is None:
        np.testing.assert_array_equal(got, want)
        return
    same = got[:, 1] == want[:, 1]
    assert same.mean() >= 0.99, same.mean()
    assert np.all(np.abs(got[:, 1] - want[:, 1]) <= 60.0 / shortest + 1e-4)
    steady = got[got[:, 0] >= 10.0, 1]
    assert abs(np.median(steady) - BPM) <= 6.0


def test_green_avg_psd_stages_match_jax(workspace, port_cpu, monkeypatch,
                                        tmp_path):
    """The stage PSDs and the two cache files of ``green_avg_psd``."""
    out = {}
    for pkg, reg in (("jax", jregistry), ("port", registry)):
        base = _dirs(monkeypatch, tmp_path, pkg)
        reg.get_measurement("green_avg_psd").measure(workspace["video"])
        out[pkg] = base / "cache"
    names = {pkg: sorted(str(p.relative_to(d)) for p in d.rglob("*.npz"))
             for pkg, d in out.items()}
    assert names["port"] == names["jax"] == [
        "psd_stages/subject.npz", "roi_mean_data/subject.npz"]
    got = np.load(out["port"] / "psd_stages" / "subject.npz")
    want = np.load(out["jax"] / "psd_stages" / "subject.npz")
    assert sorted(got.files) == sorted(want.files)
    np.testing.assert_array_equal(got["freqs"], want["freqs"])
    for k in set(want.files) - {"freqs"}:
        # Bins in the filters' stop band sit at float32's floor, 1e-7 of
        # the stage's peak, where a relative bound means nothing.
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-7 * np.abs(want[k]).max(),
                                   err_msg=k)
    # A second call reads the ROI-mean cache: the same rows.
    again = green_avg_psd.measure(workspace["video"])
    first = registry.get_measurement("green_avg_psd")
    np.testing.assert_array_equal(again, first.measure(workspace["video"]))


# --- device ops -------------------------------------------------------------

def _chunk(seed, shape=(5, 36, 44, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("bits", [7, 6, 5, 4])
def test_quantise_op_bit_equal(bits, port_cpu):
    chunk = _chunk(bits)
    got = tquant._quantise_op(bits)(chunk)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jquant._quantise_op(bits)(chunk))


@pytest.mark.parametrize("std", tnoise.NOISE_LEVELS)
def test_add_noise_bit_equal_on_jax_noise(std):
    """The add-and-clip step equals JAX's formula on JAX's own draw."""
    chunk = _chunk(std)
    key = jax.random.PRNGKey(tnoise._SEED + std)
    noise = np.array(float(std) * jax.random.normal(key, chunk.shape,
                                                    jnp.float32))
    want = np.asarray(jnp.clip(jnp.asarray(chunk).astype(jnp.float32)
                               + noise, 0, 255).astype(jnp.uint8))
    got = tnoise._add_noise(torch.as_tensor(chunk), torch.as_tensor(noise))
    np.testing.assert_array_equal(got.numpy(), want)
    # JAX's whole op, whose multiply and add XLA may fuse, agrees too.
    whole = jnoise._noisy_op(float(std), tnoise._SEED + std)(chunk)
    assert np.mean(whole == want) >= 0.9999


@pytest.mark.parametrize("std", [5, 40])
def test_noise_op_deterministic_with_sigma(std, port_cpu):
    chunk = np.full((4, 48, 64, 3), 128, np.uint8)
    op = tnoise._noisy_op(float(std), tnoise._SEED + std)
    first, second = op(chunk), op(chunk)
    np.testing.assert_array_equal(first, second)
    sample = first.astype(np.float64) - 128.0
    assert abs(sample.std() - std) <= 0.02 * std


@pytest.mark.parametrize("src,dst", [((64, 80), (40, 50)),
                                     ((90, 160), (40, 70)),
                                     ((48, 64), (24, 32))])
def test_resize_op_matches_jax(src, dst, port_cpu):
    chunk = _chunk(sum(src), (4,) + src + (3,))
    got = tspatial._resize_op(*dst)(chunk)
    want = jspatial._resize_op(*dst)(chunk)
    assert got.shape == want.shape == (4,) + dst + (3,)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


# --- degradations -----------------------------------------------------------

_LEVELS = ["colour_noise", "colour_quantisation", "crf", "dummy", "encoding",
           "spatial_resolution", "temporal_resolution"]


def _levels(reg, name, video):
    return list(reg.get_degradation(name).apply(video))


@pytest.mark.parametrize("name", _LEVELS)
def test_degradation_labels_match_jax(name, workspace, port_cpu,
                                      monkeypatch, tmp_path):
    """JAX's labels in JAX's order; a second ``apply`` reuses the files."""
    _dirs(monkeypatch, tmp_path, "jax")
    want = _levels(jregistry, name, workspace["video"])
    _dirs(monkeypatch, tmp_path, "port")
    got = _levels(registry, name, workspace["video"])
    assert [lbl for _, lbl in got] == [lbl for _, lbl in want]
    assert [Path(p).name for p, _ in got] == [Path(p).name for p, _ in want]
    for p, _ in got:
        assert Path(p).exists()
    mtimes = [Path(p).stat().st_mtime_ns for p, _ in got]
    again = _levels(registry, name, workspace["video"])
    assert [Path(p).stat().st_mtime_ns for p, _ in again] == mtimes


def test_spatial_level_matches_jax(port_cpu, monkeypatch, tmp_path):
    """A 256-row clip has one target below it (240p): the level's frames
    are JAX's size and within mp4v's noise of JAX's."""
    clip = synthesize(SynthSpec(duration_s=1.0, height=256, width=320))
    video = str(tmp_path / "tall.mp4")
    vio.write_video(clip.frames, video, clip.fps)
    frames = {}
    for pkg, reg in (("jax", jregistry), ("port", registry)):
        _dirs(monkeypatch, tmp_path, pkg)
        levels = _levels(reg, "spatial_resolution", video)
        assert [lbl for _, lbl in levels] == ["256p", "240p"]
        frames[pkg] = vio.read_video(levels[1][0])[0].astype(np.int16)
    assert frames["port"].shape == frames["jax"].shape == (30, 240, 300, 3)
    assert np.abs(frames["port"] - frames["jax"]).mean() < 1.0


STUB = r'''#!{python}
import json, shutil, sys
args = sys.argv[1:]
inp = args[args.index("-i") + 1]
out = args[-1]
shutil.copyfile(inp, out)
with open(out + ".argv.json", "w") as f:
    json.dump(args, f)
'''


@pytest.mark.parametrize("name", ["crf", "encoding", "spatial_resolution",
                                  "temporal_resolution"])
def test_ffmpeg_branch_argv_matches_jax(name, port_cpu, monkeypatch,
                                        tmp_path):
    """``tests/test_ffmpeg_branch.py``'s stub ffmpeg on PATH: each level's
    argv equals JAX's, up to the results directory."""
    exe = tmp_path / "bin" / "ffmpeg"
    exe.parent.mkdir()
    exe.write_text(STUB.format(python=sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{exe.parent}:{os.environ['PATH']}")
    monkeypatch.chdir(tmp_path)
    clip = synthesize(SynthSpec(duration_s=1.0, height=48, width=64))
    video = str(tmp_path / "clip.mp4")
    vio.write_video(clip.frames, video, clip.fps)
    argv = {}
    for pkg, reg in (("jax", jregistry), ("port", registry)):
        base = _dirs(monkeypatch, tmp_path, pkg)
        argv[pkg] = []
        for path, lbl in _levels(reg, name, video):
            if path == video:
                continue
            with open(path + ".argv.json") as f:
                argv[pkg].append(
                    (lbl, [a.replace(str(base), "<dir>") for a in
                           json.load(f)]))
    assert argv["port"] == argv["jax"]
    if name != "spatial_resolution":      # a 48-row clip has no level
        assert len(argv["port"]) >= 3


# --- the sweep --------------------------------------------------------------

def test_dummy_sweep_files_match_jax(workspace, port_cpu, monkeypatch,
                                     tmp_path):
    out = {}
    for pkg, sweep in (("jax", jmain.run_sweep), ("port", amain.run_sweep)):
        base = _dirs(monkeypatch, tmp_path, pkg)
        results = sweep(workspace["video"], workspace["csv"], ["dummy"],
                        ["dummy"], results_dir=str(base / "results"))
        assert list(results["dummy"]["dummy"]) == [
            "Dummy 1", "Dummy 2", "Dummy 3"]
        out[pkg] = base / "results" / "subject"
    port, ref = out["port"], out["jax"]
    npys = sorted(p.relative_to(ref) for p in ref.rglob("*.npy"))
    assert npys == sorted(p.relative_to(port) for p in port.rglob("*.npy"))
    assert len(npys) == 3
    for rel in npys:
        np.testing.assert_array_equal(np.load(port / rel), np.load(ref / rel))
    s_port = json.loads((port / "summary.json").read_text())
    s_ref = json.loads((ref / "summary.json").read_text())
    for k in ("degradations", "methods", "rows"):
        assert s_port[k] == s_ref[k], k
    assert set(s_port["stage_timings"]) == set(s_ref["stage_timings"])
    for name in ("mae_vs_dummy.csv", "accuracy_vs_dummy.csv"):
        assert (port / "plots" / name).read_bytes() == \
            (ref / "plots" / name).read_bytes()
    assert (port / "plots" / "signals_dummy.png").exists()


@pytest.mark.parametrize("missing", ["matplotlib", "scipy"])
def test_sweep_without_matplotlib(missing, workspace, port_cpu, monkeypatch,
                                  tmp_path, caplog):
    """A metric whose ``plot`` cannot import matplotlib writes no files and
    the sweep goes on; any other missing module stops it."""
    from vhr_tpu_torch.analysis.metrics import mae

    def plot(*args, **kwargs):
        raise ModuleNotFoundError(f"No module named {missing!r}",
                                  name=missing)

    monkeypatch.setattr(mae, "plot", plot)
    base = _dirs(monkeypatch, tmp_path, "port")
    run = lambda: amain.run_sweep(  # noqa: E731
        workspace["video"], workspace["csv"], ["dummy"], ["dummy"],
        results_dir=str(base / "results"))
    if missing != "matplotlib":
        with pytest.raises(ModuleNotFoundError):
            run()
        return
    run()
    plots = base / "results" / "subject" / "plots"
    assert not (plots / "mae_vs_dummy.csv").exists()
    assert (plots / "accuracy_vs_dummy.csv").exists()
    assert (base / "results" / "subject" / "summary.json").exists()
    assert any("metric mae: matplotlib is not installed" in r.getMessage()
               for r in caplog.records)


def test_main_runs_on_the_cpu(workspace, port_cpu, monkeypatch, tmp_path):
    base = _dirs(monkeypatch, tmp_path, "port")
    rc = amain.main(["--video", workspace["video"], "--methods", "green_avg",
                     "dummy", "--degradation", "original", "dummy",
                     "--device", "cpu", "--results-dir",
                     str(base / "results")])
    assert rc == 0
    summary = json.loads(
        (base / "results" / "subject" / "summary.json").read_text())
    assert summary["rows"]["original"]["green_avg"]["original"] > 100
    assert context.current_device() == torch.device("cpu")


def test_main_runs_with_the_landmarker(workspace, port_cpu, monkeypatch,
                                       tmp_path):
    """``--detector landmarker`` threads the learned detector to the
    sweep's measurement, which reads the clip's pulse through it."""
    base = _dirs(monkeypatch, tmp_path, "port")
    rc = amain.main(["--video", workspace["video"], "--methods", "green_avg",
                     "--detector", "landmarker", "--device", "cpu",
                     "--results-dir", str(base / "results")])
    assert rc == 0
    assert context.current_detector_name() == "landmarker"
    summary = json.loads(
        (base / "results" / "subject" / "summary.json").read_text())
    assert summary["rows"]["original"]["green_avg"]["original"] > 100


def test_user_plugin_file_loads(tmp_path):
    plugin = tmp_path / "const_hr.py"
    plugin.write_text(
        "import numpy as np\n"
        "def measure(path):\n"
        "    return np.column_stack([np.arange(5.0), np.full(5, 65.0)])\n")
    arr = registry.get_measurement(str(plugin)).measure("ignored")
    assert arr.shape == (5, 2) and arr[0, 1] == 65.0
    with pytest.raises(AttributeError, match="apply"):
        registry.get_degradation(str(plugin))
    with pytest.raises(FileNotFoundError):
        registry.get_measurement(str(tmp_path / "none.py"))


def test_registry_lists_match_jax():
    assert registry.degradations() == jregistry.degradations()
    assert registry.measurements() == jregistry.measurements()
    assert registry.metrics() == jregistry.metrics()
    assert len(registry.degradations()) == 7
    assert len(registry.measurements()) == 10
    assert [n for n, _ in registry.iter_metrics()] == \
        [n for n, _ in jregistry.iter_metrics()]


def test_context_device_needs_a_card_or_cpu(monkeypatch, port_cpu):
    """The sweep's device is the CUDA card unless set: without one the
    plugins refuse to start; the detector is cached per device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    context.set_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        context.current_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.get_measurement("green_avg").measure("missing.mp4")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tquant._quantise_op(4)
    context.set_device("cpu")
    assert context.current_device() == torch.device("cpu")
    assert context.current_detector() is None
