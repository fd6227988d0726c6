"""The port's learned landmarker (``vhr_tpu_torch.models.landmarker``)
against the JAX package's on the CPU.

Both packages get the same numpy inputs made from a seed.  The weights are
the repo's checkpoints: JAX restores them with orbax, the port reads their
``.npz`` export with numpy (``tools/export_landmarker_weights.py``).
Tolerances: the resize within 1e-6; the net in float32 within 1e-5
(landmarks) and 1e-4 (presence logit), in bf16 (the shipped config)
within 1e-3 and 2e-2, where each side rounds its convs to bf16 on its own;
the detectors' boxes within 1 px, their validity equal wherever the
presence logit is more than 0.05 from the threshold.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vhr_tpu.models import checkpoint as jckpt
from vhr_tpu.models import facegen
from vhr_tpu.models import landmarker as jlmk
from vhr_tpu.models.train import TrainConfig
from vhr_tpu.pipeline import offline as joffline
from vhr_tpu.utils.synth import SynthSpec, synthesize

from tools.export_landmarker_weights import flat_leaves
from vhr_tpu_torch.interop import landmarker_params_from_jax
from vhr_tpu_torch.models import landmarker as tlmk
from vhr_tpu_torch.ops import reduce as treduce
from vhr_tpu_torch.pipeline import offline as toffline

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CKPTS = ("landmarker", "landmarker_distill")


@pytest.fixture(scope="module")
def jax_params():
    """Each checkpoint as JAX restores it."""
    return {name: jlmk.load_default_detector(
        str(REPO / "checkpoints" / name)).args[0] for name in CKPTS}


@pytest.fixture(scope="module")
def clip():
    """A 20-frame ``utils/synth`` clip at 16:9."""
    return synthesize(SynthSpec(duration_s=20 / 30, height=144, width=256,
                                noise_std=1.0))


def _configs(dtype_name):
    jcfg, tcfg = jlmk.LandmarkerConfig(), tlmk.LandmarkerConfig()
    if dtype_name == "float32":
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    return jcfg, tcfg


# -- weights and configuration ----------------------------------------------

@pytest.mark.parametrize("name", CKPTS)
def test_npz_equals_orbax_checkpoint(name):
    """Each exported archive holds the checkpoint's leaves bit for bit."""
    cfg = TrainConfig().model
    like = jlmk.FaceLandmarker(cfg).init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, cfg.input_size, cfg.input_size, 3)))["params"]
    want = flat_leaves(jckpt.load_params(str(REPO / "checkpoints" / name),
                                         like=like))
    with np.load(REPO / "checkpoints" / f"{name}.npz") as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want) and len(got) == 32
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
        assert np.array_equal(got[k].view(np.uint32), w.view(np.uint32)), k


def test_landmarker_config_equals_jax():
    """The port's default config is the JAX model's training config, field
    for field (the dtype by name)."""
    j, t = TrainConfig().model, tlmk.LandmarkerConfig()
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert sorted(jd) == sorted(td)
    for k in jd:
        if k == "compute_dtype":
            assert jnp.dtype(jd[k]).name == str(td[k]).split(".")[-1]
        else:
            assert jd[k] == td[k], k


def test_params_conversion_rejects_bad_leaves(jax_params):
    leaves = flat_leaves(jax_params["landmarker"])
    bad = dict(leaves)
    bad["block9/dw/kernel"] = bad.pop("block0/dw/kernel")
    with pytest.raises(ValueError, match="differ"):
        landmarker_params_from_jax(bad, device="cpu")
    missing = {k: v for k, v in leaves.items() if k != "trunk/bias"}
    with pytest.raises(ValueError, match="missing"):
        landmarker_params_from_jax(missing, device="cpu")
    wrong = dict(leaves, **{"trunk/kernel": leaves["trunk/kernel"][:-1]})
    with pytest.raises(ValueError, match="shape"):
        landmarker_params_from_jax(wrong, device="cpu")


# -- the net ------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(96, 120), (144, 256), (600, 512), (61, 97)])
def test_preprocess_frames_matches_jax(hw):
    """The antialiased bilinear resize of ``jax.image.resize`` within 1e-6,
    upscaling, downscaling and mixed, at an odd size too."""
    rng = np.random.default_rng(hw[0])
    frames = rng.integers(0, 256, (3,) + hw + (3,), dtype=np.uint8)
    want = np.asarray(jlmk.preprocess_frames(jnp.asarray(frames), 96))
    got = tlmk.preprocess_frames(torch.as_tensor(frames), 96).numpy()
    assert got.shape == want.shape == (3, 96, 96, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


_NET_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 2e-2)}


@pytest.mark.parametrize("dtype_name,weights", [
    ("float32", "init"), ("float32", "landmarker"),
    ("float32", "landmarker_distill"), ("bfloat16", "landmarker"),
    ("bfloat16", "landmarker_distill")])
def test_face_landmarker_matches_flax(jax_params, clip, dtype_name, weights):
    """The net on Flax-``init`` random weights (seeded) and on both
    checkpoints, the inputs the net's domain: the synth clip's frames and
    held-out facegen frames, resized by JAX.

    The convs are XLA's bit for bit; GroupNorm's float32 statistics sum in
    another order, so about 3e-4 of its bf16 outputs round one ulp apart.
    The trained nets keep that within 1e-3; the untrained ``init`` net
    amplifies it to 1.2e-3, so it is held in float32 only."""
    jcfg, tcfg = _configs(dtype_name)
    fg, _ = facegen.render_clip(
        facegen.FaceGenConfig(held_out=True, face_prob=1.0),
        np.random.default_rng(11), 4, 96, 120)
    x = np.concatenate([
        np.asarray(jlmk.preprocess_frames(jnp.asarray(f), 96))
        for f in (clip.frames[::4], fg)])
    if weights == "init":
        params = jlmk.FaceLandmarker(jcfg).init(
            jax.random.PRNGKey(5), jnp.zeros((1, 96, 96, 3)))["params"]
    else:
        params = jax_params[weights]
    jlm, jpr = jlmk.FaceLandmarker(jcfg).apply({"params": params},
                                               jnp.asarray(x))
    model = tlmk.build_model(
        landmarker_params_from_jax(flat_leaves(params), device="cpu"),
        tcfg, "cpu")
    tlm, tpr = tlmk.run_net(model, torch.as_tensor(x))
    lm_tol, pr_tol = _NET_TOL[dtype_name]
    np.testing.assert_allclose(tlm.numpy(), np.asarray(jlm), atol=lm_tol,
                               rtol=0)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), atol=pr_tol,
                               rtol=0)


def test_net_in_slices_equals_one_batch():
    """GroupNorm works per sample: in float32, splitting the batch changes
    the result only by the convolutions' summation order."""
    cfg = dataclasses.replace(tlmk.LandmarkerConfig(),
                              compute_dtype=torch.float32)
    model = tlmk.build_model(tlmk.load_params(device="cpu"), cfg, "cpu")
    x = torch.as_tensor(np.random.default_rng(2).random(
        (7, 96, 96, 3), dtype=np.float32))
    whole = tlmk.run_net(model, x)
    parts = [tlmk.run_net(model, x[i:i + 1]) for i in range(7)]
    for w, p in zip(whole, zip(*parts)):
        torch.testing.assert_close(torch.cat(p), w, rtol=1e-6, atol=1e-6)


# -- the detectors ------------------------------------------------------------

def _jax_logits(params, frames):
    cfg = TrainConfig().model
    x = jlmk.preprocess_frames(jnp.asarray(frames), cfg.input_size)
    return np.asarray(jlmk.FaceLandmarker(cfg).apply({"params": params},
                                                     x)[1])


@pytest.mark.parametrize("choice", ["landmarker", "landmarker-real"])
def test_detectors_match_jax(jax_params, clip, choice):
    """``load_default_detector`` and ``load_real_distilled_detector`` on
    the synth clip: boxes within 1 px, validity equal where the logit is
    clear of the threshold."""
    if choice == "landmarker":
        jdet, tdet = (jlmk.load_default_detector(),
                      tlmk.load_default_detector(device="cpu"))
        params = jax_params["landmarker"]
    else:
        jdet, tdet = (jlmk.load_real_distilled_detector(),
                      tlmk.load_real_distilled_detector(device="cpu"))
        params = jax_params["landmarker_distill"]
    jb, jv = (np.asarray(a) for a in jdet(jnp.asarray(clip.frames)))
    tb, tv = tdet(clip.frames)
    assert tb.dtype == torch.int32 and tv.dtype == torch.bool
    clear = np.abs(_jax_logits(params, clip.frames)) > 0.05
    assert (tv.numpy() == jv)[clear].all()
    assert np.abs(tb.numpy() - jb).max() <= 1


def test_detector_params_rewrap(clip):
    """The detector carries its weights and config, which the apps re-wrap
    as the multi-face detectors, and drops into ``extract_signals``."""
    det = tlmk.load_default_detector(device="cpu")
    again = tlmk.make_detector(det.params, det.cfg, device="cpu")
    b1, v1 = det(clip.frames[:4])
    b2, v2 = again(torch.as_tensor(clip.frames[:4]))
    assert torch.equal(b1, b2) and torch.equal(v1, v2)
    trace = toffline.extract_signals(torch.as_tensor(clip.frames),
                                     detector=det)
    assert tuple(trace.bgr.shape) == (20, 3) and bool(trace.valid.all())


def test_roi_detector_matches_jax(jax_params, clip):
    """``make_roi_detector`` through ``extract_signals_landmark_roi``:
    ROIs and boxes within 1 px of JAX's; the means within 1e-4 of JAX's
    where the ROIs agree, and the port's reduction of JAX's ROIs within
    1e-4 of JAX's means on every frame."""
    jdet = jlmk.make_roi_detector(jax_params["landmarker"],
                                  TrainConfig().model)
    tdet = tlmk.make_roi_detector(tlmk.load_params(device="cpu"),
                                  device="cpu")
    jt = joffline.extract_signals_landmark_roi(jnp.asarray(clip.frames), jdet)
    tt = toffline.extract_signals_landmark_roi(torch.as_tensor(clip.frames),
                                               tdet)
    assert np.array_equal(tt.valid.numpy(), np.asarray(jt.valid))
    assert np.abs(tt.rois.numpy() - np.asarray(jt.rois)).max() <= 1
    assert np.abs(tt.boxes.numpy() - np.asarray(jt.boxes)).max() <= 1
    same = (tt.rois.numpy() == np.asarray(jt.rois)).all(axis=1)
    assert same.any()
    np.testing.assert_allclose(tt.bgr.numpy()[same],
                               np.asarray(jt.bgr)[same], atol=1e-4, rtol=0)
    on_jax, _ = treduce.roi_channel_means(
        torch.as_tensor(clip.frames),
        torch.as_tensor(np.array(jt.rois, np.int32)))
    np.testing.assert_allclose(on_jax.numpy(), np.asarray(jt.bgr),
                               atol=1e-4, rtol=0)
    # Every ROI sits inside a slightly padded true face box.
    rois, truth = tt.rois.numpy(), clip.face_boxes
    assert (rois[:, :2] >= truth[:, :2] - 6).all()
    assert (rois[:, 2:] <= truth[:, 2:] + 6).all()


def _iou(a, c):
    ix = max(0, min(a[2], c[2]) - max(a[0], c[0]))
    iy = max(0, min(a[3], c[3]) - max(a[1], c[1]))
    inter = ix * iy
    union = ((a[2] - a[0]) * (a[3] - a[1])
             + (c[2] - c[0]) * (c[3] - c[1]) - inter)
    return inter / max(union, 1)


def test_port_localizes_held_out_faces():
    """The JAX package's held-out facegen bar on the port: mean IoU >= 0.8
    over five clips of the held-out generator family (interpolated tones,
    shifted poses, elliptical occluders)."""
    det = tlmk.load_default_detector(device="cpu")
    gen = facegen.FaceGenConfig(held_out=True, face_prob=1.0)
    rng = np.random.default_rng(7)
    ious = []
    for _ in range(5):
        fr, truth = facegen.render_clip(gen, rng, 4, 96, 120)
        b, v = det(fr)
        ious += [_iou(b[i].tolist(), truth[i]) if v[i] else 0.0
                 for i in range(4)]
    assert float(np.mean(ious)) >= 0.8, ious
