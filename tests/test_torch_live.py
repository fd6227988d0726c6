"""Port parity for the live step (``vhr_tpu_torch.pipeline.live``).

The same numpy inputs go through ``vhr_tpu``'s live functions (jitted, on
the CPU, the fused kernel in interpret mode) and the port's.  Tolerances:

- streaming SOS push and the live step's outputs: equal (the port rounds
  each float32 operation as XLA:CPU does under ``jit``);
- masked Welch: same peak bin and validity, mean PSD within ``rtol=1e-4``
  (float32 matmul sums in another order);
- the projection methods and the adaptive selector: every tick's BPM,
  validity and ``choice`` equal;
- ``transfer="i420"`` steps: equal, as the BGR steps;
- ``LivePipeline`` against the port's sequential step and its own 1-deep
  form: equal; against the JAX package's ``LivePipeline``: every field
  equal but the filtered green, within ``5e-4`` (the JAX pipeline's
  program rounds the SOS push a little differently from its own step,
  which the port equals; ``tests/test_torch_serving.py`` holds the pools
  to the same bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhr_tpu.dsp import design as jdesign
from vhr_tpu.dsp import filters as jfilters
from vhr_tpu.pipeline import live as jlive
from vhr_tpu.utils.synth import SynthSpec, synthesize

from vhr_tpu_torch import interop
from vhr_tpu_torch.dsp import design, filters, projections
from vhr_tpu_torch.pipeline import live

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clip():
    return synthesize(SynthSpec(duration_s=4.0, bpm=84.0, height=48,
                                width=128, fps=10.0, noise_std=0.5))


def _port_cfg(jcfg):
    return interop.live_config_from_jax(dataclasses.asdict(jcfg))


def _run_jax(jcfg, frames):
    st, stp = jlive.init_state(jcfg), jlive.make_step(jcfg, donate=False)
    outs = []
    for f in frames:
        st, o = stp(st, jnp.asarray(f))
        outs.append(jax.tree.map(np.asarray, o))
    return st, outs


def _run_port(cfg, frames):
    st, stp = live.init_state(cfg), live.make_step(cfg)
    outs = []
    for f in frames:
        st, o = stp(st, torch.as_tensor(f))
        outs.append(o)
    return st, outs


def _field(outs, k):
    return np.array([np.asarray(getattr(o, k)) for o in outs])


@pytest.mark.parametrize("fps,order", [(10.0, 4), (30.0, 4), (30.0, 2)])
def test_sos_stream_push_matches_jax(fps, order):
    sos = jdesign.sos_design("butterworth", fps, 40 / 60, 150 / 60, order)
    assert np.array_equal(design.sos_design("butterworth", fps, 40 / 60,
                                            150 / 60, order), sos)
    rng = np.random.default_rng(0)
    S = 512
    z = (rng.normal(size=(S, sos.shape[0], 2))
         * rng.uniform(0, 100, (S, 1, 1))).astype(np.float32)
    x = (rng.normal(size=(S,)) * 100).astype(np.float32)
    push = jax.jit(jax.vmap(lambda zz, xx: jfilters.sos_stream_push(sos, zz,
                                                                    xx)))
    y_ref, z_ref = map(np.asarray, push(z, x))
    y, z_new = filters.sos_stream_push(sos, torch.as_tensor(z),
                                       torch.as_tensor(x))
    np.testing.assert_array_equal(y.numpy(), y_ref)
    np.testing.assert_array_equal(z_new.numpy(), z_ref)
    # Unbatched state, as one live stream holds it.
    y1, z1 = filters.sos_stream_push(sos, torch.as_tensor(z[3]),
                                     torch.as_tensor(x[3]))
    assert y1.shape == () and float(y1) == y_ref[3]
    np.testing.assert_array_equal(z1.numpy(), z_ref[3])


@pytest.mark.parametrize("n_valid", [0, 100, 270, 271, 400, 500])
def test_masked_welch_bpm_matches_jax(n_valid):
    """A partly filled ring (zeros before the valid suffix), batched over
    rings with their own fill levels."""
    fps, N = 30.0, 500
    rng = np.random.default_rng(n_valid)
    t = np.arange(N) / fps
    rings = np.stack([np.sin(2 * np.pi * (1.0 + 0.3 * k) * t)
                      + 0.5 * rng.normal(size=N) for k in range(3)])
    fills = np.array([n_valid, max(n_valid - 50, 0), N])
    rings[np.arange(N)[None, :] < (N - fills)[:, None]] = 0.0
    rings = rings.astype(np.float32)
    bpm, valid = live._masked_welch_bpm(torch.as_tensor(rings),
                                        torch.as_tensor(fills), fps,
                                        live.LiveConfig().band, 9.0)
    psd = live._masked_welch_psd(torch.as_tensor(rings),
                                 torch.as_tensor(fills), fps,
                                 live.LiveConfig().band, 9.0)[0]
    for k in range(3):
        ref_bpm, ref_valid = jlive._masked_welch_bpm(
            jnp.asarray(rings[k]), jnp.int32(fills[k]), fps,
            jlive.LiveConfig().band, 9.0)
        ref_psd = jlive._masked_welch_psd(
            jnp.asarray(rings[k]), jnp.int32(fills[k]), fps,
            jlive.LiveConfig().band, 9.0)[0]
        assert float(bpm[k]) == float(ref_bpm)
        assert bool(valid[k]) == bool(ref_valid)
        np.testing.assert_allclose(psd[k].numpy(), np.asarray(ref_psd),
                                   rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("detect_every", [1, 3])
@pytest.mark.parametrize("use_fused", [True, False])
def test_live_step_matches_jax(clip, use_fused, detect_every):
    jcfg = jlive.LiveConfig(fps=clip.fps, use_fused=use_fused,
                            detect_every=detect_every, ring_len=30)
    jst, ref = _run_jax(jcfg, clip.frames)
    st, got = _run_port(_port_cfg(jcfg), clip.frames)
    for k in jlive.LiveOutput._fields:
        np.testing.assert_array_equal(_field(got, k), _field(ref, k),
                                      err_msg=k)
    assert _field(got, "bpm_valid")[-1]
    want = interop.live_state_to_numpy(
        interop.live_state_from_numpy(jax.tree.map(np.asarray, jst)))
    for k, v in interop.live_state_to_numpy(st).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_live_step_continues_a_jax_stream(clip):
    """Half a clip in JAX, the state handed over as numpy leaves, the rest in
    the port: the joined outputs equal JAX over the whole clip."""
    jcfg = jlive.LiveConfig(fps=clip.fps, use_fused=True, detect_every=2,
                            gate_margin=0.5, ring_len=24)
    _, ref = _run_jax(jcfg, clip.frames)
    half = 17
    jst, _ = _run_jax(jcfg, clip.frames[:half])
    cfg = _port_cfg(jcfg)
    st = interop.live_state_from_numpy(jax.tree.map(np.asarray, jst))
    outs = []
    for f in clip.frames[half:]:
        st, o = live.step(st, torch.as_tensor(f), cfg)
        outs.append(o)
    for k in ("bpm", "bpm_valid", "green_filtered", "box", "face_valid"):
        np.testing.assert_array_equal(_field(outs, k),
                                      _field(ref[half:], k), err_msg=k)


def test_pack_output_layout_matches_jax(clip):
    jcfg = jlive.LiveConfig(fps=clip.fps, ring_len=20)
    _, ref = _run_jax(jcfg, clip.frames[:25])
    _, got = _run_port(_port_cfg(jcfg), clip.frames[:25])
    packed = live.pack_output(got[-1])
    want = np.asarray(jlive.pack_output(jax.tree.map(jnp.asarray, ref[-1])))
    np.testing.assert_array_equal(packed.numpy(), want)
    back = live.unpack_output(packed.numpy())
    for k in jlive.LiveOutput._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(ref[-1], k)))


@pytest.mark.parametrize("method,use_fused", [
    ("chrom", True), ("pos", False), ("omit", True), ("adaptive", True),
    ("adaptive", False)])
def test_live_methods_match_jax(clip, method, use_fused):
    """The projection methods and the adaptive selector over a ring that
    fills (40 frames into a 30-sample ring): every tick's BPM, validity and
    ``choice`` equal ``vhr_tpu``'s, and so is the final state."""
    jcfg = jlive.LiveConfig(fps=clip.fps, use_fused=use_fused, ring_len=30,
                            method=method)
    jst, ref = _run_jax(jcfg, clip.frames)
    st, got = _run_port(_port_cfg(jcfg), clip.frames)
    for k in jlive.LiveOutput._fields:
        np.testing.assert_array_equal(_field(got, k), _field(ref, k),
                                      err_msg=k)
    assert _field(got, "bpm_valid")[-10:].all()
    if method == "adaptive":
        assert len(set(_field(got, "choice")[_field(got, "bpm_valid")])) > 1
    want = interop.live_state_to_numpy(
        interop.live_state_from_numpy(jax.tree.map(np.asarray, jst)))
    for k, v in interop.live_state_to_numpy(st).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("method", ["chrom", "pos", "omit", "adaptive"])
def test_projection_methods_not_ported_yet(method):
    """(Named when these methods raised.)  Each method now builds a step;
    once a 30-sample ring is full its pulse is the offline projection of
    the ring's frames, so the BPM is the masked Welch peak of that pulse,
    and ``choice`` indexes ``adaptive_methods``."""
    cfg = live.LiveConfig(method=method, fps=10.0, ring_len=30)
    rng = np.random.default_rng(9)
    t = np.arange(40) / 10.0
    bgr = np.stack([105 + np.sin(2 * np.pi * 1.4 * t),
                    135 + 2 * np.sin(2 * np.pi * 1.4 * t), 180 + 0 * t], 1)
    bgr = (bgr + 0.1 * rng.normal(size=bgr.shape)).astype(np.float32)
    # 40 samples written into a 30-sample ring: slot 10 holds the oldest.
    ring_bgr = torch.as_tensor(np.roll(bgr[-30:], 10, 0))[None]
    count = torch.tensor([40], dtype=torch.int32)
    bpm, valid, choice = live._method_bpm(
        cfg, ring_bgr[..., 1], ring_bgr, torch.zeros((1, 30)), count)
    if method != "adaptive":
        pulse = projections.PULSES[method](
            torch.as_tensor(bgr[-30:])[None],
            torch.ones((1, 30), dtype=torch.bool), 10.0,
            cfg.proj_window_seconds)
        want, ok = live._masked_welch_bpm(pulse, torch.tensor([30]), 10.0,
                                          cfg.band, 9.0)
        assert float(bpm[0]) == float(want[0]) and bool(valid[0]) == bool(ok)
    assert 0 <= int(choice[0]) < len(cfg.adaptive_methods)
    st, out = live.make_step(cfg)(live.init_state(cfg),
                                  torch.zeros((48, 128, 3), dtype=torch.uint8))
    assert not bool(out.face_valid) and int(out.choice) == 0


def test_live_config_checks():
    live.make_step(live.LiveConfig(), transfer="i420")
    with pytest.raises(ValueError, match="transfer"):
        live.make_step(live.LiveConfig(), transfer="yuv")
    with pytest.raises(ValueError, match="detector"):
        live.make_step(live.LiveConfig(use_fused=True),
                       detector=lambda f: None)
    with pytest.raises(ValueError, match="cheek"):
        live.make_step(live.LiveConfig(use_fused=True, roi_site="forehead"))
    with pytest.raises(ValueError, match="unknown"):
        live.make_step(live.LiveConfig(method="nope"))
    # The configuration is the JAX one, field for field.
    assert dataclasses.asdict(live.LiveConfig()) == \
        dataclasses.asdict(jlive.LiveConfig())
    bad = dict(dataclasses.asdict(jlive.LiveConfig()), extra=1)
    with pytest.raises(ValueError, match="extra"):
        interop.live_config_from_jax(bad)
    # LivePipeline's argument errors, as the JAX package raises them; the
    # multi-face pipeline (k_faces > 1) runs step_multi.
    for kw, match in [(dict(transfer="yuv"), "transfer"),
                      (dict(fetch_every=0), "fetch_every"),
                      (dict(frames_per_call=0), "frames_per_call"),
                      (dict(fetch_every=2, frames_per_call=2),
                       "alternative")]:
        with pytest.raises(ValueError, match=match):
            live.LivePipeline(live.LiveConfig(), device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            jlive.LivePipeline(jlive.LiveConfig(), **kw)
    multi = live.LivePipeline(live.LiveConfig(), k_faces=2, device="cpu")
    assert isinstance(multi._state, live.MultiLiveState)
    assert tuple(multi._state.count.shape) == (2,)
    with pytest.raises(ValueError, match="single-face"):
        live.LivePipeline(live.LiveConfig(use_fused=True), k_faces=2,
                          device="cpu")
    with pytest.raises(ValueError, match="detector"):
        live.LivePipeline(live.LiveConfig(use_fused=True),
                          detector=lambda f: None, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        live.LivePipeline(live.LiveConfig(method="nope"), device="cpu")


# -- transfer="i420" and LivePipeline ---------------------------------------

def _i420(frames):
    return [live.bgr_to_i420_host(f) for f in frames]


@pytest.mark.parametrize("use_fused", [True, False])
def test_live_step_i420_matches_jax(clip, use_fused):
    """``make_step(transfer="i420")`` on planar frames, fused and skin:
    every tick's outputs and the final state equal ``vhr_tpu``'s I420
    step's, as ``test_live_methods_match_jax`` holds them."""
    jcfg = jlive.LiveConfig(fps=clip.fps, use_fused=use_fused, ring_len=30,
                            detect_every=2)
    planar = _i420(clip.frames)
    jst, jstp = jlive.init_state(jcfg), jlive.make_step(
        jcfg, donate=False, transfer="i420")
    ref = []
    for f in planar:
        jst, o = jstp(jst, jnp.asarray(f))
        ref.append(jax.tree.map(np.asarray, o))
    cfg = _port_cfg(jcfg)
    st, stp = live.init_state(cfg), live.make_step(cfg, transfer="i420")
    got = []
    for f in planar:
        st, o = stp(st, torch.as_tensor(f))
        got.append(o)
    for k in jlive.LiveOutput._fields:
        np.testing.assert_array_equal(_field(got, k), _field(ref, k),
                                      err_msg=k)
    assert _field(got, "bpm_valid")[-1]
    want = interop.live_state_to_numpy(
        interop.live_state_from_numpy(jax.tree.map(np.asarray, jst)))
    for k, v in interop.live_state_to_numpy(st).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def _pipe_outputs(pipe, frames):
    """Every output of ``pipe`` over ``frames`` and its flush, in order,
    with the call on which each came back."""
    outs, when = [], []
    for i, f in enumerate(frames):
        o = pipe.submit(f)
        if o is not None:
            batch = o if isinstance(o, list) else [o]
            outs.extend(batch)
            when.extend([i] * len(batch))
    o = pipe.flush()
    if o is not None:
        batch = o if isinstance(o, list) else [o]
        outs.extend(batch)
        when.extend([len(frames)] * len(batch))
    return outs, when


def _assert_outputs_equal(got, ref, filt_atol=0.0):
    assert len(got) == len(ref)
    for k in live.LiveOutput._fields:
        g, r = _field(got, k), _field(ref, k)
        if k == "green_filtered" and filt_atol:
            np.testing.assert_allclose(g, r, rtol=0, atol=filt_atol)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)


@pytest.mark.parametrize("transfer,use_fused", [
    ("bgr", True), ("bgr", False), ("i420", True), ("i420", False)])
def test_live_pipeline_matches_sequential_step(clip, transfer, use_fused):
    """The 1-deep pipeline returns the sequential step's outputs shifted by
    one call: nothing on the first submit, frame N-1's on submit N, the
    last frame's on flush."""
    cfg = live.LiveConfig(fps=clip.fps, use_fused=use_fused, ring_len=30,
                          detect_every=3)
    frames = _i420(clip.frames) if transfer == "i420" else clip.frames
    st, stp = live.init_state(cfg), live.make_step(cfg, transfer=transfer)
    ref = []
    for f in frames:
        st, o = stp(st, torch.as_tensor(f))
        ref.append(o)
    pipe = live.LivePipeline(cfg, transfer=transfer, device="cpu")
    got, when = _pipe_outputs(pipe, frames)
    assert when == list(range(1, len(frames) + 1))
    _assert_outputs_equal(got, ref)
    assert isinstance(got[-1].bpm, np.ndarray) and got[-1].bpm_valid
    for k, v in interop.live_state_to_numpy(pipe._state).items():
        np.testing.assert_array_equal(
            v, interop.live_state_to_numpy(st)[k], err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(fetch_every=3), dict(frames_per_call=4),
    dict(frames_per_call=4, transfer="i420")])
def test_live_pipeline_batching_equals_one_deep(clip, kw):
    """``fetch_every=3`` and ``frames_per_call=4`` over 23 frames (a partial
    tail for both) give the 1-deep pipeline's outputs, in lists, on the
    calls the JAX package returns them: N outputs every N-th call from the
    (N+1)-th, M every M-th from the 2M-th, the rest on flush."""
    frames = clip.frames[:23]
    cfg = live.LiveConfig(fps=clip.fps, use_fused=True, ring_len=20)
    transfer = kw.get("transfer", "bgr")
    src = _i420(frames) if transfer == "i420" else frames
    ref, _ = _pipe_outputs(live.LivePipeline(cfg, device="cpu",
                                             transfer=transfer), src)
    got, when = _pipe_outputs(live.LivePipeline(cfg, device="cpu", **kw),
                              src)
    _assert_outputs_equal(got, ref)
    n = kw.get("fetch_every", 1)
    m = kw.get("frames_per_call", 1)
    if n > 1:
        want = [i for i in range(n, 23, n) for _ in range(n)]
    else:
        want = [i for i in range(2 * m - 1, 23, m) for _ in range(m)]
    assert when == want + [23] * (23 - len(want))


@pytest.mark.parametrize("use_fused", [True, False])
def test_live_pipeline_matches_jax_pipeline(clip, use_fused):
    """The port's ``LivePipeline`` against the JAX package's on the same
    planar frames (``transfer="i420"``, ``frames_per_call=4``): the same
    outputs on the same calls."""
    jcfg = jlive.LiveConfig(fps=clip.fps, use_fused=use_fused, ring_len=30)
    frames = _i420(clip.frames)
    ref, ref_when = _pipe_outputs(jlive.LivePipeline(
        jcfg, donate=False, transfer="i420", frames_per_call=4), frames)
    got, when = _pipe_outputs(live.LivePipeline(
        _port_cfg(jcfg), transfer="i420", frames_per_call=4, device="cpu"),
        frames)
    assert when == ref_when
    _assert_outputs_equal(got, ref, filt_atol=5e-4)
    assert got[-1].bpm_valid


# -- the live step with the MediaPipe detector --------------------------------

@pytest.fixture(scope="module")
def mp_face_clip():
    """90 frames of ``tests/test_torch_mediapipe.py``'s drawn face at 192 x
    224, swaying +-4 px, with a 1.25 Hz green pulse on its skin."""
    from test_torch_mediapipe import draw_face
    img = draw_face(H=192, W=224, cx=112, cy=96, rx=45, ry=62)
    ys, xs = np.mgrid[0:192, 0:224]
    skin = ((xs - 112) / 45.0) ** 2 + ((ys - 96) / 62.0) ** 2 <= 1.0
    out = []
    for t in range(90):
        f = img.astype(np.float32)
        f[skin, 1] += 3.0 * np.sin(2 * np.pi * 1.25 * t / 10.0)
        out.append(np.roll(f, int(round(4 * np.sin(t / 7.0))), axis=1))
    return np.clip(np.stack(out), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("detect_every", [1, 3])
def test_live_step_mediapipe_matches_jax(mp_face_clip, detect_every):
    """The single-face live step with the MediaPipe detector (float32
    nets), and ``LivePipeline`` with it, against ``vhr_tpu``'s step: every
    ``LiveOutput`` field equal on every frame."""
    from vhr_tpu.models import mediapipe_face as jmp
    from vhr_tpu_torch.models import mediapipe_face as tmp
    jdet = jmp.make_mediapipe_detector(tmp.default_task_path(),
                                       activation_dtype=None)
    tdet = tmp.make_mediapipe_detector(activation_dtype=None, device="cpu")
    jcfg = jlive.LiveConfig(fps=10.0, detect_every=detect_every, ring_len=30)
    jst = jlive.init_state(jcfg)
    jstp = jlive.make_step(jcfg, donate=False, detector=jdet)
    ref = []
    for f in mp_face_clip:
        jst, o = jstp(jst, jnp.asarray(f))
        ref.append(jax.tree.map(np.asarray, o))
    cfg = _port_cfg(jcfg)
    st, stp = live.init_state(cfg), live.make_step(cfg, detector=tdet)
    got = []
    for f in mp_face_clip:
        st, o = stp(st, torch.as_tensor(f))
        got.append(o)
    _assert_outputs_equal(got, ref)
    assert _field(got, "face_valid").all() and _field(got, "bpm_valid")[-1]
    piped, _ = _pipe_outputs(live.LivePipeline(cfg, detector=tdet,
                                               device="cpu"), mp_face_clip)
    _assert_outputs_equal(piped, ref)
