"""The port's skin (chroma) multi-face path against the JAX package's, on
the CPU: ``models.multiface.detect_faces_multi``, the K-track holdover
(``ops.roi.holdover_multi``, ``holdover_multi_step``),
``reduce.roi_channel_means_multi``, ``offline.extract_signals_multi`` and
``measure_green_avg_multi``, the live ``step_multi`` and
``LivePipeline(k_faces=2)``, the K=2 serving pool and its front-end's
per-subject JSON lists, and ``--faces 2`` in the live and serving apps.

Both packages see the same numpy clips (``utils.synth.synthesize_multi``,
seeded): integer outputs (boxes, validity, ROIs) must be equal, the means
equal to K single-ROI calls, BPM equal on >= 99 % of valid frames.
"""

import contextlib
import dataclasses
import io
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhr_tpu import serving as jserving
from vhr_tpu.apps import rppg_livestream as jlivestream
from vhr_tpu.config import PipelineConfig as JaxPipelineConfig
from vhr_tpu.models.multiface import detect_faces_multi as jdetect
from vhr_tpu.ops import reduce as jreduce
from vhr_tpu.ops import roi as jroi
from vhr_tpu.pipeline import live as jlive
from vhr_tpu.pipeline import offline as joffline
from vhr_tpu.utils.synth import FaceSpec, synthesize_multi

from vhr_tpu_torch import serving
from vhr_tpu_torch.apps import rppg_livestream, serve_bpm
from vhr_tpu_torch.config import PipelineConfig
from vhr_tpu_torch.io import video as tvio
from vhr_tpu_torch.models.multiface import detect_faces_multi
from vhr_tpu_torch.models.skin_detector import SkinDetectorConfig
from vhr_tpu_torch.ops import reduce as treduce
from vhr_tpu_torch.ops import roi as troi
from vhr_tpu_torch.pipeline import live
from vhr_tpu_torch.pipeline import offline

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)

BPM_SHARE = 0.99


def _duo(**kw):
    faces = kw.pop("faces", (FaceSpec(center=(0.25, 0.45), bpm=60.0),
                             FaceSpec(center=(0.72, 0.5), bpm=96.0)))
    return synthesize_multi(faces, **kw)


# The clips: two faces (tests/test_multiface.py's), one face dropping out
# for 10 frames and returning (its :47), two faces of equal area (the
# top-K and x-order ties), and a face that appears late at the left of an
# already tracked one (a free slot claimed by the leftmost candidate).
CLIPS = {
    "duo": dict(height=144, width=256, duration_s=4.0, noise_std=1.0),
    "dropout": dict(faces=(FaceSpec(center=(0.25, 0.45), bpm=66.0,
                                    dropout_frames=tuple(range(40, 50))),
                           FaceSpec(center=(0.72, 0.5), bpm=90.0)),
                    duration_s=4.0),
    "equal_area": dict(faces=(FaceSpec(center=(0.3, 0.5), bpm=66.0),
                              FaceSpec(center=(0.7, 0.5), bpm=90.0)),
                       height=64, width=128, duration_s=2.0),
    "late_left": dict(faces=(FaceSpec(center=(0.25, 0.45), bpm=66.0,
                                      dropout_frames=tuple(range(0, 30))),
                             FaceSpec(center=(0.72, 0.5), bpm=90.0)),
                      duration_s=2.0, noise_std=1.0),
}


@pytest.fixture(scope="module", params=sorted(CLIPS))
def clip(request):
    return request.param, _duo(**CLIPS[request.param])


def _share(want, got, valid):
    v = np.asarray(valid, bool)
    if not v.any():
        return 1.0
    return float((np.asarray(want)[v] == np.asarray(got)[v]).mean())


# -- detection and the K-track holdover --------------------------------------

def test_detect_faces_multi_matches_jax(clip):
    name, duo = clip
    want_b, want_v = jdetect(jnp.asarray(duo.frames), k_faces=2)
    got_b, got_v = detect_faces_multi(torch.as_tensor(duo.frames), 2)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    if name == "equal_area":
        # Equal areas: both faces kept, in x-order.
        assert bool(got_v.all())
        assert (got_b[:, 0, 0] < got_b[:, 1, 0]).all()


@pytest.mark.parametrize("kw", [dict(k_faces=3), dict(k_faces=1),
                                dict(k_faces=2, candidates=2),
                                dict(k_faces=2, downsample=2),
                                dict(k_faces=2, downsample=3,
                                     pool_mode="mean")])
def test_detect_faces_multi_options_match_jax(kw):
    """More slots than faces, one slot, fewer candidates, and detection on
    a pooled grid (the boxes scaled back and clipped to the frame)."""
    from vhr_tpu.models.skin_detector import SkinDetectorConfig as JCfg
    duo = _duo(**CLIPS["duo"])
    k = kw.pop("k_faces")
    cand = kw.pop("candidates", None)
    want = jdetect(jnp.asarray(duo.frames[:20]), k, JCfg(**kw), cand)
    got = detect_faces_multi(torch.as_tensor(duo.frames[:20]), k,
                             SkinDetectorConfig(**kw), cand)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("detect_every", [1, 2])
def test_extract_signals_multi_matches_jax(clip, detect_every):
    """The holdover (boxes, validity), the ROIs and the means equal JAX's;
    through a dropout slot 0 stays the left subject on its held box."""
    name, duo = clip
    want = joffline.extract_signals_multi(jnp.asarray(duo.frames), 2,
                                          detect_every=detect_every)
    got = offline.extract_signals_multi(torch.as_tensor(duo.frames), 2,
                                        detect_every=detect_every)
    for f in ("valid", "rois", "boxes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.bgr.numpy(), np.asarray(want.bgr),
                               rtol=1e-6, atol=1e-4)
    if name == "dropout" and detect_every == 1:
        v, b = got.valid.numpy(), got.boxes.numpy()
        assert v[40:50, 0].all() and v[:, 1].all()
        np.testing.assert_array_equal(b[45, 0], b[39, 0])
        assert (b[40:50, 1, 0] > b[40:50, 0, 2]).all()


def test_holdover_multi_matches_jax_on_random_candidates():
    """Random candidates with dropouts, equal centres and a cadence: the
    scan's boxes and validity equal JAX's ``holdover_multi``."""
    rng = np.random.default_rng(7)
    T, K = 120, 3
    box = rng.integers(0, 60, (T, K, 4)).astype(np.int32)
    box[..., 2:] += box[..., :2]
    box[10:20, 1] = box[10:20, 0]                     # equal centres
    valid = rng.random((T, K)) > 0.3
    valid[30:50] = False                              # budgets run out
    attempted = (np.arange(T) % 3) != 1
    for att in (None, attempted):
        want = jroi.holdover_multi(jnp.asarray(box), jnp.asarray(valid), 5,
                                   None if att is None
                                   else jnp.asarray(att))
        got = troi.holdover_multi(torch.as_tensor(box),
                                  torch.as_tensor(valid), 5,
                                  None if att is None
                                  else torch.as_tensor(att))
        np.testing.assert_array_equal(got.box.numpy(), np.asarray(want.box))
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))


def test_holdover_multi_step_batched_equals_per_slot():
    """The step over a leading slot axis (the pool's) equals each slot's
    step alone."""
    rng = np.random.default_rng(3)
    S, K = 4, 2
    carry = troi.init_multi_carry(K, (S,))
    carries = [troi.init_multi_carry(K) for _ in range(S)]
    for t in range(30):
        cand = torch.as_tensor(rng.integers(0, 50, (S, K, 4)), dtype=torch.int32)
        cval = torch.as_tensor(rng.random((S, K)) > 0.4)
        att = torch.as_tensor(rng.random(S) > 0.2)
        carry, (b, v) = troi.holdover_multi_step(carry, cand, cval, 4, att)
        for s in range(S):
            carries[s], (bs, vs) = troi.holdover_multi_step(
                carries[s], cand[s], cval[s], 4, att[s])
            assert torch.equal(b[s], bs) and torch.equal(v[s], vs)


def test_roi_channel_means_multi_equals_k_single_calls():
    """K ROIs a frame equal K calls of ``roi_channel_means`` exactly, and
    JAX's ``roi_channel_means_multi`` within float32 rounding; ROIs off the
    frame and empty ROIs included."""
    rng = np.random.default_rng(11)
    T, H, W, K = 6, 40, 56, 3
    frames = rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8)
    x1 = rng.integers(-10, W, (T, K))
    y1 = rng.integers(-10, H, (T, K))
    rois = np.stack([x1, y1, x1 + rng.integers(-3, 40, (T, K)),
                     y1 + rng.integers(-3, 30, (T, K))], -1).astype(np.int32)
    means, count = treduce.roi_channel_means_multi(
        torch.as_tensor(frames), torch.as_tensor(rois))
    for k in range(K):
        m_k, c_k = treduce.roi_channel_means(torch.as_tensor(frames),
                                             torch.as_tensor(rois[:, k]))
        assert torch.equal(means[:, k], m_k) and torch.equal(count[:, k], c_k)
    jm, jc = jreduce.roi_channel_means_multi(jnp.asarray(frames),
                                             jnp.asarray(rois))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc))
    np.testing.assert_allclose(means.numpy(), np.asarray(jm), rtol=1e-6,
                               atol=1e-4)


@pytest.fixture(scope="module")
def long_duo():
    """``tests/test_multiface.py``'s 25 s clip and each package's trace."""
    duo = _duo(height=144, width=256, duration_s=25.0, noise_std=1.0)
    frames = torch.as_tensor(duo.frames)
    cfg = PipelineConfig(window_seconds=10.0, acquisition_seconds=5.0)
    return (duo, offline.extract_signals_multi(frames, 2, cfg),
            joffline.extract_signals_multi(jnp.asarray(duo.frames), 2))


@pytest.mark.parametrize("estimator", ["fft", "welch"])
def test_measure_green_avg_multi_matches_jax(long_duo, estimator):
    """Per-face BPM over the 25 s clip: validity equal, BPM equal on >= 99 %
    of valid frames, each subject on its own rate; the K estimates run as
    one batch, equal to the single-trace DSP a face."""
    duo, trace, jtrace = long_duo
    kw = dict(window_seconds=10.0, acquisition_seconds=5.0,
              estimator=estimator)
    cfg = PipelineConfig(**kw)
    frames = torch.as_tensor(duo.frames)
    ts, bpm, ok = offline.measure_green_avg_multi(frames, duo.fps, 2, cfg,
                                                  trace=trace)
    jts, jbpm, jok = joffline.measure_green_avg_multi(
        jnp.asarray(duo.frames), duo.fps, 2, JaxPipelineConfig(**kw),
        trace=jtrace)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(ok, jok)
    assert _share(jbpm, bpm, jok) >= BPM_SHARE
    steady = slice(int(10.0 * duo.fps), None)
    assert ok[steady].all()
    err = np.abs(bpm[steady] - duo.bpm_truth[None, :]).mean(0)
    assert (err <= 3.0).all()
    for k in range(2):
        b, v = offline._green_bpm(trace.bgr[:, k], trace.valid[:, k],
                                  duo.fps, cfg)
        np.testing.assert_array_equal(v.numpy(), ok[:, k])
        np.testing.assert_array_equal(b.numpy()[ok[:, k]], bpm[ok[:, k], k])
    with pytest.raises(ValueError, match="face slots"):
        offline.measure_green_avg_multi(frames, duo.fps, 3, cfg,
                                        trace=trace)


def test_measure_green_avg_multi_extracts(long_duo):
    """Without ``trace`` the measure extracts its own."""
    duo = long_duo[0]
    cfg = PipelineConfig(window_seconds=10.0, acquisition_seconds=5.0)
    frames = torch.as_tensor(duo.frames[:400])
    a = offline.measure_green_avg_multi(frames, duo.fps, 2, cfg)
    b = offline.measure_green_avg_multi(
        frames, duo.fps, 2, cfg,
        trace=offline.extract_signals_multi(frames, 2, cfg))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fps,detect_every", [(15.0, 1), (24.0, 3)])
def test_three_faces_match_jax(fps, detect_every):
    """K=3: three faces at 144 x 320, the middle one gone for 30 frames.
    ``extract_signals_multi``'s boxes, ROIs and validity equal JAX's, and
    ``measure_green_avg_multi``'s timestamps, validity and BPM equal on
    every frame."""
    trio = synthesize_multi(
        (FaceSpec(center=(0.17, 0.45), bpm=60.0),
         FaceSpec(center=(0.5, 0.5), bpm=84.0,
                  dropout_frames=tuple(range(60, 90))),
         FaceSpec(center=(0.83, 0.45), bpm=108.0)),
        height=144, width=320, fps=fps, duration_s=12.0, noise_std=1.0)
    kw = dict(window_seconds=6.0, acquisition_seconds=3.0)
    want = joffline.extract_signals_multi(jnp.asarray(trio.frames), 3,
                                          JaxPipelineConfig(**kw),
                                          detect_every=detect_every)
    got = offline.extract_signals_multi(torch.as_tensor(trio.frames), 3,
                                        PipelineConfig(**kw),
                                        detect_every=detect_every)
    for f in ("boxes", "rois", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    # The held box covers 15 failed attempts: every frame's at cadence 1,
    # every third frame's at cadence 3.
    v = got.valid.numpy()
    assert v[:, [0, 2]].all() and v[60:75, 1].all()
    assert v[80:90, 1].all() == (detect_every == 3)
    ts, bpm, ok = offline.measure_green_avg_multi(
        torch.as_tensor(trio.frames), fps, 3, PipelineConfig(**kw),
        trace=got)
    jts, jbpm, jok = joffline.measure_green_avg_multi(
        jnp.asarray(trio.frames), fps, 3, JaxPipelineConfig(**kw),
        trace=want)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(bpm[ok], np.asarray(jbpm)[ok])
    assert ok[-1].all()


def test_extract_signals_multi_custom_detector():
    """A detector of the multi-face contract replaces the skin detector."""
    duo = _duo(**CLIPS["duo"])
    frames = torch.as_tensor(duo.frames[:12])
    calls = []

    def det(fr):
        calls.append(fr.shape[0])
        return detect_faces_multi(fr, 2)

    got = offline.extract_signals_multi(frames, 2, detector=det,
                                        detect_every=3)
    want = offline.extract_signals_multi(frames, 2, detect_every=3)
    assert calls == [4]
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# -- the live step, LivePipeline and the pool --------------------------------

def _live_clip():
    return _duo(faces=(FaceSpec(center=(0.25, 0.45), bpm=66.0,
                                dropout_frames=tuple(range(40, 50))),
                       FaceSpec(center=(0.72, 0.5), bpm=90.0)),
                height=64, width=128, duration_s=8.0, noise_std=1.0)


@pytest.fixture(scope="module")
def live_clip():
    return _live_clip()


def _jax_multi_outputs(frames, kw):
    cfg = jlive.LiveConfig(**kw)
    stp = jlive.make_step_multi(cfg, 2, donate=False)
    st = jlive.init_state_multi(cfg, 2)
    outs = []
    for f in frames:
        st, o = stp(st, jnp.asarray(f))
        outs.append(o)
    return outs


def _check_outputs(got, want):
    """Boxes, face validity and BPM validity equal frame by frame; BPM
    equal on >= 99 % of the valid (frame, face) pairs."""
    assert len(got) == len(want)
    eq, n = 0, 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.box), np.asarray(w.box))
        np.testing.assert_array_equal(np.asarray(g.face_valid),
                                      np.asarray(w.face_valid))
        np.testing.assert_array_equal(np.asarray(g.bpm_valid),
                                      np.asarray(w.bpm_valid))
        v = np.asarray(w.bpm_valid)
        eq += int((np.asarray(g.bpm)[v] == np.asarray(w.bpm)[v]).sum())
        n += int(v.sum())
    assert n > 0 and eq >= BPM_SHARE * n


@pytest.mark.parametrize("kw", [dict(fps=10.0),
                                dict(fps=10.0, detect_every=2),
                                dict(fps=10.0, method="adaptive")],
                         ids=["green", "detect_every2", "adaptive"])
def test_step_multi_matches_jax(live_clip, kw):
    want = _jax_multi_outputs(live_clip.frames, kw)
    cfg = live.LiveConfig(**kw)
    st = live.init_state_multi(cfg, 2, device="cpu")
    got = []
    for f in live_clip.frames:
        st, o = live.step_multi(st, torch.as_tensor(f), cfg, 2)
        got.append(o)
    _check_outputs(got, want)
    assert tuple(got[-1].bpm.shape) == (2,)


@pytest.mark.parametrize("kw", [dict(), dict(fetch_every=3),
                                dict(frames_per_call=4),
                                dict(transfer="i420")],
                         ids=["one_deep", "fetch_every3",
                              "frames_per_call4", "i420"])
def test_live_pipeline_multi_matches_jax(live_clip, kw):
    """``LivePipeline(k_faces=2)`` equals JAX's frame by frame, in every
    batching mode and with I420 frames (rebuilt on the device)."""
    frames = list(live_clip.frames)
    if kw.get("transfer") == "i420":
        frames = [live.bgr_to_i420_host(f) for f in frames]
    cfg = dict(fps=10.0)
    jpipe = jlive.LivePipeline(jlive.LiveConfig(**cfg), k_faces=2,
                               donate=False, **kw)
    pipe = live.LivePipeline(live.LiveConfig(**cfg), k_faces=2,
                             device="cpu", **kw)

    def drain(p):
        outs = []
        for f in frames:
            o = p.submit(f)
            if o is not None:
                outs.extend(o if isinstance(o, list) else [o])
        tail = p.flush()
        if tail is not None:
            outs.extend(tail if isinstance(tail, list) else [tail])
        return outs

    got, want = drain(pipe), drain(jpipe)
    _check_outputs(got, want)
    assert got[-1].bpm.shape == (2,)


def test_live_pipeline_multi_equals_step_multi(live_clip):
    cfg = live.LiveConfig(fps=10.0)
    pipe = live.LivePipeline(cfg, k_faces=2, device="cpu")
    st = live.init_state_multi(cfg, 2, device="cpu")
    outs, refs = [], []
    for f in live_clip.frames[:60]:
        o = pipe.submit(f)
        if o is not None:
            outs.append(o)
        st, r = live.step_multi(st, torch.as_tensor(f), cfg, 2)
        refs.append(r)
    outs.append(pipe.flush())
    for o, r in zip(outs, refs):
        assert np.array_equal(o.box, r.box.numpy())
        assert np.array_equal(o.bpm, r.bpm.numpy())
        assert np.array_equal(o.green_raw, r.green_raw.numpy())


@pytest.mark.parametrize("detect_every", [1, 2])
def test_pool_multiface_matches_jax_and_step_multi(live_clip, detect_every):
    """A K=2 pool with a slot that skips ticks: every slot's outputs equal
    JAX's pool, and the slot that never skips equals ``step_multi`` on its
    own frames bit for bit."""
    kw = dict(fps=10.0, detect_every=detect_every)
    jpool = jserving.BpmServer(jlive.LiveConfig(**kw), n_slots=3,
                               donate=False, k_faces=2)
    pool = serving.BpmServer(live.LiveConfig(**kw), n_slots=3, k_faces=2,
                             device="cpu")
    for p in (jpool, pool):
        assert [p.attach(), p.attach()] == [0, 1]
    cfg = live.LiveConfig(**kw)
    st = live.init_state_multi(cfg, 2, device="cpu")
    got, want = {0: [], 1: []}, {0: [], 1: []}
    for i, f in enumerate(live_clip.frames):
        frames = {0: f, 1: np.ascontiguousarray(f[:, ::-1])}
        if i % 7 == 3:
            del frames[1]
        tj, tt = jpool.tick(frames), pool.tick(frames)
        for s in frames:
            want[s].append(tj[s])
            got[s].append(tt[s])
        st, ref = live.step_multi(st, torch.as_tensor(f), cfg, 2)
        assert np.array_equal(tt[0].bpm, ref.bpm.numpy())
        assert np.array_equal(tt[0].box, ref.box.numpy())
        assert np.array_equal(tt[0].green_filtered,
                              ref.green_filtered.numpy())
    for s in (0, 1):
        _check_outputs(got[s], want[s])


def test_pool_multiface_snapshot_restores(live_clip):
    """A K=2 pool's snapshot restores into a new pool, and so does the JAX
    pool's: each ticks on as the pool it was taken from."""
    frames = live_clip.frames

    def pool():
        return serving.BpmServer(live.LiveConfig(fps=10.0), n_slots=2,
                                 k_faces=2, device="cpu")

    tpool = pool()
    jpool = jserving.BpmServer(jlive.LiveConfig(fps=10.0), n_slots=2,
                               donate=False, k_faces=2)
    for p in (tpool, jpool):
        p.attach()
        for f in frames[:30]:
            p.tick({0: f})
    snaps = [tpool.snapshot(), jpool.snapshot()]
    want = tpool.tick({0: frames[30]})[0]
    for snap in snaps:
        again = pool()
        again.restore(snap)
        assert isinstance(again._state, live.MultiLiveState)
        got = again.tick({0: frames[30]})[0]
        np.testing.assert_array_equal(got.box, want.box)
        np.testing.assert_array_equal(got.bpm, want.bpm)
        np.testing.assert_array_equal(got.green_filtered,
                                      want.green_filtered)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _serve_lines(serve_forever, pool, frames):
    srv = serve_forever("127.0.0.1", 0, pool, frame_shape=frames[0].shape[:2])
    try:
        c = serving.BpmClient("127.0.0.1", srv.server_address[1],
                              timeout=120.0)
        for f in frames:
            c.send(f)
        lines = [c.recv() for _ in frames]
        c.close()
    finally:
        srv.shutdown()
    return lines


def test_front_end_multiface_lists_match_jax(live_clip):
    """The front-end of a K=2 pool answers one list entry per subject, as
    the JAX front-end does: the same lines, frame by frame (BPM on >= 99 %
    of the valid entries)."""
    frames = list(live_clip.frames[:120])
    kw = dict(fps=10.0, method="adaptive")
    got = _serve_lines(serving.serve_forever, serving.BpmServer(
        live.LiveConfig(**kw), n_slots=2, k_faces=2, device="cpu"), frames)
    want = _serve_lines(jserving.serve_forever, jserving.BpmServer(
        jlive.LiveConfig(**kw), n_slots=2, donate=False, k_faces=2), frames)
    eq = n = 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("seq", "bpm_valid", "face_valid", "box", "method"):
            assert g[k] == w[k], k
        assert len(g["bpm"]) == 2
        for gb, wb, v in zip(g["bpm"], w["bpm"], w["bpm_valid"]):
            n += v
            eq += v and gb == wb
    assert n > 0 and eq >= BPM_SHARE * n


# -- the apps ----------------------------------------------------------------

@pytest.fixture(scope="module")
def duo_avi(tmp_path_factory):
    """The live clip at 30 fps for 24 s (the live BPM needs its 9 s Welch
    segments), written as MJPG at the fused kernel's width."""
    root = tmp_path_factory.mktemp("multi_apps")
    duo = _duo(height=64, width=128, duration_s=24.0, noise_std=0.5)
    path = root / "duo.avi"
    tvio.write_video(duo.frames, str(path), duo.fps, fourcc="MJPG")
    return {"path": str(path), "duo": duo}


def _bpm_lines(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    assert rc == 0
    return [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("Bpm after filtering")]


def test_livestream_app_faces_matches_jax(duo_avi):
    """``rppg_livestream --faces 2``: the same per-face BPM lines as the
    JAX app, and each subject's late BPM on its rate."""
    args = ["--video", duo_avi["path"], "--no-display", "--faces", "2"]
    got = _bpm_lines(rppg_livestream.main, args + ["--device", "cpu"])
    want = _bpm_lines(jlivestream.main, args)
    assert len(got) == len(want) > 60
    same = sum(g == w for g, w in zip(got, want))
    assert same >= BPM_SHARE * len(want)
    both = [ln for ln in got if "face0" in ln and "face1" in ln]
    last = dict(part.split(": ") for part in
                both[-1].split("filtering: ")[1].split("  "))
    assert abs(float(last["face0"]) - 60.0) <= 8.0
    assert abs(float(last["face1"]) - 96.0) <= 8.0


def test_serve_bpm_app_faces(duo_avi):
    """``serve_bpm --faces 2`` serves per-subject lists; they equal the
    live ``step_multi`` outputs on the same frames."""
    duo = duo_avi["duo"]
    port = _free_port()
    h, w = duo.frames[0].shape[:2]
    th = threading.Thread(target=serve_bpm.main, daemon=True, args=(
        ["--host", "127.0.0.1", "--port", str(port), "--height", str(h),
         "--width", str(w), "--slots", "2", "--fps", str(duo.fps),
         "--faces", "2", "--max-seconds", "120", "--device", "cpu"],))
    th.start()
    c = None
    for _ in range(300):
        try:
            c = serving.BpmClient("127.0.0.1", port, timeout=60.0)
            break
        except OSError:
            time.sleep(0.1)
    assert c is not None, "server never came up"
    n = 12
    for f in duo.frames[:n]:
        c.send(f)
    outs = [c.recv() for _ in range(n)]
    c.close()
    cfg = live.LiveConfig(fps=duo.fps)
    st = live.init_state_multi(cfg, 2, device="cpu")
    for o, f in zip(outs, duo.frames[:n]):
        st, ref = live.step_multi(st, torch.as_tensor(f), cfg, 2)
        assert o["box"] == ref.box.tolist()
        assert o["face_valid"] == ref.face_valid.tolist()
        assert len(o["bpm"]) == 2


# -- what still raises --------------------------------------------------------

def test_multiface_config_errors():
    """``use_fused`` is single-face: the multi-face step, its maker, the
    pipeline and the pool refuse it, with a learned multi-face detector
    too."""
    fused = live.LiveConfig(use_fused=True)
    st = live.init_state_multi(live.LiveConfig(), 2, device="cpu")
    with pytest.raises(ValueError, match="single-face"):
        live.step_multi(st, torch.zeros((8, 128, 3), dtype=torch.uint8),
                        fused, 2)
    with pytest.raises(ValueError, match="single-face"):
        live.make_step_multi(fused, 2)
    with pytest.raises(ValueError, match="single-face"):
        live.LivePipeline(fused, k_faces=2, device="cpu")
    with pytest.raises(ValueError, match="single-face"):
        serving.BpmServer(fused, k_faces=2, device="cpu")
    with pytest.raises(ValueError, match="transfer"):
        live.make_step_multi(live.LiveConfig(), 2, transfer="yuv")
    from vhr_tpu_torch.apps import rppg_video
    det = rppg_video._resolve_detector_multi("landmarker", 2, "cpu")
    with pytest.raises(ValueError, match="skin detector|single-face"):
        live.LivePipeline(fused, k_faces=2, detector=det, device="cpu")
    with pytest.raises(SystemExit):
        rppg_livestream.main(["--video", "x.avi", "--no-display",
                              "--faces", "2", "--fused", "--device", "cpu"])
    state = serving.init_state_batched(live.LiveConfig(), 3, 2)
    assert isinstance(state, live.MultiLiveState)
    assert tuple(state.ring_raw.shape) == (3, 2, 500)
    assert tuple(state.frame_idx.shape) == (3,)
    assert dataclasses.asdict(live.LiveConfig()) == \
        dataclasses.asdict(jlive.LiveConfig())
