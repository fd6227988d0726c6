"""Port parity for the serving pool and its front-end
(``vhr_tpu_torch.serving``) and for kernel K4's plain version.

The same numpy frames go through ``vhr_tpu``'s pool (jitted on the CPU, the
fused kernel in interpret mode) and the port's.  Tolerances:

- K4 plain version against the Pallas kernel: boxes, flags, counts and
  carries equal; means within ``rtol=1e-6, atol=1e-5`` (both sum exactly at
  these sizes);
- pool against pool: boxes, flags and BPM equal, raw green within ``1e-5``,
  filtered green within ``5e-4`` (the JAX pool's batched program rounds the
  SOS push a little differently from its own single-stream step; its tests
  use the same bound, ``tests/test_serving.py``);
- the port's pool against the port's single-stream step: equal, under the
  projection and adaptive methods too.
"""

import dataclasses
import json
import socket
import struct
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhr_tpu import serving as jserving
from vhr_tpu.config import ROIConfig as JROIConfig
from vhr_tpu.ops import pallas_fused as jfused
from vhr_tpu.pipeline import live as jlive
from vhr_tpu.utils.synth import SynthSpec, synthesize

from vhr_tpu_torch import interop, serving
from vhr_tpu_torch.config import ROIConfig
from vhr_tpu_torch.ops import fused_cuda
from vhr_tpu_torch.pipeline import live
from vhr_tpu_torch.utils.profiling import counter

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)

MEANS_TOL = dict(rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def clips():
    spec = dict(duration_s=4.0, height=48, width=128, fps=10.0,
                noise_std=0.5)
    return (synthesize(SynthSpec(bpm=84.0, **spec)).frames,
            synthesize(SynthSpec(bpm=66.0, seed=7, **spec)).frames)


def _cfgs(**kw):
    jcfg = jlive.LiveConfig(fps=10.0, ring_len=30, **kw)
    return jcfg, interop.live_config_from_jax(dataclasses.asdict(jcfg))


def _drive(pool, clip_a, clip_b, start=0, stop=None):
    """Two clients: a attaches at tick 0; b attaches at tick 3, skips every
    fourth tick, and is detached and reattached (a fresh stream) at tick
    22."""
    outs = []
    for t in range(start, stop or len(clip_a)):
        if t in (0, 3):
            pool.attach()
        if t == 22:
            pool.detach(1)
            assert pool.attach() == 1
        fr = {0: clip_a[t]}
        if t >= 3 and t % 4 != 1:
            fr[1] = clip_b[t]
        outs.append(pool.tick(fr))
    return outs


def _assert_pools_equal(got, ref, filt_atol=5e-4):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for s in r:
            for k in ("bpm", "bpm_valid", "box", "face_valid", "choice"):
                np.testing.assert_array_equal(np.asarray(getattr(g[s], k)),
                                              np.asarray(getattr(r[s], k)),
                                              err_msg=k)
            np.testing.assert_allclose(g[s].green_raw, r[s].green_raw,
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(g[s].green_filtered,
                                       r[s].green_filtered, rtol=0,
                                       atol=filt_atol)


@pytest.mark.parametrize("kw", [
    dict(row_block=64),
    dict(row_block=32, detect_every=4, gate_margin=0.5, rescan_every=3),
    dict(row_block=8, detect_row_pool=8, gate_margin=0.2, detect_every=3),
    dict(row_block=128, detect_row_pool=2, detect_every=2),
])
def test_k4_plain_matches_pallas(kw):
    v = synthesize(SynthSpec(duration_s=1.0, height=104, width=128,
                             bpm=80.0, motion_amplitude=1.0, fps=10.0))
    S = 7
    rng = np.random.default_rng(len(kw))
    frames = v.frames[rng.integers(0, len(v.frames), S)]
    x1, y1 = rng.integers(0, 64, S), rng.integers(0, 52, S)
    carry = np.stack([x1, y1, x1 + rng.integers(10, 64, S),
                      y1 + rng.integers(10, 52, S), rng.integers(0, 16, S),
                      rng.integers(0, 2, S)], 1).astype(np.int32)
    carry[0] = 0                                   # a fresh slot
    carry[1, 4:] = [0, 1]                          # a spent budget
    carry[2] = v.face_boxes[0].tolist() + [15, 1]  # a tracked face
    phase = rng.integers(0, 100, S).astype(np.int32)
    ref, ref_c = jfused.fused_detect_roi_slots(
        jnp.asarray(frames), jnp.asarray(carry), jnp.asarray(phase),
        interpret=True, **kw)
    before = counter("k4.launches")
    got, got_c = fused_cuda.fused_detect_roi_slots(
        torch.as_tensor(frames), torch.as_tensor(carry),
        torch.as_tensor(phase), **kw)
    assert counter("k4.launches") == before      # CPU: no kernel launch
    np.testing.assert_allclose(got.means.numpy(), np.asarray(ref.means),
                               **MEANS_TOL)
    for f in ("count", "boxes", "det_valid", "roi_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))


# A box whose cheek ROI, with cheek_bottom=3.5, runs from row chunk 0 down
# into a chunk that the gate leaves out, and one over the right and bottom
# edge of the 104 x 128 frame, whose ROI is clipped there (its y1 >= 0).
_GATED_BOX = [40, 8, 90, 30, 15, 1]
_EDGE_BOX = [100, 70, 140, 130, 15, 1]


@pytest.mark.parametrize("kw", [
    dict(row_block=64, slots=1),
    dict(row_block=128),                       # larger than H: one chunk
    dict(row_block=64, detect_row_pool=8),     # clamped last chunk, q0 > 0
    dict(row_block=32, gate_margin=0.1, rescan_every=7, cheek_bottom=3.5,
         box=_GATED_BOX),
    dict(row_block=32, detect_every=2, cheek_bottom=3.5, box=_GATED_BOX),
    dict(row_block=64, box=_EDGE_BOX),
    dict(row_block=16, detect_row_pool=4, gate_margin=0.3, box=_EDGE_BOX),
], ids=["one-slot", "one-chunk", "clamped-chunk-pool8", "roi-in-gated-chunk",
        "roi-off-cadence", "roi-clipped", "roi-clipped-pool4-gated"])
def test_k4_plain_matches_pallas_geometries(kw):
    """The geometries K4's tile layout could get wrong on the card, where
    the plain version is its yardstick: the plain version against the
    Pallas kernel.  ``box`` puts a tracked carry row on slots 3 to 8, at
    phases 1 to 6 (on and off the cadences)."""
    kw = dict(kw)
    S, box = kw.pop("slots", 10), kw.pop("box", None)
    cheek_bottom = kw.pop("cheek_bottom", None)
    jkw, tkw = dict(kw), dict(kw)
    if cheek_bottom is not None:
        jkw["roi"] = JROIConfig(cheek_bottom=cheek_bottom)
        tkw["roi"] = ROIConfig(cheek_bottom=cheek_bottom)
    v = synthesize(SynthSpec(duration_s=1.0, height=104, width=128,
                             bpm=80.0, motion_amplitude=1.0, fps=10.0))
    rng = np.random.default_rng(S + len(kw))
    frames = v.frames[rng.integers(0, len(v.frames), S)]
    x1, y1 = rng.integers(0, 64, S), rng.integers(0, 52, S)
    carry = np.stack([x1, y1, x1 + rng.integers(10, 64, S),
                      y1 + rng.integers(10, 52, S), rng.integers(0, 16, S),
                      rng.integers(0, 2, S)], 1).astype(np.int32)
    phase = rng.integers(0, 100, S).astype(np.int32)
    carry[0] = v.face_boxes[0].tolist() + [15, 1]
    if box is not None:
        carry[3:9] = box
        phase[3:9] = np.arange(1, 7)
    ref, ref_c = jfused.fused_detect_roi_slots(
        jnp.asarray(frames), jnp.asarray(carry), jnp.asarray(phase),
        interpret=True, **jkw)
    got, got_c = fused_cuda.fused_detect_roi_slots(
        torch.as_tensor(frames), torch.as_tensor(carry),
        torch.as_tensor(phase), **tkw)
    np.testing.assert_allclose(got.means.numpy(), np.asarray(ref.means),
                               **MEANS_TOL)
    for f in ("count", "boxes", "det_valid", "roi_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    if box is not None:
        assert got.roi_valid[3:9].all() and (got.count[3:9] > 0).all()


@pytest.mark.parametrize("use_fused,detect_every", [(True, 3), (False, 1),
                                                    (False, 2)])
def test_pool_matches_jax_pool(clips, use_fused, detect_every):
    jcfg, cfg = _cfgs(use_fused=use_fused, detect_every=detect_every)
    ref = _drive(jserving.BpmServer(jcfg, n_slots=3, donate=False), *clips)
    got = _drive(serving.BpmServer(cfg, n_slots=3, device="cpu"), *clips)
    _assert_pools_equal(got, ref)
    assert got[-1][0].bpm_valid


@pytest.mark.parametrize("method", ["pos", "adaptive"])
@pytest.mark.parametrize("use_fused", [True, False])
def test_pool_methods_match_jax_pool(clips, method, use_fused):
    """A projection method and the adaptive selector over the pool's
    ``(S, N, 3)`` rings, in the fused (K4) and the skin (K2) tick: every
    tick's outputs, ``choice`` included, equal the JAX pool's."""
    jcfg, cfg = _cfgs(use_fused=use_fused, method=method)
    ref = _drive(jserving.BpmServer(jcfg, n_slots=3, donate=False), *clips)
    got = _drive(serving.BpmServer(cfg, n_slots=3, device="cpu"), *clips)
    _assert_pools_equal(got, ref)
    assert got[-1][0].bpm_valid


@pytest.mark.parametrize("method", ["pos", "adaptive"])
@pytest.mark.parametrize("use_fused", [True, False])
def test_pool_method_slots_equal_single_stream_step(clips, method,
                                                    use_fused):
    """Two slots, one attached two ticks late, each equal to the port's
    single-stream step on its own frames under the same method."""
    _, cfg = _cfgs(use_fused=use_fused, method=method)
    pool = serving.BpmServer(cfg, n_slots=2, device="cpu")
    singles = [live.init_state(cfg), live.init_state(cfg)]
    a = pool.attach()
    for t in range(len(clips[0])):
        fr = {a: clips[0][t]}
        if t == 2:
            b = pool.attach()
        if t >= 2:
            fr[b] = clips[1][t - 2]
        outs = pool.tick(fr)
        for s, (slot, f) in enumerate(fr.items()):
            singles[s], o = live.step(singles[s], torch.as_tensor(f), cfg)
            for k in live.LiveOutput._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(o, k)), getattr(outs[slot], k),
                    err_msg=f"slot {slot} tick {t} {k}")
    assert outs[a].bpm_valid and outs[b].bpm_valid


def test_pool_slots_equal_single_stream_step(clips):
    """Each fused slot is the port's single-stream fused step on its own
    frames, exactly: a late attacher detects on its own first frame."""
    _, cfg = _cfgs(use_fused=True, detect_every=4, gate_margin=0.5)
    pool = serving.BpmServer(cfg, n_slots=2, device="cpu")
    a = pool.attach()
    st_b = live.init_state(cfg)
    for t, f in enumerate(clips[0]):
        fr = {a: f}
        if t == 2:
            b = pool.attach()
        if t >= 2:
            fr[b] = clips[1][t - 2]
        outs = pool.tick(fr)
        if t >= 2:
            st_b, ob = live.step(st_b, torch.as_tensor(clips[1][t - 2]), cfg)
            for k in live.LiveOutput._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(ob, k)), getattr(outs[b], k),
                    err_msg=k)
    assert outs[b].face_valid


@pytest.mark.parametrize("use_fused", [True, False])
def test_jax_snapshot_restores_into_port_pool(clips, use_fused, tmp_path):
    """A JAX pool's np.savez snapshot restored into the port's pool: the next
    ticks equal the JAX pool's.  And the other way round."""
    jcfg, cfg = _cfgs(use_fused=use_fused, detect_every=2)
    jpool = jserving.BpmServer(jcfg, n_slots=3, donate=False)
    _drive(jpool, *clips, stop=25)
    np.savez(tmp_path / "jax.npz", **jpool.snapshot())
    pool = serving.BpmServer(cfg, n_slots=3, device="cpu")
    with np.load(tmp_path / "jax.npz") as snap:
        pool.restore(snap)
    assert pool.active_slots == jpool.active_slots == [0, 1]
    ref = _drive(jpool, *clips, start=25)
    got = _drive(pool, *clips, start=25)
    _assert_pools_equal(got, ref)

    np.savez(tmp_path / "port.npz", **pool.snapshot())
    back = jserving.BpmServer(jcfg, n_slots=3, donate=False)
    with np.load(tmp_path / "port.npz") as snap:
        back.restore(snap)
    for k, v in jpool.snapshot().items():
        np.testing.assert_allclose(np.asarray(back.snapshot()[k], float),
                                   np.asarray(v, float), rtol=0, atol=5e-4,
                                   err_msg=k)


def test_legacy_snapshot_and_missing_field(clips, capsys):
    _, cfg = _cfgs()
    pool = serving.BpmServer(cfg, n_slots=2, device="cpu")
    s = pool.attach()
    for f in clips[0][:12]:
        pool.tick({s: f})
    snap = pool.snapshot()
    fields = list(live.LiveState._fields)
    legacy = {f"leaf{i}": snap[f"state.{k}"] for i, k in enumerate(fields)}
    legacy.update(attached=snap["attached"], needs_reset=snap["needs_reset"],
                  tick_count=snap["tick_count"])
    p2 = serving.BpmServer(cfg, n_slots=2, device="cpu")
    p2.restore(legacy)
    np.testing.assert_array_equal(p2.snapshot()["state.ring_filt"],
                                  snap["state.ring_filt"])
    del legacy["leaf8"]
    with pytest.raises(ValueError, match="leaves"):
        serving.BpmServer(cfg, n_slots=2, device="cpu").restore(legacy)
    older = {k: v for k, v in snap.items() if k != "state.ring_bgr"}
    p3 = serving.BpmServer(cfg, n_slots=2, device="cpu")
    p3.restore(older)
    assert "ring_bgr" in capsys.readouterr().err
    assert not p3.snapshot()["state.ring_bgr"].any()


def _planar(clip):
    """BGR frames -> planar I420 frames, as a client converts them."""
    return np.stack([live.bgr_to_i420_host(f) for f in clip])


@pytest.mark.parametrize("use_fused,detect_every", [(True, 3), (False, 2)])
def test_i420_pool_matches_jax_pool(clips, use_fused, detect_every):
    """``BpmServer(transfer="i420")`` on planar frames, in the fused (K4)
    and the skin (K2) tick, against the JAX package's I420 pool on the same
    frames: every tick's outputs as ``test_pool_matches_jax_pool`` holds
    them, and equal to the port's BGR pool on the cv2-rebuilt frames."""
    import cv2

    jcfg, cfg = _cfgs(use_fused=use_fused, detect_every=detect_every)
    planar = [_planar(c) for c in clips]
    ref = _drive(jserving.BpmServer(jcfg, n_slots=3, donate=False,
                                    transfer="i420"), *planar)
    got = _drive(serving.BpmServer(cfg, n_slots=3, device="cpu",
                                   transfer="i420"), *planar)
    _assert_pools_equal(got, ref)
    assert got[-1][0].bpm_valid
    rebuilt = [np.stack([cv2.cvtColor(f, cv2.COLOR_YUV2BGR_I420)
                         for f in c]) for c in planar]
    bgr = _drive(serving.BpmServer(cfg, n_slots=3, device="cpu"), *rebuilt)
    _assert_pools_equal(got, bgr, filt_atol=0.0)


def test_tcp_i420_client_gets_one_line_per_frame(clips):
    """A TCP client with ``transfer="i420"`` streams planar frames into an
    I420 pool: one ordered line per frame, each equal to the I420 step's
    output; the stats hello advertises the transfer."""
    _, cfg = _cfgs(use_fused=True)
    pool = serving.BpmServer(cfg, n_slots=2, device="cpu", transfer="i420")
    srv = _serve(pool, clips[0][0].shape[:2])
    port = srv.server_address[1]
    frames = _planar(clips[0])
    c = serving.BpmClient("127.0.0.1", port, transfer="i420")
    for f in frames:
        c.send(f)
    lines = [c.recv() for _ in frames]
    c.close()
    stats = serving.WsBpmClient("127.0.0.1", port,
                                hello_extra={"stats": True}).stats
    srv.shutdown()
    assert stats["transfer"] == "i420"
    assert [o["seq"] for o in lines] == list(range(len(frames)))
    st, stp = live.init_state(cfg), live.make_step(cfg, transfer="i420")
    for line, f in zip(lines, frames):
        st, o = stp(st, torch.as_tensor(f))
        assert line["bpm"] == round(float(o.bpm), 4)
        assert line["bpm_valid"] == bool(o.bpm_valid)
        assert line["box"] == [int(x) for x in o.box]
    assert lines[-1]["bpm_valid"]


def test_bgr_client_to_i420_pool_is_refused(clips):
    """The hello names the wire format: a BGR client of an I420 pool gets
    the JAX front-end's error, and a BGR-sized frame on an I420 connection is
    a payload error."""
    _, cfg = _cfgs()
    pool = serving.BpmServer(cfg, n_slots=2, device="cpu", transfer="i420")
    srv = _serve(pool, clips[0][0].shape[:2])
    port = srv.server_address[1]
    with pytest.raises(ConnectionError, match="transfer='i420'"):
        serving.BpmClient("127.0.0.1", port)
    with pytest.raises(ConnectionError, match="transfer"):
        serving.WsBpmClient("127.0.0.1", port)
    c = serving.BpmClient("127.0.0.1", port, transfer="i420")
    c.sock.sendall(struct.pack("<I", clips[0][0].nbytes)
                   + clips[0][0].tobytes())
    line = json.loads(c.rfile.readline().decode())
    assert "error" in line and "i420" in line["error"]
    c.close()
    srv.shutdown()


def _serve(pool, shape, **kw):
    return serving.serve_forever("127.0.0.1", 0, pool, frame_shape=shape,
                                 **kw)


def test_tcp_and_ws_replies_equal_tick_outputs(clips):
    """A raw-TCP and a WebSocket client stream into one port pool; every
    reply line equals the single-stream step's output on that frame."""
    _, cfg = _cfgs(use_fused=True, detect_every=3)
    pool = serving.BpmServer(cfg, n_slots=4, device="cpu")
    srv = _serve(pool, clips[0][0].shape[:2])
    port = srv.server_address[1]
    results = {}

    def run(name, client_cls, frames):
        c = client_cls("127.0.0.1", port)
        for f in frames:
            c.send(f)
        results[name] = [c.recv() for _ in frames]
        c.close()

    threads = [threading.Thread(target=run, args=("tcp", serving.BpmClient,
                                                  clips[0])),
               threading.Thread(target=run, args=("ws", serving.WsBpmClient,
                                                  clips[1]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    srv.shutdown()
    for name, frames in (("tcp", clips[0]), ("ws", clips[1])):
        st = live.init_state(cfg)
        lines = results[name]
        assert [o["seq"] for o in lines] == list(range(len(frames)))
        for line, f in zip(lines, frames):
            st, o = live.step(st, torch.as_tensor(f), cfg)
            assert line["bpm"] == round(float(o.bpm), 4)
            assert line["bpm_valid"] == bool(o.bpm_valid)
            assert line["face_valid"] == bool(o.face_valid)
            assert line["box"] == [int(x) for x in o.box]
    assert results["tcp"][-1]["bpm_valid"]


def test_served_lines_name_the_adaptive_method(clips):
    """Under ``method="adaptive"`` every served line carries ``"method"``,
    the name of the pulse construction behind its BPM (the JAX front-end's
    field); the lines equal the single-stream step's outputs."""
    _, cfg = _cfgs(use_fused=True, method="adaptive")
    pool = serving.BpmServer(cfg, n_slots=2, device="cpu")
    srv = _serve(pool, clips[0][0].shape[:2])
    c = serving.BpmClient("127.0.0.1", srv.server_address[1])
    for f in clips[0]:
        c.send(f)
    lines = [c.recv() for _ in clips[0]]
    c.close()
    srv.shutdown()
    st = live.init_state(cfg)
    for line, f in zip(lines, clips[0]):
        st, o = live.step(st, torch.as_tensor(f), cfg)
        assert line["method"] == cfg.adaptive_methods[int(o.choice)]
        assert line["bpm"] == round(float(o.bpm), 4)
        assert line["bpm_valid"] == bool(o.bpm_valid)
    assert lines[-1]["bpm_valid"]
    assert len({ln["method"] for ln in lines if ln["bpm_valid"]}) > 1
    plain = serving.BpmServer(_cfgs()[1], n_slots=1, device="cpu")
    srv = _serve(plain, clips[0][0].shape[:2])
    c = serving.BpmClient("127.0.0.1", srv.server_address[1])
    c.send(clips[0][0])
    assert "method" not in c.recv()
    c.close()
    srv.shutdown()


def test_tcp_server_survives_malformed_clients(clips):
    """Garbage hellos and wrong-length frames get an error line and a clean
    hangup; the pool and other clients are unaffected."""
    _, cfg = _cfgs()
    pool = serving.BpmServer(cfg, n_slots=2, device="cpu")
    srv = _serve(pool, clips[0][0].shape[:2])
    port = srv.server_address[1]
    for hello in (b"not json at all\n", b"[1, 2, 3]\n"):
        bad = socket.create_connection(("127.0.0.1", port), timeout=30)
        bad.sendall(hello)
        assert "error" in json.loads(bad.makefile("rb").readline().decode())
        bad.close()
    with pytest.raises(ConnectionError, match="transfer"):
        serving.BpmClient("127.0.0.1", port, transfer="i420")
    bad2 = serving.BpmClient("127.0.0.1", port)
    bad2.sock.sendall(struct.pack("<I", 13) + b"x" * 13)
    line = json.loads(bad2.rfile.readline().decode())
    assert "error" in line and "13" in line["error"]
    good = serving.BpmClient("127.0.0.1", port)
    for f in clips[0][:5]:
        good.send(f)
    assert [good.recv()["seq"] for _ in range(5)] == list(range(5))
    good.close()
    stats = serving.WsBpmClient("127.0.0.1", port,
                                hello_extra={"stats": True}).stats
    assert stats["slots"] == 2 and stats["transfer"] == "bgr"
    srv.shutdown()


def test_auth_token_both_protocols(clips):
    _, cfg = _cfgs()
    pool = serving.BpmServer(cfg, n_slots=2, device="cpu")
    srv = _serve(pool, clips[0][0].shape[:2], auth_token="s3cret")
    port = srv.server_address[1]
    with pytest.raises(ConnectionError, match="token"):
        serving.BpmClient("127.0.0.1", port)
    with pytest.raises(ConnectionError, match="token"):
        serving.BpmClient("127.0.0.1", port, token="wrong")
    with pytest.raises(ConnectionError, match="token"):
        serving.WsBpmClient("127.0.0.1", port)
    with pytest.raises(ConnectionError, match="403"):
        serving.WsBpmClient("127.0.0.1", port, token="s3cret",
                            origin="http://evil.example")
    c = serving.BpmClient("127.0.0.1", port, token="s3cret")
    w = serving.WsBpmClient("127.0.0.1", port, token="s3cret")
    c.send(clips[0][0])
    w.send(clips[0][0])
    assert c.recv()["seq"] == 0 and w.recv()["seq"] == 0
    assert pool.active_slots == [0, 1]
    c.close()
    w.close()
    srv.shutdown()


@pytest.mark.parametrize("kw,item", [
    (dict(mesh="two cpu places"), "item 14"),
    (dict(k_faces=2), "item 12"),
])
def test_pool_unported_options_raise(kw, item):
    """Both options are ported.  ``mesh=`` (item 14) splits the slots over
    the mesh's places, refuses a ``device`` beside it and a slot count the
    places do not divide.  ``k_faces > 1`` (item 12): the pool holds the
    multi-face state, with the skin detector and with the learned tiled
    detector."""
    if "mesh" in kw:
        from vhr_tpu_torch.parallel.mesh import stream_mesh
        mesh = stream_mesh(["cpu"] * 2)
        pool = serving.BpmServer(n_slots=8, mesh=mesh, slot_axis="stream")
        assert pool.device == torch.device("cpu") and not pool._multiproc
        assert tuple(pool._state.last_box.shape) == (8, 4)
        with pytest.raises(ValueError, match="device=None"):
            serving.BpmServer(mesh=mesh, slot_axis="stream", device="cpu")
        with pytest.raises(ValueError, match="divide"):
            serving.BpmServer(n_slots=7, mesh=mesh, slot_axis="stream")
        return
    pool = serving.BpmServer(device="cpu", **kw)
    assert isinstance(pool._state, live.MultiLiveState)
    assert tuple(pool._state.last_box.shape) == (8, 2, 4)
    from vhr_tpu_torch.apps import rppg_video
    det = rppg_video._resolve_detector_multi("landmarker", kw["k_faces"],
                                             "cpu")
    pool = serving.BpmServer(device="cpu", detector=det, **kw)
    assert tuple(pool._state.last_box.shape) == (8, 2, 4)


def test_pool_init_and_tick_errors():
    fused = live.LiveConfig(use_fused=True)
    with pytest.raises(ValueError, match="cheek"):
        serving.BpmServer(dataclasses.replace(fused, roi_site="forehead"),
                          device="cpu")
    with pytest.raises(ValueError, match="detector"):
        serving.BpmServer(fused, detector=lambda f: None, device="cpu")
    with pytest.raises(ValueError, match="single-face"):
        serving.BpmServer(fused, k_faces=2, device="cpu")
    with pytest.raises(ValueError, match="transfer"):
        serving.BpmServer(transfer="yuv", device="cpu")
    pool = serving.BpmServer(live.LiveConfig(fps=10.0), n_slots=2,
                             device="cpu")
    s = pool.attach()
    with pytest.raises(KeyError, match="not attached"):
        pool.tick({s + 1: np.zeros((48, 128, 3), np.uint8)})
    pool.attach()
    with pytest.raises(RuntimeError, match="busy"):
        pool.attach()
    pool.tick({s: np.zeros((48, 128, 3), np.uint8)})
    with pytest.raises(ValueError, match="geometry"):
        pool.tick({s: np.zeros((40, 128, 3), np.uint8)})
    assert pool.tick({}) == {}
