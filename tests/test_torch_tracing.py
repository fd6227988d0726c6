"""The port's one tracing system (``vhr_tpu_torch/utils/profiling.py``):
span trees of ``multistream_green_bpm`` in the fused form and with a
detector, the host's waits on the card counted at their sites, tracing off
keeping nothing and changing nothing, the counters, ``StageTimer`` and
``device_trace`` on spans, and (on a CUDA card) the spans on the
profiler's clock.

The file imports no JAX, so its card case also runs where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_tracing.py``.
"""

import json
import threading

import numpy as np
import pytest
import torch

from vhr_tpu_torch.config import PipelineConfig
from vhr_tpu_torch.parallel.mesh import stream_mesh
from vhr_tpu_torch.parallel.streams import multistream_green_bpm
from vhr_tpu_torch.utils import profiling
from vhr_tpu_torch.utils.profiling import (StageTimer, count, counter,
                                           device_trace, reset_counters,
                                           span, tracing)

FPS = 30.0
SMALL = PipelineConfig(window_seconds=1.0, acquisition_seconds=0.5)


def _frames(S, T, H=64, W=128, seed=0, device="cpu"):
    """Noise frames with a skin-coloured block that sways, so the skin
    test finds a box on most frames."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 60, (S, T, H, W, 3), dtype=np.uint8)
    for t in range(T):
        y0, x0 = 16 + t % 3, 40 + t % 5
        x[:, t, y0:y0 + 32, x0:x0 + 40] = (120, 150, 200)   # BGR skin
    return torch.as_tensor(x, device=device)


def _detector(flat):
    """A stand-in detector: the same box on every frame but every 7th."""
    n = flat.shape[0]
    boxes = torch.tensor([40, 16, 80, 48], dtype=torch.int32).repeat(n, 1)
    valid = torch.arange(n) % 7 != 3
    return boxes, valid


FORMS = {"fused": dict(use_fused=True), "detector": dict(detector=_detector)}


def _call(frames, cfg=SMALL, places=1, **kw):
    return multistream_green_bpm(frames, FPS,
                                 mesh=stream_mesh(["cpu"] * places),
                                 cfg=cfg, **kw)


def _ramp_waits(cfg):
    """The waits of one shard's estimate: none.  The ramp is one kernel
    launch that builds its own frequency grids from scalars
    (``ops/ramp_cuda.py``; its plain version on the CPU builds them where
    the trace lies), and the steady pick's grids are built on the
    spectrum's device (``dsp/spectral.py::_band_grid``), so no table is
    copied from the host at any of the window and acquisition lengths."""
    return 0


def _check_tree(spans, request):
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.request == request
        assert s.end_ns >= s.start_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["vhr.entry"]
    return by_id


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("places", [1, 2])
def test_span_tree_of_a_call(form, places):
    """Each span lies inside its parent, carries its call's request id and
    has a non-negative own time; ``frames`` and ``recordings`` are the
    call's; each shard is a ``vhr.shard`` span."""
    S, T = 2, 48
    frames = _frames(S, T)
    with tracing() as tr:
        _call(frames, places=places, **FORMS[form])
        _call(frames, places=places, **FORMS[form])
    requests = sorted({s.request for s in tr.spans})
    assert len(requests) == 2 and None not in requests
    for req in requests:
        mine = [s for s in tr.spans if s.request == req]
        _check_tree(mine, req)
        names = {s.name for s in mine}
        assert {"vhr.entry", "vhr.shard", "vhr.estimate",
                "vhr.estimate.ramp", "vhr.estimate.steady"} <= names
        if form == "detector":
            assert {"vhr.detect", "vhr.holdover", "vhr.roi",
                    "vhr.k2"} <= names
        entry, = (s for s in mine if s.name == "vhr.entry")
        assert entry.counts == {"recordings": S, "frames": S * T}
        shards = [s for s in mine if s.name == "vhr.shard"]
        assert [s.attrs["streams"] for s in shards] == [S // places] * places
        assert all(s.parent == entry.id for s in shards)
        waits = [s for s in mine if s.name == "vhr.wait"]
        assert len(waits) == places * _ramp_waits(SMALL)
        assert all(s.attrs["what"] for s in waits)
    own = tr.self_ns()
    assert all(v >= 0 for v in own.values())
    assert tr.counts["frames"] == 2 * S * T
    assert tr.counts["recordings"] == 2 * S
    assert tr.counts.get("waits", 0) == 2 * places * _ramp_waits(SMALL)


def test_waits_at_the_skin_cells_lengths():
    """The skin cell's window (30 s) and acquisition (10 s) at 30 fps: a
    call waits on the card nowhere, with tracing off (the counter) and on
    (the spans), and both calls give the same outputs."""
    cfg = PipelineConfig()
    frames = _frames(1, 960, seed=3)
    want = _ramp_waits(cfg)
    assert want == 0
    before = counter("waits")
    off = _call(frames, cfg, use_fused=True)
    assert counter("waits") - before == want
    with tracing() as tr:
        on = _call(frames, cfg, use_fused=True)
    assert tr.counts.get("waits", 0) == want
    assert len([s for s in tr.spans if s.name == "vhr.wait"]) == want
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_off_keeps_nothing_and_changes_nothing(form):
    """With tracing off no span is kept and ``span`` hands back the shared
    no-op; the outputs equal a traced call's bit for bit."""
    frames = _frames(2, 48, seed=5)
    assert span("vhr.k1", T=1) is span("vhr.entry")
    off = _call(frames, **FORMS[form])
    assert profiling._SPANS == [] and not profiling._ON
    with tracing() as tr:
        on = _call(frames, **FORMS[form])
    assert tr.spans and profiling._SPANS == [] and not profiling._ON
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_counters_and_nested_blocks():
    """A count goes to the registry always and, while tracing, to the
    innermost open span; nested blocks see their own spans and totals;
    each thread has its own stack of open spans."""
    reset_counters("test.a", "test.b")
    count("test.a")
    assert counter("test.a") == 1
    with tracing() as outer:
        with span("vhr.outer", k=1) as o:
            count("test.a", 2)
            with tracing() as inner:
                with span("vhr.inner"):
                    count("test.b", 5)
            seen = {}

            def other():
                with span("vhr.thread") as t:
                    seen["parent"] = t.parent
                    count("test.b")
            th = threading.Thread(target=other)
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
    assert counter("test.a") == 3 and counter("test.b") == 6
    assert [s.name for s in inner.spans] == ["vhr.inner"]
    assert inner.counts == {"test.b": 5}
    assert {s.name for s in outer.spans} == {"vhr.outer", "vhr.inner",
                                             "vhr.thread"}
    assert outer.counts == {"test.a": 2, "test.b": 6}
    assert o.counts == {"test.a": 2} and o.attrs == {"k": 1}
    assert seen["parent"] is None
    in_span = {s.name: s for s in outer.spans}
    assert in_span["vhr.inner"].parent == o.id
    assert in_span["vhr.inner"].counts == {"test.b": 5}
    reset_counters("test.a", "test.b")
    assert counter("test.a") == counter("test.b") == 0


def test_stage_timer_keeps_its_report():
    """``StageTimer.report()`` keeps its format; each stage is a span."""
    timer = StageTimer()
    with tracing() as tr:
        for _ in range(2):
            with timer.stage("decode"):
                pass
    with timer.stage("step", sync=True):
        pass
    rep = timer.report()
    assert set(rep) == {"decode", "step"}
    for row in rep.values():
        assert set(row) == {"total_s", "count", "mean_ms"}
    assert rep["decode"]["count"] == 2 and rep["step"]["count"] == 1
    assert [s.name for s in tr.spans] == ["vhr.stage.decode"] * 2
    assert json.loads(timer.json()) == rep


def test_device_trace_holds_the_ports_spans(tmp_path):
    """``device_trace`` (the apps' ``--profile-trace``) turns tracing on:
    its Chrome trace holds the port's spans."""
    with device_trace(str(tmp_path)):
        _call(_frames(1, 48), use_fused=True)
    path, = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert {"vhr.entry", "vhr.shard", "vhr.estimate",
            "vhr.estimate.ramp"} <= names
    assert not profiling._ON


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_spans_on_the_profilers_clock(cuda):
    """On the card, under ``torch.profiler``: every in-memory ``vhr.*``
    span starts and ends within 50 us of its profiler range, and
    ``vhr.k1``'s device annotation holds K1's kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frames = _frames(2, 256, H=64, W=128, device=cuda)
    mesh = stream_mesh([cuda])
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for keep in (False, True):             # the first pass warms up
        with profile(activities=acts) as prof:
            with tracing() as tr:
                multistream_green_bpm(frames, FPS, mesh=mesh, cfg=SMALL,
                                      use_fused=True)
                torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    host, dev = {}, {}
    for e in events:
        a = e.start_ns()
        side = dev if e.device_type() == DeviceType.CUDA else host
        side.setdefault(e.name(), []).append((a, a + e.duration_ns()))
    spans = [s for s in tr.spans if s.name.startswith("vhr.")]
    assert {"vhr.entry", "vhr.k1", "vhr.estimate.ramp"} <= {
        s.name for s in spans}
    for name in {s.name for s in spans}:
        mine = sorted((s.start_ns, s.end_ns) for s in spans
                      if s.name == name)
        theirs = sorted(host[name])
        assert len(mine) == len(theirs)
        for (a, b), (x, y) in zip(mine, theirs):
            assert abs(a - x) <= 50_000 and abs(b - y) <= 50_000, name
    k1 = [iv for name, ivs in dev.items() if "pass_kernel" in name
          for iv in ivs]
    assert k1 and "vhr.k1" in dev
    assert any(x <= a and b <= y for a, b in k1 for x, y in dev["vhr.k1"])


def _pool(device="cpu", slots=2):
    from vhr_tpu_torch.pipeline.live import LiveConfig
    from vhr_tpu_torch.serving import BpmServer

    pool = BpmServer(LiveConfig(fps=FPS, use_fused=True, ring_len=60,
                                welch_segment_seconds=1.0),
                     n_slots=slots, device=device)
    for _ in range(slots):
        pool.attach()
    return pool


def _tick_all(pool, frames, t):
    """One tick of every attached slot on its clip's frame ``t``, fetched
    one tick behind, as the pool's front-end does: the handle."""
    return pool.tick_async({s: frames[s, t] for s in pool.active_slots})


def test_pool_counts_its_ticks_and_frames():
    """``pool.ticks`` counts ticks and ``pool.frames`` the frames they
    took, tracing off; a slot without a frame adds none."""
    reset_counters("pool.ticks", "pool.frames")
    pool = _pool(slots=3)
    frames = _frames(3, 4)
    for t in range(4):
        given = {s: frames[s, t] for s in range(3) if not (s == 2 and t)}
        pool.fetch(pool.tick_async(given))
    assert counter("pool.ticks") == 4
    assert counter("pool.frames") == 3 + 3 * 2
    reset_counters("pool.ticks", "pool.frames")


def test_pool_spans_nest_under_the_tick():
    """Each tick is a request span ``vhr.pool.tick`` (``slots``, ``H``,
    ``W``) holding the upload, the masks' upload (a ``vhr.wait``) and the
    live tail; the fetch of the tick before it waits outside it."""
    pool = _pool()
    frames = _frames(2, 3)
    prev = None
    with tracing() as tr:
        for t in range(3):
            handle = _tick_all(pool, frames, t)
            if prev is not None:
                pool.fetch(prev)
            prev = handle
        pool.fetch(prev)
    ticks = [s for s in tr.spans if s.name == "vhr.pool.tick"]
    assert len(ticks) == 3
    assert len({s.request for s in ticks}) == 3 and None not in {
        s.request for s in ticks}
    for tick in ticks:
        assert tick.attrs == {"slots": 2, "H": 64, "W": 128}
        # ``waits`` goes to the span open where the wait starts.
        assert tick.counts == {"pool.ticks": 1, "pool.frames": 2,
                               "waits": 1}
        mine = [s for s in tr.spans if s.request == tick.request]
        kids = {s.name: s for s in mine if s.parent == tick.id}
        assert set(kids) == {"vhr.pool.upload", "vhr.wait",
                             "vhr.pool.finish"}
        assert kids["vhr.pool.upload"].attrs == {"bytes": 2 * 64 * 128 * 3,
                                                 "on_card": 0}
        assert kids["vhr.wait"].attrs == {"what": "pool masks"}
        for s in mine:
            assert tick.start_ns <= s.start_ns <= s.end_ns <= tick.end_ns
    fetches = [s for s in tr.spans if s.name == "vhr.wait"
               and s.attrs["what"] == "pool fetch"]
    assert len(fetches) == 3 and all(s.parent is None for s in fetches)
    assert tr.counts["waits"] == 6


@pytest.mark.gpu
def test_every_wait_of_a_pool_tick_is_marked(cuda):
    """On the card, a warm fused tick of frames already there, fetched one
    tick behind: each synchronizing CUDA call (``set_sync_debug_mode``
    warns on one) happens inside a ``vhr.wait`` span, and K4's launch is
    the span ``vhr.k4`` inside the tick."""
    import warnings

    pool = _pool(cuda, slots=4)
    frames = _frames(4, 6, device=cuda)
    pool.fetch(_tick_all(pool, frames, 0))
    torch.cuda.synchronize()
    sites = []

    def show(message, category, filename, lineno, file=None, line=None):
        st = profiling._stack()
        sites.append(st[-1].name if st else None)

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            with tracing() as tr:
                prev = None
                for t in range(1, 6):
                    handle = _tick_all(pool, frames, t)
                    if prev is not None:
                        pool.fetch(prev)
                    prev = handle
                pool.fetch(prev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sites and all(name == "vhr.wait" for name in sites), sites
    k4 = [s for s in tr.spans if s.name == "vhr.k4"]
    by_id = {s.id: s for s in tr.spans}
    assert len(k4) == 5
    assert all(s.attrs == {"S": 4, "H": 64, "W": 128, "pool": 1}
               for s in k4)
    for s in k4:
        while s.parent is not None:
            s = by_id[s.parent]
        assert s.name == "vhr.pool.tick"
