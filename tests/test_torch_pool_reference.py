"""The served pool (``vhr_tpu_torch.serving.BpmServer``, the fused tick)
against the benchmark's plain reference of the live step
(``portbench/reference/pool.py``) on seeded skin-ellipse clips, tick by
tick: fresh sessions whose ring wraps, a slot attached late, a slot that
skips ticks, a slot detached and attached again; and the reference a
precision lower (the benchmark's control) fails the same comparison.

The file imports no JAX.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.core import harness, loader  # noqa: E402
from portbench.reference import pool as ref_pool  # noqa: E402
from portbench.scenes import skin_ellipse  # noqa: E402
from vhr_tpu_torch.pipeline import live  # noqa: E402
from vhr_tpu_torch.pipeline.live import LiveConfig  # noqa: E402
from vhr_tpu_torch.serving import BpmServer  # noqa: E402

SLOTS, T, H, W = 4, 150, 64, 128
LCFG = LiveConfig(fps=30.0, use_fused=True, ring_len=120,
                  welch_segment_seconds=2.0)
# The benchmark configuration at the pool's settings: a 120-sample ring
# (it wraps at tick 120) and 2 s segments (a BPM from tick 59 on).
CFG = harness.merge(loader.config("skin_fused-720p"),
                    {"slots": SLOTS, "live": {"ring_len": 120,
                                              "welch_segment_seconds": 2.0}})
DRV = loader.plugin("drivers", "pool")

# Each tolerance, and why:
# - the box: the same float32 chroma values (the reference rounds as the
#   port's fused multiply-adds do) compared with the same bounds, and
#   integer tracking: exact;
# - the means and the green sample: the port divides float32 sums, the
#   reference float64 ones, a float32 rounding of a value below 256
#   (1.5e-5), far inside 1e-3;
# - the filtered sample: the port filters in float32 with float32
#   coefficients, the reference in float64 with scipy's; the gap grows
#   with the start-up transient of the 139-level step to some 5e-4 here;
# - the BPM: the band's bin frequencies in float32 against float64, some
#   1e-6 BPM apart, and the same peak: 1e-3, validity equal.
TOL = {"track_px": 0.0, "means_gap": 1e-3, "green_gap": 1e-3,
       "filt_gap": 5e-3, "bpm_pct": 0.0}


def clips(seed):
    return skin_ellipse.make(torch.device("cpu"), SLOTS, T, H, W, 30.0,
                             seed, loader.traffic("pool64"))


def serve(frames, case):
    """Tick a 4-slot pool over the clips under ``case``'s schedule ->
    ``{slot: [session, ...]}``, each session a list of ``(tick, packed
    (10,) outputs, K4's means (3,))``."""
    pool = BpmServer(LCFG, n_slots=SLOTS, device="cpu")
    kept = {}
    orig = live.fused_detect_roi_slots

    def keep(*args, **kwargs):
        res, carry = orig(*args, **kwargs)
        kept["means"] = res.means
        return res, carry
    live.fused_detect_roi_slots = keep
    try:
        late = 3 if case == "late" else None
        for s in range(SLOTS):
            if s != late:
                assert pool.attach() == s
        sessions = {s: [[]] for s in range(SLOTS)}
        for t in range(T):
            if t == 40 and late is not None:
                assert pool.attach() == late
            if t == 70 and case == "reattach":
                pool.detach(1)
                assert pool.attach() == 1
                sessions[1].append([])
            given = {s: frames[s, t] for s in pool.active_slots
                     if not (case == "skip" and s == 2 and t % 10 == 9)}
            outs = pool.tick(given)
            for s, o in outs.items():
                packed = np.concatenate([
                    [o.bpm, o.bpm_valid, o.green_raw, o.green_filtered,
                     o.face_valid], o.box, [o.choice]]).astype(np.float32)
                sessions[s][-1].append(
                    (t, packed, kept["means"][s].numpy().copy()))
    finally:
        live.fused_detect_roi_slots = orig
    return sessions


def judged(frames, sessions, prec):
    """Every session's numbers against the reference of its own frames."""
    cell = SimpleNamespace(W=W)
    out = []
    for s, runs in sessions.items():
        for run in runs:
            ticks = [t for t, _, _ in run]
            prog = DRV.records({"packed": np.stack([p for _, p, _ in run])
                                [:, None],
                                "means": np.stack([m for _, _, m in run])
                                [:, None]}, 1, len(run))[0]
            ref, = ref_pool.reference(frames[s, ticks][None], CFG, prec)
            out.append(DRV.compare(prog, ref, cell))
    return out


def passes(n):
    return all(n[k] <= v for k, v in TOL.items())


@pytest.mark.parametrize("case,seed", [("fresh", 4000000033),
                                       ("fresh", 17), ("late", 23),
                                       ("skip", 29), ("reattach", 31)])
def test_pool_ticks_equal_the_reference(case, seed):
    frames = clips(seed)
    sessions = serve(frames, case)
    if case == "skip":
        assert len(sessions[2][0]) == T - T // 10
    if case == "reattach":
        assert [len(r) for r in sessions[1]] == [70, T - 70]
    if case == "late":
        assert len(sessions[3][0]) == T - 40
    for n in judged(frames, sessions, CFG["precision"]):
        assert passes(n), n
        assert n["bpm_tie"] < 0.99           # no peak is a near tie


def test_the_control_fails_the_comparison():
    """The reference in the precision below the configuration's (bf16
    chroma, means and estimate), in the program's place, fails at least
    one tolerance on every session."""
    frames = clips(37)
    cell = SimpleNamespace(W=W)
    ref = ref_pool.reference(frames, CFG, CFG["precision"])
    ctl = ref_pool.reference(frames, CFG, CFG["control"])
    for c, r in zip(ctl, ref):
        assert not passes(DRV.compare(c, r, cell))


def test_the_configuration_is_the_pools_default():
    """The benchmark's file holds ``LiveConfig(fps=30, use_fused=True)``
    and the skin bounds K4 tests by."""
    from vhr_tpu_torch.models.skin_detector import SkinDetectorConfig

    cfg = loader.config("skin_fused-720p")
    assert DRV.live_config(cfg) == LiveConfig(fps=30.0, use_fused=True)
    assert SkinDetectorConfig(**cfg["skin"]) == SkinDetectorConfig()
