"""How a served pool is called: ``vhr_tpu_torch.serving.BpmServer``, one
session of every slot a call, ticked as the pool's TCP front-end ticks it;
the reference that works the same out again (``reference/pool.py``); and
the numbers that compare the two (``NUMBERS``, ``compare``).

A call detaches and re-attaches every slot, so each slot's state zeroes on
the first tick, then hands slot ``s`` the frame ``recordings[s, t]`` at
tick ``t``.  The ticks are pipelined one deep, as
``serving._BpmTCPServer._tick_loop`` runs them: tick ``t`` is enqueued,
then tick ``t - 1`` fetched, so every client is answered every tick, one
tick behind; the last tick is fetched before the call returns.  Besides
the packed outputs of every tick the driver keeps K4's ROI means, which
the packed outputs drop, by wrapping the call site that
``pipeline/live.py`` resolves when it runs (it only keeps a reference).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from portbench.reference import pool as ref_pool

LIVE = "vhr_tpu_torch.pipeline.live"

# One session's numbers:
# - ``track_px``: the widest gap, in pixels, between the program's and the
#   reference's per-tick boxes; a tick whose face validity differs counts
#   as the frame's width.
# - ``means_gap``: the widest gap, in u8 levels, between the per-tick ROI
#   channel means, over the ticks whose face both sides hold valid.
# - ``green_gap``: the widest gap between the green samples the pool
#   returned and the reference's, over every tick.
# - ``filt_gap``: the same for the filtered samples.
# - ``bpm_pct``: the share, in percent, of ticks whose BPM validity
#   differs from the reference's, or whose valid BPM differs by more than
#   ``BPM_TOL``.
# - ``bpm_tie``: the reference's second largest in-band power over its
#   largest, the largest over the ticks whose BPM it holds valid; no limit
#   holds it: it says how near a tie the peaks came.
NUMBERS = ("track_px", "means_gap", "green_gap", "filt_gap", "bpm_pct",
           "bpm_tie")
BPM_TOL = 1e-3      # BPM; Welch's bins are 6.67 BPM apart at 270 samples


def live_config(cfg: dict):
    """The port's ``LiveConfig`` for the configuration file's values."""
    from vhr_tpu_torch.config import HRBand, ROIConfig
    from vhr_tpu_torch.pipeline.live import LiveConfig

    lv = cfg["live"]
    return LiveConfig(band=HRBand(*lv["band_hz"]),
                      filter_order=int(lv["filter_order"]),
                      ring_len=int(lv["ring_len"]),
                      welch_segment_seconds=float(
                          lv["welch_segment_seconds"]),
                      roi=ROIConfig(**lv["roi"]), fps=float(cfg["fps"]),
                      use_fused=bool(lv["use_fused"]),
                      detect_row_pool=int(lv["detect_row_pool"]),
                      gate_margin=lv["gate_margin"],
                      detect_every=int(lv["detect_every"]),
                      roi_site=lv["roi_site"], method=lv["method"])


class Driver:
    """``Driver(cfg, device)``; ``call(recordings (S, T, H, W, 3) u8)``
    runs one session of every slot and returns ``packed`` ``(T, S, 10)``
    (``pipeline.live.pack_output``'s layout) and K4's ``means`` ``(T, S,
    3)``, on the device, queued."""

    def __init__(self, cfg: dict, device):
        from vhr_tpu_torch.serving import BpmServer

        self.live = importlib.import_module(LIVE)
        self.pool = BpmServer(live_config(cfg), n_slots=int(cfg["slots"]),
                              transfer=cfg["transfer"], device=device)
        self._orig = self.live.fused_detect_roi_slots
        self._means = None

        def kept(*args, **kwargs):
            res, carry = self._orig(*args, **kwargs)
            self._means = res.means
            return res, carry
        self.live.fused_detect_roi_slots = kept

    def call(self, recordings: torch.Tensor):
        S, T = recordings.shape[:2]
        for s in range(self.pool.n_slots):
            self.pool.detach(s)
        # A free pool hands out its slots in order: slot s streams
        # recording s, so the outputs' rows are the recordings'.
        for s in range(S):
            if self.pool.attach() != s:
                raise RuntimeError("the pool did not hand out slot "
                                   f"{s} in order")
        packed, means, prev = [], [], None
        for t in range(T):
            handle = self.pool.tick_async(
                {s: recordings[s, t] for s in range(S)})
            packed.append(handle[1][0])
            means.append(self._means)
            if prev is not None:
                self.pool.fetch(prev)
            prev = handle
        self.pool.fetch(prev)
        return {"packed": torch.stack(packed)[:, :S],
                "means": torch.stack(means)[:, :S]}

    def close(self):
        if self._orig is not None:
            self.live.fused_detect_roi_slots = self._orig
            self._orig = None
        self.pool = None


def records(outputs: dict, S: int, T: int) -> list:
    """A call's outputs (host arrays, ``(T, S, ...)``) as one dict a
    session."""
    packed = np.asarray(outputs["packed"])
    means = np.asarray(outputs["means"])
    return [{"bpm": packed[:, s, 0], "bpm_valid": packed[:, s, 1] > 0.5,
             "green_raw": packed[:, s, 2], "green_filtered": packed[:, s, 3],
             "face_valid": packed[:, s, 4] > 0.5,
             "box": packed[:, s, 5:9].astype(np.int64), "means": means[:, s]}
            for s in range(S)]


class Reference:
    """The plain reference of the configuration, or its control
    (``control=True``): ``ref(recordings (S, T, H, W, 3))`` -> one dict a
    session, numpy."""

    def __init__(self, cfg: dict, device, control: bool = False):
        self.cfg = cfg
        self.prec = cfg["control"] if control else cfg["precision"]

    def __call__(self, recordings: torch.Tensor) -> list:
        return ref_pool.reference(recordings, self.cfg, self.prec)


def compare(prog: dict, ref: dict, cell) -> dict:
    """One session's ``NUMBERS``: the program's record against the
    reference's, on the cell's ``W``-pixel frames."""
    both = prog["face_valid"] & ref["face_valid"]
    gap = np.abs(prog["box"].astype(np.int64) - ref["box"]).max(-1)
    gap = np.where(prog["face_valid"] != ref["face_valid"], cell.W, gap)
    means = np.abs(prog["means"].astype(np.float64) - ref["means"]).max(-1)
    ok, ref_ok = prog["bpm_valid"], ref["bpm_valid"]
    differs = (ok != ref_ok) | (ref_ok & (np.abs(
        prog["bpm"].astype(np.float64) - ref["bpm"]) > BPM_TOL))
    return {"track_px": float(gap.max()),
            "means_gap": float(means[both].max()) if both.any() else 0.0,
            "green_gap": float(np.abs(prog["green_raw"].astype(np.float64)
                                      - ref["green_raw"]).max()),
            "filt_gap": float(np.abs(
                prog["green_filtered"].astype(np.float64)
                - ref["green_filtered"]).max()),
            "bpm_pct": 100.0 * float(differs.mean()),
            "bpm_tie": float(ref["tie"].max())}
