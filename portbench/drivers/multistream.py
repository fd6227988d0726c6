"""How a configuration calls the port: ``multistream_green_bpm`` on a
one-place mesh, in the fused skin form (K1) or with the MediaPipe
detector; the reference that works the same out again; and the numbers
that compare the two (``NUMBERS``, ``compare``).

Besides the call's own outputs ``(bpm, valid, green)``, the driver keeps
what the timed call produced on its way, by wrapping the call sites that
``parallel/streams.py`` resolves when it runs: K1's result in the fused
form; the detector's boxes and the ROIs and means given to K2 in the
detector form.  The wrappers only keep references to those outputs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench.core.loader import ROOT
from portbench.reference import dsp, skin_fused, track
from portbench.reference.mediapipe import FaceLandmarker

STREAMS = "vhr_tpu_torch.parallel.streams"

# One recording's numbers:
# - ``track_px``: the widest gap, in pixels, between the program's and the
#   reference's per-frame boxes (and ROIs, where the form passes them to
#   K2); a frame whose detection or track validity differs counts as the
#   frame's width.
# - ``means_gap``: the widest gap, in u8 levels, between the per-frame ROI
#   channel means, over the frames whose track both sides hold valid.
# - ``green_gap``: the widest gap between the green trace the call
#   returned and the reference's (the means' channel carried forward over
#   dropouts).
# - ``bpm_pct``: the share, in percent, of frames whose BPM or validity
#   differs from the reference's own: its rolling FFT peak over its own
#   green trace, valid where its track is.
# - ``bpm_stage_pct``: the same share against the reference's FFT peak over
#   the green trace the call returned, valid where the call's track is: a
#   stage check of the estimate, whose input the numbers above judge.
NUMBERS = ("track_px", "means_gap", "green_gap", "bpm_pct", "bpm_stage_pct")
BPM_TOL = 1e-3      # BPM; one bin is at least 2 BPM apart at 900 samples


def pipeline_config(cfg: dict):
    """The port's ``PipelineConfig`` for the configuration file's values."""
    from vhr_tpu_torch.config import HRBand, PipelineConfig, ROIConfig

    p = cfg["pipeline"]
    return PipelineConfig(band=HRBand(*p["band_hz"]),
                          window_seconds=p["window_seconds"],
                          acquisition_seconds=p["acquisition_seconds"],
                          roi=ROIConfig(**p["roi"]),
                          estimator=p["estimator"], channel=p["channel"])


def task_path(cfg: dict) -> str:
    return os.path.join(ROOT, cfg["mediapipe"]["task_file"])


class Driver:
    """``Driver(cfg, device)``; ``call(frames (S, T, H, W, 3) u8)`` returns
    the call's outputs ``bpm``, ``valid``, ``green`` and what it produced
    on the way, by name, all on the device, queued."""

    def __init__(self, cfg: dict, device):
        import importlib

        from vhr_tpu_torch.parallel.mesh import stream_mesh
        self.streams = importlib.import_module(STREAMS)
        self.cfg = cfg
        self.form = cfg["form"]
        self.fps = float(cfg["fps"])
        self.pcfg = pipeline_config(cfg)
        self.mesh = stream_mesh(devices=[device])
        self._patched = []
        self._cap: dict = {}
        if self.form == "fused":
            self.kwargs = dict(use_fused=True,
                               detect_row_pool=cfg["fused"]["detect_row_pool"],
                               gate_margin=cfg["fused"]["gate_margin"],
                               det=self._skin())
            self._wrap("fused_detect_roi_cuda", self._keep_fused)
        elif self.form == "mediapipe":
            from vhr_tpu_torch.models.mediapipe_face import \
                make_mediapipe_detector
            mp = cfg["mediapipe"]
            det = make_mediapipe_detector(
                task_path(cfg), crop_mode=mp["crop_mode"],
                activation_dtype=getattr(torch, mp["activation_dtype"]),
                device=device)

            def detector(frames):
                boxes, valid = det(frames)
                self._cap["boxes"], self._cap["box_valid"] = boxes, valid
                return boxes, valid
            self.kwargs = dict(detector=detector)
            self._wrap("roi_channel_means_cuda", self._keep_means)
        else:
            raise ValueError(f"unknown form {self.form!r}")

    def _skin(self):
        from vhr_tpu_torch.models.skin_detector import SkinDetectorConfig

        return SkinDetectorConfig(**self.cfg["skin"])

    def _wrap(self, attr, make):
        orig = getattr(self.streams, attr)
        self._patched.append((attr, orig))
        setattr(self.streams, attr, make(orig))

    def _keep_fused(self, orig):
        def fused(*args, **kwargs):
            res = orig(*args, **kwargs)
            self._cap.update(boxes=res.boxes, box_valid=res.det_valid,
                             roi_valid=res.roi_valid, means=res.means)
            return res
        return fused

    def _keep_means(self, orig):
        def means(frames, rois, *args, **kwargs):
            out = orig(frames, rois, *args, **kwargs)
            self._cap.update(rois=rois, means=out[0])
            return out
        return means

    def call(self, frames: torch.Tensor):
        self._cap = {}
        res = self.streams.multistream_green_bpm(
            frames, self.fps, mesh=self.mesh, cfg=self.pcfg, **self.kwargs)
        return dict(self._cap, bpm=res.bpm, valid=res.valid,
                    green=res.green)

    def close(self):
        for attr, orig in reversed(self._patched):
            setattr(self.streams, attr, orig)
        self._patched = []
        self.kwargs = {}


def records(outputs: dict, S: int, T: int) -> list:
    """A call's outputs (host arrays: the per-stream ``(S, T)`` ones and
    the flat ``(S * T, ...)`` ones captured on the way) as one dict a
    recording."""
    recs = []
    for s in range(S):
        r = {k: np.asarray(v).reshape((S, T) + v.shape[1:])[s]
             if k not in ("bpm", "valid", "green") else np.asarray(v)[s]
             for k, v in outputs.items()}
        if "rois" in r:
            r["roi_valid"] = (r["rois"] != 0).any(-1)
        recs.append(r)
    return recs


class Reference:
    """The plain reference of a configuration, or its control
    (``control=True``): ``ref(frames (S, T, H, W, 3))`` -> one dict a
    recording, numpy, with ``green``, ``bpm`` and ``valid``."""

    def __init__(self, cfg: dict, device, control: bool = False):
        self.cfg, self.control = cfg, control
        self.prec = cfg["control"] if control else cfg["precision"]
        if cfg["form"] == "mediapipe":
            self.lm = FaceLandmarker(task_path(cfg), device,
                                     self.prec["nets"] if control
                                     else "float32")

    def __call__(self, frames: torch.Tensor) -> list:
        cfg, p = self.cfg, self.cfg["pipeline"]
        S, T, H, W, _ = frames.shape
        if cfg["form"] == "fused":
            out = skin_fused.reference(frames, cfg, self.prec["chroma"])
            recs = [{k: v[s] for k, v in out.items()} for s in range(S)]
        else:
            recs = []
            for s in range(S):
                boxes, ok = self.lm.boxes(frames[s])
                boxes, ok = boxes.cpu().numpy(), ok.cpu().numpy()
                held, held_ok = track.holdover(
                    boxes, ok, p["roi"]["landmark_hold_frames"])
                rois = track.cheek_roi(held, held_ok, p["roi"], W, H)
                recs.append(dict(
                    boxes=boxes, box_valid=ok, rois=rois,
                    roi_valid=(rois != 0).any(-1),
                    means=track.roi_means(frames[s], rois,
                                          self.prec["means"])))
        for r in recs:
            r["green"] = dsp.round_to(dsp.fill_invalid(
                r["means"][:, p["channel"]], r["roi_valid"]),
                self.prec["means"])
            bpm, ok = estimate(r["green"][None], cfg,
                               self.prec["estimate"] if self.control
                               else "float64")
            r["bpm"], r["valid"] = bpm[0], ok[0] & r["roi_valid"]
        return recs


def estimate(green: np.ndarray, cfg: dict, precision: str = "float64"):
    p = cfg["pipeline"]
    fps = float(cfg["fps"])
    return dsp.rolling_bpm(green, fps, p["band_hz"],
                           int(p["window_seconds"] * fps),
                           int(p["acquisition_seconds"] * fps), precision)


def _bpm_differs(bpm, valid, ref_bpm, ref_valid) -> float:
    """Percent of frames whose validity, or valid BPM, differs."""
    differs = (valid != ref_valid) | (ref_valid & (
        np.abs(bpm.astype(np.float64) - ref_bpm) > BPM_TOL))
    return 100.0 * float(differs.mean())


def compare(prog: dict, ref: dict, cell) -> dict:
    """One recording's ``NUMBERS``: the program's record against the
    reference's, on the cell's ``W``-pixel frames."""
    stage_bpm, stage_ok = estimate(prog["green"][None], cell.config)
    both = prog["roi_valid"] & ref["roi_valid"]
    mismatch = (prog["box_valid"] != ref["box_valid"]) \
        | (prog["roi_valid"] != ref["roi_valid"])
    gap = np.abs(prog["boxes"].astype(np.int64) - ref["boxes"]).max(-1)
    if "rois" in ref:
        gap = np.maximum(gap, np.abs(prog["rois"].astype(np.int64)
                                     - ref["rois"]).max(-1))
    gap = np.where(mismatch, cell.W, gap)
    means = np.abs(prog["means"].astype(np.float64) - ref["means"]).max(-1)
    return {"track_px": float(gap.max()),
            "means_gap": float(means[both].max()) if both.any() else 0.0,
            "green_gap": float(np.abs(prog["green"].astype(np.float64)
                                      - ref["green"]).max()),
            "bpm_pct": _bpm_differs(prog["bpm"], prog["valid"], ref["bpm"],
                                    ref["valid"]),
            "bpm_stage_pct": _bpm_differs(prog["bpm"], prog["valid"],
                                          stage_bpm[0],
                                          stage_ok[0] & prog["roi_valid"])}
