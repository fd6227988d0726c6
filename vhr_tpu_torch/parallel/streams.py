"""Stream-parallel batched monitoring: N subjects over the places of a mesh.

Port of ``vhr_tpu/parallel/streams.py``: the ``BASELINE.json``
configuration of 64 concurrent 720p streams.  Frames arrive as ``(streams,
T, H, W, 3)``; each stream runs the whole green-channel pipeline on its
own, so the stream axis is split over the mesh's places and no shard needs
another's data.

A shard of ``S_local`` streams runs in one of three forms:

- **skin** (the default): the skin detector over the shard's ``S_local *
  T`` frames (detection is frame-local), then per stream the holdover, the
  cheek ROI zeroed where the track is invalid, and the ROI means (kernel K2
  on a CUDA place, one launch a shard);
- **detector**: ``detector`` (any pipeline detector, e.g. the MediaPipe
  one) once over the shard's flat ``S_local * T`` frames, then per stream
  as above;
- **fused** (``use_fused=True``): kernel K1 once over the shard's flat
  frames with ``seq_len=T``, which resets the tracking at each stream's
  first frame (its plain version on a CPU place).

Then per stream the forward-fill over dropouts and the rolling FFT BPM, the
shard's streams as one batch; ``valid`` is the estimate's validity and the
track's.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch

from ..config import PipelineConfig
from ..models import skin_detector
from ..ops import roi as vroi
from ..ops import windows as vwin
from ..ops.fused_cuda import fused_detect_roi_cuda
from ..ops.roi_means_cuda import roi_channel_means_cuda
from ..pipeline.offline import _fill_invalid
from ..utils.profiling import count, request, span
from .mesh import Mesh, gather, local_shards

__all__ = ["multistream_green_bpm", "MultiStreamResult"]


class MultiStreamResult(NamedTuple):
    bpm: torch.Tensor      # (streams, T)
    valid: torch.Tensor    # (streams, T)
    green: torch.Tensor    # (streams, T)


def _estimate(means: torch.Tensor, valid: torch.Tensor, fps: float,
              cfg: PipelineConfig):
    """``(S, T, 3)`` means and ``(S, T)`` track validity -> ``(bpm, valid,
    green)``, each ``(S, T)``: the shard's streams as one batch."""
    with span("vhr.estimate"):
        green = _fill_invalid(means[..., cfg.channel].T.contiguous(),
                              valid.T.contiguous())               # (T, S)
        rolling = vwin.rolling_bpm_fft(green, fps, cfg.band,
                                       cfg.window_len(fps),
                                       cfg.acquisition_len(fps))
        return rolling.bpm.T, (rolling.valid & valid.T).T, green.T


def _shard(frames: torch.Tensor, fps: float, cfg: PipelineConfig,
           det: skin_detector.SkinDetectorConfig, detector):
    """One shard ``(S_local, T, H, W, 3)`` of the skin or detector form."""
    S, T, H, W, _ = frames.shape
    flat = frames.reshape(S * T, H, W, 3)
    with span("vhr.detect"):
        if detector is not None:
            boxes, valid = detector(flat)
        else:
            boxes, valid = skin_detector.detect_faces(flat, det)
    boxes = boxes.to(torch.int32).reshape(S, T, 4)
    valid = valid.to(torch.bool).reshape(S, T)
    with span("vhr.holdover"):
        tracks = [vroi.holdover(boxes[s], valid[s],
                                cfg.roi.landmark_hold_frames)
                  for s in range(S)]
        tbox = torch.stack([t.box for t in tracks]).reshape(S * T, 4)
        tvalid = torch.stack([t.valid for t in tracks])
    with span("vhr.roi"):
        rois = vroi.cheek_roi(tbox, cfg.roi, W, H)
        rois = torch.where(tvalid.reshape(-1, 1), rois, 0)
    with span("vhr.k2"):
        means, _ = roi_channel_means_cuda(flat, rois)
    return _estimate(means.reshape(S, T, 3), tvalid, fps, cfg)


def _shard_fused(frames: torch.Tensor, fps: float, cfg: PipelineConfig,
                 det: skin_detector.SkinDetectorConfig, detect_row_pool: int,
                 gate_margin):
    """One shard in the fused form: one K1 launch over its streams
    (``det.downsample`` is ignored; ``detect_row_pool`` is K1's
    resolution)."""
    S, T, H, W, _ = frames.shape
    res = fused_detect_roi_cuda(
        frames.reshape(S * T, H, W, 3), det=det, roi=cfg.roi, seq_len=T,
        detect_row_pool=detect_row_pool, gate_margin=gate_margin)
    return _estimate(res.means.reshape(S, T, 3),
                     res.roi_valid.reshape(S, T), fps, cfg)


def multistream_green_bpm(frames: Union[torch.Tensor,
                                        Sequence[torch.Tensor]],
                          fps: float, mesh: Mesh,
                          cfg: PipelineConfig = PipelineConfig(),
                          det: skin_detector.SkinDetectorConfig = None,
                          use_fused: bool = False,
                          detect_row_pool: int = 1,
                          gate_margin=None,
                          detector=None) -> MultiStreamResult:
    """The green-channel pipeline for ``(streams, T, H, W, 3)`` uint8
    frames split over the mesh's ``stream`` axis.

    ``frames`` is the whole batch or this process's shards of it
    (:func:`~vhr_tpu_torch.parallel.dcn.distribute_streams`).  ``det``
    tunes the skin detector (``downsample=4`` for many-stream 720p).
    ``use_fused=True`` runs each shard through kernel K1 (``H % 8 == 0``,
    ``W * 3 % 128 == 0``; ``detect_row_pool`` and ``gate_margin`` are its
    knobs) and refuses a ``detector``.  ``detector`` replaces the skin
    detector (its weights serve every place of its device).

    Returns the shards' results concatenated, each ``(streams, T)``: every
    stream on a one-process mesh, this process's on a mesh over several
    (:func:`~vhr_tpu_torch.parallel.dcn.gather_streams` gathers them).
    """
    det = det or skin_detector.SkinDetectorConfig()
    if use_fused and detector is not None:
        raise ValueError("use_fused=True embeds its own detection; "
                         "pass detector=None")
    with request("vhr.entry"):
        shards = local_shards(frames, mesh, "stream")
        count("recordings", sum(fr.shape[0] for fr in shards))
        count("frames", sum(fr.shape[0] * fr.shape[1] for fr in shards))
        parts = []
        for fr in shards:
            with span("vhr.shard", streams=fr.shape[0]):
                if use_fused:
                    parts.append(_shard_fused(fr, fps, cfg, det,
                                              detect_row_pool, gate_margin))
                else:
                    parts.append(_shard(fr, fps, cfg, det, detector))
        return MultiStreamResult(*(gather([p[i] for p in parts])
                                   for i in range(3)))
