"""K2 and K3: per-frame ROI channel means on hand-written CUDA kernels.

K2 (:func:`roi_channel_means_cuda`) is the port of
``vhr_tpu/ops/pallas_roi.py::roi_channel_means_pallas`` and K3
(:func:`roi_channel_means_batched_cuda`, rows read through a pitch) of
``roi_channel_means_pallas_batched``.  Both compute
:func:`vhr_tpu_torch.ops.reduce.roi_channel_means`, their plain version,
and both launch ``csrc/roi_means.cu``, which has two instances that agree
bit for bit: a vectorised one for frames, rows and base that are 16-byte
aligned (a block a frame and band of its ROI rows, the bands of a frame in
one thread-block cluster), and the generic one for any other layout.
:func:`roi_plan` chooses the instance and the launch from shapes, strides
and the SM count alone (it never reads the ROIs, which stay on the card).
A CPU tensor takes the plain version; a CUDA tensor launches a kernel or
raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from ..utils import profiling
from .reduce import frame_layout, roi_channel_means

__all__ = ["roi_channel_means_cuda", "roi_channel_means_batched_cuda",
           "roi_plan", "plan_bands", "RoiPlan", "group_bytes", "alignment",
           "sm_count",
           "INSTANCES", "MAX_BANDS", "VEC_THREADS", "GENERIC_THREADS",
           "GENERIC_FRAMES"]

# ``csrc/roi_means.cu`` is compiled for these and refuses another plan.
# The C entries number the instances by their index here.
INSTANCES = ("vector", "generic")
MAX_BANDS = 8                 # a portable thread-block cluster
VEC_THREADS = 256             # vectorised: threads a block
GENERIC_FRAMES = 8            # generic: frames a block ...
GENERIC_THREADS = 128         # ... and threads a frame
# A band count whose busiest SM holds at most this much more of the work
# than the best count's is taken if it has fewer bands: each band beyond a
# frame's first costs a combine, and resident blocks even out some of the
# imbalance.
BAND_SLACK = 1.1


class RoiPlan(NamedTuple):
    """One launch: the instance, the bands a frame, the threads a block and
    the grid's blocks."""

    instance: str
    bands: int
    threads: int
    grid: int


def group_bytes(C: int) -> int:
    """Bytes of a vectorised work item: lcm(16, C), whose channels are
    fixed since it starts at a multiple of it from the row's start."""
    return 48 if C == 3 else 16


def alignment(address: int) -> int:
    """The largest power of two that divides ``address``, at most 16."""
    return 16 if address % 16 == 0 else address & -address


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_bands(T: int, sms: int) -> int:
    """Bands a frame for ``T`` frames on ``sms`` SMs.

    Among the counts whose ``T * bands`` blocks give every SM one (all of
    them, 8, where none does), the fewest whose busiest SM takes at most
    :data:`BAND_SLACK` times the least share of the frames: that share is
    ``ceil(T * bands / sms) / bands`` frames, the blocks being equal and
    sharing their SM's bandwidth.
    """
    def share(b):
        return -(-T * b // sms) / b

    fits = [b for b in range(1, MAX_BANDS + 1) if T * b >= sms]
    fits = fits or [MAX_BANDS]
    least = min(share(b) for b in fits)
    return min(b for b in fits if share(b) <= BAND_SLACK * least)


def roi_plan(T: int, H: int, W: int, C: int, frame_stride: int,
             row_pitch: int, base_align: int, sms: int,
             instance: Optional[str] = None) -> RoiPlan:
    """The launch of K2/K3 for ``T`` frames of ``H`` rows of ``W * C``
    bytes, ``row_pitch`` bytes apart in frames ``frame_stride`` bytes
    apart, the first at an address aligned to ``base_align`` bytes
    (:func:`alignment`), on a card of ``sms`` SMs.

    The vectorised instance needs ``base_align``, ``frame_stride`` and
    ``row_pitch`` 16-byte aligned; it takes :func:`plan_bands` blocks a
    frame, from 1 to :data:`MAX_BANDS` (a cluster).  Any other layout
    takes the generic instance, a block per 8 frames.  ``instance`` forces
    one (``"vector"`` raises where the layout does not allow it).
    """
    if not 1 <= C <= 4:
        raise ValueError(f"K2/K3 take 1 to 4 channels, got {C}")
    if min(T, H, W, sms) < 0 or sms == 0:
        raise ValueError(f"bad launch size T={T} H={H} W={W} sms={sms}")
    aligned = (base_align % 16 == 0 and frame_stride % 16 == 0
               and row_pitch % 16 == 0)
    if instance is None:
        instance = "vector" if aligned else "generic"
    if instance not in INSTANCES:
        raise ValueError(f"unknown instance {instance!r} {INSTANCES}")
    if instance == "vector":
        if not aligned:
            raise ValueError("the vectorised K2/K3 needs the base, the row "
                             "pitch and the frame stride 16-byte aligned")
        gb = group_bytes(C)
        items = H * ((W * C + gb - 1) // gb + 1)       # a frame's, at most
        bands = plan_bands(max(T, 1), sms)
        plan = RoiPlan("vector", bands, VEC_THREADS, T * bands)
        per_thread, per_item = -(-items // VEC_THREADS), gb // C
    else:
        items = H * ((W * C + 15) // 16 + 1)
        plan = RoiPlan("generic", 1, GENERIC_FRAMES * GENERIC_THREADS,
                       -(-T // GENERIC_FRAMES))
        per_thread, per_item = -(-items // GENERIC_THREADS), -(-16 // C)
    # The kernels index a frame's items in int32 and sum a thread's bytes of
    # a channel in uint32.
    if items >= 2 ** 31 or per_thread * per_item * 255 >= 2 ** 32:
        raise ValueError(f"frame {H}x{W}x{C} too large for K2/K3")
    return plan


def _launch(entry: str, frames: torch.Tensor, rois: torch.Tensor,
            plan: RoiPlan, lead: tuple, T: int, H: int, W: int, C: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    means = torch.empty((T, C), dtype=torch.float32, device=frames.device)
    count = torch.empty((T,), dtype=torch.float32, device=frames.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    # Launches of K2 and K3 by instance (``k2.launches`` and
    # ``k2.batched`` count each entry's).
    profiling.count("k2.vec" if plan.instance == "vector" else "k2.generic")
    _build.check(getattr(lib, entry)(
        *lead, means.data_ptr(), count.data_ptr(), T, H, W, C,
        INSTANCES.index(plan.instance), plan.bands, plan.threads, plan.grid,
        stream), entry)
    return means, count


def roi_channel_means_cuda(frames: torch.Tensor, rois: torch.Tensor,
                           channels: int = 3, instance: Optional[str] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ROI channel means via the K2 entry.

    Args:
      frames: contiguous ``(T, H, W, C)`` uint8, or flat ``(T, H, W*C)``
        with ``channels`` giving the interleave.
      rois: ``(T, 4)`` int ``[x1, y1, x2, y2]`` (exclusive ends); reads are
        clamped to the frame, ``count`` is the unclipped area.
      instance: force ``"vector"`` or ``"generic"`` (default: as
        :func:`roi_plan` chooses).

    Returns:
      ``(means (T, C) float32, count (T,) float32)``, equal to
      :func:`vhr_tpu_torch.ops.reduce.roi_channel_means`.
    """
    T, H, W, C = frame_layout(frames, channels)
    if tuple(rois.shape) != (T, 4):
        raise ValueError(f"rois must be ({T}, 4), got {tuple(rois.shape)}")
    if frames.device.type == "cpu":
        return roi_channel_means(frames.reshape(T, H, W, C), rois.cpu())
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if frames.dtype != torch.uint8:
        raise TypeError(f"K2 takes uint8 frames, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("K2 needs contiguous frames")
    plan = roi_plan(T, H, W, C, H * W * C, W * C,
                    alignment(frames.data_ptr()),
                    sm_count(frames.device.index or 0), instance)
    rois = rois.to(device=frames.device, dtype=torch.int32).contiguous()
    profiling.count("k2.launches")          # CUDA tensors only
    return _launch("vhr_roi_means_u8", frames, rois, plan,
                   (frames.data_ptr(), rois.data_ptr(), None, 0), T, H, W, C)


def roi_channel_means_batched_cuda(frames: torch.Tensor, rois: torch.Tensor,
                                   channels: int = 3,
                                   width: Optional[int] = None,
                                   instance: Optional[str] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ROI channel means via the K3 entry, one launch for any ``T``.

    Args:
      frames: ``(T, H, W, C)`` uint8, or flat ``(T, H, row_bytes)`` uint8
        whose rows hold ``W * channels`` pixel bytes and then padding
        (``width`` gives ``W``, see
        :func:`vhr_tpu_torch.ops.reduce.frame_layout`).  Frames and rows may
        be strided (a padded reader buffer needs no copy); each row's bytes
        must be contiguous.
      rois: ``(T, 4)`` int ``[x1, y1, x2, y2]`` (exclusive ends); reads are
        clamped to the frame, ``count`` is the unclipped area.
      instance: force ``"vector"`` or ``"generic"`` (default: as
        :func:`roi_plan` chooses).

    Returns:
      ``(means (T, C) float32, count (T,) float32)``, equal to
      :func:`vhr_tpu_torch.ops.reduce.roi_channel_means`.
    """
    T, H, W, C = frame_layout(frames, channels, width)
    if tuple(rois.shape) != (T, 4):
        raise ValueError(f"rois must be ({T}, 4), got {tuple(rois.shape)}")
    if frames.device.type == "cpu":
        return roi_channel_means(frames, rois.cpu(), channels, width)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if frames.dtype != torch.uint8:
        raise TypeError(f"K3 takes uint8 frames, got {frames.dtype}")
    if not 1 <= C <= 4:
        raise ValueError(f"K3 takes 1 to 4 channels, got {C}")
    inner = (1,) if frames.dim() == 3 else (C, 1)
    if tuple(frames.stride()[2:]) != inner and H * W > 0:
        raise ValueError("K3 needs each row's bytes contiguous")
    plan = roi_plan(T, H, W, C, frames.stride(0), frames.stride(1),
                    alignment(frames.data_ptr()),
                    sm_count(frames.device.index or 0), instance)
    rois = rois.to(device=frames.device, dtype=torch.int32).contiguous()
    profiling.count("k2.batched")           # CUDA tensors only
    return _launch("vhr_roi_means_batched_u8", frames, rois, plan,
                   (frames.data_ptr(), frames.stride(0), frames.stride(1),
                    rois.data_ptr()), T, H, W, C)
