"""K6: the EVM front-end (blur + 2x decimate + YIQ) on a hand-written CUDA
kernel.

Port of ``vhr_tpu/ops/pallas_evm.py::yiq_pyrdown_pallas``; the kernel is
``csrc/evm_pyrdown.cu``.  It reads interleaved u8 frames of any width (the
Pallas kernel's ``W % 128`` and planar input are Mosaic layout needs) into
a ring of rows in shared memory, in 16-byte copies where the base and the
row pitch allow, else 4-byte copies or bytes (:func:`copy_width`); its
launch is :func:`k6_geometry`.  A CPU tensor takes the plain version
(:func:`yiq_pyrdown_plain`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from . import color

__all__ = ["yiq_pyrdown", "yiq_pyrdown_plain", "to_planar", "k6_geometry",
           "copy_width", "K6Geometry", "KERNEL_SHAPE", "LAUNCHES"]

# Kernel launches made by yiq_pyrdown (CUDA tensors only).
LAUNCHES = 0

# K6's launch shape.  ``csrc/evm_pyrdown.cu`` is compiled with the same
# numbers and refuses a launch that disagrees.  A thread block owns a strip
# of ``strip_cols`` output columns (4 a lane, one warp a row) and walks
# down a segment of at most ``max_steps`` steps of ``warps`` output rows,
# with ``depth`` groups of ``2 * warps`` input rows in its ring (one landing
# while the warps compute on the other); a ring row holds ``row_bytes``.
# ``max_steps`` is the host's alone: short segments keep the blocks that
# run at once on about two frames, which was fastest on the H100.
KERNEL_SHAPE = dict(strip_cols=128, warps=8, depth=2, max_steps=2,
                    row_bytes=800)


class K6Geometry(NamedTuple):
    """One K6 launch: copy width in bytes, the grid (``T * segments *
    strips`` blocks) and the ring."""

    copy_bytes: int
    strips: int
    segments: int
    seg_steps: int
    ring_rows: int
    smem_bytes: int
    blocks: int


def copy_width(base_ptr: int, W: int) -> int:
    """The widest copy (16, 4 or 1 bytes) that every row start of a
    contiguous ``(T, H, W, 3)`` u8 tensor at ``base_ptr`` is aligned to:
    the base, the row pitch ``3W`` and the frame stride ``3HW`` (a multiple
    of the pitch) all divisible by it."""
    for v in (16, 4):
        if base_ptr % v == 0 and (3 * W) % v == 0:
            return v
    return 1


def k6_geometry(T: int, H: int, W: int, base_ptr: int = 0) -> K6Geometry:
    """K6's launch for ``(T, H, W, 3)`` u8 frames at ``base_ptr``."""
    sh = KERNEL_SHAPE
    h_out, w_out = H // 2, W // 2
    steps = -(-h_out // sh["warps"])
    segments = -(-steps // sh["max_steps"])
    seg_steps = -(-steps // segments)
    ring_rows = 2 * sh["warps"] * sh["depth"] + 3
    strips = -(-w_out // sh["strip_cols"])
    return K6Geometry(copy_bytes=copy_width(base_ptr, W), strips=strips,
                      segments=segments, seg_steps=seg_steps,
                      ring_rows=ring_rows,
                      smem_bytes=ring_rows * sh["row_bytes"],
                      blocks=T * segments * strips)

_W5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
# The kernels scale u8 values by float32(1/255), a multiplication (the JAX
# package's plain route divides by 255 instead).
U8_SCALE = float(np.float32(1.0 / 255.0))


def to_planar(frames: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) channel-interleaved -> (T, 3, H, W) planar (a view)."""
    return frames.permute(0, 3, 1, 2)


def _blur_decimate(x: torch.Tensor, axis: int) -> torch.Tensor:
    """5-tap binomial blur at the even positions of ``axis``, edge-clamped:
    ``n // 2`` outputs."""
    n = x.shape[axis]
    base = 2 * torch.arange(n // 2, device=x.device)
    out = None
    for tap, w in enumerate(_W5):
        idx = torch.clamp(base + (tap - 2), 0, n - 1)
        term = w * x.index_select(axis, idx).to(torch.float32)
        out = term if out is None else out + term
    return out


def yiq_pyrdown_plain(frames: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6: ``(T, H, W, 3)`` u8 BGR ->
    ``(T, 3, H//2, W//2)`` float32 YIQ (luma scale [0, 1]).

    The blur of u8 values with binomial weights is exact in float32, so the
    order of the taps does not matter; the YIQ combine follows the kernel.
    """
    low = _blur_decimate(_blur_decimate(frames, 1), 2)     # (T, h, w, 3)
    yiq = color.rgb_to_yiq(low.flip(-1)) * U8_SCALE
    return yiq.permute(0, 3, 1, 2).contiguous()


def yiq_pyrdown(frames: torch.Tensor) -> torch.Tensor:
    """Fused u8 -> blur -> 2x decimate -> YIQ (K6).

    Args:
      frames: ``(T, H, W, 3)`` uint8 BGR, ``H, W >= 2``.
    Returns:
      ``(T, 3, H//2, W//2)`` float32 YIQ (luma scale [0, 1]).
    """
    if frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (T, H, W, 3), got "
                         f"{tuple(frames.shape)}")
    T, H, W, _ = frames.shape
    if H < 2 or W < 2:
        raise ValueError(f"frames must be at least 2x2, got {H}x{W}")
    if frames.dtype != torch.uint8:
        raise TypeError(f"K6 takes uint8 frames, got {frames.dtype}")
    if frames.device.type == "cpu":
        return yiq_pyrdown_plain(frames)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if not frames.is_contiguous():
        raise ValueError("K6 needs contiguous frames")
    out = torch.empty((T, 3, H // 2, W // 2), dtype=torch.float32,
                      device=frames.device)
    geo = k6_geometry(T, H, W, frames.data_ptr())
    lib = _build.library()
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    global LAUNCHES
    LAUNCHES += 1
    _build.check(lib.vhr_yiq_pyrdown(
        frames.data_ptr(), out.data_ptr(), T, H, W, geo.copy_bytes,
        KERNEL_SHAPE["strip_cols"], KERNEL_SHAPE["warps"], geo.ring_rows,
        geo.strips, geo.segments, geo.seg_steps, stream), "yiq_pyrdown")
    return out
