"""K6: the EVM front-end (blur + 2x decimate + YIQ) on a hand-written CUDA
kernel.

Port of ``vhr_tpu/ops/pallas_evm.py::yiq_pyrdown_pallas``; the kernel is
``csrc/evm_pyrdown.cu``.  It reads interleaved u8 frames of any width (the
Pallas kernel's ``W % 128`` and planar input are Mosaic layout needs).  A
CPU tensor takes the plain version (:func:`yiq_pyrdown_plain`); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from . import color

__all__ = ["yiq_pyrdown", "yiq_pyrdown_plain", "to_planar", "LAUNCHES"]

# Kernel launches made by yiq_pyrdown (CUDA tensors only).
LAUNCHES = 0

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
    lib = _build.library()
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    global LAUNCHES
    LAUNCHES += 1
    _build.check(lib.vhr_yiq_pyrdown(frames.data_ptr(), out.data_ptr(),
                                     T, H, W, stream), "yiq_pyrdown")
    return out
