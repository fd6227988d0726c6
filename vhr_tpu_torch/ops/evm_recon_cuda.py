"""K7: the EVM reconstruction (upsample + add + BGR u8) on a hand-written
CUDA kernel.

Port of ``vhr_tpu/ops/pallas_evm_recon.py::evm_reconstruct_pallas``; the
kernel is ``csrc/evm_recon.cu``.  It addresses pixels by strides, so the
planar ``(T, 3, H, W)`` argument may be a view of interleaved frames
(``to_planar``): the EVM path reads and writes ``(T, H, W, 3)`` frames with
no transposes.  A CPU tensor takes the plain version
(:func:`evm_reconstruct_plain`); a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from . import color
from .evm_cuda import U8_SCALE

__all__ = ["evm_reconstruct", "evm_reconstruct_plain", "resize_matrix",
           "upsample", "LAUNCHES"]

# Kernel launches made by evm_reconstruct (CUDA tensors only).
LAUNCHES = 0


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear-upsample matrix with ``jax.image.resize``
    'linear' semantics (half-pixel centers, edge clamp)."""
    M = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for r in range(n_out):
        x = (r + 0.5) * scale - 0.5
        lo = int(np.floor(x))
        frac = x - lo
        lo_c = min(max(lo, 0), n_in - 1)
        hi_c = min(max(lo + 1, 0), n_in - 1)
        M[r, lo_c] += 1.0 - frac
        M[r, hi_c] += frac
    return M


def upsample(band: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear upsample of ``(..., hb, wb)`` to ``(..., H, W)``: the rows'
    weights first, then the columns' (``Uv @ band @ Uh``)."""
    hb, wb = band.shape[-2:]
    uv = torch.as_tensor(resize_matrix(hb, H), device=band.device)
    uh = torch.as_tensor(resize_matrix(wb, W).T, device=band.device)
    return torch.matmul(torch.matmul(uv, band), uh)


def evm_reconstruct_plain(planar: torch.Tensor,
                          band: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7 (same contract as
    :func:`evm_reconstruct`)."""
    H, W = planar.shape[2:]
    frames = planar.permute(0, 2, 3, 1)                  # (T, H, W, 3) BGR
    yiq = color.rgb_to_yiq(frames.flip(-1).to(torch.float32) * U8_SCALE)
    yiq = yiq + upsample(band.to(torch.float32), H, W).permute(0, 2, 3, 1)
    bgr = color.yiq_to_rgb(yiq).flip(-1)
    # K7 rounds +0.5 then truncates; clamping to [0, 1] first changes no
    # value.
    u8 = torch.clamp(bgr * 255.0 + 0.5, 0.0, 255.0).to(torch.int32)
    out = torch.empty_like(planar)
    out.copy_(u8.permute(0, 3, 1, 2))
    return out


@functools.lru_cache(maxsize=16)
def _tables(n_in: int, n_out: int, device: torch.device):
    """Per output index, the two input indices and weights of
    ``resize_matrix(n_in, n_out)`` (the second weight is 0 where a row has
    one non-zero)."""
    M = resize_matrix(n_in, n_out)
    lo = np.empty(n_out, np.int32)
    hi = np.empty(n_out, np.int32)
    w_lo = np.empty(n_out, np.float32)
    w_hi = np.zeros(n_out, np.float32)
    for r in range(n_out):
        nz = np.flatnonzero(M[r])
        lo[r], hi[r] = nz[0], nz[-1]
        w_lo[r] = M[r, nz[0]]
        if len(nz) > 1:
            w_hi[r] = M[r, nz[-1]]
    return tuple(torch.as_tensor(a, device=device)
                 for a in (lo, hi, w_lo, w_hi))


def evm_reconstruct(planar: torch.Tensor, band: torch.Tensor) -> torch.Tensor:
    """Fused u8 + upsampled band -> magnified u8 (K7).

    Args:
      planar: ``(T, 3, H, W)`` uint8 BGR, any strides (e.g. ``to_planar``
        of ``(T, H, W, 3)`` frames).
      band: ``(T, 3, hb, wb)`` float32 amplified band-passed YIQ (gains
        already applied), luma scale [0, 1].
    Returns:
      ``(T, 3, H, W)`` uint8 BGR, laid out as ``planar`` is
      (``torch.empty_like``).
    """
    if planar.dim() != 4 or planar.shape[1] != 3:
        raise ValueError(f"planar must be (T, 3, H, W), got "
                         f"{tuple(planar.shape)}")
    T, _, H, W = planar.shape
    if band.dim() != 4 or tuple(band.shape[:2]) != (T, 3):
        raise ValueError(f"band must be ({T}, 3, hb, wb), got "
                         f"{tuple(band.shape)}")
    if planar.dtype != torch.uint8:
        raise TypeError(f"K7 takes uint8 frames, got {planar.dtype}")
    if planar.device.type == "cpu":
        return evm_reconstruct_plain(planar, band.cpu())
    if planar.device.type != "cuda":
        raise ValueError(f"unsupported device {planar.device}")
    if band.device != planar.device or band.dtype != torch.float32:
        raise ValueError("band must be float32 on the frames' device")
    hb, wb = band.shape[2], band.shape[3]
    band = band.contiguous()
    out = torch.empty_like(planar)
    v_tab = _tables(hb, H, planar.device)
    h_tab = _tables(wb, W, planar.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(planar.device).cuda_stream
    global LAUNCHES
    LAUNCHES += 1
    _build.check(lib.vhr_evm_reconstruct(
        planar.data_ptr(), *planar.stride(), out.data_ptr(), *out.stride(),
        band.data_ptr(), *(a.data_ptr() for a in v_tab),
        *(a.data_ptr() for a in h_tab), T, H, W, hb, wb, stream),
        "evm_reconstruct")
    return out
