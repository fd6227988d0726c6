"""K7: the EVM reconstruction (upsample + add + BGR u8) on a hand-written
CUDA kernel.

Port of ``vhr_tpu/ops/pallas_evm_recon.py::evm_reconstruct_pallas``; the
kernel is ``csrc/evm_recon.cu``.  It addresses pixels by strides, so the
planar ``(T, 3, H, W)`` argument may be a view of interleaved frames
(``to_planar``): the EVM path reads and writes ``(T, H, W, 3)`` frames with
no transposes.  The kernel has two instances, which agree bit for bit: a
vectorised one for interleaved frames whose base, row and frame pitches
are 16-byte aligned and whose width is a multiple of 16 (every frame of
the EVM kernel route), launched as :func:`k7_geometry` says, and the
generic one for any other strides, base or width (:func:`k7_instance`
chooses).  A CPU tensor takes the plain version
(:func:`evm_reconstruct_plain`); a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from . import color
from .evm_cuda import U8_SCALE

__all__ = ["evm_reconstruct", "evm_reconstruct_plain", "resize_matrix",
           "upsample", "k7_geometry", "k7_instance", "K7Geometry",
           "KERNEL_SHAPE", "LAUNCHES", "VEC_LAUNCHES", "GENERIC_LAUNCHES"]

# Kernel launches made by evm_reconstruct (CUDA tensors only), in all and
# by instance.
LAUNCHES = 0
VEC_LAUNCHES = 0
GENERIC_LAUNCHES = 0

# The vectorised instance's launch shape.  ``csrc/evm_recon.cu`` is
# compiled with the same strip, pass, ring and pitch and refuses a launch
# that disagrees.  A thread block owns a strip of ``strip_cols`` columns
# (one warp a group of 16 pixels) and a segment of ``seg_rows`` rows of one
# frame, walked in passes of ``pass_rows`` (one lane a row) through a ring
# of ``ring`` pass tiles whose rows are ``pitch`` bytes; a column's taps
# take ``tap_bytes``.  ``seg_rows`` is the host's alone (a multiple of
# ``pass_rows``).
KERNEL_SHAPE = dict(strip_cols=128, pass_rows=32, ring=2, seg_rows=128,
                    pitch=400, tap_bytes=16)
# Shared memory a block may hold on the H100.
MAX_SMEM = 232448


class K7Geometry(NamedTuple):
    """One launch of the vectorised K7: the grid (``T * segments * strips``
    blocks), the staged band columns and the block's shared memory."""

    strips: int
    segments: int
    seg_rows: int
    band_cols: int
    smem_bytes: int
    blocks: int


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
def _tap_arrays(n_in: int, n_out: int):
    """Per output index, the two input indices and weights of
    ``resize_matrix(n_in, n_out)`` (the second weight is 0 where a row has
    one non-zero), as numpy arrays."""
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
    return lo, hi, w_lo, w_hi


@functools.lru_cache(maxsize=16)
def _tables(n_in: int, n_out: int, device: torch.device):
    """:func:`_tap_arrays` as tensors on ``device``."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in _tap_arrays(n_in, n_out))


def _band_cols(wb: int, W: int) -> int:
    """The most band columns one strip of the vectorised K7 reads: the
    tables' ``lo`` is non-decreasing and ``hi`` is ``lo`` or ``lo + 1``, so
    a strip reads columns ``lo[first]`` to ``min(lo[last] + 1, wb - 1)``."""
    lo = _tap_arrays(wb, W)[0]
    first = np.arange(0, W, KERNEL_SHAPE["strip_cols"])
    last = np.minimum(first + KERNEL_SHAPE["strip_cols"], W) - 1
    return int((np.minimum(lo[last] + 1, wb - 1) - lo[first] + 1).max())


def k7_geometry(T: int, H: int, W: int, wb: int) -> K7Geometry:
    """The vectorised K7's launch for ``T`` frames of ``H x W`` and a band
    ``wb`` columns wide.  The segment is ``KERNEL_SHAPE["seg_rows"]`` rows,
    halved (down to one pass) while the block's shared memory would exceed
    the card's."""
    sh = KERNEL_SHAPE
    nb = _band_cols(wb, W)
    seg = sh["seg_rows"]

    def smem(rows):
        return (sh["ring"] * sh["pass_rows"] * sh["pitch"]
                + sh["strip_cols"] * sh["tap_bytes"] + 3 * nb * rows * 4)

    while seg > sh["pass_rows"] and smem(seg) > MAX_SMEM:
        seg //= 2
    strips = -(-W // sh["strip_cols"])
    segments = -(-H // seg)
    return K7Geometry(strips=strips, segments=segments, seg_rows=seg,
                      band_cols=nb, smem_bytes=smem(seg),
                      blocks=T * segments * strips)


def _vector_layout(ptr: int, strides, W: int) -> bool:
    """Interleaved u8 ``(T, 3, H, W)`` strides (channel 1, pixel 3) with the
    base, the row and the frame pitch 16-byte aligned, ``W % 16 == 0``."""
    st, sc, sh, sw = strides
    return (sc == 1 and sw == 3 and W % 16 == 0 and ptr % 16 == 0
            and sh % 16 == 0 and st % 16 == 0)


def k7_instance(in_ptr: int, in_strides, out_ptr: int, out_strides, W: int,
                wb: int) -> str:
    """``"vector"`` where both the input and the output have the vectorised
    instance's layout and alignment and a strip's band columns fit in
    shared memory (``wb`` up to about twice ``W``), else ``"generic"``."""
    if not (_vector_layout(in_ptr, in_strides, W)
            and _vector_layout(out_ptr, out_strides, W)):
        return "generic"
    return ("vector" if k7_geometry(1, 1, W, wb).smem_bytes <= MAX_SMEM
            else "generic")


def evm_reconstruct(planar: torch.Tensor, band: torch.Tensor,
                    instance: str | None = None) -> torch.Tensor:
    """Fused u8 + upsampled band -> magnified u8 (K7).

    Args:
      planar: ``(T, 3, H, W)`` uint8 BGR, any strides (e.g. ``to_planar``
        of ``(T, H, W, 3)`` frames).
      band: ``(T, 3, hb, wb)`` float32 amplified band-passed YIQ (gains
        already applied), luma scale [0, 1].
      instance: the kernel's instance on a CUDA tensor: None for
        :func:`k7_instance`'s choice, ``"generic"`` (any layout) or
        ``"vector"`` (raises where the layout does not allow it).
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
    choice = k7_instance(planar.data_ptr(), planar.stride(), out.data_ptr(),
                         out.stride(), W, wb)
    if instance not in (None, "vector", "generic"):
        raise ValueError(f"unknown K7 instance {instance!r}")
    if instance == "vector" and choice != "vector":
        raise ValueError("K7's vectorised instance needs interleaved frames "
                         "with 16-byte aligned base and pitches and W % 16 "
                         "== 0")
    choice = instance or choice
    geo = (k7_geometry(T, H, W, wb) if choice == "vector"
           else K7Geometry(0, 0, 0, 0, 0, 0))
    v_tab = _tables(hb, H, planar.device)
    h_tab = _tables(wb, W, planar.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(planar.device).cuda_stream
    global LAUNCHES, VEC_LAUNCHES, GENERIC_LAUNCHES
    LAUNCHES += 1
    if choice == "vector":
        VEC_LAUNCHES += 1
    else:
        GENERIC_LAUNCHES += 1
    _build.check(lib.vhr_evm_reconstruct(
        planar.data_ptr(), *planar.stride(), out.data_ptr(), *out.stride(),
        band.data_ptr(), *(a.data_ptr() for a in v_tab),
        *(a.data_ptr() for a in h_tab), T, H, W, hb, wb,
        int(choice == "vector"), KERNEL_SHAPE["ring"], geo.seg_rows,
        geo.strips, geo.segments, geo.band_cols, stream),
        f"evm_reconstruct ({choice})")
    return out
