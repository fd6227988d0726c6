"""K5: one face-mesh residual bottleneck stage on a hand-written CUDA kernel.

Port of ``vhr_tpu/ops/pallas_meshblocks.py::residual_stage_pallas``; the
kernel is ``csrc/residual_stage.cu``.  A stage of the MediaPipe face-mesh
graph is a run of identical bottleneck blocks::

    entry: PRELU(C)
    block: 1x1 conv (C->Cm) + bias -> PRELU(Cm)
           -> depthwise 3x3 SAME (Cm) + bias
           -> 1x1 conv (Cm->C) + bias -> ADD(residual) -> PRELU(C)

Op by op, every block moves about five feature maps through device memory;
the kernel reads the stage input once and writes its output once, with the
intermediate maps in shared memory as float32.  Its two 1x1 convs run on
the tensor cores in three TF32 passes with float32 accumulators (about 22
bits of each product), everything else in float32 on the CUDA cores.

``x`` is ``(B, C, S)`` with ``S = H * w_row``: a plain NCHW tensor seen
with its spatial axes flattened, so the executor calls it with no
transposes.  A CPU tensor takes the plain version
(:func:`residual_stage_plain`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..device import float32_exact
from ..utils.profiling import count

__all__ = ["StageWeights", "pack_stage_weights", "residual_stage",
           "residual_stage_plain", "stage_rows", "plane_stride",
           "weight_floats", "band_rows", "check_kernel_shape"]

_TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
# Mid widths Cm the kernel is compiled for (C = 2 * Cm, the face-mesh net's
# bottleneck), each with its launch shape (m-tiles of 16 pixels a warp works
# on at a time, warps a thread block).
KERNEL_TILING = {8: (2, 24), 16: (2, 16), 32: (2, 16), 64: (1, 16)}


class StageWeights(NamedTuple):
    """Stacked float32 weights for an N-block residual stage.

    Shapes: ``a0 (C,1)``; per-block stacks ``w1 (N,Cm,C)``, ``b1 (N,Cm,1)``,
    ``a1 (N,Cm,1)``, ``dw (N,9,Cm)``, ``bdw (N,Cm,1)``, ``w2 (N,C,Cm)``,
    ``b2 (N,C,1)``, ``a2 (N,C,1)``.
    """

    a0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    a1: torch.Tensor
    dw: torch.Tensor
    bdw: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    a2: torch.Tensor


def pack_stage_weights(a0, blocks, device=None) -> StageWeights:
    """Host-side packing from TFLite tensors.

    ``a0``: entry PRELU alpha ``(1,1,C)`` (or ``(C,)``); ``blocks``: list of
    dicts with keys ``w1 (Cm,1,1,C)``, ``b1 (Cm,)``, ``a1 (1,1,Cm)``,
    ``dw (1,3,3,Cm)``, ``bdw (Cm,)``, ``w2 (C,1,1,Cm)``, ``b2 (C,)``,
    ``a2 (1,1,C)`` — the raw TFLite constant layouts.
    """
    f = np.float32
    a0 = np.asarray(a0, f).reshape(-1, 1)
    C = a0.shape[0]

    def col(v):
        return np.asarray(v, f).reshape(-1, 1)

    w1 = np.stack([np.asarray(b["w1"], f).reshape(-1, C) for b in blocks])
    Cm = w1.shape[1]
    arrays = (
        a0, w1,
        np.stack([col(b["b1"]) for b in blocks]),
        np.stack([col(b["a1"]) for b in blocks]),
        np.stack([np.asarray(b["dw"], f).reshape(9, Cm) for b in blocks]),
        np.stack([col(b["bdw"]) for b in blocks]),
        np.stack([np.asarray(b["w2"], f).reshape(C, Cm) for b in blocks]),
        np.stack([col(b["b2"]) for b in blocks]),
        np.stack([col(b["a2"]) for b in blocks]))
    return StageWeights(*(torch.as_tensor(a, device=device) for a in arrays))


def _prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * alpha)


def residual_stage_plain(x: torch.Tensor, wts: StageWeights,
                         w_row: int) -> torch.Tensor:
    """Plain PyTorch version of K5, op by op in float32 (TF32 off), the
    result in ``x``'s dtype."""
    B, C, S = x.shape
    H, dtype = S // w_row, x.dtype
    with float32_exact():
        x = _prelu(x.to(torch.float32), wts.a0)
        for k in range(wts.w1.shape[0]):
            h = _prelu(torch.matmul(wts.w1[k], x) + wts.b1[k], wts.a1[k])
            hp = F.pad(h.reshape(B, -1, H, w_row), (1, 1, 1, 1))
            d = wts.bdw[k].reshape(1, -1, 1, 1).expand(B, -1, H, w_row)
            for t, (dy, dx) in enumerate(_TAPS):
                tap = hp[:, :, 1 + dy:1 + dy + H, 1 + dx:1 + dx + w_row]
                d = d + tap * wts.dw[k, t].reshape(1, -1, 1, 1)
            y = torch.matmul(wts.w2[k], d.reshape(B, -1, S)) + wts.b2[k]
            x = _prelu(x + y, wts.a2[k])
    return x.to(dtype)


def plane_stride(pixels: int, tile: int) -> int:
    """Floats between two channels' planes in K5's shared memory: the held
    pixels rounded up to whole tiles (a warp computes whole tiles), then
    padded to 8 modulo 32, so that the four channels and eight pixel groups
    a warp touches at once fall into 32 different banks."""
    whole = -(-pixels // tile) * tile
    return whole + (8 - whole) % 32


def weight_floats(C: int, Cm: int) -> int:
    """Floats of one block's weights in K5's shared memory: one 1x1 conv's
    matrix split into big and small parts (w2 takes w1's place), the nine
    depthwise taps, and the biases and slopes."""
    return 2 * C * Cm + 9 * Cm + 3 * Cm + 2 * C


def band_rows(H: int, rows: int, n_blocks: int, band: int):
    """``(r0, r1, lo, hi)``: band ``band`` writes rows ``[r0, r1)`` and
    holds rows ``[lo, hi)``, its own plus ``n_blocks`` halo rows on each
    side (each 3x3 depthwise conv widens the rows it needs by one), clipped
    to the frame."""
    r0 = band * rows
    r1 = min(H, r0 + rows)
    return r0, r1, max(0, r0 - n_blocks), min(H, r1 + n_blocks)


def check_kernel_shape(C: int, Cm: int, w_row: int) -> None:
    """Raise for a stage the CUDA kernel is not compiled for."""
    if Cm not in KERNEL_TILING or C != 2 * Cm:
        raise ValueError(f"K5 is built for Cm in {tuple(KERNEL_TILING)} and "
                         f"C = 2 * Cm, got C={C}, Cm={Cm}")
    if w_row % 4 != 0:
        raise ValueError(f"K5 takes a w_row that is a multiple of 4 (a "
                         f"lane's pixels lie in one row), got w_row={w_row}")


def stage_rows(C: int, Cm: int, H: int, W: int, n_blocks: int,
               smem_bytes: int, tile: int = 16):
    """Output rows per thread block of K5, its shared memory bytes and the
    stride of a plane there, for tiles of ``tile`` pixels.

    A block holds its band of ``x`` (C channels) and of ``h`` (Cm channels)
    as float32 planes of :func:`plane_stride` floats over the rows of
    :func:`band_rows`, and one block's weights (:func:`weight_floats`).
    The frame is cut into the fewest bands of equal height whose largest
    fits ``smem_bytes``.
    """
    for n_bands in range(1, H + 1):
        rows = -(-H // n_bands)
        held = max(hi - lo for _, _, lo, hi in
                   (band_rows(H, rows, n_blocks, b)
                    for b in range(-(-H // rows))))
        stride = plane_stride(held * W, tile)
        smem = 4 * ((C + Cm) * stride + weight_floats(C, Cm))
        if smem <= smem_bytes:
            return rows, smem, stride
    raise ValueError(f"a residual stage of {C}+{Cm} channels at width {W} "
                     f"does not fit {smem_bytes} bytes of shared memory")


def residual_stage(x: torch.Tensor, wts: StageWeights,
                   w_row: int) -> torch.Tensor:
    """Run an N-block residual bottleneck stage (K5).

    ``x``: ``(B, C, S)`` float32 or bfloat16, ``S = H * w_row`` flattened
    spatial positions (``S % 128 == 0``, the JAX package's contract);
    returns the same shape and dtype.  Results are float32 inside; the
    output is rounded to ``x``'s dtype once, at the end.  On a CUDA tensor
    the kernel is launched, or the call raises for a shape it is not built
    for (:func:`check_kernel_shape`).
    """
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, S), got {tuple(x.shape)}")
    B, C, S = x.shape
    if S % 128 != 0 or S < 128:
        raise ValueError(f"flattened spatial dim {S} must be a multiple "
                         f"of 128 (w_row={w_row})")
    if S % w_row != 0:
        raise ValueError(f"flattened spatial dim {S} is not a whole number "
                         f"of rows of {w_row}")
    N, Cm = wts.w1.shape[0], wts.w1.shape[1]
    if tuple(wts.w1.shape) != (N, Cm, C):
        raise ValueError(f"w1 {tuple(wts.w1.shape)} does not fit C={C}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K5 takes float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return residual_stage_plain(x, wts, w_row)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    check_kernel_shape(C, Cm, w_row)
    if not 1 <= B <= 65535:
        raise ValueError(f"K5 takes 1 to 65535 frames a launch, got {B}")
    if not x.is_contiguous():
        raise ValueError("K5 needs a contiguous x")
    for name, w in zip(StageWeights._fields, wts):
        if (w.device != x.device or w.dtype != torch.float32
                or not w.is_contiguous()):
            raise ValueError(f"K5 weight {name} must be contiguous float32 "
                             f"on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("K5 needs a 16-byte aligned x")
    H = S // w_row
    mt, warps = KERNEL_TILING[Cm]
    smem_max = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    rows, smem, stride = stage_rows(C, Cm, H, w_row, N, smem_max, 16 * mt)
    out = torch.empty_like(x)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    count("k5.launches")          # CUDA tensors only
    _build.check(lib.vhr_residual_stage(
        x.data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16),
        *(w.data_ptr() for w in wts), B, C, Cm, H, w_row, N, rows, stride,
        smem, mt, warps, stream), "residual_stage")
    return out
