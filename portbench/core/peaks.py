"""The card's published peaks and the least-time arithmetic of a kernel.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the full 700 W power
limit.  ``bound`` is a frozen copy of ``chip_smoke.py``'s (commit
523c5c8, line 670), with the bf16 tensor-core peak added for the whole
step's share.
"""

from __future__ import annotations

HBM_BPS = 3.35e12          # bytes/s of HBM3
F32_OPS = 67e12            # float32 operations/s on the CUDA cores
TF32_OPS = 495e12          # dense TF32 operations/s on the tensor cores
BF16_OPS = 989e12          # dense bf16 operations/s on the tensor cores


def bound(nbytes: float, ops: float, tensor_ops: float = 0.0):
    """(least seconds for the work on the card, what bounds it):
    ``tensor_ops`` of the ``ops`` run on the tensor cores in TF32, the rest
    in float32 on the CUDA cores."""
    t_bytes = nbytes / HBM_BPS
    t_ops = max((ops - tensor_ops) / F32_OPS, tensor_ops / TF32_OPS)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def k1_work(T: int, H: int, W: int, pool: int):
    """(bytes, operations) of one K1 call over ``T`` frames of ``H x W``:
    every frame byte read once and the per-frame outputs written once
    (means 12, count 4, boxes 16, flags 8 bytes a frame, plus the 24-byte
    carry in and out); 3 pooling adds a pixel and about 20 operations a
    pooled cell's chroma test (``chip_smoke.py``'s count, lines 4897-4899,
    at any row pool)."""
    nbytes = T * H * W * 3 + T * (12 + 4 + 16 + 8) + 48
    ops = 3 * T * H * W + 20 * T * (H // pool) * W
    return nbytes, ops


def k5_ops(C: int, Cm: int, S: int, n_blocks: int = 4):
    """Operations of one residual stage on one frame, (all of them, those
    of the two 1x1 convs, which K5 does on the tensor cores): per pixel and
    block 4*C*Cm (the two 1x1 convs, a multiply and an add each; the
    algorithm's, not the three TF32 passes') + 18*Cm (the 3x3 depthwise
    conv) + 3*Cm (bias, PReLU) + 4*C (bias, residual add, PReLU); 2*C per
    pixel for the entry PReLU.  Frozen copy of ``chip_smoke.py:1875``."""
    convs = S * n_blocks * 4 * C * Cm
    return convs + S * (n_blocks * (21 * Cm + 4 * C) + 2 * C), convs


def k5_work(B: int, C: int, Cm: int, S: int, n_blocks: int,
            act_bytes: int, weight_floats: int):
    """(bytes, operations, tensor-core operations) of one K5 launch: the
    input and output maps once in the activation dtype and the float32
    weights once a launch (``chip_smoke.py:2320``'s count)."""
    ops, convs = k5_ops(C, Cm, S, n_blocks)
    nbytes = 2 * act_bytes * B * C * S + 4 * weight_floats
    return nbytes, ops * B, convs * B
