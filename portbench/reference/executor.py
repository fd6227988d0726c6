"""A plain float32 executor of the MediaPipe face graphs, op by op.

The ten ops the two graphs use (CONV_2D, DEPTHWISE_CONV_2D, ADD, RELU,
PRELU, PAD, MAX_POOL_2D, RESHAPE, CONCATENATION, LOGISTIC, after the fp16
constants' DEQUANTIZE is folded into float32 weights), each as one
PyTorch call with TFLite's semantics: SAME padding puts the extra pixel
after, RESHAPE flattens in NHWC order, a batch-1 target shape takes the
batch.  Maps are held NCHW inside.  Convolutions and products run in
full float32: TF32 is off while the executor runs.

``precision="float8"`` is the control: every weight and every op's
output rounded to float8 (e4m3, saturated at +-448).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .tflite_parse import Subgraph


@contextlib.contextmanager
def no_tf32():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def rounder(precision: str):
    """The rounding of every value the executor keeps."""
    if precision == "float32":
        return lambda t: t
    if precision == "float8":
        return lambda t: t.clamp(-448.0, 448.0).to(
            torch.float8_e4m3fn).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def _same(size: int, k: int, s: int, d: int, padding: str):
    if padding == "VALID":
        return 0, 0
    k_eff = (k - 1) * d + 1
    total = max((-(-size // s) - 1) * s + k_eff - size, 0)
    return total // 2, total - total // 2


def _act(name, y):
    if name is None:
        return y
    if name == "RELU":
        return y.clamp_min(0.0)
    if name == "RELU6":
        return y.clamp(0.0, 6.0)
    raise NotImplementedError(name)


def _chw(t: torch.Tensor) -> torch.Tensor:
    """A constant that broadcasts against an NHWC map, for an NCHW one."""
    t = t.reshape((1,) * (4 - t.dim()) + tuple(t.shape))
    return t.permute(0, 3, 1, 2)


class Graph:
    """``Graph(subgraph, device, precision)(x)``: ``x (B, H, W, C)`` float32
    -> the graph's outputs, float32, 4-D ones NHWC."""

    def __init__(self, g: Subgraph, device, precision: str = "float32"):
        self.g = g
        self.q = rounder(precision)
        self.consts: Dict[int, torch.Tensor] = {}
        self.ops = []
        for op in g.operators:
            if op.op == "DEQUANTIZE":
                src = g.tensors[op.inputs[0]].data
                self.consts[op.outputs[0]] = self.q(torch.as_tensor(
                    src.astype(np.float32), device=device))
                continue
            self.ops.append(op)
            for i in op.inputs:
                t = g.tensors[i] if i >= 0 else None
                if t is not None and t.data is not None \
                        and i not in self.consts and t.dtype == np.float32:
                    self.consts[i] = self.q(torch.as_tensor(t.data,
                                                            device=device))

    def __call__(self, x: torch.Tensor):
        g = self.g
        env = {g.inputs[0]: self.q(x.permute(0, 3, 1, 2).contiguous())}

        def get(i):
            return env[i] if i in env else self.consts[i]

        with no_tf32():
            for op in self.ops:
                env[op.outputs[0]] = self.q(self._op(op, get))
        outs = []
        for i in g.outputs:
            y = env[i]
            outs.append(y.permute(0, 2, 3, 1) if y.dim() == 4 else y)
        return outs

    def _op(self, op, get):
        o, kind = op.options, op.op
        if kind in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            x, filt, bias = get(op.inputs[0]), get(op.inputs[1]), \
                get(op.inputs[2])
            kh, kw = filt.shape[1:3]
            (sh, sw), (dh, dw) = o["stride"], o["dilation"]
            top, bottom = _same(x.shape[2], kh, sh, dh, o["padding"])
            left, right = _same(x.shape[3], kw, sw, dw, o["padding"])
            x = F.pad(x, (left, right, top, bottom))
            if kind == "CONV_2D":           # OHWI -> OIHW
                w, groups = filt.permute(0, 3, 1, 2), 1
            else:                           # (1, kh, kw, C) -> (C, 1, kh, kw)
                w, groups = filt.permute(3, 0, 1, 2), x.shape[1]
            y = F.conv2d(x, w, bias, (sh, sw), 0, (dh, dw), groups)
            return _act(o["activation"], y)
        if kind == "ADD":
            a, b = get(op.inputs[0]), get(op.inputs[1])
            if a.dim() == 4 and op.inputs[1] in self.consts:
                b = _chw(b)
            return _act(o.get("activation"), a + b)
        if kind == "RELU":
            return get(op.inputs[0]).clamp_min(0.0)
        if kind == "PRELU":
            x, alpha = get(op.inputs[0]), get(op.inputs[1])
            if x.dim() == 4:
                alpha = _chw(alpha)
            return torch.where(x >= 0, x, x * alpha)
        if kind == "PAD":
            x = get(op.inputs[0])
            pads = np.asarray(self.g.tensors[op.inputs[1]].data).tolist()
            if x.dim() == 4:
                pads = [pads[a] for a in (0, 3, 1, 2)]
            return F.pad(x, [int(p) for pair in reversed(pads) for p in pair])
        if kind == "MAX_POOL_2D":
            x = get(op.inputs[0])
            (kh, kw), (sh, sw) = o["filter"], o["stride"]
            top, bottom = _same(x.shape[2], kh, sh, 1, o["padding"])
            left, right = _same(x.shape[3], kw, sw, 1, o["padding"])
            x = F.pad(x, (left, right, top, bottom), value=-float("inf"))
            return _act(o["activation"], F.max_pool2d(x, (kh, kw), (sh, sw)))
        if kind == "RESHAPE":
            return self._reshape(op, get(op.inputs[0]))
        if kind == "CONCATENATION":
            parts = [get(i) for i in op.inputs]
            axis = o["axis"] % parts[0].dim()
            if parts[0].dim() == 4:
                axis = (0, 2, 3, 1)[axis]
            return _act(o["activation"], torch.cat(parts, axis))
        if kind == "LOGISTIC":
            return torch.sigmoid(get(op.inputs[0]))
        raise NotImplementedError(kind)

    def _reshape(self, op, x):
        g = self.g
        shape = o_shape = tuple(int(s) for s in g.tensors[op.outputs[0]].shape)
        if op.options.get("new_shape") is not None:
            shape = tuple(int(s) for s in op.options["new_shape"])
        elif len(op.inputs) > 1 and g.tensors[op.inputs[1]].data is not None:
            shape = tuple(int(s) for s in g.tensors[op.inputs[1]].data)
        if any(s < 0 for s in shape):
            shape = o_shape
        if int(np.prod(shape)) != x.numel():
            rest = int(np.prod(shape[1:]))
            shape = (x.numel() // rest,) + shape[1:]
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        y = x.reshape(shape)
        return y.permute(0, 3, 1, 2) if y.dim() == 4 else y
