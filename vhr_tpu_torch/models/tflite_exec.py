"""Execute parsed TFLite graphs: a PyTorch executor and a numpy oracle.

The port's copy of ``vhr_tpu/models/tflite_exec.py``.  The MediaPipe face
graphs (:mod:`vhr_tpu_torch.models.tflite`) use a 10-op subset: CONV_2D,
DEPTHWISE_CONV_2D, ADD, RELU, PRELU, PAD, MAX_POOL_2D, RESHAPE,
CONCATENATION, LOGISTIC (+ fp16-constant DEQUANTIZE, folded at load).

Two independent executors of the same graph description:

* :func:`build_torch` — the product path, the counterpart of the JAX
  package's ``build_jax``: weights as a dict of tensors keyed as the JAX
  package keys them, and an ``nn.Module`` whose ``forward(params, x)``
  returns the graph outputs.  It runs NCHW inside (cuDNN's layout; a
  residual stage is then a plain ``(B, C, H*W)`` view for kernel K5) and
  keeps TFLite's NHWC at its boundary: ``(B, H, W, C)`` in, outputs in
  their TFLite layout.
* :class:`NumpyInterpreter` — the validation oracle: an im2col interpreter
  written against numpy only, copied from the JAX package, sharing no
  execution code with the PyTorch path.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import float32_exact, resolve_device
from ..ops.meshblocks_cuda import (StageWeights, pack_stage_weights,
                                   residual_stage)
from ..utils.profiling import count, span
from .tflite import Operator, Subgraph, Tensor

__all__ = ["fold_dequantize", "build_torch", "const_inputs",
           "TFLiteExecutor", "NumpyInterpreter", "SUPPORTED_OPS"]

SUPPORTED_OPS = frozenset({
    "CONV_2D", "DEPTHWISE_CONV_2D", "ADD", "RELU", "PRELU", "PAD",
    "MAX_POOL_2D", "RESHAPE", "CONCATENATION", "LOGISTIC",
})

# NHWC axis -> NCHW axis, for 4-D tensors.
_NCHW_AXIS = (0, 2, 3, 1)


def fold_dequantize(graph: Subgraph) -> Subgraph:
    """Fold ``DEQUANTIZE(const fp16) -> fp32`` into fp32 constant tensors.

    Both face graphs store weights as fp16 constants dequantized at graph
    entry; after folding, the op stream contains only :data:`SUPPORTED_OPS`.
    """
    ops: List[Operator] = []
    for op in graph.operators:
        if op.op == "DEQUANTIZE":
            src = graph.tensors[op.inputs[0]]
            if src.data is None:
                raise NotImplementedError(
                    "runtime DEQUANTIZE (non-constant input) unsupported")
            dst = graph.tensors[op.outputs[0]]
            dst.data = src.data.astype(np.float32)
            continue
        if op.op not in SUPPORTED_OPS:
            raise NotImplementedError(f"op {op.op} not in supported subset")
        ops.append(op)
    return Subgraph(name=graph.name, tensors=graph.tensors,
                    inputs=graph.inputs, outputs=graph.outputs,
                    operators=ops)


def _find_residual_stages(ops: List[Operator], tensors: List[Tensor]):
    """Detect maximal fusible runs ``PRELU -> [1x1 conv, PRELU, dw3x3,
    1x1 conv, ADD, PRELU] x N`` at constant spatial shape — the face-mesh
    graph's residual bottleneck stages.  Each hit runs as one launch of
    kernel K5 (``ops/meshblocks_cuda.py``) instead of op by op.

    Safety rules: every op in the run must be activation-free where the
    pattern requires, the ADD must close exactly over the block entry, no
    tensor internal to the run may be read outside it, and the flattened
    spatial extent must be a multiple of 128 (``H*W % 128 == 0``)."""
    def shape(t):
        return tuple(tensors[t].shape)

    consumers: Dict[int, List[int]] = {}
    for oi, op in enumerate(ops):
        for t in op.inputs:
            if t >= 0 and tensors[t].data is None:
                consumers.setdefault(t, []).append(oi)

    stages = []
    i, n = 0, len(ops)
    while i < n:
        op = ops[i]
        if op.op != "PRELU" or len(shape(op.outputs[0])) != 4:
            i += 1
            continue
        _, H, W, C = shape(op.outputs[0])
        S = H * W
        if S < 128 or S % 128 != 0:
            i += 1
            continue
        blocks, cm = [], None
        cur = op.outputs[0]
        j = i + 1
        while j + 6 <= n:
            c1, p1, dwo, c2, addo, p2 = ops[j:j + 6]
            if not (c1.op == "CONV_2D" and c1.inputs[0] == cur
                    and c1.options.get("activation") is None
                    and tuple(c1.options["stride"]) == (1, 1)
                    and shape(c1.inputs[1])[1:3] == (1, 1)
                    and p1.op == "PRELU" and p1.inputs[0] == c1.outputs[0]
                    and dwo.op == "DEPTHWISE_CONV_2D"
                    and dwo.inputs[0] == p1.outputs[0]
                    and dwo.options.get("activation") is None
                    and tuple(dwo.options["stride"]) == (1, 1)
                    and dwo.options["padding"] == "SAME"
                    and dwo.options.get("depth_multiplier", 1) == 1
                    and shape(dwo.inputs[1])[1:3] == (3, 3)
                    and c2.op == "CONV_2D" and c2.inputs[0] == dwo.outputs[0]
                    and c2.options.get("activation") is None
                    and tuple(c2.options["stride"]) == (1, 1)
                    and shape(c2.inputs[1])[1:3] == (1, 1)
                    and shape(c2.outputs[0])[-1] == C
                    and addo.op == "ADD"
                    and addo.options.get("activation") is None
                    and set(addo.inputs) == {cur, c2.outputs[0]}
                    and p2.op == "PRELU"
                    and p2.inputs[0] == addo.outputs[0]):
                break
            cm_k = shape(c1.inputs[1])[0]
            if cm is None:
                cm = cm_k
            elif cm_k != cm:                  # kernel wants one Cm stack
                break
            blocks.append(dict(w1=c1.inputs[1], b1=c1.inputs[2],
                               a1=p1.inputs[1], dw=dwo.inputs[1],
                               bdw=dwo.inputs[2], w2=c2.inputs[1],
                               b2=c2.inputs[2], a2=p2.inputs[1]))
            cur = p2.outputs[0]
            j += 6
        # Internal tensors must have no readers outside the fused range
        # (and must not be graph outputs) — otherwise fusing would drop a
        # value someone needs.
        if blocks:
            internal = set()
            for jj in range(i, j):
                for t in ops[jj].outputs:
                    if t != cur:
                        internal.add(t)
            leaks = any(not (i <= r < j)
                        for t in internal for r in consumers.get(t, []))
            if leaks:
                blocks = []
        if blocks:
            stages.append(dict(start=i, n_ops=j - i, in_tensor=op.inputs[0],
                               out_tensor=cur, H=H, W=W, C=C, Cm=cm,
                               a0=op.inputs[1], blocks=blocks))
            i = j
        else:
            i += 1
    return stages


def _same_pads(size: int, k: int, s: int, d: int, mode: str):
    """TF padding of one spatial axis: SAME pads the extra pixel at the
    end (the larger half after), VALID pads nothing."""
    return _np_pad_amount(size, (k - 1) * d + 1, s, mode)


def _pad(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """``F.pad`` that skips the copy when there is nothing to pad."""
    return F.pad(x, tuple(pads), value=value) if any(pads) else x


def _act(name, y):
    if name is None:
        return y
    if name == "RELU":
        return torch.clamp_min(y, 0.0)
    if name == "RELU6":
        return torch.clamp(y, 0.0, 6.0)
    raise NotImplementedError(f"fused activation {name}")


def _nchw_const(t: torch.Tensor) -> torch.Tensor:
    """A constant operand that broadcasts against an NHWC map, made to
    broadcast against the NCHW map."""
    t = t.reshape((1,) * (4 - t.dim()) + tuple(t.shape))
    return t.permute(0, 3, 1, 2)


class TFLiteExecutor(torch.nn.Module):
    """A folded TFLite graph as a PyTorch module: ``forward(params, x)``
    with ``x (B, H, W, C)`` returns the tuple of graph outputs in float32,
    4-D outputs as NHWC.  Made by :func:`build_torch`.

    Every 4-D map is held NCHW; others (after a RESHAPE) in TFLite's order.
    A map is dropped right after its last reader (counted when the module
    is built), so the live set stays a few maps.

    ``io_dtype`` is the dtype the callers hand the input in
    (``load_face_models`` sets it, as the JAX package tags its apply).
    """

    def __init__(self, graph: Subgraph, compute_dtype, activation_dtype,
                 stages: Dict[int, dict]):
        super().__init__()
        self.graph = graph
        self.stages = stages
        self.io_dtype = None
        self.ad = activation_dtype
        self.cd = compute_dtype if activation_dtype is None \
            else activation_dtype
        outputs = set(graph.outputs)
        last: Dict[int, int] = {}
        # Ops a forward dispatches: each op, each fused stage as one.
        self.n_dispatch = 0
        op_i = 0
        while op_i < len(graph.operators):
            st = stages.get(op_i)
            reads = ([st["in_tensor"]] if st is not None
                     else graph.operators[op_i].inputs)
            for t in reads:
                if t >= 0 and graph.tensors[t].data is None:
                    last[t] = op_i
            op_i += st["n_ops"] if st is not None else 1
            self.n_dispatch += 1
        self.drop_after: Dict[int, List[int]] = {}
        for t, i in last.items():
            if t not in outputs:
                self.drop_after.setdefault(i, []).append(t)

    def _cd(self, t: torch.Tensor) -> torch.Tensor:
        """A conv operand in the compute dtype.  With float32 activations
        (``compute_dtype`` alone) the operand is rounded to it and the conv
        runs in float32: products of bfloat16 values are exact in float32,
        so this is bf16 inputs with float32 accumulation and output."""
        if self.cd is None:
            return t
        t = t.to(self.cd)
        return t.to(torch.float32) if self.ad is None else t

    def _ad(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.ad) if self.ad is not None else t

    def _conv(self, op, x, filt, bias, depthwise: bool):
        kh, kw = filt.shape[1:3]
        sh, sw = op.options["stride"]
        dh, dw = op.options["dilation"]
        top, bottom = _same_pads(x.shape[2], kh, sh, dh,
                                 op.options["padding"])
        left, right = _same_pads(x.shape[3], kw, sw, dw,
                                 op.options["padding"])
        if depthwise:   # TFLite (1, kh, kw, C*mult) -> (C*mult, 1, kh, kw)
            w, groups = filt.permute(3, 0, 1, 2), x.shape[1]
        else:           # TFLite OHWI -> OIHW
            w, groups = filt.permute(0, 3, 1, 2), 1
        y = F.conv2d(_pad(self._cd(x), (left, right, top, bottom)),
                     self._cd(w), None, (sh, sw), 0, (dh, dw), groups)
        y = y + self._ad(bias).reshape(1, -1, 1, 1)
        return _act(op.options["activation"], y)

    def forward(self, params: Dict[str, torch.Tensor],
                x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        with float32_exact():
            return self._run(params, x)

    def _run(self, params, x):
        g = self.graph
        tensors = g.tensors
        env: Dict[int, torch.Tensor] = {
            g.inputs[0]: self._ad(x.permute(0, 3, 1, 2).contiguous())}

        def get(i):
            return env[i] if i in env else params[str(i)]

        op_i = 0
        while op_i < len(g.operators):
            st = self.stages.get(op_i)
            if st is not None:
                xin = get(st["in_tensor"])           # NCHW (B, C, H, W)
                B, C, H, W = xin.shape
                wts = StageWeights(*(params[f"_fs{op_i}_{f_i}"]
                                     for f_i in range(9)))
                with span("vhr.k5", B=B, C=C, S=H * W):
                    y = residual_stage(xin.reshape(B, C, H * W).contiguous(),
                                       wts, W)
                env[st["out_tensor"]] = y.reshape(B, C, H, W)
                done, op_i = op_i, op_i + st["n_ops"]
            else:
                op = g.operators[op_i]
                env[op.outputs[0]] = self._op(op, get, tensors)
                done, op_i = op_i, op_i + 1
            for t in self.drop_after.get(done, ()):
                env.pop(t, None)
        outs = []
        for i in g.outputs:
            y = env[i].to(torch.float32)
            outs.append(y.permute(0, 2, 3, 1) if y.dim() == 4 else y)
        count("exec.ops", self.n_dispatch)
        return tuple(outs)

    def _op(self, op, get, tensors):
        if op.op in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            inp, filt, bias = (get(i) for i in op.inputs)
            return self._conv(op, inp, filt, bias,
                              op.op == "DEPTHWISE_CONV_2D")
        if op.op == "ADD":
            a, b = get(op.inputs[0]), get(op.inputs[1])
            if a.dim() == 4 and tensors[op.inputs[1]].data is not None:
                b = _nchw_const(b)
            return _act(op.options.get("activation"), a + self._ad(b))
        if op.op == "RELU":
            return torch.clamp_min(get(op.inputs[0]), 0.0)
        if op.op == "PRELU":
            xin = get(op.inputs[0])
            alpha = self._ad(get(op.inputs[1]))
            if xin.dim() == 4:
                alpha = _nchw_const(alpha)
            return torch.where(xin >= 0, xin, xin * alpha)
        if op.op == "PAD":
            xin = get(op.inputs[0])
            pads = np.asarray(tensors[op.inputs[1]].data).tolist()
            if xin.dim() == 4:
                pads = [pads[a] for a in (0, 3, 1, 2)]
            flat = [int(p) for pair in reversed(pads) for p in pair]
            return _pad(xin, flat)
        if op.op == "MAX_POOL_2D":
            xin = get(op.inputs[0])
            kh, kw = op.options["filter"]
            sh, sw = op.options["stride"]
            top, bottom = _same_pads(xin.shape[2], kh, sh, 1,
                                     op.options["padding"])
            left, right = _same_pads(xin.shape[3], kw, sw, 1,
                                     op.options["padding"])
            xp = _pad(xin, (left, right, top, bottom), value=-np.inf)
            return _act(op.options["activation"],
                        F.max_pool2d(xp, (kh, kw), (sh, sw)))
        if op.op == "RESHAPE":
            return _reshape(op, get(op.inputs[0]), tensors)
        if op.op == "CONCATENATION":
            parts = [get(i) for i in op.inputs]
            axis = op.options["axis"] % parts[0].dim()
            if parts[0].dim() == 4:
                axis = _NCHW_AXIS[axis]
            return _act(op.options["activation"], torch.cat(parts, axis))
        if op.op == "LOGISTIC":
            x32 = get(op.inputs[0]).to(torch.float32)
            return 1.0 / (1.0 + torch.exp(-x32))
        raise NotImplementedError(op.op)       # unreachable post-fold


def _reshape(op, xin: torch.Tensor, tensors) -> torch.Tensor:
    """TFLite RESHAPE on a map held NCHW (if 4-D): flatten in NHWC order,
    and hold a 4-D result NCHW again.

    The flatbuffer bakes batch-1 target shapes; a target with a unit
    leading dim is scaled to the input's batch, anything else that does
    not fit raises (the JAX executor's rule)."""
    o = op.outputs[0]
    shape = op.options.get("new_shape")
    if shape is None and len(op.inputs) > 1:
        shape = tuple(int(s) for s in tensors[op.inputs[1]].data)
    if shape is None:
        shape = tensors[o].shape                 # static output shape
    shape = tuple(int(s) for s in shape)
    if any(s < 0 for s in shape):
        # Wildcard target (the mesh net's (-1, 1) presence reshape):
        # resolve it against the baked batch-1 output shape, then scale
        # the batch like any literal target.
        shape = tuple(int(s) for s in tensors[o].shape)
    size = xin.numel()
    if int(np.prod(shape)) != size:
        if shape[0] != 1:
            raise ValueError(
                f"RESHAPE target {shape} is not batch-agnostic for input "
                f"size {size} (need a unit leading dim)")
        rest = int(np.prod(shape[1:]))
        if rest <= 0 or size % rest != 0:
            raise ValueError(
                f"RESHAPE: input size {size} not divisible by per-sample "
                f"size {rest} (target {shape})")
        shape = (size // rest,) + shape[1:]
    if xin.dim() == 4:
        xin = xin.permute(0, 2, 3, 1)
    y = xin.reshape(shape)
    return y.permute(0, 3, 1, 2) if y.dim() == 4 else y


def build_torch(graph: Subgraph, compute_dtype=None, activation_dtype=None,
                fuse_stages: bool = False, device=None):
    """The graph as ``(params, apply)``: ``params`` maps tensor-index
    strings to the constant tensors the ops read (TFLite layouts, float32),
    plus ``_fs{start}_{i}`` for the nine stacks of each fused stage, as the
    JAX package's ``build_jax`` keys them; ``apply`` is a
    :class:`TFLiteExecutor`, called as ``apply(params, x)``.

    Float32 convolutions and products run in full float32 (TF32 off on the
    card).  ``compute_dtype=torch.bfloat16`` rounds conv inputs and filters
    to bf16 and accumulates in float32 (outputs float32);
    ``activation_dtype=torch.bfloat16`` stores every feature map in bf16 and
    runs the convs and elementwise ops in bf16 (LOGISTIC and the outputs in
    float32).  ``fuse_stages=True`` runs each residual stage
    (:func:`_find_residual_stages`) as one call of K5 (its plain version
    for CPU tensors).  ``device`` defaults to the CUDA card.
    """
    device = resolve_device(device)
    graph = fold_dequantize(graph)
    stages = {}
    params = {str(i): torch.as_tensor(graph.tensors[i].data, device=device)
              for i in const_inputs(graph)}
    if fuse_stages:
        for st in _find_residual_stages(graph.operators, graph.tensors):
            blocks = [{k: graph.tensors[t].data for k, t in b.items()}
                      for b in st["blocks"]]
            wts = pack_stage_weights(graph.tensors[st["a0"]].data, blocks,
                                     device=device)
            stages[st["start"]] = st
            for f_i, arr in enumerate(wts):
                params[f"_fs{st['start']}_{f_i}"] = arr
    apply = TFLiteExecutor(graph, compute_dtype, activation_dtype, stages)
    return params, apply


def const_inputs(graph: Subgraph) -> List[int]:
    """The constant tensors the (folded) graph's ops read, sorted: the
    executor's params.  PAD paddings and RESHAPE shapes stay host-side
    (static geometry)."""
    out = set()
    for op in graph.operators:
        for i in op.inputs:
            if i >= 0 and graph.tensors[i].data is not None:
                if op.op in ("PAD", "RESHAPE") and i == op.inputs[-1]:
                    continue
                out.add(i)
    return sorted(out)


# --- independent numpy oracle ----------------------------------------------

def _np_pad_amount(size: int, k: int, s: int, mode: str) -> Tuple[int, int]:
    if mode == "VALID":
        return (0, 0)
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return (total // 2, total - total // 2)


def _np_conv(x: np.ndarray, filt: np.ndarray, bias, stride, padding,
             groups: int = 1) -> np.ndarray:
    """im2col NHWC conv; ``filt`` is OHWI (TFLite layout)."""
    n, h, w, cin = x.shape
    co, kh, kw, ci_g = filt.shape
    sh, sw = stride
    ph = _np_pad_amount(h, kh, sh, padding)
    pw = _np_pad_amount(w, kw, sw, padding)
    xp = np.pad(x, ((0, 0), ph, pw, (0, 0)))
    oh = (xp.shape[1] - kh) // sh + 1
    ow = (xp.shape[2] - kw) // sw + 1
    # window view: (n, oh, ow, kh, kw, cin)
    sN, sH, sW, sC = xp.strides
    win = np.lib.stride_tricks.as_strided(
        xp, (n, oh, ow, kh, kw, cin),
        (sN, sH * sh, sW * sw, sH, sW, sC), writeable=False)
    if groups == 1:
        cols = win.reshape(n * oh * ow, kh * kw * cin)
        wmat = filt.transpose(1, 2, 3, 0).reshape(kh * kw * ci_g, co)
        y = (cols @ wmat).reshape(n, oh, ow, co)
    else:
        # depthwise: groups == cin, ci_g == 1 after the caller reshapes;
        # filt arrives as TFLite DW layout (1, kh, kw, cin*mult).
        mult = filt.shape[-1] // cin
        f = filt.reshape(kh, kw, cin, mult)
        y = np.einsum("nhwklc,klcm->nhwcm", win, f, optimize=True)
        y = y.reshape(n, oh, ow, cin * mult)
    return y + bias


class NumpyInterpreter:
    """Tensor-by-tensor numpy evaluation of a (folded) subgraph."""

    def __init__(self, graph: Subgraph):
        self.graph = fold_dequantize(graph)

    def __call__(self, x: np.ndarray) -> Tuple[np.ndarray, ...]:
        g = self.graph
        env: Dict[int, np.ndarray] = {g.inputs[0]: np.asarray(x, np.float32)}

        def get(i):
            if i in env:
                return env[i]
            return g.tensors[i].data

        def act(name, y):
            if name == "RELU":
                return np.maximum(y, 0.0)
            if name == "RELU6":
                return np.clip(y, 0.0, 6.0)
            return y

        for op in g.operators:
            if op.op == "CONV_2D":
                y = _np_conv(get(op.inputs[0]), get(op.inputs[1]),
                             get(op.inputs[2]), op.options["stride"],
                             op.options["padding"])
                y = act(op.options["activation"], y)
            elif op.op == "DEPTHWISE_CONV_2D":
                xin = get(op.inputs[0])
                y = _np_conv(xin, get(op.inputs[1]), get(op.inputs[2]),
                             op.options["stride"], op.options["padding"],
                             groups=xin.shape[-1])
                y = act(op.options["activation"], y)
            elif op.op == "ADD":
                y = act(op.options.get("activation"),
                        get(op.inputs[0]) + get(op.inputs[1]))
            elif op.op == "RELU":
                y = np.maximum(get(op.inputs[0]), 0.0)
            elif op.op == "PRELU":
                xin = get(op.inputs[0])
                alpha = get(op.inputs[1])
                y = np.where(xin >= 0, xin, xin * alpha)
            elif op.op == "PAD":
                pads = np.asarray(get(op.inputs[1]))
                y = np.pad(get(op.inputs[0]), [tuple(p) for p in pads])
            elif op.op == "MAX_POOL_2D":
                xin = get(op.inputs[0])
                kh, kw = op.options["filter"]
                sh, sw = op.options["stride"]
                n, h, w, c = xin.shape
                ph = _np_pad_amount(h, kh, sh, op.options["padding"])
                pw = _np_pad_amount(w, kw, sw, op.options["padding"])
                xp = np.pad(xin, ((0, 0), ph, pw, (0, 0)),
                            constant_values=-np.inf)
                oh = (xp.shape[1] - kh) // sh + 1
                ow = (xp.shape[2] - kw) // sw + 1
                sN, sH, sW, sC = xp.strides
                win = np.lib.stride_tricks.as_strided(
                    xp, (n, oh, ow, kh, kw, c),
                    (sN, sH * sh, sW * sw, sH, sW, sC), writeable=False)
                y = act(op.options["activation"], win.max(axis=(3, 4)))
            elif op.op == "RESHAPE":
                shape = op.options.get("new_shape")
                if shape is None and len(op.inputs) > 1:
                    shape = tuple(int(s)
                                  for s in g.tensors[op.inputs[1]].data)
                if shape is None:
                    shape = g.tensors[op.outputs[0]].shape
                y = np.reshape(get(op.inputs[0]), shape)
            elif op.op == "CONCATENATION":
                y = act(op.options["activation"],
                        np.concatenate([get(i) for i in op.inputs],
                                       axis=op.options["axis"]))
            elif op.op == "LOGISTIC":
                y = 1.0 / (1.0 + np.exp(-get(op.inputs[0])))
            else:
                raise NotImplementedError(op.op)
            env[op.outputs[0]] = y.astype(np.float32)
        return tuple(env[i] for i in g.outputs)
