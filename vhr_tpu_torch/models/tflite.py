"""TFLite flatbuffer reader: ``struct`` and numpy only.

The port's copy of ``vhr_tpu/models/tflite.py``.  The original navigates the
flatbuffer with the ``flatbuffers`` pip package; this one reads it with
``struct`` (:class:`_T`: root offset, vtable lookup, scalars, strings,
vectors, tables and unions), so the port needs no package beyond numpy to
load the MediaPipe face models.  The TFLite schema's field ids are those of
the public ``tensorflow/lite/schema/schema.fbs``, as in the original, and the
parse is pinned equal to the original's on the bundled ``.task``
(``tests/test_torch_mediapipe.py``).

Output is a plain :class:`TFLiteModel` graph description (tensors with
shapes, dtypes and constant data; operators with resolved builtin names and
options) that :mod:`vhr_tpu_torch.models.tflite_exec` runs.
"""

from __future__ import annotations

import dataclasses
import struct
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["TFLiteModel", "Subgraph", "Tensor", "Operator",
           "parse_tflite", "load_task_models", "BUILTIN_NAMES"]


# --- schema enums (tensorflow/lite/schema/schema.fbs, stable since 2019) ---

TENSOR_DTYPES = {
    0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8, 4: np.int64,
    5: object, 6: np.bool_, 7: np.int16, 8: np.complex64, 9: np.int8,
}

# BuiltinOperator enum — the subset plus neighbours we might meet; unknown
# codes surface as "OP_<code>" so a new model fails loudly, not wrongly.
BUILTIN_NAMES = {
    0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION", 3: "CONV_2D",
    4: "DEPTHWISE_CONV_2D", 5: "DEPTH_TO_SPACE", 6: "DEQUANTIZE",
    9: "FULLY_CONNECTED", 14: "LOGISTIC", 17: "MAX_POOL_2D", 18: "MUL",
    19: "RELU", 21: "RELU6", 22: "RESHAPE", 23: "RESIZE_BILINEAR",
    25: "SOFTMAX", 28: "TANH", 32: "CUSTOM", 34: "PAD", 36: "GATHER",
    39: "TRANSPOSE", 40: "MEAN", 41: "SUB", 42: "DIV", 43: "SQUEEZE",
    45: "STRIDED_SLICE", 47: "EXP", 49: "SPLIT", 53: "CAST", 54: "PRELU",
    55: "MAXIMUM", 57: "MINIMUM", 59: "NEG", 65: "SLICE", 67: "TRANSPOSE_CONV",
    70: "EXPAND_DIMS", 73: "LOG", 74: "SUM", 75: "SQRT", 76: "RSQRT",
    77: "SHAPE", 78: "POW", 83: "PACK", 88: "UNPACK", 92: "SQUARE",
    97: "RESIZE_NEAREST_NEIGHBOR", 98: "LEAKY_RELU",
    99: "SQUARED_DIFFERENCE", 101: "ABS", 102: "SPLIT_V", 106: "ADD_N",
    114: "QUANTIZE", 117: "HARD_SWISH", 126: "BATCH_MATMUL",
}

ACT_NAMES = {0: None, 1: "RELU", 2: "RELU_N1_TO_1", 3: "RELU6", 4: "TANH"}
PAD_NAMES = {0: "SAME", 1: "VALID"}


# --- flatbuffer navigation ---------------------------------------------------

def _u32(buf: bytes, pos: int) -> int:
    return struct.unpack_from("<I", buf, pos)[0]


class _T:
    """One flatbuffer table at byte ``pos`` of ``buf``.

    A table starts with a signed 32-bit offset back to its vtable; the
    vtable holds its own size, the table's size, then one unsigned 16-bit
    offset per field id (0, or beyond the vtable, means absent).  Offsets
    to tables, vectors and strings are unsigned 32-bit, relative to where
    they are stored; a vector or string is a 32-bit length, then its items.
    """

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        self.vtable = pos - struct.unpack_from("<i", buf, pos)[0]

    def _field(self, field_id: int) -> int:
        """Absolute position of the field, or 0 when absent."""
        slot = 4 + 2 * field_id
        if slot >= struct.unpack_from("<H", self.buf, self.vtable)[0]:
            return 0
        off = struct.unpack_from("<H", self.buf, self.vtable + slot)[0]
        return self.pos + off if off else 0

    def scalar(self, field_id: int, fmt: str, default=0):
        p = self._field(field_id)
        return struct.unpack_from("<" + fmt, self.buf, p)[0] if p else default

    def i32(self, fid, default=0):
        return int(self.scalar(fid, "i", default))

    def u32(self, fid, default=0):
        return int(self.scalar(fid, "I", default))

    def i8(self, fid, default=0):
        return int(self.scalar(fid, "b", default))

    def u8(self, fid, default=0):
        return int(self.scalar(fid, "B", default))

    def f32(self, fid, default=0.0):
        return float(self.scalar(fid, "f", default))

    def boolean(self, fid, default=False):
        return bool(self.scalar(fid, "B", default))

    def _target(self, field_id: int) -> int:
        """Where the offset stored in the field points, or 0."""
        p = self._field(field_id)
        return p + _u32(self.buf, p) if p else 0

    def string(self, fid) -> Optional[str]:
        p = self._target(fid)
        if not p:
            return None
        return bytes(self.buf[p + 4:p + 4 + _u32(self.buf, p)]).decode("utf-8")

    def table(self, fid) -> Optional["_T"]:
        """A table field, or a union's value (stored the same way)."""
        p = self._target(fid)
        return _T(self.buf, p) if p else None

    def vec_len(self, fid) -> int:
        p = self._target(fid)
        return _u32(self.buf, p) if p else 0

    def vec_numeric(self, fid, dtype) -> np.ndarray:
        p = self._target(fid)
        if not p:
            return np.zeros((0,), dtype)
        return np.frombuffer(self.buf, dtype, count=_u32(self.buf, p),
                             offset=p + 4).copy()

    def vec_bytes(self, fid) -> bytes:
        p = self._target(fid)
        return bytes(self.buf[p + 4:p + 4 + _u32(self.buf, p)]) if p else b""

    def vec_table(self, fid, i: int) -> "_T":
        item = self._target(fid) + 4 + 4 * i
        return _T(self.buf, item + _u32(self.buf, item))


# --- graph description ------------------------------------------------------

@dataclasses.dataclass
class Tensor:
    name: str
    shape: Tuple[int, ...]
    dtype: Any
    data: Optional[np.ndarray]        # constant weights, else None
    quant_scale: Optional[np.ndarray] = None
    quant_zero: Optional[np.ndarray] = None


@dataclasses.dataclass
class Operator:
    op: str                           # builtin name, e.g. "CONV_2D"
    inputs: List[int]                 # tensor indices (-1 = absent optional)
    outputs: List[int]
    options: Dict[str, Any]


@dataclasses.dataclass
class Subgraph:
    name: Optional[str]
    tensors: List[Tensor]
    inputs: List[int]
    outputs: List[int]
    operators: List[Operator]


@dataclasses.dataclass
class TFLiteModel:
    description: Optional[str]
    subgraphs: List[Subgraph]

    @property
    def graph(self) -> Subgraph:
        return self.subgraphs[0]


# --- builtin-options decoding (schema union BuiltinOptions) ---------------

def _conv2d_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"padding": "SAME", "stride": (1, 1), "dilation": (1, 1),
                "activation": None}
    return {
        "padding": PAD_NAMES[t.i8(0, 0)],
        "stride": (t.i32(2, 1), t.i32(1, 1)),          # (h, w)
        "activation": ACT_NAMES.get(t.i8(3, 0)),
        "dilation": (t.i32(5, 1), t.i32(4, 1)),
    }


def _dwconv2d_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"padding": "SAME", "stride": (1, 1), "dilation": (1, 1),
                "depth_multiplier": 1, "activation": None}
    return {
        "padding": PAD_NAMES[t.i8(0, 0)],
        "stride": (t.i32(2, 1), t.i32(1, 1)),
        "depth_multiplier": t.i32(3, 1),
        "activation": ACT_NAMES.get(t.i8(4, 0)),
        "dilation": (t.i32(6, 1), t.i32(5, 1)),
    }


def _pool_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"padding": "SAME", "stride": (1, 1), "filter": (1, 1),
                "activation": None}
    return {
        "padding": PAD_NAMES[t.i8(0, 0)],
        "stride": (t.i32(2, 1), t.i32(1, 1)),
        "filter": (t.i32(4, 1), t.i32(3, 1)),
        "activation": ACT_NAMES.get(t.i8(5, 0)),
    }


def _act_only(field_id: int):
    def go(t: Optional[_T]) -> Dict[str, Any]:
        if t is None:
            return {"activation": None}
        return {"activation": ACT_NAMES.get(t.i8(field_id, 0))}
    return go


def _reshape_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"new_shape": None}
    v = t.vec_numeric(0, np.int32)
    return {"new_shape": tuple(int(x) for x in v) if v.size else None}


def _concat_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"axis": 0, "activation": None}
    return {"axis": t.i32(0, 0), "activation": ACT_NAMES.get(t.i8(1, 0))}


def _strided_slice_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {k: 0 for k in ("begin_mask", "end_mask", "ellipsis_mask",
                               "new_axis_mask", "shrink_axis_mask")}
    return {
        "begin_mask": t.i32(0, 0), "end_mask": t.i32(1, 0),
        "ellipsis_mask": t.i32(2, 0), "new_axis_mask": t.i32(3, 0),
        "shrink_axis_mask": t.i32(4, 0),
    }


def _transpose_conv_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"padding": "SAME", "stride": (1, 1)}
    return {"padding": PAD_NAMES[t.i8(0, 0)],
            "stride": (t.i32(2, 1), t.i32(1, 1))}


def _resize_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"align_corners": False, "half_pixel_centers": False}
    return {"align_corners": t.boolean(2, False),
            "half_pixel_centers": t.boolean(3, False)}


def _softmax_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"beta": 1.0}
    return {"beta": t.f32(0, 1.0)}


def _fully_connected_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"activation": None, "keep_num_dims": False}
    return {"activation": ACT_NAMES.get(t.i8(0, 0)),
            "keep_num_dims": t.boolean(2, False)}


def _gather_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"axis": 0}
    return {"axis": t.i32(0, 0)}


def _split_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"num_splits": 0}
    return {"num_splits": t.i32(0, 0)}


def _leaky_relu_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"alpha": 0.0}
    return {"alpha": t.f32(0, 0.0)}


def _mean_opts(t: Optional[_T]) -> Dict[str, Any]:   # ReducerOptions
    if t is None:
        return {"keep_dims": False}
    return {"keep_dims": t.boolean(0, False)}


def _pack_opts(t: Optional[_T]) -> Dict[str, Any]:
    if t is None:
        return {"values_count": 0, "axis": 0}
    return {"values_count": t.i32(0, 0), "axis": t.i32(1, 0)}


# BuiltinOptions union type code -> decoder (schema.fbs union order).
_OPTION_DECODERS = {
    1: _conv2d_opts,            # Conv2DOptions
    2: _dwconv2d_opts,          # DepthwiseConv2DOptions
    5: _pool_opts,              # Pool2DOptions
    8: _fully_connected_opts,   # FullyConnectedOptions
    9: _softmax_opts,           # SoftmaxOptions
    10: _concat_opts,           # ConcatenationOptions
    11: _act_only(0),           # AddOptions
    21: _act_only(0),           # MulOptions
    13: _reshape_opts,          # ReshapeOptions
    23: _resize_opts,           # ResizeBilinearOptions
    25: _mean_opts,             # ReducerOptions (MEAN/SUM/...)
    27: _gather_opts,           # GatherOptions
    28: _strided_slice_opts,    # StridedSliceOptions
    30: _act_only(0),           # SubOptions
    31: _act_only(0),           # DivOptions
    35: _split_opts,            # SplitOptions
    44: _leaky_relu_opts,       # LeakyReluOptions
    54: _pack_opts,             # PackOptions
    66: _transpose_conv_opts,   # TransposeConvOptions
}


# --- parsing ----------------------------------------------------------------

def _parse_tensor(t: _T, buffers: List[bytes]) -> Tensor:
    shape = tuple(int(x) for x in t.vec_numeric(0, np.int32))
    dtype = TENSOR_DTYPES[t.i8(1, 0)]
    buf_idx = t.u32(2, 0)
    name = t.string(3) or ""
    raw = buffers[buf_idx] if buf_idx < len(buffers) else b""
    data = None
    if raw:
        data = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    qscale = qzero = None
    q = t.table(4)
    if q is not None:
        s = q.vec_numeric(2, np.float32)
        z = q.vec_numeric(3, np.int64)
        if s.size:
            qscale, qzero = s, z
    return Tensor(name=name, shape=shape, dtype=dtype, data=data,
                  quant_scale=qscale, quant_zero=qzero)


def _parse_operator(t: _T, opcodes: List[str]) -> Operator:
    op = opcodes[t.u32(0, 0)]
    inputs = [int(x) for x in t.vec_numeric(1, np.int32)]
    outputs = [int(x) for x in t.vec_numeric(2, np.int32)]
    opt_type = t.u8(3, 0)
    decoder = _OPTION_DECODERS.get(opt_type)
    options = decoder(t.table(4)) if decoder else {}
    return Operator(op=op, inputs=inputs, outputs=outputs, options=options)


def parse_tflite(data: bytes) -> TFLiteModel:
    """Parse a ``.tflite`` flatbuffer into a plain graph description."""
    if data[4:8] != b"TFL3":
        raise ValueError(f"not a TFLite v3 flatbuffer (magic {data[4:8]!r})")
    model = _T(data, _u32(data, 0))

    opcodes = []
    for i in range(model.vec_len(1)):
        oc = model.vec_table(1, i)
        code = oc.i32(3, 0)                     # builtin_code (new field)
        if code == 0:
            code = oc.i8(0, 0)                  # deprecated_builtin_code
        if code == 32:
            opcodes.append(f"CUSTOM:{oc.string(1)}")
        else:
            opcodes.append(BUILTIN_NAMES.get(code, f"OP_{code}"))

    buffers = [model.vec_table(4, i).vec_bytes(0)
               for i in range(model.vec_len(4))]

    subgraphs = []
    for i in range(model.vec_len(2)):
        sg = model.vec_table(2, i)
        tensors = [_parse_tensor(sg.vec_table(0, j), buffers)
                   for j in range(sg.vec_len(0))]
        operators = [_parse_operator(sg.vec_table(3, j), opcodes)
                     for j in range(sg.vec_len(3))]
        subgraphs.append(Subgraph(
            name=sg.string(4), tensors=tensors,
            inputs=[int(x) for x in sg.vec_numeric(1, np.int32)],
            outputs=[int(x) for x in sg.vec_numeric(2, np.int32)],
            operators=operators))

    return TFLiteModel(description=model.string(3), subgraphs=subgraphs)


def load_task_models(task_path: str) -> Dict[str, TFLiteModel]:
    """Parse every ``.tflite`` inside a MediaPipe ``.task`` zip."""
    out = {}
    with zipfile.ZipFile(task_path) as z:
        for info in z.infolist():
            if info.filename.endswith(".tflite"):
                out[info.filename] = parse_tflite(z.read(info.filename))
    return out
