"""Floating-point operations of a TFLite graph at batch 1, counted from
its shapes: CONV_2D, DEPTHWISE_CONV_2D and FULLY_CONNECTED, a multiply
and an add per weight per output position (bias, activations and the
elementwise ops are left out)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .tflite_parse import Subgraph, load_task_models


def graph_flops(g: Subgraph) -> int:
    total = 0
    for op in g.operators:
        if op.op not in ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED"):
            continue
        filt = g.tensors[op.inputs[1]].shape
        out = g.tensors[op.outputs[0]].shape
        if op.op == "CONV_2D":            # OHWI filter, NHWC output
            total += 2 * int(np.prod(out[1:])) * int(np.prod(filt[1:]))
        elif op.op == "DEPTHWISE_CONV_2D":  # (1, kh, kw, C * mult) filter
            total += 2 * int(np.prod(out[1:])) * filt[1] * filt[2]
        else:                               # (out, in) weights
            total += 2 * int(np.prod(filt))
    return total


@lru_cache(maxsize=None)
def task_flops(task_path: str) -> dict:
    """``{graph file name: operations at batch 1}`` of every graph in a
    ``.task`` bundle."""
    return {name: graph_flops(m.graph)
            for name, m in load_task_models(task_path).items()}
