"""K5's share of its roofline: for each launch the least time for its work
(its input and output maps once in their dtype and its float32 weights
once, over 3.35 TB/s; or its operations, the 1x1 convs' over 495 TFLOP/s
of TF32 and the rest over 67 TFLOP/s, whichever is longer), summed, over
the device time of the kernels launched under the span on
``vhr_tpu_torch.models.tflite_exec.residual_stage``."""

from portbench.core import peaks

SPANS = [("vhr_tpu_torch.models.tflite_exec", "residual_stage")]
NAME = "vhr_tpu_torch.models.tflite_exec.residual_stage"


def describe(args, kwargs):
    x, wts = args[0], args[1]
    B, C, S = x.shape
    return {"B": B, "C": C, "Cm": int(wts.w1.shape[1]), "S": S,
            "n_blocks": int(wts.w1.shape[0]), "act_bytes": x.element_size(),
            "weight_floats": int(sum(w.numel() for w in wts))}


def read(ctx):
    tr = ctx["trace"]
    hits = tr.spans.get(NAME) if tr else None
    if not hits or tr.busy_s <= 0 or any(h.info is None for h in hits):
        return None
    least = sum(peaks.bound(*peaks.k5_work(**h.info))[0] for h in hits)
    spent = sum(h.device_s for h in hits)
    return 100.0 * least / spent if spent > 0 else None
