"""K1's share of its roofline: the least time for its work (every frame
byte read once, its outputs written once, over 3.35 TB/s, or its
operations over 67 TFLOP/s, whichever is longer) over the device time of
the kernels launched under the span on
``vhr_tpu_torch.parallel.streams.fused_detect_roi_cuda`` (its skin pass
and K2's entry)."""

from portbench.core import peaks

SPANS = [("vhr_tpu_torch.parallel.streams", "fused_detect_roi_cuda")]
NAME = "vhr_tpu_torch.parallel.streams.fused_detect_roi_cuda"


def describe(args, kwargs):
    frames = args[0]
    n, H = frames.shape[0], frames.shape[1]
    W = frames.shape[2] if frames.dim() == 4 else frames.shape[2] // 3
    return {"T": n, "H": H, "W": W,
            "pool": int(kwargs.get("detect_row_pool", 1))}


def read(ctx):
    tr = ctx["trace"]
    hits = tr.spans.get(NAME) if tr else None
    if not hits or tr.busy_s <= 0 or any(h.info is None for h in hits):
        return None
    least = sum(peaks.bound(*peaks.k1_work(**h.info))[0] for h in hits)
    spent = sum(h.device_s for h in hits)
    return 100.0 * least / spent if spent > 0 else None
