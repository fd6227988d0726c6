"""K4's share of its roofline: the least time for its work (every slot's
frame read once, each slot's outputs and carry written once, over 3.35
TB/s, or its operations over 67 TFLOP/s, whichever is longer) over the
device time of the kernels launched under the span on
``vhr_tpu_torch.pipeline.live.fused_detect_roi_slots`` (the pool's tick
calls it once)."""

from portbench.core import peaks

SPANS = [("vhr_tpu_torch.pipeline.live", "fused_detect_roi_slots")]
NAME = "vhr_tpu_torch.pipeline.live.fused_detect_roi_slots"


def k4_work(S: int, H: int, W: int, pool: int):
    """(bytes, operations) of one K4 launch over ``S`` slots of ``H x W``:
    each slot's frame read once; its means 12, count 4, box 16 and flags
    8 bytes written once, its 24-byte carry read and written; 3 pooling
    adds a pixel and about 20 operations a pooled cell's chroma test (the
    count of ``peaks.k1_work``)."""
    nbytes = S * H * W * 3 + S * (12 + 4 + 16 + 8) + S * 48
    ops = 3 * S * H * W + 20 * S * (H // pool) * W
    return nbytes, ops


def describe(args, kwargs):
    frames = args[0]
    S, H = frames.shape[0], frames.shape[1]
    W = frames.shape[2] if frames.dim() == 4 else frames.shape[2] // 3
    return {"S": S, "H": H, "W": W,
            "pool": int(kwargs.get("detect_row_pool", 1))}


def read(ctx):
    tr = ctx["trace"]
    hits = tr.spans.get(NAME) if tr else None
    if not hits or tr.busy_s <= 0 or any(h.info is None for h in hits):
        return None
    least = sum(peaks.bound(*k4_work(**h.info))[0] for h in hits)
    spent = sum(h.device_s for h in hits)
    return 100.0 * least / spent if spent > 0 else None
