"""Device milliseconds a tick of the kernels launched under the span on
``vhr_tpu_torch.serving._finish_batched``: the live step's tail over every
slot (the streaming filter's push, the masked ring writes, the masked
Welch over every slot's ring)."""

SPANS = [("vhr_tpu_torch.serving", "_finish_batched")]
NAME = "vhr_tpu_torch.serving._finish_batched"


def read(ctx):
    tr = ctx["trace"]
    hits = tr.spans.get(NAME) if tr else None
    if not hits or tr.busy_s <= 0:
        return None
    return sum(h.device_s for h in hits) * 1e3 / len(hits)
