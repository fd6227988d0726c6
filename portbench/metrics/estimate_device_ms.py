"""Device milliseconds a call of the kernels launched under the span on
``vhr_tpu_torch.parallel.streams._estimate`` (the forward fill and
``ops/windows.py::rolling_bpm_fft`` over the shard's streams)."""

SPANS = [("vhr_tpu_torch.parallel.streams", "_estimate")]


def read(ctx):
    tr = ctx["trace"]
    hits = tr.spans.get("vhr_tpu_torch.parallel.streams._estimate") \
        if tr else None
    if not hits or tr.busy_s <= 0:
        return None
    return sum(h.device_s for h in hits) * 1e3 / len(hits)
