"""Host milliseconds a pool tick: the host's time inside the measured
window's calls (up to each call's return, which fetches its last tick),
over the ticks they ran.  A call's ticks come from the program's own
counters (``vhr_tpu_torch/utils/profiling.py``): ``pool.frames`` over
``pool.ticks`` is the frames a tick, over the whole run, so a call's
frames over it are its ticks.  ``None`` where the program keeps no such
counters."""


def read(ctx):
    calls = [c for c in ctx["calls"] if c.in_window]
    try:
        from vhr_tpu_torch.utils.profiling import counter
    except ImportError:
        return None
    ticks, frames = counter("pool.ticks"), counter("pool.frames")
    if not calls or ticks <= 0 or frames <= 0:
        return None
    per_tick = frames / ticks
    host_ms = sum((c.t_return - c.t_enter) * 1e3 for c in calls)
    return host_ms / sum(c.frames / per_tick for c in calls)
