"""Host milliseconds inside ``multistream_green_bpm`` a call, up to its
return (not the wait for its outputs), the mean over the measured
window's calls; in a traced run the window after the traced calls, so the
profiler's cost is not in it."""


def read(ctx):
    calls = [c for c in ctx["calls"] if c.in_window]
    if not calls:
        return None
    return sum((c.t_return - c.t_enter) * 1e3 for c in calls) / len(calls)
