"""The 95th percentile over every recording completed in the window, each
timed on the host's clock from entering the call that carries it to that
call's outputs in host memory."""

from portbench.core.stats import percentile


def read(ctx):
    times = [(c.t_done - c.t_enter) * 1e3 for c in ctx["calls"]
             if c.in_window for _ in range(c.recordings)]
    return percentile(times, 95.0) if times else None
