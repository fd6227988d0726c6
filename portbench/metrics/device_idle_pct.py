"""The share of the traced window in which no kernel, copy or set ran on
the device: 1 minus the union of the device intervals over the window,
from the traffic's ``busy_calls`` calls traced with device activity alone
(the host's clock gives the window's length)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
