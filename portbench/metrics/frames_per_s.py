"""Frames of every recording whose outputs reached the host inside the
window, over the window's seconds (host clock)."""


def read(ctx):
    done = [c for c in ctx["calls"] if c.in_window]
    return sum(c.frames for c in done) / ctx["seconds"] if done else None
