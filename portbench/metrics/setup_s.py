"""Seconds from the start of ``portbench/run.py`` to the first timed call:
imports, the kernel library, the nets, the recordings, the warm-up."""


def read(ctx):
    return ctx["setup_s"]
