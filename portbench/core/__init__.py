"""The harness: loading a cell by name, the measured window, the trace's
reduction to metrics, and the comparison that decides ``correct``."""
