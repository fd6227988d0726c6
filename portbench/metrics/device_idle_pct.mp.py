"""``device_idle_pct`` in the MediaPipe cell, which reports
``frames_per_s.mp`` rather than ``frames_per_s``."""

from portbench.core import loader

read = loader.plugin("metrics", "device_idle_pct").read
