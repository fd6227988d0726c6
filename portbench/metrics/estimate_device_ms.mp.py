"""``estimate_device_ms`` in the MediaPipe cell, which reports
``frames_per_s.mp`` rather than ``frames_per_s``."""

from portbench.core import loader

SPANS = loader.plugin("metrics", "estimate_device_ms").SPANS
read = loader.plugin("metrics", "estimate_device_ms").read
