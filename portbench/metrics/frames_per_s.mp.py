"""``frames_per_s`` in the MediaPipe cell, apart so that it has a bound of
its own: the host-paced nets spread far more from run to run than the
skin cell's K1 does."""

from portbench.core import loader

read = loader.plugin("metrics", "frames_per_s").read
