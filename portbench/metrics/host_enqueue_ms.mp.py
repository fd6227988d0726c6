"""The MediaPipe cell's host milliseconds inside ``multistream_green_bpm``
a call, up to its return (not the wait for its outputs), the mean over the
measured window's calls (after the traced calls, so the profiler's cost
is not in it).  Apart from ``host_enqueue_ms`` because this cell reports
no tail: the metric moves ``frames_per_s.mp`` here."""

from portbench.core import loader

read = loader.plugin("metrics", "host_enqueue_ms").read
