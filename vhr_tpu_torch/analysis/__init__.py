"""Offline analysis harness of the port: degradation x measurement sweeps
and their metrics.

Port of ``vhr_tpu/analysis`` with the reference's three plugin contracts
(``analysis/README.md``):

* degradation: ``apply(video_path) -> iterator of (degraded_path, label)``
* measurement: ``measure(video_path) -> np.ndarray (N, 2) [t_sec, bpm]``
* metric: ``plot(truth, results, x_label, output_dir)``

Plugins resolve through :mod:`.registry`; the pixel-domain degradations and
the measurements run on the device that :mod:`.context` holds (the CUDA
card unless the sweep asks for the CPU).
"""

from . import registry  # noqa: F401
