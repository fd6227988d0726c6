"""The benchmark of ``vhr_tpu_torch`` on one NVIDIA card.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) for a fixed number of seconds and prints one JSON line; see
``portbench/README.md``.
"""
