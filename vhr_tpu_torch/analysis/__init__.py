"""Offline analysis harness of the port: measurement plugins.

Port of ``vhr_tpu/analysis``.  A measurement plugin maps a video path to an
``(N, 2)`` array of ``[t_sec, bpm]`` rows (the reference's contract).
"""
