"""The plain reference: PyTorch and NumPy only.

It imports neither JAX, nor the JAX package, nor the port
(``portbench/core/guard.py`` checks that), and takes nothing the port has
made: it reads the recordings the benchmark made and the bundled
``checkpoints/face_landmarker.task``, and works everything else out
again.  Where it follows the port's plain versions, the module says from
which file and commit it was copied, and every departure.
"""
