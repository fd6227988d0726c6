"""Export the learned landmarker's orbax checkpoints as numpy archives.

The JAX package restores ``checkpoints/landmarker`` and
``checkpoints/landmarker_distill`` with orbax and tensorstore; the PyTorch
port reads the same weights from ``checkpoints/landmarker.npz`` and
``checkpoints/landmarker_distill.npz`` with numpy alone
(``vhr_tpu_torch.interop.landmarker_params_from_jax``).  This tool writes
those archives: each holds the flat Flax leaves as float32, keyed by their
path (``stem/kernel``, ``block0/dw/kernel``, ``block0/GroupNorm_0/scale``,
``trunk/kernel``, ...).

Run it on a host with the JAX package's dependencies (jax, flax, orbax)::

    JAX_PLATFORMS=cpu python tools/export_landmarker_weights.py

``tests/test_torch_landmarker.py`` holds each archive equal, leaf for leaf
and bit for bit, to the checkpoint it came from.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = ("landmarker", "landmarker_distill")


def flat_leaves(params) -> dict:
    """A nested Flax params dict -> ``{"a/b/c": float32 array}``."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict) or hasattr(node, "items"):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            out[prefix] = np.asarray(node, np.float32)

    walk(params, "")
    return out


def export(name: str, out_dir: str) -> str:
    sys.path.insert(0, REPO)
    from vhr_tpu.models import landmarker

    params = landmarker.load_default_detector(
        os.path.join(REPO, "checkpoints", name)).args[0]
    path = os.path.join(out_dir, f"{name}.npz")
    np.savez(path, **flat_leaves(params))
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out-dir", default=os.path.join(REPO, "checkpoints"))
    args = p.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    for name in CHECKPOINTS:
        path = export(name, args.out_dir)
        print(path, os.path.getsize(path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
