"""EVM colour-magnification app: make the pulse visible in a video.

Port of ``vhr_tpu/apps/evm_magnify.py``.  Streams a video through
``vhr_tpu_torch.pipeline.evm.magnify`` in chunks and writes the amplified
result as mp4v with cv2.  On a CUDA card both full-resolution stages run
on kernels K6 and K7 where the JAX app takes its Pallas route on a TPU:
the frame width a multiple of 128 and at least one pyramid level;
elsewhere, and on the CPU, the plain route.

Usage::

    python -m vhr_tpu_torch.apps.evm_magnify in.mp4 out.mp4 \\
        [--alpha 50] [--low-hz 0.83] [--high-hz 1.0] [--levels 4] \\
        [--device cpu]

``--device`` defaults to the CUDA card.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    import cv2
    import torch

    from ..config import EVMConfig, HRBand
    from ..device import resolve_device
    from ..io import video as vio
    from ..pipeline import evm

    p = argparse.ArgumentParser(description="Eulerian color magnification")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--alpha", type=float, default=50.0)
    p.add_argument("--low-hz", type=float, default=0.83)
    p.add_argument("--high-hz", type=float, default=1.0)
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--chunk-seconds", type=float, default=20.0,
                   help="temporal chunk length (FFT bandpass is per chunk)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "on the host)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = EVMConfig(pyramid_levels=args.levels, amplification=args.alpha,
                    band=HRBand(args.low_hz, args.high_hz))
    writer = None
    total = 0
    for chunk, fps, _ in vio.iter_video_chunks(
            args.input, chunk_frames=max(16, int(args.chunk_seconds * 30))):
        use_kernels = (dev.type == "cuda" and chunk.shape[2] % 128 == 0
                       and args.levels >= 1)
        out = evm.magnify(torch.from_numpy(chunk).to(dev), float(fps), cfg,
                          use_pallas=use_kernels).cpu().numpy()
        if writer is None:
            h, w = out.shape[1:3]
            writer = cv2.VideoWriter(args.output,
                                     cv2.VideoWriter_fourcc(*"mp4v"),
                                     fps, (w, h))
        for f in out:
            writer.write(np.ascontiguousarray(f))
        total += out.shape[0]
        print(f"magnified {total} frames", flush=True)
    if writer is not None:
        writer.release()
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
