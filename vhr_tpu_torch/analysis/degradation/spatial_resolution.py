"""Spatial downscaling to target heights {720, 480, 360, 240}.

Port of ``vhr_tpu/analysis/degradation/spatial_resolution.py`` (targets,
below-original only, even-width fixup, original yielded first as control).
With an ffmpeg binary the rescale is the reference's libx264 command;
without one it is ``jax.image.resize(..., "linear")`` rebuilt on the
sweep's device (``analysis.context``) + a cv2 write.

JAX's linear resize antialiases (``antialias=True``): a triangle kernel
widened by the downscale factor, each output sample's weights normalised
to sum 1 (``jax._src.image.scale.compute_weight_mat``).
``F.interpolate(..., antialias=True)`` weighs and clamps the edges
otherwise, so :func:`weight_matrix` builds JAX's matrices and the resize
is two matrix products, one along H and one along W, in full float32.
XLA contracts in an order of its own, so the u8 result may differ from
JAX's by one step.
"""

from __future__ import annotations

from typing import Generator, Tuple

import numpy as np
import torch

from . import common
from .. import context
from ...device import float32_exact
from ...io import video as vio

TARGET_HEIGHTS = [720, 480, 360, 240]


def weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``(n_in, n_out)`` float32 weights of JAX's antialiased linear resize
    of one axis from ``n_in`` to ``n_out`` samples."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize_op(h: int, w: int):
    """``chunk (T, H, W, 3) u8 -> (T, h, w, 3) u8``, computed on the
    sweep's device."""
    device = context.current_device()
    mats = {}

    def op(chunk: np.ndarray) -> np.ndarray:
        frames = torch.as_tensor(chunk, device=device)
        H, W = frames.shape[1:3]
        if (H, W) not in mats:
            mats[H, W] = tuple(torch.as_tensor(weight_matrix(n, m),
                                               device=device)
                               for n, m in ((H, h), (W, w)))
        wh, ww = mats[H, W]
        with float32_exact():
            x = frames.to(torch.float32).permute(0, 2, 3, 1)  # (T, W, 3, H)
            x = (x @ wh).permute(0, 3, 2, 1)                  # (T, h, 3, W)
            x = (x @ ww).permute(0, 1, 3, 2)                  # (T, h, w, 3)
        return torch.clamp(torch.round(x), 0, 255).to(torch.uint8) \
            .contiguous().cpu().numpy()

    return op


def apply(input_path: str) -> Generator[Tuple[str, str], None, None]:
    root = common.output_root(input_path, "spatial_resolution")
    width, height, _, _, _ = vio.video_metadata(input_path)

    yield str(input_path), f"{height}p"

    for th in [t for t in TARGET_HEIGHTS if t < height]:
        tw = int(round(width * th / height))
        tw -= tw % 2  # even-width fixup, rounding down like the reference
        label = f"{th}p"
        out = root / f"{label}.mp4"

        def gen(o=out, t_h=th, t_w=tw):
            if common.have_ffmpeg():   # reference spatial_resolution.py:36-47
                common.run_ffmpeg(["-i", str(input_path), "-c:v", "libx264",
                                   "-s", f"{t_w}x{t_h}",
                                   "-pix_fmt", "yuv420p", str(o)])
            else:
                common.per_frame_device_op(input_path, o,
                                           _resize_op(t_h, t_w))

        yield common.cached_level(out, label, gen)
