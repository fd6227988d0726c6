"""Subjects as skin ellipses on a grey ground, each with its own pulse and
sway: the skin-chroma detector's scene.

A frozen copy of ``chip_smoke.py``'s ``Subjects`` (commit 523c5c8, lines
546-591).  Departures: every frame of every recording is made at once into
one ``(n, t, h, w, 3)`` tensor, in slices of ``chunk`` frames; the sway
amplitude, the BPM range and the noise levels come from the traffic's
parameters (the traffic file ``rec8x32s.json`` gives the original's
numbers); the noise is drawn as uint8.
"""

from __future__ import annotations

import math

import torch


def make(device, n: int, t: int, h: int, w: int, fps: float, seed: int,
         params: dict, chunk: int = 32):
    """``(n, t, h, w, 3)`` u8 BGR recordings made on ``device`` from
    ``seed``."""
    lo, hi = params["bpm_range"]
    sway_px = float(params["sway_px"])
    noise = int(params["noise_levels"])
    gen = torch.Generator(device=device).manual_seed(seed)
    bpm = lo + (hi - lo) * torch.rand(n, generator=gen, device=device)
    phase = 2 * math.pi * torch.rand(n, generator=gen, device=device)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    skin = torch.tensor([105.0, 135.0, 180.0], device=device)
    ground = torch.tensor([60.0, 60.0, 60.0], device=device)
    out = torch.empty((n, t, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(n):
        for s in range(0, t, chunk):
            m = min(chunk, t - s)
            ts = torch.arange(s, s + m, device=device,
                              dtype=torch.float32) / fps
            cx = 0.5 * w + sway_px * torch.sin(2 * math.pi * 0.1 * ts
                                               + phase[i])
            r2 = (((xx - cx[:, None, None]) / (0.16 * w)) ** 2
                  + ((yy - 0.45 * h) / (0.26 * h)) ** 2)
            color = skin.expand(m, 3).clone()
            color[:, 1] += 2.0 * torch.sin(2 * math.pi * bpm[i] / 60.0 * ts)
            img = torch.where((r2 <= 1.0)[..., None],
                              color[:, None, None, :], ground)
            img += torch.randint(0, noise, img.shape, generator=gen,
                                 device=device,
                                 dtype=torch.uint8).to(torch.float32)
            out[i, s:s + m] = img.clamp(0, 255).to(torch.uint8)
    return out
