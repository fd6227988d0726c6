"""A schematic face (skin ellipse, hair, eyes, brows, nose, mouth) that the
MediaPipe detector finds, swaying by whole pixels, its skin carrying a
pulse: the MediaPipe FaceLandmarker's scene.

Frozen copies of ``chip_smoke.py``'s ``draw_face`` and ``make_face_clip``
(commit 523c5c8, lines 1770-1827).  Departures: ``n`` recordings at once
into one ``(n, t, h, w, 3)`` tensor, each with its own BPM drawn from the
seed (the original's was fixed at 72) and its own noise; the scale, the
sway, the BPM range and the noise levels come from the traffic's
parameters (the traffic file ``rec1x32s.json`` gives the original's
numbers); the noise is drawn as uint8.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def draw_face(h: int, w: int, scale: float, cy=None, cx=None):
    """The face drawn ``scale`` times its size centred in an ``h x w``
    frame: ``(u8 BGR image, bool skin-ellipse mask, ellipse box)``."""
    import cv2

    def s(v):
        return int(round(v * scale))

    cx = w // 2 if cx is None else cx
    cy, rx, ry = h // 2 if cy is None else cy, s(55), s(75)
    img = np.full((h, w, 3), (60, 70, 80), np.uint8)
    cv2.ellipse(img, (cx, cy), (rx, ry), 0, 0, 360, (130, 165, 200), -1)
    cv2.ellipse(img, (cx, cy - ry + s(18)), (rx - s(6), s(26)), 0, 180, 360,
                (40, 60, 80), -1)
    for ex in (cx - s(22), cx + s(22)):
        cv2.circle(img, (ex, cy - s(15)), s(9), (255, 255, 255), -1)
        cv2.circle(img, (ex, cy - s(15)), s(5), (40, 30, 30), -1)
        cv2.line(img, (ex - s(12), cy - s(30)), (ex + s(12), cy - s(32)),
                 (50, 50, 60), s(3))
    cv2.line(img, (cx, cy - s(5)), (cx - s(6), cy + s(14)), (90, 120, 150),
             s(3))
    cv2.ellipse(img, (cx, cy + s(34)), (s(18), s(9)), 0, 0, 180,
                (60, 60, 120), s(3))
    mask = np.zeros((h, w), np.uint8)
    cv2.ellipse(mask, (cx, cy), (rx, ry), 0, 0, 360, 1, -1)
    return img, mask.astype(bool), (cx - rx, cy - ry, cx + rx, cy + ry)


def make(device, n: int, t: int, h: int, w: int, fps: float, seed: int,
         params: dict, chunk: int = 32):
    """``(n, t, h, w, 3)`` u8 BGR recordings made on ``device`` from
    ``seed``."""
    lo, hi = params["bpm_range"]
    sway = float(params["sway_px"])
    noise = int(params["noise_levels"])
    img, mask, _ = draw_face(h, w, float(params["face_scale"]))
    base = torch.as_tensor(img, device=device).to(torch.float32)
    skin = torch.as_tensor(mask, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    bpm = lo + (hi - lo) * torch.rand(n, generator=gen, device=device)
    ts = torch.arange(t, dtype=torch.float64) / fps
    dx = torch.round(sway * torch.sin(2 * math.pi * 0.1 * ts)).long()
    out = torch.empty((n, t, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(n):
        pulse = 2.0 * torch.sin(2 * math.pi * float(bpm[i]) / 60.0 * ts)
        for s0 in range(0, t, chunk):
            idx = range(s0, min(t, s0 + chunk))
            img_c = torch.stack([torch.roll(base, int(dx[k]), 1)
                                 for k in idx])
            on = torch.stack([torch.roll(skin, int(dx[k]), 1) for k in idx])
            amp = pulse[list(idx)].to(device=device, dtype=torch.float32)
            img_c[..., 1] += on * amp[:, None, None]
            img_c += torch.randint(0, noise, img_c.shape, generator=gen,
                                   device=device,
                                   dtype=torch.uint8).to(torch.float32)
            out[i, s0:s0 + len(idx)] = img_c.clamp(0, 255).to(torch.uint8)
    return out
