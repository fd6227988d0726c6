"""The MediaPipe step's share of the card's bf16 peak: the operations a
frame of the two nets (the detector once a frame, the mesh net once a
crop, one crop a frame), counted from the graphs in the bundled ``.task``
(CONV_2D, DEPTHWISE_CONV_2D, FULLY_CONNECTED by their shapes), times the
frames a second that the run's measured window completed, over 989
TFLOP/s (dense bf16, 700 W; the run prints the card's power limit).  The
frames a second are the measured window's, not the traced calls': the
profiler's own cost slows the host that dispatches the nets."""

import os

from portbench.core import peaks
from portbench.core.loader import ROOT
from portbench.reference.flops import task_flops

GRAPHS = {"face_detector.tflite": 1, "face_landmarks_detector.tflite": 1}


def read(ctx):
    done = [c for c in ctx["calls"] if c.in_window]
    if not done or ctx["trace"] is None or ctx["trace"].busy_s <= 0:
        return None
    counts = task_flops(os.path.join(
        ROOT, ctx["config"]["mediapipe"]["task_file"]))
    per_frame = sum(counts[g] * n for g, n in GRAPHS.items())
    frames_per_s = sum(c.frames for c in done) / ctx["seconds"]
    return 100.0 * per_frame * frames_per_s / peaks.BF16_OPS
