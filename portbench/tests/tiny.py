"""Sizes a CPU test run can hold, as overrides of a cell's files."""

SKIN = "skin_fused-1080p.rec8x32s"
MP = "mediapipe_mesh-1080p.rec1x32s"

_WINDOWS = {"pipeline": {"window_seconds": 1.0, "acquisition_seconds": 0.5}}


def overrides(cell: str) -> dict:
    """A few small recordings and a 1 s window: 64 x 128 skin ellipses, or
    240 x 320 drawn faces at scale 1."""
    traffic = {"frames": 48, "height": 64, "width": 128, "resident": 2,
               "per_call": 2, "warmup_calls": 1, "trace_calls": 2}
    if cell == MP:
        traffic.update(frames=24, height=240, width=320, face_scale=1.0,
                       per_call=1)
    return {"traffic": traffic, "config": dict(_WINDOWS)}
