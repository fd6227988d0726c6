"""The MediaPipe executor's dispatched operations a frame: the program's
``exec.ops`` counter (each op of a net's forward, each residual stage on
K5 as one, added once a forward in ``models/tflite_exec.py``) over its
``frames`` counter (the frames entering ``multistream_green_bpm``), over
every call the run made: each call of the cell runs the same forwards.
``None`` where the program keeps no such counters."""


def read(ctx):
    try:
        from vhr_tpu_torch.utils.profiling import counter
    except ImportError:
        return None
    ops, frames = counter("exec.ops"), counter("frames")
    return ops / frames if ops > 0 and frames > 0 else None
