"""The host's waits on the card a pool tick: the program's ``waits``
counter (one a ``vhr.wait`` site passed: the fetch of a tick's outputs,
the upload of the slot masks from pageable memory, a pinned buffer's
turn) over its ``pool.ticks`` counter, over every call the run made:
each tick of the cell passes the same sites.  ``None`` where the program
keeps no such counters."""


def read(ctx):
    try:
        from vhr_tpu_torch.utils.profiling import counter
    except ImportError:
        return None
    ticks = counter("pool.ticks")
    return counter("waits") / ticks if ticks > 0 else None
