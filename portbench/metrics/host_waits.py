"""The host's waits on the card a call: how many times a call blocked the
host until the card had run what was queued before it (a copy from
pageable host memory, a value read back), from the program's own counters
(``vhr_tpu_torch/utils/profiling.py``): ``waits``, one a ``vhr.wait`` site
passed, over the calls the run made, which its ``recordings`` counter
gives.  Every call of a cell passes the same sites, so the warm-up, traced
and timed calls count alike.  ``None`` where the program keeps no such
counters."""


def read(ctx):
    calls = ctx["calls"]
    try:
        from vhr_tpu_torch.utils.profiling import counter
    except ImportError:
        return None
    recordings = counter("recordings")
    if not calls or recordings <= 0:
        return None
    return counter("waits") * calls[0].recordings / recordings
