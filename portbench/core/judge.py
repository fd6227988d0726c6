"""The comparison that decides ``correct``.

A cell's driver (``portbench/drivers/<driver>.py``) says what is compared:
``records`` splits a call's outputs into one dict a recording,
``Reference`` works the same out again from the recordings, and
``compare`` gives one recording's numbers against the reference's, by
name (``NUMBERS``).  The configuration file's ``limits`` name the numbers
held, each to its limit; a number is within its limit when it is no
larger.
"""

from __future__ import annotations

import hashlib

import numpy as np


def worst(readings) -> dict:
    """The largest of each number over several recordings' readings."""
    readings = list(readings)
    return {k: max(r[k] for r in readings) for k in readings[0]}


def passes(numbers: dict, limits: dict) -> bool:
    """Every number the limits name is within its limit."""
    return all(numbers[k] <= limit for k, limit in limits.items())


def judge_calls(cell, calls) -> tuple:
    """Every recording of every call against the reference, outputs that
    repeat those of an earlier call of the same recordings judged once:
    (the worst of each number, recordings attempted, recordings failed)."""
    drv = cell.driver_mod
    ref = drv.Reference(cell.config, cell.device)
    limits = cell.config["limits"]
    refs, seen, numbers, attempted, failed = {}, {}, None, 0, 0
    for c in calls:
        recs = drv.records(c.host, cell.P, cell.T)
        h = hashlib.sha1(str(c.group).encode())
        for r in recs:
            for k in sorted(r):
                h.update(k.encode() + np.ascontiguousarray(r[k]).tobytes())
        key = h.hexdigest()
        if key not in seen:
            if c.group not in refs:
                refs[c.group] = ref(cell.groups[c.group])
            seen[key] = [drv.compare(p, r, cell)
                         for p, r in zip(recs, refs[c.group])]
        for n in seen[key]:
            attempted += 1
            failed += not passes(n, limits)
            numbers = n if numbers is None else worst([numbers, n])
    return numbers, attempted, failed
