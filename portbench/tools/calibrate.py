"""The readings that a cell's limits are set from, on the CUDA card.

    python3 portbench/tools/calibrate.py --workload <name> \
        --seeds <n> ... --control-seeds <n> ... [--calls 3]

For each of ``--seeds`` the cell is set up from that seed as a run sets it
up, ``--calls`` timed calls run closed-loop at the cell's load, and their
recordings are judged against the reference: the program's readings (the
lower ones).  For each of ``--control-seeds`` the reference computed in
the precision below the configuration's (the file's ``control``) takes
the program's place and is judged the same way: the control's readings
(the upper ones).  One JSON line a seed; a summary last.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control(cell, config, device):
    """The control in the program's place over the cell's recordings:
    (the worst of each number, recordings judged, recordings failed)."""
    from portbench.core import judge

    drv = cell.driver_mod
    ref = drv.Reference(config, device)
    ctl = drv.Reference(config, device, control=True)
    readings = []
    for group in cell.groups:
        readings += [drv.compare(c, r, cell)
                     for c, r in zip(ctl(group), ref(group))]
    failed = sum(not judge.passes(n, config["limits"]) for n in readings)
    return judge.worst(readings), len(readings), failed


def main(argv=None, device=None, overrides=None):
    import torch

    from portbench.core import harness, judge, loader

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            print("calibrate: no CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    over = overrides or {}
    entry = loader.cell(loader.benchmark(), args.workload)
    config = harness.merge(loader.config(entry["config"]),
                           over.get("config"))
    traffic = harness.merge(loader.traffic(entry["traffic"]),
                            over.get("traffic"))
    drv = loader.plugin("drivers", config["driver"])
    lows, highs = [], []
    for kind, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            cell = harness.Cell(config, traffic, device, seed)
            if kind == "program":
                cell.run(calls=1)
                calls, _, _ = cell.run(calls=args.calls)
                cell.close()
                nums, attempted, failed = judge.judge_calls(cell, calls)
                lows.append(nums)
            else:
                cell.close()
                nums, attempted, failed = control(cell, config, device)
                highs.append(nums)
            print(json.dumps({"kind": kind, "seed": seed, "numbers": nums,
                              "attempted": attempted, "failed": failed,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            del cell
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    summary = {}
    for k in drv.NUMBERS:
        summary[k] = {"lower": max((n[k] for n in lows), default=None),
                      "upper": min((n[k] for n in highs), default=None),
                      "limit": config["limits"].get(k)}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
