"""Find everything a cell needs by its name in ``BENCHMARK.json``.

- ``portbench/configs/<config>.json``: the configuration as it is run, its
  driver and the limits of its comparison;
- ``portbench/traffic/<traffic>.json``: the traffic mix, parameters that
  the harness, its scene and its pacing read;
- ``portbench/scenes/<scene>.py``: how a recording of a traffic mix is
  drawn (``make``);
- ``portbench/pacing/<pacing>.py``: how the calls are offered (``run``);
- ``portbench/drivers/<driver>.py``: how a configuration calls the port
  and how what it returns is judged (``Driver``, ``records``,
  ``Reference``, ``compare``);
- ``portbench/metrics/<metric>.py``: one metric each (``read``, and the
  call sites it wraps in ``SPANS``).

A later cell, configuration or metric is a new file and a new entry; no
file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                   f"{[w['name'] for w in bench['workloads']]})")


def _json(kind: str, name: str) -> dict:
    path = os.path.join(BENCH_DIR, kind, f"{name}.json")
    if not os.path.exists(path):
        raise KeyError(f"no {kind} file {name}.json under portbench/{kind}")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


_MODULES: dict = {}


def plugin(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module (a name may hold ``.``
    and ``-``, so it is loaded by its path)."""
    key = (kind, name)
    if key not in _MODULES:
        path = os.path.join(BENCH_DIR, kind, f"{name}.py")
        if not os.path.exists(path):
            raise KeyError(f"no {kind} file {name}.py under portbench/{kind}")
        spec = importlib.util.spec_from_file_location(
            f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def metrics_of(bench: dict, cell_name: str, section: str) -> list:
    """The entries of ``bench[section]`` that the cell reports: those that
    list it under ``workloads``, and those without the key."""
    return [m for m in bench[section]
            if cell_name in m.get("workloads", [cell_name])]
