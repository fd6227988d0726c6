"""Plugin registries for degradations, measurements, and metrics.

Port of ``vhr_tpu/analysis/registry.py``: the same names, listings and
user-file loading, with the modules under ``vhr_tpu_torch.analysis``.

The reference discovers plugins with ``importlib.import_module`` against a
working-directory-relative package (``analysis/main.py:16-31``) and a
filesystem glob for metrics (``analysis/main.py:95-105``).  Here first-party
plugins register declaratively and external plugin *files* can still be
loaded by path, preserving the drop-a-file extensibility contract.
"""

from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

__all__ = ["degradations", "measurements", "metrics",
           "get_degradation", "get_measurement", "iter_metrics",
           "load_plugin_file"]

_DEGRADATIONS: Dict[str, str] = {
    "spatial_resolution": "vhr_tpu_torch.analysis.degradation.spatial_resolution",
    "temporal_resolution": "vhr_tpu_torch.analysis.degradation.temporal_resolution",
    "colour_quantisation": "vhr_tpu_torch.analysis.degradation.colour_quantisation",
    "colour_noise": "vhr_tpu_torch.analysis.degradation.colour_noise",
    "crf": "vhr_tpu_torch.analysis.degradation.crf",
    "encoding": "vhr_tpu_torch.analysis.degradation.encoding",
    "dummy": "vhr_tpu_torch.analysis.degradation.dummy",
}

_MEASUREMENTS: Dict[str, str] = {
    "green_avg": "vhr_tpu_torch.analysis.measurement.green_avg",
    "ica": "vhr_tpu_torch.analysis.measurement.ica",
    "chrom": "vhr_tpu_torch.analysis.measurement.chrom",
    "pos": "vhr_tpu_torch.analysis.measurement.pos",
    "omit": "vhr_tpu_torch.analysis.measurement.omit",
    "adaptive": "vhr_tpu_torch.analysis.measurement.adaptive",
    "green_avg_psd": "vhr_tpu_torch.analysis.measurement.green_avg_psd",
    "app_welch": "vhr_tpu_torch.analysis.measurement.app_welch",
    "evm": "vhr_tpu_torch.analysis.measurement.evm",
    "dummy": "vhr_tpu_torch.analysis.measurement.dummy",
}

_METRICS: Dict[str, str] = {
    "mae": "vhr_tpu_torch.analysis.metrics.mae",
    "signals": "vhr_tpu_torch.analysis.metrics.signals",
    "accuracy": "vhr_tpu_torch.analysis.metrics.accuracy",
}


def degradations() -> List[str]:
    return sorted(_DEGRADATIONS)


def measurements() -> List[str]:
    return sorted(_MEASUREMENTS)


def metrics() -> List[str]:
    return sorted(_METRICS)


def get_degradation(name: str):
    """Resolve a degradation module exposing ``apply(path)``."""
    if name in _DEGRADATIONS:
        return importlib.import_module(_DEGRADATIONS[name])
    return load_plugin_file(name, required_attr="apply")


def get_measurement(name: str):
    """Resolve a measurement module exposing ``measure(path)``."""
    if name in _MEASUREMENTS:
        return importlib.import_module(_MEASUREMENTS[name])
    return load_plugin_file(name, required_attr="measure")


def iter_metrics(extra_dir: str = None) -> Iterable[Tuple[str, object]]:
    """Yield (name, module) for every registered metric plus any ``*.py`` in
    ``extra_dir`` (the reference's drop-a-file metric discovery,
    ``analysis/main.py:95-105``)."""
    for name, modpath in sorted(_METRICS.items()):
        yield name, importlib.import_module(modpath)
    if extra_dir:
        for f in sorted(Path(extra_dir).glob("*.py")):
            if f.name.startswith("_"):
                continue
            yield f.stem, load_plugin_file(str(f), required_attr="plot")


def load_plugin_file(path: str, required_attr: str):
    """Load a user plugin module from a filesystem path."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(
            f"unknown plugin {path!r}: not a registered name and not a file")
    spec = importlib.util.spec_from_file_location(p.stem, p)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load plugin from {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not hasattr(module, required_attr):
        raise AttributeError(
            f"plugin {path} lacks required attribute {required_attr!r}")
    return module
