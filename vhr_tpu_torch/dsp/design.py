"""Filter design, shared with the JAX package.

``vhr_tpu/dsp/design.py`` designs filters in plain numpy (it imports only
numpy and typing), but its package ``vhr_tpu.dsp`` imports JAX on the way
in.  So this module loads that one file by path, without its package's
``__init__``, and re-exports it: both packages design every filter from
the same source.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_NAME = "vhr_tpu_torch.dsp._shared_design"


def _load():
    if _NAME in sys.modules:
        return sys.modules[_NAME]
    # find_spec locates the top-level package without running its
    # __init__.
    pkg = importlib.util.find_spec("vhr_tpu")
    source = Path(pkg.submodule_search_locations[0]) / "dsp" / "design.py"
    spec = importlib.util.spec_from_file_location(_NAME, source)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[_NAME] = mod
    spec.loader.exec_module(mod)
    return mod


_design = _load()

butter_bandpass_sos = _design.butter_bandpass_sos
cheby2_bandpass_sos = _design.cheby2_bandpass_sos
firwin_bandpass = _design.firwin_bandpass
sos_design = _design.sos_design
lfilter_zi = _design.lfilter_zi
sosfilt_zi = _design.sosfilt_zi
filtfilt_padlen = _design.filtfilt_padlen
sosfiltfilt_padlen = _design.sosfiltfilt_padlen

__all__ = list(_design.__all__)
