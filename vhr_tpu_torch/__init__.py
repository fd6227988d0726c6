"""vhr_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of ``vhr_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``dsp/``, ``ops/``, ``models/``, ``pipeline/``) and function names so each
function has an obvious counterpart.  It imports ``torch`` and never
``jax``: the only ``vhr_tpu`` modules it uses are the jax-free ones
(``vhr_tpu.config``, ``vhr_tpu.utils.synth`` and
``vhr_tpu.validation.cpu_reference_green_avg``).

Each ported Pallas kernel is hand-written CUDA C++ for ``sm_90a`` under
``csrc/``, built with ``nvcc`` on first use (``_build.py``).  On CPU tensors every kernel wrapper runs its plain PyTorch
version instead.
"""

__version__ = "0.1.0"

from vhr_tpu import config  # noqa: F401
from vhr_tpu.config import (  # noqa: F401
    BAND_ANALYSIS,
    BAND_LIVE,
    BAND_VIDEO,
    DEFAULT_CONFIG,
    EVMConfig,
    FilterConfig,
    HRBand,
    ICAConfig,
    PipelineConfig,
    ROIConfig,
    WelchConfig,
)
