"""vhr_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of ``vhr_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``dsp/``, ``ops/``, ``models/``, ``pipeline/``) and function names so each
function has an obvious counterpart.  It imports ``torch`` and never
``jax``, and nothing of ``vhr_tpu``: what it needs of the JAX package's
jax-free modules it keeps as its own copies (``config``, ``dsp.design``,
``io.video``, ``validation.cpu_reference_green_avg``).

Each ported Pallas kernel is hand-written CUDA C++ for ``sm_90a`` under
``csrc/``, built with ``nvcc`` on first use (``_build.py``).  On CPU
tensors every kernel wrapper runs its plain PyTorch version instead.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from .config import (  # noqa: F401
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
