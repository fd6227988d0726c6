"""The PyTorch port imports without JAX and shares the JAX package's
configuration surface."""

import dataclasses
import subprocess
import sys
from pathlib import Path

from vhr_tpu.models.skin_detector import SkinDetectorConfig as JaxSkinConfig

import vhr_tpu_torch
from vhr_tpu_torch import interop
from vhr_tpu_torch.models.skin_detector import SkinDetectorConfig

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vhr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vhr_tpu_torch.__path__,
                                               'vhr_tpu_torch.')]
for n in names:
    importlib.import_module(n)
print(len(names), 'jax' in sys.modules, 'torch' in sys.modules)
"""


def test_port_imports_without_jax():
    """Every module of the port imports in a fresh interpreter without
    loading jax (the GPU machine has none)."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, check=True)
    n, has_jax, has_torch = out.stdout.split()
    assert int(n) >= 18
    assert has_jax == "False" and has_torch == "True"


def test_serving_modules_import_without_jax():
    """The serving slice's entry modules load no jax in a fresh
    interpreter (the shared filter design is loaded by file path)."""
    code = ("import sys; import vhr_tpu_torch.serving, "
            "vhr_tpu_torch.pipeline.live, vhr_tpu_torch.dsp.design; "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False"]


def test_evm_modules_import_without_jax():
    """The EVM slice's entry modules load no jax in a fresh interpreter."""
    code = ("import sys; import vhr_tpu_torch.pipeline.evm, "
            "vhr_tpu_torch.analysis.measurement.evm; "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["False"]


def test_skin_config_equals_jax_field_for_field():
    ours = dataclasses.asdict(SkinDetectorConfig())
    ref = dataclasses.asdict(JaxSkinConfig())
    assert ours == ref
    assert [f.name for f in dataclasses.fields(SkinDetectorConfig)] == \
        [f.name for f in dataclasses.fields(JaxSkinConfig)]
    custom = JaxSkinConfig(cb_min=80.0, downsample=2, pool_mode="mean")
    assert dataclasses.asdict(interop.skin_config_from_jax(
        dataclasses.asdict(custom))) == dataclasses.asdict(custom)


def test_config_types_are_shared():
    from vhr_tpu import config
    assert vhr_tpu_torch.PipelineConfig is config.PipelineConfig
    assert vhr_tpu_torch.ROIConfig is config.ROIConfig
    assert vhr_tpu_torch.BAND_ANALYSIS == config.BAND_ANALYSIS
