"""The import rule: no JAX and no JAX package anywhere under portbench/,
no port under portbench/reference/, by whole top-level names."""

import os
import subprocess
import sys
import textwrap

from portbench.core import guard, loader


def test_the_benchmark_keeps_the_rule():
    assert guard.static_violations(loader.BENCH_DIR) == []


def test_the_rule_catches_each_kind(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "a.py").write_text(textwrap.dedent("""
        import jax.numpy as jnp
        from vhr_tpu import config
        import vhr_tpu_torch
        import importlib
        importlib.import_module("flax.linen")
    """))
    (tmp_path / "reference" / "b.py").write_text(
        "from vhr_tpu_torch.ops import roi\nimport vhr_tpu_torchx\n")
    bad = guard.static_violations(str(tmp_path))
    assert bad == ["a.py:2 jax", "a.py:3 vhr_tpu", "a.py:6 flax",
                   "reference/b.py:1 vhr_tpu_torch"]


def test_loaded_names_are_compared_whole():
    assert guard.loaded_forbidden({"vhr_tpu_torch.ops": 1, "jaxtyping": 1,
                                   "numpy": 1}) == []
    assert guard.loaded_forbidden({"jax._src.core": 1, "vhr_tpu.config": 1,
                                   "vhr_tpu_torch": 1}) == ["jax", "vhr_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = textwrap.dedent(f"""
        import io, sys, time, torch
        sys.path.insert(0, {loader.ROOT!r})
        sys.path.insert(0, {os.path.dirname(__file__)!r})
        import tiny
        from portbench.core import guard, harness
        out = io.StringIO()
        rc = harness.main(["--workload", tiny.SKIN, "--seed", "7",
                           "--seconds", "0.2", "--trace", "0"],
                          time.perf_counter(), device=torch.device("cpu"),
                          overrides=tiny.overrides(tiny.SKIN), out=out)
        assert rc == 0, rc
        print(guard.loaded_forbidden())
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip().splitlines()[-1] == "[]"
