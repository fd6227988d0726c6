"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled on first use by its own ``nvcc`` process
(all started together) and the objects are linked into one shared library
with a plain C interface, under ``build/vhr_tpu_torch/`` at the root of the
checkout, loaded with ``ctypes``.  The library's file name holds a hash of
the sources (headers included) and flags, so an edited source is rebuilt.
Each C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "library", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "vhr_tpu_torch"

# --fmad=false: nvcc contracts no a*b+c on its own; where the kernels want a
# fused multiply-add (the chroma test) they write __fmaf_rn.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "vhr_yiq_pyrdown": [_P, _P] + [_I] * 10 + [_P],
    "vhr_evm_reconstruct": ([_P] + [_L] * 4 + [_P] + [_L] * 4 + [_P] * 9
                            + [_I] * 11 + [_P]),
    "vhr_roi_means_u8": [_P, _P, _P, _I, _P, _P] + [_I] * 8 + [_P],
    "vhr_roi_means_batched_u8": [_P, _L, _L, _P, _P, _P] + [_I] * 8 + [_P],
    "vhr_fused_detect_roi": ([_P] + [_I] * 11 + [_F, _I] + [_F] * 9
                             + [_I] * 6 + [_P] * 10),
    "vhr_fused_detect_roi_slots": ([_P] + [_I] * 7 + [_F, _I] + [_F] * 9
                                   + [_I] + [_P] * 9),
    "vhr_residual_stage": [_P, _P, _I] + [_P] * 9 + [_I] * 11 + [_P],
    "vhr_ramp_dft": [_P] + [_I] * 5 + [_F] * 3 + [_I] * 2 + [_P] * 3,
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvhr_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    The compilers' output (with ``-Xptxas -v``: registers, shared memory
    and spills of each kernel) is kept beside the library as ``.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o",
                 str(Path(tmp) / f"{src.stem}.o"), str(src)]
                for src in _sources()]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [(c, p.communicate()[0], p.returncode)
                for c, p in zip(cmds, procs)]
        lib = str(Path(tmp) / out.name)
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", lib, *(c[-2] for c in cmds)]
        if all(rc == 0 for _, _, rc in logs):
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append((link, proc.stdout + proc.stderr, proc.returncode))
        out.with_suffix(".log").write_text("".join(
            " ".join(c) + "\n" + text for c, text, _ in logs))
        failed = [(c, text, rc) for c, text, rc in logs if rc != 0]
        if failed:
            c, text, rc = failed[0]
            raise RuntimeError(f"{' '.join(c)} failed ({rc}):\n"
                               f"{text[-4000:]}")
        os.replace(lib, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
