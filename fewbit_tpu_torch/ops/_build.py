"""Build and load the package's CUDA kernels.

The sources in ``fewbit_tpu_torch/csrc/*.cu`` are compiled with ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, loaded
with :mod:`ctypes`.  The build runs at the first kernel launch, never at
import, into ``fewbit_tpu_torch/_build/`` (listed in ``.gitignore``), under
a name keyed on the sources' hash, so an edited source rebuilds and an
unchanged one loads the library already built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ("load_library", "build_seconds", "CSRC", "BUILD_DIR")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argument types, in the order of each extern "C" signature.
SIGNATURES = {
    "fewbit_matmul_input_sketch": (
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "fewbit_dense_act_sketch": (
        _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "fewbit_matmul_lut_backward": (
        _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

_build_seconds = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for path in cu + cuh:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build the kernels' library if needed and load it (once per
    process).  A failed build raises with the compiler's output."""
    global _build_seconds
    lib_path = BUILD_DIR / f"libfewbit_kernels_{_digest()}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cu, _ = _sources()
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               *map(str, cu)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_seconds() -> float:
    """Wall seconds the last build in this process took (0 if the library
    was already built)."""
    return _build_seconds
