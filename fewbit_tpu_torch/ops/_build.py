"""Build and load the package's CUDA kernels.

The sources in ``fewbit_tpu_torch/csrc/*.cu`` are compiled with ``nvcc``
for ``sm_90a``, one ``nvcc`` per source, all started together, and linked
into one shared library with a plain C interface, loaded with
:mod:`ctypes`.  The build runs at the first kernel launch, never at import,
into ``fewbit_tpu_torch/_build/`` (listed in ``.gitignore``), under a name
keyed on the sources' hash, so an edited source rebuilds and an unchanged
one loads the library already built.
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

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The tensor-core schedules of kernel 6 but the k loop, which has one more
# int (its epilogue switch).  The activation's ActArgs goes by address.
_DENSE_ACT = (_P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
              _I, _P)
# The flash kernels, on the tensor cores and on CUDA cores: forward, dK/dV,
# dQ.
_FLASH_FWD = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
              _P)
_FLASH_DKV = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
              _I, _F, _I, _P)
_FLASH_DQ = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _F, _I, _P)
# name -> argument types, in the order of each extern "C" signature.
SIGNATURES = {
    "fewbit_matmul_input_sketch": (
        _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        _P),
    "fewbit_matmul_sketch_smem": (_I, _I, _I, _I, _I),
    "fewbit_input_sketch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "fewbit_dense_act_sketch": (
        _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
        _I, _I, _I, _I, _P),
    "fewbit_dense_act_sketch_x_simt": (
        _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
        _I, _I, _I, _P),
    "fewbit_ffn_gemm_smem": (_I, _I),
    "fewbit_dense_act_sketch_x_smem": (_I, _I, _I, _I),
    "fewbit_matmul_lut_backward": (
        _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _I, _P),
    "fewbit_act_forward": (_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P),
    "fewbit_act_backward": (_P, _P, _I, _P, _P, _I, _I, _I, _P),
    "fewbit_dense_act_simt": (
        _P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "fewbit_dense_act_kloop": (
        _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        _I, _P),
    "fewbit_dense_act_direct": _DENSE_ACT,
    "fewbit_dense_act_emit": _DENSE_ACT,
    "fewbit_dense_act_pipelined": _DENSE_ACT,
    "fewbit_dense_act_resident_smem": (_I, _I, _I, _I, _I),
    "fewbit_dense_act_pipelined_smem": (_I, _I),
    "fewbit_flash_forward": _FLASH_FWD,
    "fewbit_flash_forward_simt": _FLASH_FWD,
    "fewbit_flash_backward_dkv": _FLASH_DKV,
    "fewbit_flash_backward_dq": _FLASH_DQ,
    "fewbit_flash_smem": (_I, _I, _I),
    "fewbit_flash_backward_dkv_simt": _FLASH_DKV,
    "fewbit_flash_backward_dq_simt": _FLASH_DQ,
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
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in cu]
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in ([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                              "-o", str(obj), str(src)]
                             for src, obj in zip(cu, objs))]
        outs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, proc in procs]
        if all(rc == 0 for *_, rc in outs):
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            outs.append((cmd, proc.stdout, proc.returncode))
        _build_seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink(missing_ok=True)
        for cmd, out, rc in outs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}"
                                   f"\n{out}")
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
