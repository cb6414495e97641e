"""ctypes bindings for the native host codec (``src/fewbit_host_codec.cc``),
as ``fewbit_tpu/native.py``.

The shared library builds on first use with the system ``g++`` into
``fewbit_tpu_torch/_native/``; without a toolchain (or with
``FEWBIT_TPU_NATIVE=0``) every entry point falls back to numpy.  This is a
host codec for storage, not a device path.

Public surface:

* :func:`plane_pack` / :func:`plane_unpack`: multi-threaded host bit-plane
  codec in the JAX package's *flat, strided* layout (element ``i`` goes to
  bit ``i // m`` of word ``i % m``, ``m = ceil(n / 32)``), bit-identical to
  ``pack_codes`` of ``fewbit_tpu/ops/bitpack.py``; not the port's ``(bits,
  ceil(N / 32), M)`` layout of :mod:`fewbit_tpu_torch.ops.bitpack`;
* :func:`stream_pack` / :func:`stream_unpack`: dense little-endian stream
  codec (widths 1..32) for storage interchange;
* :func:`save_packed` / :func:`load_packed`: compressed npz storage for
  code tensors.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ("available", "plane_pack", "plane_unpack", "stream_pack",
           "stream_unpack", "save_packed", "load_packed")

logger = logging.getLogger(__name__)

_SOURCE = Path(__file__).resolve().parent.parent / "src" / "fewbit_host_codec.cc"
_CACHE = Path(__file__).parent / "_native"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
GROUP = 32


def _build() -> Optional[Path]:
    _CACHE.mkdir(exist_ok=True)
    out = _CACHE / "libfewbit_host.so"
    if out.exists() and out.stat().st_mtime >= _SOURCE.stat().st_mtime:
        return out
    # Built under a name of this process's own, then moved into place: two
    # processes building at once never load a half-written library.
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
           str(_SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        logger.warning("native codec build failed (%s); using numpy fallback",
                       exc)
        return None
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.getenv("FEWBIT_TPU_NATIVE", "").lower() in ("0", "no", "false"):
        return None
    path = _build() if _SOURCE.exists() else None
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.fewbit_plane_pack.argtypes = [u32p, ctypes.c_uint64, ctypes.c_int,
                                      u32p, ctypes.c_int]
    lib.fewbit_plane_unpack.argtypes = [u32p, ctypes.c_uint64, ctypes.c_int,
                                        u32p, ctypes.c_int]
    lib.fewbit_stream_pack.argtypes = [u32p, ctypes.c_uint64, ctypes.c_int,
                                       u8p]
    lib.fewbit_stream_pack.restype = ctypes.c_uint64
    lib.fewbit_stream_unpack.argtypes = [u8p, ctypes.c_uint64, ctypes.c_int,
                                         u32p]
    lib.fewbit_stream_unpack.restype = ctypes.c_uint64
    lib.fewbit_stream_nbytes.argtypes = [ctypes.c_uint64, ctypes.c_int]
    lib.fewbit_stream_nbytes.restype = ctypes.c_uint64
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _pack_flat(codes: np.ndarray, bits: int) -> np.ndarray:
    """numpy bit-plane pack: codes viewed as a (32, m) C-order matrix (a
    ragged tail zero-padded); word ``j`` of plane ``b`` holds bit ``b`` of
    row ``i`` of column ``j`` at bit ``i``."""
    n = codes.size
    m = -(-n // GROUP)
    c = np.zeros((GROUP * m,), np.uint32)
    c[:n] = codes
    c = c.reshape(GROUP, m)
    shift = np.arange(GROUP, dtype=np.uint32)[:, None]
    # Disjoint bits: the sum over the 32 rows is the bitwise OR.
    return np.stack([np.sum(((c >> np.uint32(b)) & np.uint32(1)) << shift,
                            axis=0, dtype=np.uint32)
                     for b in range(bits)]).reshape(bits, m)


def _unpack_flat(packed: np.ndarray, bits: int, n: int) -> np.ndarray:
    """Inverse of :func:`_pack_flat`: the first ``n`` codes."""
    m = packed.shape[1]
    shift = np.arange(GROUP, dtype=np.uint32)[:, None]
    c = np.zeros((GROUP, m), np.uint32)
    for b in range(bits):
        c |= ((packed[b][None, :] >> shift) & np.uint32(1)) << np.uint32(b)
    return c.reshape(-1)[:n]


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def plane_pack(codes: np.ndarray, bits: int, threads: int = 0) -> np.ndarray:
    """Bit-plane pack a flat uint32 code vector -> (bits, ceil(n/32))."""
    codes = np.ascontiguousarray(codes, dtype=np.uint32).reshape(-1)
    n = codes.size
    m = -(-n // GROUP)
    lib = _load()
    if lib is None:
        return _pack_flat(codes, bits)
    out = np.zeros((bits, m), dtype=np.uint32)
    lib.fewbit_plane_pack(_u32(codes), n, bits, _u32(out),
                          threads or os.cpu_count() or 1)
    return out


def plane_unpack(packed: np.ndarray, bits: int, n: int,
                 threads: int = 0) -> np.ndarray:
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    lib = _load()
    if lib is None:
        return _unpack_flat(packed, bits, n)
    out = np.zeros((n,), dtype=np.uint32)
    lib.fewbit_plane_unpack(_u32(packed), n, bits, _u32(out),
                            threads or os.cpu_count() or 1)
    return out


def stream_pack(codes: np.ndarray, width: int) -> np.ndarray:
    """Dense little-endian stream pack (width bits per code)."""
    codes = np.ascontiguousarray(codes, dtype=np.uint32).reshape(-1)
    n = codes.size
    nbytes = (n * width + 7) // 8
    lib = _load()
    if lib is not None:
        out = np.zeros((nbytes,), dtype=np.uint8)
        lib.fewbit_stream_pack(_u32(codes), n, width, _u8(out))
        return out
    # numpy fallback via per-code bit scatter
    out = np.zeros((nbytes,), dtype=np.uint8)
    mask = (1 << width) - 1 if width < 32 else 0xFFFFFFFF
    for k in range(n):
        value = int(codes[k]) & mask
        bitpos = k * width
        byte, shift = divmod(bitpos, 8)
        merged = value << shift
        b = 0
        while merged:
            out[byte + b] |= merged & 0xFF
            merged >>= 8
            b += 1
    return out


def stream_unpack(stream: np.ndarray, n: int, width: int) -> np.ndarray:
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    lib = _load()
    if lib is not None:
        out = np.zeros((n,), dtype=np.uint32)
        lib.fewbit_stream_unpack(_u8(stream), n, width, _u32(out))
        return out
    mask = (1 << width) - 1 if width < 32 else 0xFFFFFFFF
    out = np.zeros((n,), dtype=np.uint32)
    for k in range(n):
        bitpos = k * width
        byte, shift = divmod(bitpos, 8)
        acc = 0
        for b in range(6):
            if byte + b < stream.size:
                acc |= int(stream[byte + b]) << (8 * b)
        out[k] = (acc >> shift) & mask
    return out


def save_packed(path, codes: np.ndarray, bits: int) -> None:
    """Persist an integer code tensor at ``bits`` bits/element."""
    flat = np.ascontiguousarray(codes, dtype=np.uint32).reshape(-1)
    np.savez_compressed(path, packed=plane_pack(flat, bits), bits=bits,
                        shape=np.asarray(codes.shape), n=flat.size)


def load_packed(path) -> np.ndarray:
    with np.load(path) as npz:
        codes = plane_unpack(npz["packed"], int(npz["bits"]), int(npz["n"]))
        return codes.reshape(npz["shape"])
