"""DCT types 2 and 3 and the Walsh-Hadamard transform, as
``fewbit_tpu/fft.py``: the structured transforms behind the ``dct`` and
``srht`` sketches of :func:`fewbit_tpu_torch.functional.linear.linear_grp`.

``dct`` follows scipy's ``scipy.fft.dct`` conventions for ``type`` and
``norm`` through one complex FFT (Makhoul, 1980):

* ``dct2_backward(x)_k = 2 Re(e^{-i pi k / 2N} FFT(P x)_k)``, ``P`` the
  even indices followed by the odd ones reversed;
* its inverse builds ``V_k = (y_k - i y_{N-k}) e^{i pi k / 2N} / 2``
  (``y_N := 0``), takes the inverse FFT and undoes ``P``;
* ``dct3_backward = 2N idct2_backward``; the ortho norm scales entry 0 by
  ``1 / (2 sqrt(N))`` and the rest by ``1 / sqrt(2N)``.

The FFT runs in f32 (``torch.fft`` takes no bf16); ``dct`` casts back to the
input's dtype, as the JAX package does.  ``fwht`` is two products with
small Sylvester Hadamard matrices (``H_N = H_a kron H_b``), in the input's
dtype; its ortho scale promotes bf16 to f32, as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ("dct", "idct", "fwht")


def _hadamard(n: int) -> np.ndarray:
    """Sylvester-construction Hadamard matrix, ``n`` a power of two."""
    h = np.ones((1, 1), dtype=np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def fwht(x: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    """Walsh-Hadamard transform along axis 0; its length a power of two.

    ``(H_N X).reshape(a, b, d) = H_a @ (H_b @ X.reshape(a, b, d))`` with
    ``a b = N``: two products with ``a x a`` and ``b x b`` matrices instead
    of ``log2 N`` butterfly stages.
    """
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"fwht length must be a power of two, got {n}")
    if norm not in ("ortho", "backward"):
        raise ValueError(f"unknown norm: {norm!r}")
    log2 = n.bit_length() - 1
    a = 1 << (log2 // 2)
    b = n // a
    ha = torch.from_numpy(_hadamard(a)).to(x.device, x.dtype)
    hb = torch.from_numpy(_hadamard(b)).to(x.device, x.dtype)
    tail = x.shape[1:]
    y = torch.matmul(hb, x.reshape(a, b, -1))
    y = torch.matmul(ha, y.reshape(a, -1)).reshape(n, *tail)
    if norm == "ortho":
        # JAX scales by an f64 scalar: bf16 comes out f32.
        dt = torch.promote_types(y.dtype, torch.float32)
        return y.to(dt) * (1.0 / np.sqrt(n))
    return y


def _ortho_scale(n: int, device) -> torch.Tensor:
    s = np.full((n,), 1.0 / np.sqrt(2.0 * n))
    s[0] = 1.0 / (2.0 * np.sqrt(n))
    return torch.from_numpy(s).to(device, torch.float32)


def _twiddle(n: int, sign: float, device) -> torch.Tensor:
    k = np.arange(n)
    return torch.from_numpy(np.exp(sign * 0.5j * np.pi * k / n)).to(
        device, torch.complex64)


def _dct2_backward(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    v = torch.cat([x[..., 0::2], x[..., 1::2].flip(-1)], dim=-1)
    fv = torch.fft.fft(v, dim=-1)
    return 2.0 * torch.real(fv * _twiddle(n, -1.0, x.device))


def _idct2_backward(y: torch.Tensor) -> torch.Tensor:
    n = y.shape[-1]
    tail = torch.cat([torch.zeros_like(y[..., :1]), y[..., 1:].flip(-1)],
                     dim=-1)
    v = torch.fft.ifft((y - 1j * tail) * _twiddle(n, 1.0, y.device) * 0.5,
                       dim=-1)
    nhalf = (n + 1) // 2
    out = torch.empty(y.shape, dtype=v.real.dtype, device=y.device)
    out[..., 0::2] = torch.real(v[..., :nhalf])
    out[..., 1::2] = torch.real(v[..., nhalf:]).flip(-1)
    return out


def _dct_last(x: torch.Tensor, type: int, norm: str) -> torch.Tensor:
    n = x.shape[-1]
    if type == 2:
        y = _dct2_backward(x)
        if norm == "backward":
            return y
        if norm == "forward":
            return y / (2.0 * n)
        if norm == "ortho":
            return y * _ortho_scale(n, x.device)
    elif type == 3:
        if norm == "backward":
            return 2.0 * n * _idct2_backward(x)
        if norm == "forward":
            return _idct2_backward(x)
        if norm == "ortho":
            return _idct2_backward(x / _ortho_scale(n, x.device))
    else:
        raise ValueError(f"unsupported DCT type: {type}")
    raise ValueError(f"unknown norm: {norm!r}")


def dct(x: torch.Tensor, type: int = 2, axis: int = -1,
        norm: str = "backward") -> torch.Tensor:
    """Discrete cosine transform (types 2 and 3), scipy conventions."""
    x = torch.movedim(x, axis, -1)
    wide = x if x.dtype in (torch.float32, torch.float64) else x.float()
    y = _dct_last(wide, type, norm).to(x.dtype)
    return torch.movedim(y, -1, axis)


def idct(x: torch.Tensor, type: int = 2, axis: int = -1,
         norm: str = "backward") -> torch.Tensor:
    """Inverse DCT, scipy conventions: ``idct(dct(x, t, norm), t, norm) == x``."""
    inverse_type = {2: 3, 3: 2}[type]
    inverse_norm = {"backward": "forward", "forward": "backward",
                    "ortho": "ortho"}[norm]
    return dct(x, inverse_type, axis, inverse_norm)
