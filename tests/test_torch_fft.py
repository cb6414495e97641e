"""Port parity for ``fewbit_tpu_torch.fft``: ``dct``/``idct`` (types 2 and
3, every norm, any axis) and ``fwht`` against scipy and against the JAX
package's ``fewbit_tpu.fft``, on inputs made from a seed with numpy.

Tolerances: f32 transforms through one complex FFT of length up to 64,
against scipy's f64 (atol 1e-5 on values of order 1-10) and JAX's f32
(atol 2e-5: other FFT summation orders).  bf16 results cast back to bf16
on both sides and may differ by one bf16 step (rtol 1e-2).
"""

import numpy as np
import pytest
import scipy.fft as sfft
import scipy.linalg
import torch

import jax.numpy as jnp

from fewbit_tpu import fft as jfft

from fewbit_tpu_torch.fft import dct, fwht, idct

NORMS = ("backward", "forward", "ortho")


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("type_", [2, 3])
@pytest.mark.parametrize("n", [1, 2, 7, 16, 33, 64])
def test_dct_matches_scipy_and_jax(n, type_, norm):
    x = _x((n, 5), seed=n)
    got = dct(torch.from_numpy(x), type=type_, axis=0, norm=norm).numpy()
    want = sfft.dct(x.astype(np.float64), type=type_, axis=0, norm=norm)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)
    ref = np.asarray(jfft.dct(jnp.asarray(x), type=type_, axis=0, norm=norm))
    np.testing.assert_allclose(got, ref, atol=2e-5 * scale)
    assert got.dtype == np.float32


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("type_", [2, 3])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_idct_inverts_dct_on_any_axis(axis, type_, norm):
    x = _x((6, 10, 3), seed=axis + 5)
    t = torch.from_numpy(x)
    y = dct(t, type=type_, axis=axis, norm=norm)
    np.testing.assert_allclose(
        y.numpy(), sfft.dct(x.astype(np.float64), type=type_, axis=axis,
                            norm=norm), atol=1e-4)
    back = idct(y, type=type_, axis=axis, norm=norm).numpy()
    np.testing.assert_allclose(back, x, atol=1e-5)
    np.testing.assert_allclose(
        idct(t, type=type_, axis=axis, norm=norm).numpy(),
        sfft.idct(x.astype(np.float64), type=type_, axis=axis, norm=norm),
        atol=1e-4)


def test_dct_bf16_casts_back_as_jax_does():
    x = _x((32, 4), seed=3)
    xb = torch.from_numpy(x).bfloat16()
    got = dct(xb, type=2, axis=0, norm="ortho")
    ref = jfft.dct(jnp.asarray(x, jnp.bfloat16), type=2, axis=0, norm="ortho")
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_dct_rejects_unknown_type_and_norm():
    t = torch.zeros(4)
    with pytest.raises(ValueError, match="type"):
        dct(t, type=1)
    with pytest.raises(ValueError, match="norm"):
        dct(t, norm="nope")


@pytest.mark.parametrize("n", [1, 2, 8, 32, 128, 512])
@pytest.mark.parametrize("norm", ["ortho", "backward"])
def test_fwht_matches_hadamard_and_jax(n, norm):
    x = _x((n, 3), seed=n)
    got = fwht(torch.from_numpy(x), norm=norm).numpy()
    want = scipy.linalg.hadamard(n) @ x.astype(np.float64)
    if norm == "ortho":
        want = want / np.sqrt(n)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1, np.sqrt(n)))
    ref = np.asarray(jfft.fwht(jnp.asarray(x), norm=norm))
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(1, np.sqrt(n)))


def test_fwht_keeps_trailing_shape_and_jax_dtypes():
    x = _x((16, 2, 3), seed=1)
    got = fwht(torch.from_numpy(x))
    assert got.shape == (16, 2, 3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jfft.fwht(jnp.asarray(x))), atol=1e-5)
    # The ortho scale is an f64 scalar in JAX: bf16 comes out f32.
    xb = torch.from_numpy(x).bfloat16()
    ref = jfft.fwht(jnp.asarray(x, jnp.bfloat16))
    got = fwht(xb)
    assert str(ref.dtype) == "float32" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-2,
                               atol=1e-2)
    assert fwht(xb, norm="backward").dtype == torch.bfloat16


@pytest.mark.parametrize("n", [3, 6, 100])
def test_fwht_rejects_a_length_not_a_power_of_two(n):
    with pytest.raises(ValueError, match="power of two"):
        fwht(torch.zeros(n, 2))
