"""The port's builtin LUT archive and its generator
(``fewbit_tpu_torch/data/builtin.npz``,
``fewbit_tpu_torch.tools.quantize_builtins``) against the JAX package's
archive and ``tools/quantize_builtins.py``.

Both tools run the same numpy and scipy arithmetic on the same seeds, so
every array is held equal, bit for bit.  The JAX tool is loaded by its
path; the full 13 x 4 regeneration (about two minutes) is marked ``slow``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from fewbit_tpu_torch import lut
from fewbit_tpu_torch.tools import quantize_builtins as twin

REPO = Path(__file__).resolve().parent.parent
JAX_ARCHIVE = REPO / "fewbit_tpu" / "data" / "builtin.npz"
ENTRIES = [("gelu", 3), ("tanh", 2)]


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_quantize_builtins", REPO / "tools" / "quantize_builtins.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _arrays(path):
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, a in want.items():
        assert got[key].dtype == a.dtype, key
        np.testing.assert_array_equal(got[key], a, err_msg=key)


def test_archive_matches_jax():
    """The port's archive: the JAX archive's 104 keys (13 functions x
    bits 1-4 x borders and levels), every array equal."""
    ours = _arrays(lut.BUILTIN_PATH)
    assert len(ours) == 13 * 4 * 2
    assert {k.rsplit("-", 1)[0][:-2] for k in ours} == set(twin.FUNCS)
    _assert_equal(ours, _arrays(JAX_ARCHIVE))


def test_store_reads_the_ports_archive():
    """The store loads the archive inside the port, as float32."""
    assert lut.BUILTIN_PATH.parent.parent.name == "fewbit_tpu_torch"
    store = lut.StepwiseStore()
    assert len(store) == 52
    ours = _arrays(lut.BUILTIN_PATH)
    borders, levels = store.get("gelu", 3)
    np.testing.assert_array_equal(
        borders, ours["gelu03-borders"].astype(np.float32))
    np.testing.assert_array_equal(
        levels, ours["gelu03-levels"].astype(np.float32))


def test_funcs_match_jax_tool(jax_tool):
    xs = np.linspace(-40.0, 40.0, 4001)
    assert list(twin.FUNCS) == list(jax_tool.FUNCS)
    for name, (prim, deriv) in twin.FUNCS.items():
        jprim, jderiv = jax_tool.FUNCS[name]
        np.testing.assert_array_equal(prim(xs), jprim(xs), err_msg=name)
        np.testing.assert_array_equal(deriv(xs), jderiv(xs), err_msg=name)


@pytest.mark.parametrize("name,bits", ENTRIES)
def test_quantize_one_matches_jax_tool(jax_tool, name, bits):
    """The twin's fit of one entry equals the JAX tool's and the shipped
    archive's, bit for bit; the DP fallback too."""
    fn_prim, fn = twin.FUNCS[name]
    got = twin.quantize_one(name, fn_prim, fn, bits)
    want = jax_tool.quantize_one(name, *jax_tool.FUNCS[name], bits)
    np.testing.assert_array_equal(got.borders, want.borders)
    np.testing.assert_array_equal(got.levels, want.levels)
    archive = _arrays(JAX_ARCHIVE)
    np.testing.assert_array_equal(got.borders,
                                  archive[f"{name}{bits:02d}-borders"])
    np.testing.assert_array_equal(got.levels,
                                  archive[f"{name}{bits:02d}-levels"])
    dp, jdp = (tool.dp_fallback(fn_prim, fn, bits)
               for tool in (twin, jax_tool))
    np.testing.assert_array_equal(dp.borders, jdp.borders)
    np.testing.assert_array_equal(dp.levels, jdp.levels)


def test_main_only_writes_its_entries(tmp_path):
    out = tmp_path / "luts" / "one.npz"
    arrays = twin.main([str(out), "--only", "tanh:2"])
    assert sorted(arrays) == ["tanh02-borders", "tanh02-levels"]
    _assert_equal(_arrays(out), arrays)
    archive = _arrays(JAX_ARCHIVE)
    _assert_equal(arrays, {k: archive[k] for k in arrays})


def test_main_refuses_the_jax_package(tmp_path):
    """No output path under ``fewbit_tpu/``, and none by default."""
    out = REPO / "fewbit_tpu" / "data" / "regenerated.npz"
    for argv in ([str(out), "--only", "tanh:1"],
                 [str(tmp_path / "fewbit_tpu" / "x.npz")]):
        with pytest.raises(SystemExit, match="JAX package"):
            twin.main(argv)
    assert not out.exists()
    with pytest.raises(SystemExit):
        twin.main([])
    with pytest.raises(SystemExit):
        twin.main([str(tmp_path / "x.npz"), "--only", "relu"])


def test_missing_archive_raises(tmp_path, monkeypatch):
    """Without the archive the first use raises, and so does the next: the
    store is never left empty."""
    monkeypatch.setattr(lut, "BUILTIN_PATH", tmp_path / "missing.npz")
    store = lut.StepwiseStore()
    for _ in range(2):
        with pytest.raises(FileNotFoundError):
            store.get("gelu", 3)
    with pytest.raises(FileNotFoundError):
        len(store)


@pytest.mark.slow
def test_full_regeneration_equals_both_archives(tmp_path):
    """All 13 x 4 entries regenerated: the port's archive and the JAX
    archive, every array."""
    arrays = twin.main([str(tmp_path / "builtin.npz")])
    _assert_equal(arrays, _arrays(lut.BUILTIN_PATH))
    _assert_equal(arrays, _arrays(JAX_ARCHIVE))
