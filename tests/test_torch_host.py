"""The port's host pieces (``lut``, ``approx``, ``cli``, ``metrics``,
``train/data``, ``native`` and the package's exports) against the JAX
package's on the same inputs, made from numpy seeds.

Tolerances: the numpy code paths are the same code, so their outputs are
held equal; the CLI's archives hold ``torch.autograd`` derivatives against
``jax.grad`` ones in float64 (``rtol`` 1e-9, then the same solver); the
codecs bit for bit.
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

import fewbit_tpu
from fewbit_tpu import approx as japprox
from fewbit_tpu import cli as jcli
from fewbit_tpu import lut as jlut
from fewbit_tpu import metrics as jmetrics
from fewbit_tpu import native as jnative
from fewbit_tpu import util as jutil
from fewbit_tpu.ops.bitpack import pack_codes as jax_pack_codes
from fewbit_tpu.train import data as jdata

import fewbit_tpu_torch
from fewbit_tpu_torch import approx, cli, metrics, native, util
from fewbit_tpu_torch.lut import StepwiseStore
from fewbit_tpu_torch.train import data

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# Package surface.
# ---------------------------------------------------------------------------


def test_import_builds_and_loads_nothing():
    """Importing the package builds no CUDA kernel, loads no host codec and
    imports neither JAX nor triton."""
    code = (
        "import sys, json, fewbit_tpu_torch\n"
        "from fewbit_tpu_torch.ops import _build\n"
        "from fewbit_tpu_torch import native\n"
        "print(json.dumps([_build.load_library.cache_info().currsize,\n"
        "    native._TRIED, sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'fewbit_tpu', 'triton'))]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    assert json.loads(out.splitlines()[-1]) == [0, False, []]


def test_top_level_exports_match_jax():
    """Every name ``fewbit_tpu/__init__.py`` exports has its counterpart;
    ``Stepwise`` is the activation module in both (the modules' ``*``
    import shadows the quantizer's class, which stays under ``approx``)."""
    ours = {n for n in dir(fewbit_tpu_torch) if not n.startswith("_")}
    # Names, not the submodules that imports elsewhere in the process
    # happen to set on the package; ``functional`` is an export.
    theirs = {n for n in dir(fewbit_tpu) if not n.startswith("_") and
              not isinstance(getattr(fewbit_tpu, n), types.ModuleType)}
    assert theirs | {"functional"} <= ours, theirs - ours
    assert fewbit_tpu_torch.Stepwise.__name__ == fewbit_tpu.Stepwise.__name__
    assert fewbit_tpu_torch.approx.Stepwise.__module__.endswith("approx")
    for name in ("device_memory_stats", "profile_trace", "use_fewbit_dense",
                 "use_fewbit_activation", "VarianceEstimator",
                 "VarianceEstimatorState"):
        assert hasattr(fewbit_tpu_torch, name)
    import fewbit_tpu_torch.functional as PF
    for name in ("GradientStorage", "catch_gradients",
                 "estimate_correlation", "estimate_variance_sgd",
                 "estimate_variance_rmm"):
        assert name in PF.__all__ and hasattr(PF, name)
    assert set(util.__all__) == set(jutil.__all__) - {
        "compiled_memory_stats", "tpu_compile_options"}
    assert set(jdata.__all__) <= set(data.__all__)


# The JAX package's public names that the port leaves out, each with why
# (and the port's counterpart where it has one under another name).
NOT_PORTED = {
    "tpu_compile_options": "XLA's TPU compiler flags; the CUDA kernels "
                           "build with nvcc's (ops/_build.py)",
    "compiled_memory_stats": "reads XLA's compiled memory analysis; the "
                             "port measures: util.peak_memory_bytes, "
                             "util.device_memory_stats",
    "collective_groups": "parses XLA's HLO; the port's collectives are "
                         "explicit torch.distributed calls (parallel/tp.py)",
    "assert_pod_collective_layout": "parses XLA's HLO for a TPU pod",
    "assert_collective_compute_overlap": "parses XLA's HLO schedule; on "
                                         "the card overlap shows in a "
                                         "torch.profiler trace",
    "tpu_aot_mesh": "compiles ahead of time for a TPU topology",
    "fold_shard_key": "folds a jax.random key; the port folds a "
                      "torch.Generator: parallel.fold_shard_generator",
    "state_specs": "PartitionSpecs of a flax TrainState; the port shards "
                   "per parameter: parallel.tp_param_spec, shard_tp_params",
    "TrainState": "flax's train state; the port keeps the module and its "
                  "optimizer (train.make_train_step, make_optimizer)",
    "create_train_state": "builds a TrainState; the port's "
                          "train.make_train_step builds the optimizer "
                          "(train.make_optimizer)",
}
SUBPACKAGES = ("", ".ops", ".functional", ".modules", ".models", ".train",
               ".parallel", ".util")


def _exports(mod):
    """A module's public names: ``__all__``, or its public attributes
    that are not submodules."""
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in dir(mod) if not n.startswith("_") and
                 not isinstance(getattr(mod, n), types.ModuleType)]
    return set(names)


@pytest.mark.parametrize("sub", SUBPACKAGES,
                         ids=[s.strip(".") or "top" for s in SUBPACKAGES])
def test_every_export_is_ported_or_named(sub):
    """Every name a subpackage of the JAX package exports exists in the
    port's counterpart, or stands in ``NOT_PORTED`` with its reason; a
    name there is one the port really lacks.  Exported constants (numbers
    and strings, such as ``ops.GROUP``) have JAX's values."""
    import importlib

    jmod = importlib.import_module("fewbit_tpu" + sub)
    theirs = _exports(jmod)
    ours = importlib.import_module("fewbit_tpu_torch" + sub)
    missing = {n for n in theirs if not hasattr(ours, n)}
    assert missing <= set(NOT_PORTED), missing - set(NOT_PORTED)
    assert not {n for n in theirs & set(NOT_PORTED) if hasattr(ours, n)}
    for n in theirs - missing:
        if isinstance(getattr(jmod, n), (int, float, str)):
            assert getattr(ours, n) == getattr(jmod, n), n


def test_not_ported_names_are_the_jax_packages():
    import importlib

    exported = set().union(*(_exports(importlib.import_module(
        "fewbit_tpu" + sub)) for sub in SUBPACKAGES))
    assert set(NOT_PORTED) <= exported
    assert all(reason for reason in NOT_PORTED.values())


def _glue_stand_ins(monkeypatch):
    """``datasets`` and ``transformers`` modules that record the calls
    made to them; the dataset's ``map`` applies the function to a
    two-example batch."""
    calls = []

    class Tokenizer:
        def __call__(self, a, b, **kw):
            calls.append(("tokenize", list(a), list(b), kw))
            return {"input_ids": [[len(x), len(y)] for x, y in zip(a, b)],
                    "attention_mask": [[1, 1] for _ in a]}

    class AutoTokenizer:
        @staticmethod
        def from_pretrained(name, **kw):
            calls.append(("tokenizer", name, kw))
            return Tokenizer()

    class Dataset:
        batch = {"sentence1": ["a cat", "dogs bark"],
                 "sentence2": ["a feline", "hounds"], "label": [1, 0]}

        def map(self, fn, **kw):
            calls.append(("map", kw))
            return {**self.batch, **fn(self.batch)}

    def load_dataset(*args, **kw):
        calls.append(("load_dataset", args, kw))
        return Dataset()

    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(
        load_dataset=load_dataset))
    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        AutoTokenizer=AutoTokenizer))
    return calls


@pytest.mark.parametrize("kw", [{}, dict(split="validation",
                                         tokenizer_name="roberta-large",
                                         max_length=64, cache_dir="cache")],
                         ids=["defaults", "given"])
def test_load_glue_makes_jax_calls(monkeypatch, kw):
    """``load_glue`` with stand-in ``datasets`` and ``transformers``: the
    same calls with the same arguments as JAX's, and the same mapped
    result (nothing is downloaded)."""
    import inspect

    results = []
    for fn in (jdata.load_glue, data.load_glue):
        calls = _glue_stand_ins(monkeypatch)
        results.append((fn(**kw), calls))
    (want, want_calls), (got, got_calls) = results
    assert got_calls == want_calls
    assert got == want
    assert [c[0] for c in got_calls] == ["load_dataset", "tokenizer", "map",
                                         "tokenize"]
    assert got_calls[-1][-1]["padding"] == "max_length"
    assert (inspect.signature(data.load_glue)
            == inspect.signature(jdata.load_glue))
    with pytest.raises(KeyError):
        data.load_glue(task="sst2")


# ---------------------------------------------------------------------------
# lut.
# ---------------------------------------------------------------------------


def test_store_surface_matches_jax(tmp_path):
    ours, theirs = StepwiseStore(), jlut.StepwiseStore()
    assert len(ours) == len(theirs) > 0
    assert ("gelu", 3) in ours and ("gelu", 9) not in ours
    assert repr(ours) == repr(theirs) == f"StepwiseStore(entries={len(ours)})"
    mine = dict(ours.items())
    assert list(mine) == [k for k, _ in theirs.items()]
    for key, (borders, levels) in theirs.items():
        np.testing.assert_array_equal(mine[key][0], borders)
        np.testing.assert_array_equal(mine[key][1], levels)
    ours.add("custom", 1, [-1.0, 0.0, 1.0], [0.25, 0.75])
    path = tmp_path / "all.npz"
    ours.save(path)
    back = jlut.StepwiseStore()
    back.load(path)
    assert ("custom", 1) in back and len(back) == len(ours)
    np.testing.assert_array_equal(back.get("custom", 1)[1], [0.25, 0.75])
    with pytest.raises(KeyError, match="fewbit-tpu-torch quantize 5"):
        ours.get("gelu", 5)


# ---------------------------------------------------------------------------
# approx.
# ---------------------------------------------------------------------------


def _gelu(x):
    from scipy.special import erf
    return 0.5 * x * (1.0 + erf(x / np.sqrt(2.0)))


def _gelu_grad(x):
    from scipy.special import erf
    return 0.5 * (1.0 + erf(x / np.sqrt(2.0))) + x * np.exp(
        -0.5 * x ** 2) / np.sqrt(2.0 * np.pi)


@pytest.mark.parametrize("case", [dict(cardinality=8, parity=False,
                                       domain=(-100.0, 100.0)),
                                  dict(cardinality=4, parity=True,
                                       domain=(0.0, 100.0))],
                         ids=["gelu3", "gelu_parity"])
def test_approximate_matches_jax(case):
    kw = dict(fn=_gelu_grad, fn_prim=_gelu, max_iters=2000, beps=1e-6,
              leps=1e-6, random_state=42, **case)
    ours, info = approx.approximate(**kw)
    theirs, jinfo = japprox.approximate(**kw)
    assert info == jinfo and info["status"] == "converged"
    np.testing.assert_array_equal(ours.borders, theirs.borders)
    np.testing.assert_array_equal(ours.levels, theirs.levels)
    assert ours.pretty() == theirs.pretty() and repr(ours) == repr(theirs)
    err, per = approx.estimate_error(_gelu_grad, ours)
    jerr, jper = japprox.estimate_error(_gelu_grad, theirs)
    assert err == jerr
    np.testing.assert_array_equal(per, jper)


def test_dp_quantize_and_stepwise_match_jax():
    ours = approx.dp_quantize(_gelu_grad, 8, domain=(-12.0, 12.0),
                              lattice=256)
    theirs = japprox.dp_quantize(_gelu_grad, 8, domain=(-12.0, 12.0),
                                 lattice=256)
    np.testing.assert_array_equal(ours.borders, theirs.borders)
    np.testing.assert_array_equal(ours.levels, theirs.levels)
    xs = np.random.RandomState(0).randn(1000) * 4
    np.testing.assert_array_equal(ours(xs), theirs(xs))
    np.testing.assert_array_equal(ours.codes(xs), theirs.codes(xs))
    with pytest.raises(ValueError):
        approx.Stepwise(np.zeros(3), np.zeros(3))
    with pytest.raises(ValueError):
        approx.approximate(_gelu_grad, _gelu, 4, domain=(-1.0, 1.0),
                           parity=True)


# ---------------------------------------------------------------------------
# cli.
# ---------------------------------------------------------------------------


def test_cli_version_help_usage(capsys):
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == (
        f"fewbit-tpu-torch {fewbit_tpu_torch.__version__}")
    assert cli.main([]) == 0
    assert cli.main(["help"]) == 0
    assert "quantize" in capsys.readouterr().out
    assert cli.main(["help", "quantize"]) == 0
    out = capsys.readouterr().out
    assert "nobits" in out and "torch.nn.functional:gelu" in out


QUANTIZE = ["-s", "1", "-M", "4000"]


def test_cli_quantize_matches_jax(tmp_path):
    """``tanh`` (torch's and jax.numpy's compute it alike): the same keys
    in the archive, borders and levels equal to rounding; a second entry
    merges into it, and the port's store loads it."""
    ours, theirs = tmp_path / "ours.npz", tmp_path / "theirs.npz"
    assert cli.main(["quantize", "1", "torch:tanh", "-o", str(ours)]
                    + QUANTIZE) == 0
    assert jcli.main(["quantize", "1", "jax.numpy:tanh", "-o", str(theirs)]
                     + QUANTIZE) == 0
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) == ["tanh01-borders",
                                                      "tanh01-levels"]
        for key in a.files:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-9, atol=1e-12)
    assert cli.main(["quantize", "2", "torch.nn.functional:silu", "-o",
                     str(ours), "-s", "3", "-M", "4000"]) == 0
    store = StepwiseStore()
    store.load(ours)
    assert store.get_interior("silu", 2)[0].size == 3
    assert store.get_interior("tanh", 1)[1].size == 2


def test_cli_log_output_and_failure(tmp_path):
    log = tmp_path / "quantize.log"
    # Seeded: an unseeded start converges within two iterations for a few
    # seeds in a hundred, and exits 0.  Seed 0 does not converge.
    assert cli.main(["--log-output", str(log), "quantize", "1",
                     "torch:tanh", "-M", "2", "-s", "0"]) == 1
    text = log.read_text()
    assert "running quantizer: 1 bits" in text
    assert "failed to converge in 1 iterations" in text
    assert cli.main(["--log-output", str(log), "--log-level", "error",
                     "version"]) == 0


def test_python_m_entry_point():
    out = subprocess.run([sys.executable, "-m", "fewbit_tpu_torch",
                          "version"], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    assert out.startswith("fewbit-tpu-torch ")


# ---------------------------------------------------------------------------
# metrics: the cases of tests/test_metrics.py, held to the JAX package's.
# ---------------------------------------------------------------------------


def _write_run(mod, root, param, task, records):
    with mod.MetricsLogger(root / param / task, task=task,
                           param=param) as ml:
        for step, tag, value in records:
            ml.log(step, **{tag: value})


RUNS = [("gelu3", "mrpc", [(1, "train/loss", 0.9), (10, "eval/accuracy", 0.81),
                          (20, "eval/accuracy", 0.86)]),
        ("exact", "mrpc", [(10, "eval/accuracy", 0.88)]),
        ("exact", "cola", [(10, "eval/matthews_correlation", 0.55)])]


def test_metrics_match_jax(tmp_path):
    for mod, root in ((metrics, tmp_path / "ours"),
                      (jmetrics, tmp_path / "theirs")):
        for param, task, records in RUNS:
            _write_run(mod, root, param, task, records)
    assert (metrics.read_run(tmp_path / "ours" / "gelu3" / "mrpc")
            == jmetrics.read_run(tmp_path / "theirs" / "gelu3" / "mrpc"))
    rows = metrics.summarize(tmp_path / "ours")
    assert rows == jmetrics.summarize(tmp_path / "theirs")
    assert {(r["param"], r["task"]): r["value"] for r in rows} == {
        ("gelu3", "mrpc"): 0.86, ("exact", "mrpc"): 0.88,
        ("exact", "cola"): 0.55}
    assert metrics.pivot(rows) == jmetrics.pivot(rows)
    for fmt in ("to_markdown", "to_latex", "to_csv"):
        assert getattr(metrics, fmt)(rows) == getattr(jmetrics, fmt)(rows)
    assert "—" in metrics.to_markdown(rows)
    d = tmp_path / "bare" / "rand20" / "sst2"
    d.mkdir(parents=True)
    (d / "metrics.jsonl").write_text(json.dumps(
        {"step": 5, "tag": "eval/accuracy", "value": 0.9}) + "\n")
    assert metrics.summarize(tmp_path / "bare") == [
        {"task": "sst2", "param": "rand20", "metric": "eval/accuracy",
         "value": 0.9}]


# ---------------------------------------------------------------------------
# train/data: the cases of tests/test_data.py, held to the JAX package's.
# ---------------------------------------------------------------------------


def _equal_splits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_tokenized_npz_and_epochs_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "mrpc.npz"
    np.savez(path,
             train_input_ids=rng.randint(0, 100, (10, 16)).astype(np.int32),
             train_attention_mask=np.ones((10, 16), np.int32),
             train_labels=rng.randint(0, 2, (10,)).astype(np.int32),
             validation_input_ids=rng.randint(0, 100, (4, 16)).astype(
                 np.int32),
             validation_attention_mask=np.ones((4, 16), np.int32),
             validation_labels=rng.randint(0, 2, (4,)).astype(np.int32))
    ours, theirs = data.load_tokenized_npz(path), jdata.load_tokenized_npz(
        path)
    assert sorted(ours) == ["train", "validation"]
    for split in ours:
        _equal_splits(ours[split], theirs[split])
    a = data.batches_from_arrays(ours["train"], 4, seed=1)
    b = jdata.batches_from_arrays(theirs["train"], 4, seed=1)
    for _ in range(5):
        _equal_splits(next(a), next(b))
    bad = tmp_path / "bad.npz"
    np.savez(bad, train_input_ids=np.ones((2, 4), np.int32))
    with pytest.raises(ValueError):
        data.load_tokenized_npz(bad)


def test_real_text_sources_match_jax():
    text = data.real_text_corpus(max_bytes=64 * 1024)
    assert text == jdata.real_text_corpus(max_bytes=64 * 1024)
    assert len(text) == 64 * 1024
    train, val = data.byte_lm_arrays(text, seq_len=32, val_fraction=0.25)
    jtrain, jval = jdata.byte_lm_arrays(text, seq_len=32, val_fraction=0.25)
    np.testing.assert_array_equal(train, jtrain)
    np.testing.assert_array_equal(val, jval)
    _equal_splits(next(data.byte_lm_batches(train, 8)),
                  next(jdata.byte_lm_batches(jtrain, 8)))
    docs = data.real_text_documents()
    assert docs == jdata.real_text_documents() and len(docs) >= 2
    for ours, theirs in zip(data.real_pair_arrays(docs, seq_len=64),
                            jdata.real_pair_arrays(docs, seq_len=64)):
        _equal_splits(ours, theirs)
    ours, jours = (data.real_doc_arrays(docs, seq_len=64),
                   jdata.real_doc_arrays(docs, seq_len=64))
    assert ours[2] == jours[2] >= 2
    for a, b in zip(ours[:2], jours[:2]):
        _equal_splits(a, b)


@pytest.fixture
def jax_codec_fallback(monkeypatch):
    """The JAX package's codec on its numpy/jnp fallback, so that this file
    never builds the JAX package's ``.so`` (which its own tests build, in
    another process)."""
    monkeypatch.setattr(jnative, "_TRIED", True)
    monkeypatch.setattr(jnative, "_LIB", None)


def test_token_archive_round_trips_with_jax(tmp_path, jax_codec_fallback):
    rng = np.random.RandomState(3)
    splits = {"train": {"input_ids": rng.randint(0, 50265, (6, 20)),
                        "labels": rng.randint(-100, 5, (6, 20))},
              "val": {"input_ids": rng.randint(0, 259, (3, 20))}}
    ours, theirs = tmp_path / "ours.npz", tmp_path / "theirs.npz"
    data.save_token_archive(ours, splits)
    jdata.save_token_archive(theirs, splits)
    for path in (ours, theirs):
        for load in (data.load_token_archive, jdata.load_token_archive):
            back = load(path)
            for split, fields in splits.items():
                for k, v in fields.items():
                    assert back[split][k].dtype == np.int32
                    np.testing.assert_array_equal(back[split][k], v)
    with pytest.raises(ValueError, match="must not contain"):
        data.save_token_archive(tmp_path / "x.npz", {"a.b": {"f": np.ones(2,
                                                                     int)}})


# ---------------------------------------------------------------------------
# native: the JAX package's flat, strided plane layout.
# ---------------------------------------------------------------------------


def test_native_builds_into_the_port():
    assert native.available(), "g++ toolchain expected"
    assert (REPO / "fewbit_tpu_torch" / "_native" /
            "libfewbit_host.so").exists()


@pytest.mark.parametrize("bits", [1, 3, 4])
@pytest.mark.parametrize("n", [1, 31, 32, 1000, 4096])
def test_plane_pack_matches_jax(monkeypatch, jax_codec_fallback, bits, n):
    """``plane_pack`` from the port's ``.so`` and from its numpy fallback
    (``FEWBIT_TPU_NATIVE=0``) equal JAX's ``pack_codes`` (and the JAX
    codec's fallback) bit for bit, and unpack back."""
    codes = np.random.RandomState(bits + n).randint(
        0, 1 << bits, size=n).astype(np.uint32)
    want = np.asarray(jax_pack_codes(jnp.asarray(codes), bits))
    got = native.plane_pack(codes, bits)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jnative.plane_pack(codes, bits), want)
    np.testing.assert_array_equal(native.plane_unpack(got, bits, n), codes)
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "0")
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    assert not native.available()
    np.testing.assert_array_equal(native.plane_pack(codes, bits), want)
    np.testing.assert_array_equal(native.plane_unpack(want, bits, n), codes)


@pytest.mark.parametrize("fallback", [False, True], ids=["so", "numpy"])
def test_stream_and_packed_files(monkeypatch, tmp_path, jax_codec_fallback,
                                 fallback):
    if fallback:
        monkeypatch.setenv("FEWBIT_TPU_NATIVE", "0")
        monkeypatch.setattr(native, "_TRIED", False)
        monkeypatch.setattr(native, "_LIB", None)
    rng = np.random.RandomState(9)
    for width in (1, 3, 17, 32):
        hi = (1 << width) if width < 32 else (1 << 32)
        codes = rng.randint(0, hi, size=97, dtype=np.uint64).astype(
            np.uint32)
        stream = native.stream_pack(codes, width)
        np.testing.assert_array_equal(stream,
                                      jnative.stream_pack(codes, width))
        np.testing.assert_array_equal(native.stream_unpack(stream, 97,
                                                           width), codes)
    codes = rng.randint(0, 8, size=(33, 17)).astype(np.uint32)
    native.save_packed(tmp_path / "c.npz", codes, 3)
    np.testing.assert_array_equal(jnative.load_packed(tmp_path / "c.npz"),
                                  codes)
    np.testing.assert_array_equal(native.load_packed(tmp_path / "c.npz"),
                                  codes)
