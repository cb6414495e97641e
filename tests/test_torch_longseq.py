"""The long-sequence tool (``fewbit_tpu_torch.tools.bench_longseq``)
against the JAX package's ``tools/bench_longseq.py``, on the CPU.

The JAX tool is loaded by its path.  Its flags and ``CONFIGS`` are read
from it, and each row's model config, training config and batch from its
``build``, stopped at ``create_train_state`` before anything compiles.
The twin's rows run at two layers and narrow widths on the plain
versions.
"""

import ast
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fewbit_tpu_torch.tools import bench_longseq as twin

REPO = Path(__file__).resolve().parent.parent
JAX_TOOL = REPO / "tools" / "bench_longseq.py"
# Two layers at narrow widths, for the rows on the CPU.
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128)
FAMILIES = {"gpt": ("2", "64"), "roberta": ("4", "32")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_bench_longseq",
                                                  JAX_TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _flags(path):
    """Every ``add_argument`` of a script: flag -> its keyword arguments
    that are literals."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            kw = {}
            for k in node.keywords:
                try:
                    kw[k.arg] = ast.literal_eval(k.value)
                except ValueError:
                    kw[k.arg] = None
            out[node.args[0].value] = kw
    return out


def test_flags_and_configs_match_jax_tool(jax_tool):
    """The JAX tool's flags with their defaults and choices, plus
    ``--device``; its four configurations and its loop length."""
    ours = _flags(Path(twin.__file__))
    theirs = _flags(JAX_TOOL)
    assert set(ours) == set(theirs) | {"--device"}
    for flag, kw in theirs.items():
        for key in ("default", "choices", "action", "type"):
            if key in kw and kw[key] is not None:
                assert ours[flag].get(key) == kw[key], (flag, key)
    assert ours["--dtype"]["default"] == "f32"
    assert set(twin.DTYPES) == {"f32", "bf16"}
    assert ours["--device"]["default"] == "cuda"
    assert twin.CONFIGS == jax_tool.CONFIGS
    assert twin.LOOP_ITERS == jax_tool.LOOP_ITERS


class _Stop(Exception):
    pass


def _jax_build(jax_tool, monkeypatch, family, batch, seq, c):
    """What the JAX tool's ``build`` hands to ``create_train_state``:
    (model config, training config, batch), before it compiles."""
    import fewbit_tpu.train as jtrain

    def stop(model, cfg, data):
        raise _Stop(model.cfg, cfg, data)

    monkeypatch.setattr(jtrain, "create_train_state", stop)
    with pytest.raises(_Stop) as caught:
        jax_tool.build(family, batch, seq, c["bits"], c["ratio"], c["flash"],
                       jnp.float32)
    return caught.value.args


@pytest.mark.parametrize("name", list(twin.CONFIGS))
@pytest.mark.parametrize("family", ["gpt", "roberta"])
def test_row_builder_matches_jax_build(jax_tool, monkeypatch, family, name):
    """Each configuration: the model config's fields (at the full widths
    and the tool's sequence lengths) equal the JAX tool's, but the
    deliberate differences of the configs' own fields; the training
    config, the loss and the batch's arrays equal too."""
    from fewbit_tpu_torch.train import (TrainConfig, causal_lm_loss,
                                        classification_loss)

    batch, seq = (2, 2048) if family == "gpt" else (4, 2048)
    c = twin.CONFIGS[name]
    jcfg, jtrain_cfg, jdata = _jax_build(jax_tool, monkeypatch, family,
                                         batch, seq, c)
    cfg = twin.model_config(family, seq, c["bits"], c["ratio"], c["flash"],
                            torch.float32)
    theirs = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    ours = dataclasses.asdict(cfg)
    for key, value in theirs.items():
        if key in ("dtype", "flash_blocks") or key not in ours:
            continue
        assert ours[key] == value, key
    assert cfg.max_position_embeddings == (seq if family == "gpt"
                                           else seq + 2)
    # The training config, the loss and the batch: build's own, with a
    # stand-in model and step.
    captured = {}

    class Stand(torch.nn.Module):
        def __init__(self, cfg, device=None, generator=None):
            super().__init__()
            captured["cfg"] = cfg

    def make_train_step(model, train_cfg, loss_fn):
        captured.update(train_cfg=train_cfg, loss_fn=loss_fn)

    import fewbit_tpu_torch.models as models
    import fewbit_tpu_torch.train as train

    monkeypatch.setattr(models, "GPTForCausalLM", Stand)
    monkeypatch.setattr(models, "RobertaForSequenceClassification", Stand)
    monkeypatch.setattr(train, "make_train_step", make_train_step)
    _, _, data = twin.build(family, batch, seq, c["bits"], c["ratio"],
                            c["flash"], torch.float32, torch.device("cpu"))
    assert captured["cfg"] == cfg
    assert captured["loss_fn"] is (causal_lm_loss if family == "gpt"
                                   else classification_loss)
    assert dataclasses.asdict(captured["train_cfg"]) == {
        f.name: getattr(jtrain_cfg, f.name)
        for f in dataclasses.fields(jtrain_cfg)}
    assert captured["train_cfg"] == TrainConfig(total_steps=100,
                                                learning_rate=1e-5)
    assert sorted(data) == sorted(jdata)
    for key, value in jdata.items():
        np.testing.assert_array_equal(data[key].numpy(), np.asarray(value))


def _check_rows(out, family, timed):
    assert [r["config"] for r in out["rows"]] == list(twin.CONFIGS)
    assert out["family"] == family and out["dtype"] == "f32"
    for row in out["rows"]:
        assert np.isfinite(row["loss"])
        # On the CPU: the plain versions (no kernel launch), no peak.
        assert row["launches"] == {} and row["peak_bytes"] is None
        assert row["steps"] == 2 + (twin.TIMED_RUNS * twin.LOOP_ITERS
                                    if timed else 0)
        assert ("step_ms" in row) == timed
        if timed:
            assert row["step_ms"] > 0


@pytest.mark.parametrize("family", ["gpt", "roberta"])
def test_main_rows_on_the_cpu(family, capsys):
    """Four rows of a two-layer model; the last line printed is the object
    returned.  RoBERTa with ``--no-time``."""
    batch, seq = FAMILIES[family]
    timed = family == "gpt"
    argv = ["--family", family, "--batch", batch, "--seq", seq, "--device",
            "cpu"] + ([] if timed else ["--no-time"])
    out = twin.main(argv, overrides=TINY)
    assert (out["batch"], out["seq"]) == (int(batch), int(seq))
    _check_rows(out, family, timed)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == out


def test_oom_is_an_error_row(monkeypatch):
    """A configuration that runs out of device memory is a row of its own
    with the message's head; the others run."""
    build = twin.build

    def vanilla_oom(family, batch, seq, bits, ratio, flash, *args):
        if bits is None and not flash:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 768.00 MiB\nmore")
        return build(family, batch, seq, bits, ratio, flash, *args)

    monkeypatch.setattr(twin, "build", vanilla_oom)
    out = twin.main(["--seq", "32", "--device", "cpu", "--no-time",
                     "--configs", "vanilla,fewbit"], overrides=TINY)
    assert out["rows"][0] == {
        "config": "vanilla",
        "error": "OutOfMemoryError: CUDA out of memory. Tried to allocate "
                 "768.00 MiB"}
    assert out["rows"][1]["config"] == "fewbit"
    assert np.isfinite(out["rows"][1]["loss"])


def test_other_exceptions_propagate(monkeypatch):
    def broken(*args):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(twin, "build", broken)
    with pytest.raises(RuntimeError, match="failed to launch"):
        twin.main(["--seq", "32", "--device", "cpu"], overrides=TINY)


def test_usage_errors(monkeypatch):
    """Without a card and without ``--device cpu`` the tool stops; an
    unknown configuration too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        twin.main(["--seq", "32"])
    with pytest.raises(SystemExit):
        twin.main(["--device", "cpu", "--configs", "vanilla,flash"])
