"""Model surgery and memory introspection, as ``fewbit_tpu/util.py``.

Surgery: :func:`map_module` rewrites an ``nn.Module`` tree in place
(post-order, with an optional regex on the paths) and
:func:`convert_linear` swaps an ``nn.Linear`` (or the models' exact
``Dense``) for a sketched replacement holding the same ``weight`` and
``bias`` under the same ``state_dict`` keys, so existing parameters load
into the converted model unchanged.  Paths read as the JAX package's:
``"/"`` for the root, then ``"/" + name`` per level (``"/layers/0"`` for
an item of a ``ModuleList``), so one pattern selects the same layers in
both packages.

Introspection: the residuals of ``fn(*args)`` are the tensors autograd
saves for its backward, counted by running ``fn`` once under
``torch.autograd.graph.saved_tensors_hooks`` with every floating-point
argument a leaf that requires grad (``jax.vjp`` differentiates in all its
arguments).  The JAX package sizes them abstractly with ``jax.eval_shape``;
here ``fn`` runs for real.
"""

from __future__ import annotations

import contextlib
import re
from typing import Callable, Iterator, Optional, Tuple

import torch
from torch import nn

from fewbit_tpu_torch.modules.linear import Dense

__all__ = ("map_module", "convert_linear", "residual_shapes",
           "estimate_memory_usage", "memory_delta_bytes",
           "device_memory_stats", "peak_memory_bytes", "profile_trace")


# ---------------------------------------------------------------------------
# Surgery.
# ---------------------------------------------------------------------------


def _map_module(module: nn.Module, func, patt, path: str) -> nn.Module:
    for name, child in list(module.named_children()):
        mapped = _map_module(child, func, patt, f"{path}/{name}")
        if mapped is not child:
            setattr(module, name, mapped)
    if patt.match(path or "/"):
        module = func(module, path or "/")
        if not isinstance(module, nn.Module):
            raise ValueError("map_module callback must return a Module")
    return module


def map_module(root: nn.Module,
               func: Callable[[nn.Module, str], nn.Module],
               patt: Optional[str] = None) -> nn.Module:
    """Apply ``func(module, path)`` to every submodule (post-order) whose
    path matches ``patt``; a child that ``func`` replaces is set on its
    parent in place.  Returns ``root``, or ``func``'s replacement of it."""
    return _map_module(root, func, re.compile(patt or r".*"), "")


def convert_linear(module: nn.Module, ctor: Callable, **kwargs) -> nn.Module:
    """Rebuild an ``nn.Linear`` or a ``Dense`` as
    ``ctor(in_features, out_features, bias=..., dtype=..., device=...,
    **kwargs)`` (e.g. ``RandomizedDense``) holding the same ``weight`` and
    ``bias`` parameters.  Any other module passes through as itself.

    ``dtype`` is the compute dtype: a ``Dense``'s own, None for an
    ``nn.Linear`` (which has none: the new layer follows its input).
    """
    if not isinstance(module, (nn.Linear, Dense)):
        return module
    weight = module.weight
    out_features, in_features = weight.shape
    new = ctor(in_features, out_features, bias=module.bias is not None,
               dtype=getattr(module, "dtype", None), device=weight.device,
               **kwargs)
    new.weight = weight
    if module.bias is not None:
        new.bias = module.bias
    return new


# ---------------------------------------------------------------------------
# Introspection.
# ---------------------------------------------------------------------------


def _as_leaf(a):
    if isinstance(a, torch.Tensor) and a.is_floating_point():
        return a.detach().requires_grad_()
    return a


def _tensors(obj) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)


def _run_saving(fn: Callable, args):
    """``fn(*args)`` with floating-point arguments as leaves that require
    grad, and every tensor its backward saves, each once (by storage,
    offset and shape).  Returns ``(output, leaf args, saved)``."""
    saved = {}

    def pack(t):
        key = (t.untyped_storage().data_ptr(), t.storage_offset(),
               tuple(t.shape), t.dtype)
        saved.setdefault(key, t)
        return t

    leaves = [_as_leaf(a) for a in args]
    with torch.enable_grad(), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(*leaves)
    return out, leaves, list(saved.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def residual_shapes(fn: Callable,
                    *args) -> Iterator[Tuple[torch.Size, torch.dtype]]:
    """``(shape, dtype)`` of every tensor the backward of ``fn(*args)``
    keeps (``fn`` runs once)."""
    _, _, saved = _run_saving(fn, args)
    for t in saved:
        yield t.shape, t.dtype


def estimate_memory_usage(fn: Callable, *args, saved_only: bool = True) -> int:
    """Bytes of backward-pass residual storage for ``fn(*args)``.

    With ``saved_only=False`` the sizes of the inputs and outputs are added.
    """
    out, leaves, saved = _run_saving(fn, args)
    total = sum(_nbytes(t) for t in saved)
    if not saved_only:
        total += sum(_nbytes(t) for t in _tensors((leaves, out)))
    return total


def memory_delta_bytes(baseline_fn: Callable, fn: Callable, *args) -> int:
    """Residual-byte difference between two implementations of the same
    computation (e.g. exact vs few-bit activation)."""
    return (estimate_memory_usage(baseline_fn, *args)
            - estimate_memory_usage(fn, *args))


def _cuda_device(device) -> Optional[torch.device]:
    if device is None:
        return (torch.device("cuda", torch.cuda.current_device())
                if torch.cuda.is_available() else None)
    device = torch.device(device)
    return device if device.type == "cuda" else None


def device_memory_stats(device=None) -> dict:
    """The caching allocator's statistics for a CUDA device
    (``torch.cuda.memory_stats``); an empty dict for a CPU device, or when
    ``device`` is None and there is no card."""
    device = _cuda_device(device)
    return dict(torch.cuda.memory_stats(device)) if device is not None else {}


def peak_memory_bytes(device=None) -> Optional[int]:
    """Peak bytes allocated on a CUDA device since the process started or
    its peak was last reset (``torch.cuda.max_memory_allocated``); None on
    a CPU device."""
    device = _cuda_device(device)
    return (torch.cuda.max_memory_allocated(device)
            if device is not None else None)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` over the scope, with the memory timeline
    (``profile_memory=True``), the card's activity when there is one, and a
    TensorBoard trace written into ``logdir`` on exit.  Yields the
    profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, profile_memory=True,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        yield prof
