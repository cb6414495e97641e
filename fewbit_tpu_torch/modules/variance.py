"""Variance-estimator wrapper module, as ``fewbit_tpu/modules/variance.py``.

Wraps a sketched linear layer and reports, per training step, the
input/gradient correlation and the SGD-vs-RMM gradient variances, so that
a compression ratio can be chosen where the sketch noise is dominated by
the mini-batch noise.

The state keeps the layer's input ``x`` and the gradient of its output.
The JAX module records its output in place of ``x`` when it runs eagerly
(ROADMAP queue 3, F-6); this one always records ``x``, the operand of the
weight gradient the estimates describe.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from fewbit_tpu_torch.functional.linear import calc_proj_dim
from fewbit_tpu_torch.functional.variance import (GradientStorage,
                                                  _CatchGradient,
                                                  estimate_correlation,
                                                  estimate_variance_rmm,
                                                  estimate_variance_sgd)

__all__ = ("VarianceEstimatorState", "VarianceEstimator")


class VarianceEstimatorState(GradientStorage):
    """Computes the variance statistics once both the layer input and its
    output gradient have been captured (on their device; one host sync)."""

    def __init__(self, callback: Optional[Callable] = None):
        super().__init__()
        self.callback = callback
        self.step = 0
        self.variance = None
        self.batch_size = None
        self.proj_dim = None

    def set_batch_size(self, batch_size: int, proj_dim: int) -> None:
        self.batch_size = batch_size
        self.proj_dim = proj_dim

    def postprocess(self) -> None:
        if self.input is None or self.grad_output is None:
            return
        x = self.input.reshape(-1, self.input.shape[-1])
        g = self.grad_output.reshape(-1, self.grad_output.shape[-1])
        corr, var_sgd, var_rmm = torch.stack([
            estimate_correlation(x, g),
            estimate_variance_sgd(x, g, self.batch_size),
            estimate_variance_rmm(x, g, self.proj_dim)]).tolist()
        if callable(self.callback):
            self.callback(corr, var_sgd, var_rmm, self.step)
        self.step += 1
        self.variance = (corr, var_sgd, var_rmm)


class VarianceEstimator(nn.Module):
    """Wraps a sketched layer; captures its input and output gradient.

    ``layer`` must expose the ``proj_dim*`` attributes of
    :class:`fewbit_tpu_torch.modules.RandomizedDense`; extra arguments of
    ``forward`` (the sketch generator) pass through to it.  Statistics are
    ready after the backward: read ``state.variance`` or take them in the
    ``callback``.
    """

    def __init__(self, layer: nn.Module,
                 state: Optional[VarianceEstimatorState] = None):
        super().__init__()
        self.layer = layer
        self.state = state

    def forward(self, x: torch.Tensor, *args, **kwargs):
        state = self.state
        if state is not None:
            bs = int(np.prod(x.shape[:-1]))
            proj = calc_proj_dim(bs, self.layer.proj_dim_ratio,
                                 self.layer.proj_dim,
                                 self.layer.proj_dim_max,
                                 self.layer.proj_dim_min)
            state.set_batch_size(bs, proj)
            state.record_input(x.detach())
        out = self.layer(x, *args, **kwargs)
        if state is not None:
            # The gradient of the output only: the input recorded is x.
            if isinstance(out, tuple):
                return (_CatchGradient.apply(out[0], state), *out[1:])
            return _CatchGradient.apply(out, state)
        return out
