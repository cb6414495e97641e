"""Models with few-bit config switches."""

from fewbit_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM, GPTModel
from fewbit_tpu_torch.models.mlp import MLP
from fewbit_tpu_torch.models.roberta import (
    RobertaConfig, RobertaForSequenceClassification, RobertaModel,
    flax_param_pairs, load_flax_params)

__all__ = ("GPTConfig", "GPTForCausalLM", "GPTModel", "MLP", "RobertaConfig",
           "RobertaForSequenceClassification", "RobertaModel",
           "flax_param_pairs", "load_flax_params")
