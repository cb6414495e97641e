"""When the models take the flash-attention op: the counterpart of
``fewbit_tpu/models/flash.py``.

The rules are the JAX package's, with the device type ``"cuda"`` in place
of the backend ``"tpu"``:

* ``False``/``None`` -- never;
* ``True`` -- always: the CUDA kernels on a CUDA tensor, their plain
  versions on the CPU (the JAX package keeps its standard path off the TPU;
  the port runs the flash op everywhere, so the CPU tests reach it);
* ``"auto"`` -- on a CUDA device only, at ``seq_len >= FLASH_AUTO_MIN_SEQ``,
  where :func:`auto_blocks` finds a 128-aligned block, where no attention
  dropout would be applied (``attention_dropout == 0`` or a
  ``deterministic`` call), and where the head dimension is one the flash
  kernels take (``FLASH_HEAD_DIMS``: every d from 1 to 128 and every
  multiple of 128 above it, as JAX's TPU kernels take them): at any other
  ``"auto"`` keeps the standard attention, and only ``True`` reaches a
  kernel that refuses the call.

The threshold of 1024 and the 128-alignment rule are the JAX package's TPU
findings, kept as written so that the port takes the reference's paths;
they wait for the H100's own crossover (ROADMAP, "re-measure on H100").
The TPU block table (``TUNED_BLOCKS``, ``resolve_block_sizes``) is not
ported: the CUDA kernels choose their own tiles, so a config's
``flash_blocks`` is accepted for parity and not read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fewbit_tpu_torch.ops.kernels import FLASH_HEAD_DIMS

__all__ = ("FLASH_AUTO_MIN_SEQ", "validate_flash_setting",
           "validate_flash_config", "auto_blocks", "use_flash")

FLASH_AUTO_MIN_SEQ = 1024
_MAX_AUTO_BLOCK = 1024


def validate_flash_setting(setting) -> None:
    """Reject anything but False/None/True/"auto", at config construction."""
    if setting not in (True, False, None, "auto"):
        raise ValueError(
            f"flash_attention must be True, False, or 'auto'; "
            f"got {setting!r}")


def validate_flash_config(cfg) -> None:
    """The model configs' check: a valid setting, and no ``True`` with
    attention dropout (the flash op never forms the probabilities)."""
    validate_flash_setting(cfg.flash_attention)
    if cfg.flash_attention is True and cfg.attention_dropout > 0:
        raise ValueError(
            "flash_attention=True cannot apply attention dropout (the "
            "flash kernel never materialises attention probabilities); "
            "set attention_dropout=0.0 explicitly to opt in, or use "
            "flash_attention='auto' to keep the standard path when "
            "dropout is on")


def auto_blocks(seq_len: int) -> Optional[Tuple[int, int]]:
    """The largest multiple of 128 that is at most 1024 and divides
    ``seq_len``, as ``(block, block)``; None when there is none."""
    start = (min(_MAX_AUTO_BLOCK, seq_len) // 128) * 128
    for b in range(start, 0, -128):
        if seq_len % b == 0:
            return (b, b)
    return None


def use_flash(setting, seq_len: int, attention_dropout: float, device,
              deterministic: bool = False,
              head_dim: Optional[int] = None) -> bool:
    """Resolve a ``flash_attention`` setting for one call on ``device``.
    ``head_dim`` is the model's head dimension (None: not checked)."""
    validate_flash_setting(setting)
    if setting is False or setting is None:
        return False
    if setting is True:
        return True
    if torch.device(device).type != "cuda":
        return False
    return ((deterministic or attention_dropout == 0.0)
            and (head_dim is None or head_dim in FLASH_HEAD_DIMS)
            and seq_len >= FLASH_AUTO_MIN_SEQ
            and auto_blocks(seq_len) is not None)
