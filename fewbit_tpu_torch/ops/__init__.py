"""Kernels, their plain versions, the packed-code layout and the
activation pieces."""

from fewbit_tpu_torch.ops.bitpack import (  # noqa: F401
    GROUP, pack_codes, packed_nbytes, packed_num_words, unpack_codes)
from fewbit_tpu_torch.ops.activations import (  # noqa: F401
    ActivationSpec, apply_lut, fewbit_activation, quantize_codes)
