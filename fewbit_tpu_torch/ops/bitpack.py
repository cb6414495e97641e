"""The port's packed-code layout, with a plain pack and unpack.

Codes of an ``(N, M)`` tensor (values in ``[0, 2**bits)``) pack into
``(bits, ceil(N / 32), M)`` 32-bit words: bit ``i`` of word ``[b, w, m]`` is
bit ``b`` of the code of row ``32 w + i``, column ``m``.  The layout depends
on no block size, costs ``bits / 8`` bytes per element, and is what the
CUDA kernels write: with one ``__ballot_sync`` per bit plane where a warp
holds 32 rows of one column, and as the words' 16-bit halves where it holds
16 (the fragment of a tensor-core product).  Words are ``int32`` tensors: PyTorch's ``uint32``
has few CPU ops, and the bitwise ops are the same.  Rows past ``N`` in the
last word are zero.
"""

from __future__ import annotations

import torch

__all__ = ("GROUP", "packed_shape", "packed_num_words", "packed_nbytes",
           "pack_codes", "unpack_codes")

GROUP = 32  # rows whose codes share one word per bit plane


def packed_shape(n: int, m: int, bits: int):
    return (bits, packed_num_words(n, bits), m)


def packed_num_words(n: int, bits: int) -> int:
    """Words per plane for ``n`` codes: one column of the layout (the JAX
    package's count of a flat code vector)."""
    return -(-n // GROUP)


def packed_nbytes(n: int, bits: int) -> int:
    """Bytes of the packed codes of ``n`` elements in one column."""
    return packed_num_words(n, bits) * bits * 4


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack integer ``codes`` of shape ``(N, M)`` into the word layout."""
    if codes.ndim != 2:
        raise ValueError(f"pack_codes expects (N, M) codes, got "
                         f"{tuple(codes.shape)}")
    n, m = codes.shape
    words = -(-n // GROUP)
    c = codes.to(torch.int64)
    if words * GROUP != n:
        c = torch.cat([c, c.new_zeros(words * GROUP - n, m)])
    c = c.reshape(words, GROUP, m)
    shift = torch.arange(GROUP, device=codes.device).view(1, GROUP, 1)
    planes = []
    for b in range(bits):
        # Disjoint bits: the sum is the bitwise OR.  Wrap to int32.
        word = (((c >> b) & 1) << shift).sum(dim=1)
        planes.append(torch.where(word >= 2 ** 31, word - 2 ** 32, word))
    return torch.stack(planes).to(torch.int32)


def unpack_codes(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: the ``(n, M)`` int32 codes."""
    if packed.ndim != 3 or packed.shape[0] != bits:
        raise ValueError(f"expected packed shape (bits={bits}, words, M), "
                         f"got {tuple(packed.shape)}")
    words, m = packed.shape[1], packed.shape[2]
    shift = torch.arange(GROUP, device=packed.device,
                         dtype=torch.int32).view(1, GROUP, 1)
    codes = torch.zeros(words, GROUP, m, dtype=torch.int32,
                        device=packed.device)
    for b in range(bits):
        bit = (packed[b].unsqueeze(1) >> shift) & 1
        codes |= bit << b
    return codes.reshape(words * GROUP, m)[:n]
