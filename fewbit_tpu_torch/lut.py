"""Registry of stepwise derivative LUTs (borders + levels) per activation.

The PyTorch counterpart of ``fewbit_tpu/lut.py``: the store holds plain
numpy arrays keyed by ``(name, bits)``.  The builtin LUTs are read, by file
path and with numpy alone, from the JAX package's
``fewbit_tpu/data/builtin.npz``, which stays the one copy of the data.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

__all__ = ("StepwiseStore", "store", "BUILTIN_PATH")

BUILTIN_PATH = (Path(__file__).resolve().parent.parent / "fewbit_tpu"
                / "data" / "builtin.npz")


class StepwiseStore:
    """Maps ``(name, bits)`` to ``(borders, levels)`` float32 numpy arrays.

    ``borders`` includes the outer domain edges (``len(levels) + 1``
    entries); :meth:`get_interior` gives the ``len(levels) - 1`` interior
    borders the codes are compared against.
    """

    def __init__(self) -> None:
        self._table: Dict[Tuple[str, int], Tuple[np.ndarray, np.ndarray]] = {}
        self._builtin_loaded = False

    def _ensure_builtin(self) -> None:
        if not self._builtin_loaded:
            self._builtin_loaded = True
            if BUILTIN_PATH.exists():
                self.load(BUILTIN_PATH)

    def add(self, name: str, bits: int, borders: np.ndarray,
            levels: np.ndarray) -> None:
        borders = np.asarray(borders, dtype=np.float32)
        levels = np.asarray(levels, dtype=np.float32)
        if borders.size != levels.size + 1:
            raise ValueError(
                f"expected len(borders) == len(levels) + 1 for {name!r}, got "
                f"{borders.size} vs {levels.size}")
        self._table[(name, bits)] = (borders, levels)

    def get(self, name: str, bits: int) -> Tuple[np.ndarray, np.ndarray]:
        self._ensure_builtin()
        try:
            return self._table[(name, bits)]
        except KeyError:
            raise KeyError(
                f"no {bits}-bit derivative quantisation for activation "
                f"{name!r}; pass explicit borders/values") from None

    def get_interior(self, name: str,
                     bits: int) -> Tuple[np.ndarray, np.ndarray]:
        borders, levels = self.get(name, bits)
        return borders[1:-1], levels

    def load(self, path) -> None:
        """Merge ``{name}{bits:02d}-{borders|levels}`` arrays from an npz."""
        with np.load(path) as npz:
            stems = {key.rsplit("-", 1)[0] for key in npz.files}
            for stem in sorted(stems):
                name, bits = stem[:-2], int(stem[-2:])
                self.add(name, bits, npz[f"{stem}-borders"],
                         npz[f"{stem}-levels"])


store = StepwiseStore()
