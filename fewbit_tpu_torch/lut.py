"""Registry of stepwise derivative LUTs (borders + levels) per activation.

The PyTorch counterpart of ``fewbit_tpu/lut.py``: the store holds plain
numpy arrays keyed by ``(name, bits)``.  The builtin LUTs are read, by file
path and with numpy alone, from the JAX package's
``fewbit_tpu/data/builtin.npz``, which stays the one copy of the data.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Tuple

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

    def __len__(self) -> int:
        self._ensure_builtin()
        return len(self._table)

    def __contains__(self, key: Tuple[str, int]) -> bool:
        self._ensure_builtin()
        return key in self._table

    def __repr__(self) -> str:
        return f"StepwiseStore(entries={len(self)})"

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
                f"{name!r}; run `fewbit-tpu-torch quantize {bits} "
                f"<module:func>` or pass explicit borders/values") from None

    def get_interior(self, name: str,
                     bits: int) -> Tuple[np.ndarray, np.ndarray]:
        borders, levels = self.get(name, bits)
        return borders[1:-1], levels

    def items(self) -> Iterator[Tuple[Tuple[str, int],
                                      Tuple[np.ndarray, np.ndarray]]]:
        self._ensure_builtin()
        yield from self._table.items()

    def load(self, path) -> None:
        """Merge ``{name}{bits:02d}-{borders|levels}`` arrays from an npz."""
        with np.load(path) as npz:
            stems = {key.rsplit("-", 1)[0] for key in npz.files}
            for stem in sorted(stems):
                name, bits = stem[:-2], int(stem[-2:])
                self.add(name, bits, npz[f"{stem}-borders"],
                         npz[f"{stem}-levels"])

    def save(self, path) -> None:
        """Write every entry, the builtin ones included, as
        ``{name}{bits:02d}-{borders|levels}`` arrays of an npz."""
        self._ensure_builtin()
        arrays = {}
        for (name, bits), (borders, levels) in self._table.items():
            arrays[f"{name}{bits:02d}-borders"] = borders
            arrays[f"{name}{bits:02d}-levels"] = levels
        np.savez(path, **arrays)


store = StepwiseStore()
