"""Offline stepwise quantizer for activation-function derivatives: the
port's own copy of ``fewbit_tpu/approx.py`` (numpy, with scipy's
``simpson``), so that the port never imports the JAX package.

Given an activation function ``f`` this module builds an optimal piecewise
constant (stepwise) approximation ``q`` of its derivative ``f'`` over a
domain.  At training time the backward pass of the activation only needs to
know *which* interval the forward input fell into, a ``bits``-wide integer
code, instead of the full input: that is the memory saving of the few-bit
backward pass.

Two independent solvers:

* :func:`approximate`: alternating (Lloyd-style) optimisation: move the
  interval borders along the gradient of the squared-L2 objective, then
  re-estimate each level as the mean of ``f'`` over its interval (exactly,
  from the primitive ``F``, as ``(F(b_hi) - F(b_lo)) / (b_hi - b_lo)``);
* :func:`dp_quantize`: exact dynamic programming over a discretised
  lattice; slower, a cross-check of the Lloyd solver.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np

__all__ = (
    "Stepwise",
    "approximate",
    "dp_quantize",
    "estimate_error",
)

ArrayFn = Callable[[np.ndarray], np.ndarray]
RandomState = Union[None, int, np.random.RandomState]


@dataclasses.dataclass
class Stepwise:
    """A piecewise-constant function on ``len(levels)`` intervals.

    ``borders`` has ``len(levels) + 1`` entries and includes the outermost
    domain edges; interval ``i`` is ``[borders[i], borders[i + 1])`` and maps
    to ``levels[i]``.
    """

    borders: np.ndarray
    levels: np.ndarray

    def __post_init__(self) -> None:
        self.borders = np.asarray(self.borders, dtype=np.float64)
        self.levels = np.asarray(self.levels, dtype=np.float64)
        if self.borders.ndim != 1 or self.levels.ndim != 1:
            raise ValueError("borders and levels must be 1-D")
        if self.borders.size != self.levels.size + 1:
            raise ValueError(
                f"expected len(borders) == len(levels) + 1, got "
                f"{self.borders.size} vs {self.levels.size}"
            )

    @property
    def cardinality(self) -> int:
        return self.levels.size

    def __call__(self, xs: np.ndarray) -> np.ndarray:
        xs = np.asarray(xs)
        # Interior borders only: values left of borders[1] get levels[0],
        # right of borders[-2] get levels[-1].
        codes = np.searchsorted(self.borders[1:-1], xs, side="right")
        return self.levels[codes]

    def codes(self, xs: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.borders[1:-1], np.asarray(xs), side="right")

    def __repr__(self) -> str:
        return (
            f"Stepwise(cardinality={self.cardinality}, "
            f"domain=({self.borders[0]:g}, {self.borders[-1]:g}))"
        )

    def pretty(self) -> str:
        rows = []
        for i, level in enumerate(self.levels):
            lo, hi = self.borders[i], self.borders[i + 1]
            rows.append(f"[{i}] [{lo:+10.4f}, {hi:+10.4f}) -> {level:+.6e}")
        return "\n".join(rows)


def _strictly_increasing(xs: np.ndarray, margin: float = 0.0) -> bool:
    return bool(np.all(np.diff(xs) > margin))


def _mean_levels(fn_prim: ArrayFn, borders: np.ndarray) -> np.ndarray:
    """Optimal level per interval: the mean of f' over the interval, computed
    exactly from the primitive as a difference quotient."""
    prim = fn_prim(borders)
    return np.diff(prim) / np.diff(borders)


def approximate(
    fn: ArrayFn,
    fn_prim: ArrayFn,
    cardinality: int,
    domain: Tuple[float, float] = (-100.0, 100.0),
    parity: bool = False,
    max_iters: int = 10000,
    beps: float = 1e-4,
    leps: float = 1e-4,
    random_state: RandomState = None,
) -> Tuple[Stepwise, Dict[str, Any]]:
    """Build a stepwise L2-optimal approximation of ``fn`` on ``domain``.

    :param fn: the function to approximate (typically a derivative ``f'``).
    :param fn_prim: its primitive ``F`` (typically the activation ``f``),
        used to evaluate exact per-interval means of ``fn``.
    :param cardinality: number of constant pieces (``2 ** bits``).
    :param domain: approximation domain; with ``parity=True`` the domain must
        start at 0 and the result describes the right half of an odd/even
        function.
    :param parity: approximate only on ``[0, x_max]`` (symmetric functions).
    :param max_iters: iteration cap for the alternating optimisation.
    :param beps: stop once the border-update step has L2 norm below this.
    :param leps: stop once the relative level change drops below this.
    :param random_state: seed for the random initial lattice.
    :return: ``(Stepwise, info)`` where ``info`` reports convergence status.
    """
    lo, hi = domain
    if parity and lo != 0.0:
        raise ValueError("parity=True requires the domain to start at 0")
    rng = np.random.RandomState(random_state)

    # Random initial lattice: interior borders drawn from a moderate normal
    # so they land where typical activations actually bend; retry a few times
    # until the draw is strictly sorted.
    borders = np.empty(cardinality + 1)
    borders[0], borders[-1] = lo, hi
    for _ in range(16):
        draw = rng.normal(0.0, 1.5, cardinality - 1)
        if parity:
            draw = np.abs(draw)
        borders[1:-1] = draw
        borders.sort()
        if _strictly_increasing(borders, 1e-3):
            break
    else:
        raise RuntimeError("could not draw a sorted initial lattice")

    levels = _mean_levels(fn_prim, borders)

    status = "not-converged"
    border_delta = np.inf
    level_delta = np.inf
    iters = 0
    for iters in range(max_iters):
        # Gradient step on the interior borders.  For the squared-L2 objective
        # the derivative w.r.t. border b_i is 2 (f(b_i) - (l_{i-1}+l_i)/2)
        # (l_i - l_{i-1}); descend along its negative.
        level_jump = np.diff(levels)
        level_mid = 0.5 * (levels[:-1] + levels[1:])
        step = -2.0 * level_jump * (fn(borders[1:-1]) - level_mid)
        borders[1:-1] += step
        border_delta = float(np.linalg.norm(step))

        if border_delta < beps:
            status = "converged"
            break

        next_levels = _mean_levels(fn_prim, borders)
        level_delta = float(
            np.linalg.norm(next_levels - levels) / np.linalg.norm(levels)
        )
        levels = next_levels

        if level_delta < leps:
            status = "converged"
            break

        if not _strictly_increasing(borders):
            status = "failed"
            break

    info = {
        "status": status,
        "iterations": iters,
        "border_delta": border_delta,
        "level_delta": level_delta,
    }
    return Stepwise(borders.copy(), np.asarray(levels).copy()), info


def estimate_error(
    fn: ArrayFn,
    approx: Stepwise,
    dx: float = 1e-3,
    max_points: int = 1 << 20,
) -> Tuple[float, np.ndarray]:
    """Per-interval and total squared-L2 error of a stepwise approximation,
    via Simpson quadrature on each interval."""
    from scipy.integrate import simpson

    errors = np.empty(approx.cardinality)
    for i in range(approx.cardinality):
        lo, hi = approx.borders[i], approx.borders[i + 1]
        npoints = int(min(max_points, max((hi - lo) / dx, 3)))
        xs = np.linspace(lo, hi, npoints)
        errors[i] = simpson((fn(xs) - approx.levels[i]) ** 2, x=xs)
    return float(errors.sum()), errors


def dp_quantize(
    fn: ArrayFn,
    cardinality: int,
    domain: Tuple[float, float] = (-12.0, 12.0),
    lattice: int = 512,
    weight: Optional[ArrayFn] = None,
) -> Stepwise:
    """Exact stepwise quantizer by dynamic programming on a uniform lattice.

    Minimises ``sum_i integral_{b_i}^{b_i+1} w(x) (fn(x) - l_i)^2 dx`` over
    all choices of ``cardinality`` segments with borders restricted to a
    uniform lattice of ``lattice + 1`` points.  Used as an independent
    cross-check of :func:`approximate`.
    """
    lo, hi = domain
    xs = np.linspace(lo, hi, lattice + 1)
    mids = 0.5 * (xs[:-1] + xs[1:])
    h = (hi - lo) / lattice

    ws = np.ones_like(mids) if weight is None else weight(mids)
    fs = fn(mids)

    # Prefix sums of w, f w, f^2 w over lattice cells -> O(1) segment costs.
    w_cum = np.concatenate([[0.0], np.cumsum(ws * h)])
    fw_cum = np.concatenate([[0.0], np.cumsum(fs * ws * h)])
    ffw_cum = np.concatenate([[0.0], np.cumsum(fs * fs * ws * h)])

    def segment_cost(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Optimal cost of one constant level on lattice span [a, b)."""
        w = w_cum[b] - w_cum[a]
        fw = fw_cum[b] - fw_cum[a]
        ffw = ffw_cum[b] - ffw_cum[a]
        with np.errstate(divide="ignore", invalid="ignore"):
            cost = ffw - np.where(w > 0, fw * fw / np.where(w > 0, w, 1.0), 0.0)
        return np.maximum(cost, 0.0)

    idx = np.arange(lattice + 1)
    cost_all = segment_cost(idx[:, None], idx[None, :])  # [a, b)
    # Forbid empty segments so the result always has `cardinality` distinct
    # intervals (an empty piece is never useful and breaks downstream
    # border-strictness invariants).
    cost_all[idx[:, None] >= idx[None, :]] = np.inf

    # dp[k, b]: best cost covering [0, b) with k segments.
    INF = np.inf
    dp = np.full((cardinality + 1, lattice + 1), INF)
    parent = np.zeros((cardinality + 1, lattice + 1), dtype=np.int64)
    dp[0, 0] = 0.0
    for k in range(1, cardinality + 1):
        total = dp[k - 1][:, None] + cost_all  # split point a, end b
        parent[k] = np.argmin(total, axis=0)
        dp[k] = total[parent[k], idx]

    cuts = [lattice]
    for k in range(cardinality, 0, -1):
        cuts.append(int(parent[k, cuts[-1]]))
    cuts = cuts[::-1]

    borders = xs[np.asarray(cuts)]
    a = np.asarray(cuts[:-1])
    b = np.asarray(cuts[1:])
    w = w_cum[b] - w_cum[a]
    fw = fw_cum[b] - fw_cum[a]
    levels = np.where(w > 0, fw / np.where(w > 0, w, 1.0), 0.0)
    return Stepwise(borders, levels)
