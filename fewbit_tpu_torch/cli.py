"""Command-line utility to generate few-bit gradient quantisations, as
``fewbit_tpu/cli.py``.

``fewbit-tpu-torch quantize <nobits> <module:func>`` (or ``python -m
fewbit_tpu_torch quantize ...``) differentiates the named function with
``torch.autograd`` in float64 on the host, runs the stepwise quantizer, and
merges the result into an npz archive that
:class:`fewbit_tpu_torch.lut.StepwiseStore` loads, e.g.::

    fewbit-tpu-torch quantize 3 torch.nn.functional:gelu -o luts.npz

The function must be elementwise: the derivative at every point is the
gradient of the sum of its outputs.
"""

from __future__ import annotations

import argparse
import logging
import sys
from importlib import import_module
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from fewbit_tpu_torch import __version__
from fewbit_tpu_torch.approx import approximate

__all__ = ("main", "build_parser")

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARN,
    "error": logging.ERROR,
}


def _host_f64(xs: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(xs, np.float64), device="cpu")


def quantize(nobits: int, spec: str, output: Optional[Path],
             max_iters: int, border_error: float, level_error: float,
             seed: Optional[int], domain: float, parity: bool) -> int:
    logging.info("loading function from spec %s", spec)
    module_name, func_name = spec.split(":", 1)
    func = getattr(import_module(module_name), func_name)

    def fn_prim(xs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return func(_host_f64(xs)).numpy()

    def fn(xs: np.ndarray) -> np.ndarray:
        t = _host_f64(xs).requires_grad_()
        with torch.enable_grad():
            (grad,) = torch.autograd.grad(func(t).sum(), t)
        return grad.numpy()

    dom = (0.0, domain) if parity else (-domain, domain)
    logging.info("running quantizer: %d bits on %s", nobits, dom)
    result, info = approximate(fn=fn, fn_prim=fn_prim,
                               cardinality=1 << nobits, domain=dom,
                               parity=parity, max_iters=max_iters,
                               beps=border_error, leps=level_error,
                               random_state=seed)
    if info["status"] != "converged":
        logging.error("failed to converge in %d iterations",
                      info["iterations"])
        return 1
    logging.info("converged in %d iterations; approximation:\n%s",
                 info["iterations"], result.pretty())

    if output:
        case = f"{func_name}{nobits:02d}"
        arrays = {f"{case}-borders": result.borders,
                  f"{case}-levels": result.levels}
        if output.exists():
            logging.info("merging into existing archive %s", output)
            try:
                with np.load(output) as npz:
                    merged = dict(npz)
                merged.update(arrays)
                arrays = merged
            except Exception:
                logging.error("could not read existing file; overwriting")
        np.savez(output, **arrays)
        logging.info("saved to %s", output)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="fewbit-tpu-torch",
        description="Generate few-bit gradient quantisations for activation "
                    "functions.")
    parser.add_argument("--log-level", default="info",
                        choices=sorted(LOG_LEVELS))
    parser.add_argument("--log-output", type=Path, default=None,
                        help="file to append log messages to (default: "
                             "standard error)")
    sub = parser.add_subparsers(dest="command")

    q = sub.add_parser("quantize", help="build and save a few-bit "
                                        "stepwise approximation")
    q.add_argument("nobits", type=int, help="number of bits")
    q.add_argument("spec", type=str,
                   help='qualified function name, e.g. '
                        '"torch.nn.functional:gelu"')
    q.add_argument("-o", "--output", type=Path, default=None,
                   help="npz archive to merge the result into")
    q.add_argument("-M", "--max-iters", type=int, default=10000)
    q.add_argument("-b", "--border-error", type=float, default=1e-6)
    q.add_argument("-l", "--level-error", type=float, default=1e-6)
    q.add_argument("-s", "--seed", type=int, default=None)
    q.add_argument("--domain", type=float, default=100.0,
                   help="half-width of the approximation domain")
    q.add_argument("--parity", action="store_true",
                   help="approximate on [0, domain] (symmetric derivative)")

    h = sub.add_parser("help", help="show help for a command")
    h.add_argument("topic", nargs="?", default=None,
                   help="command to describe (e.g. quantize)")

    sub.add_parser("version", help="show version")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    # A handler of this call's own on the root logger, removed on return,
    # so that an in-process caller keeps its logging configuration.
    handler = (logging.FileHandler(args.log_output) if args.log_output
               else logging.StreamHandler(sys.stderr))
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(message)s"))
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(LOG_LEVELS[args.log_level])
    try:
        return _run(parser, args)
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
        handler.close()


def _run(parser: argparse.ArgumentParser, args) -> int:
    if args.command == "version":
        print(f"fewbit-tpu-torch {__version__}")
        return 0
    if args.command == "help":
        if args.topic is None:
            parser.print_help()
            return 0
        try:
            parser.parse_args([args.topic, "--help"])
        except SystemExit as exc:
            return int(exc.code or 0)
        return 0
    if args.command == "quantize":
        return quantize(args.nobits, args.spec, args.output, args.max_iters,
                        args.border_error, args.level_error, args.seed,
                        args.domain, args.parity)
    parser.print_usage()
    return 0


if __name__ == "__main__":
    sys.exit(main())
