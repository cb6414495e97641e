"""Summarise fine-tuning runs into CSV / markdown / LaTeX tables, as
``tools/summarize_runs.py`` does with the JAX package.

Scans a log directory for runs written by
:class:`fewbit_tpu_torch.metrics.MetricsLogger` (``finetune_glue
--log-dir``), picks the best eval metric per (task, param) run, and pivots
into a param x task summary printed as markdown.

    python -m fewbit_tpu_torch.tools.summarize_runs logs/ --csv summary.csv \
        --tex table.tex
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from fewbit_tpu_torch.metrics import (DEFAULT_METRICS, summarize, to_csv,
                                      to_latex, to_markdown)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Prints the markdown table and returns the summary's rows (none when
    no run has the metrics)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log_dir", type=Path)
    ap.add_argument("--metrics", nargs="+", default=list(DEFAULT_METRICS))
    ap.add_argument("--csv", type=Path, default=None)
    ap.add_argument("--tex", type=Path, default=None)
    ap.add_argument("--scale", type=float, default=100.0,
                    help="value multiplier for display (default: percent)")
    args = ap.parse_args(argv)

    rows = summarize(args.log_dir, metrics=args.metrics)
    if not rows:
        print(f"no runs with {args.metrics} under {args.log_dir}",
              file=sys.stderr)
        return rows
    if args.csv:
        args.csv.write_text(to_csv(rows))
        print("wrote", args.csv, file=sys.stderr)
    if args.tex:
        args.tex.write_text(to_latex(rows, scale=args.scale))
        print("wrote", args.tex, file=sys.stderr)
    print(to_markdown(rows, scale=args.scale), end="")
    return rows


if __name__ == "__main__":
    raise SystemExit(0 if main() else 1)
