"""Training-metrics logging and run summarisation: the port's own copy of
``fewbit_tpu/metrics.py`` (standard library only).

* :class:`MetricsLogger` writes one JSONL record per scalar
  (``{"step": s, "tag": t, "value": v}``) into ``<run_dir>/metrics.jsonl``
  plus a ``meta.json`` labelling the run (task, param);
* :func:`read_run` / :func:`summarize` / :func:`pivot` postprocess runs:
  filter tags, aggregate per run (best eval metric), pivot into a
  (param x task) table;
* :func:`to_markdown` / :func:`to_latex` / :func:`to_csv` export it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ("MetricsLogger", "read_run", "summarize", "pivot",
           "to_markdown", "to_latex", "to_csv", "DEFAULT_METRICS")

# The eval tags a summary keeps, first match per run.
DEFAULT_METRICS = ("eval/accuracy", "eval/matthews_correlation",
                   "eval/pearson", "eval/f1")

MDASH = "—"


class MetricsLogger:
    """Append-only JSONL scalar logger for one training run.

    >>> with MetricsLogger(dir, task="mrpc", param="gelu3") as ml:
    ...     ml.log(step, loss=0.43)
    ...     ml.log(step, **{"eval/accuracy": 0.86})
    """

    def __init__(self, run_dir, task: Optional[str] = None,
                 param: Optional[str] = None, **meta):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        info = {"task": task, "param": param, **meta}
        (self.run_dir / "meta.json").write_text(json.dumps(info))
        self._fh = open(self.run_dir / "metrics.jsonl", "a")

    def log(self, step: int, **scalars) -> None:
        for tag, value in scalars.items():
            self._fh.write(json.dumps(
                {"step": int(step), "tag": tag, "value": float(value)})
                + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_run(run_dir) -> Tuple[dict, List[dict]]:
    """Load one run: ``(meta, records)``."""
    run_dir = Path(run_dir)
    meta = {}
    meta_path = run_dir / "meta.json"
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
    records = []
    jsonl = run_dir / "metrics.jsonl"
    if jsonl.exists():
        with open(jsonl) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
    return meta, records


def summarize(log_dir, metrics: Sequence[str] = DEFAULT_METRICS,
              agg: Callable[[Iterable[float]], float] = max) -> List[dict]:
    """Scan ``log_dir`` recursively for runs (dirs holding metrics.jsonl);
    one row per (task, param): the aggregated (best, by default) value of
    the first matching metric."""
    rows = []
    for jsonl in sorted(Path(log_dir).rglob("metrics.jsonl")):
        meta, records = read_run(jsonl.parent)
        # MetricsLogger lays runs out as <log_dir>/<param>/<task>/.
        task = meta.get("task") or jsonl.parent.name
        param = meta.get("param") or jsonl.parent.parent.name
        for metric in metrics:
            vals = [r["value"] for r in records if r["tag"] == metric]
            if vals:
                rows.append({"task": task, "param": param,
                             "metric": metric, "value": agg(vals)})
                break
    return rows


def pivot(rows: List[dict]) -> Tuple[List[str], List[str], Dict]:
    """(param x task) table of values: ``(params, tasks, cells)`` with
    ``cells[(param, task)] -> value`` (missing combinations absent)."""
    params = sorted({r["param"] for r in rows}, reverse=True)
    tasks = sorted({r["task"] for r in rows})
    cells = {(r["param"], r["task"]): r["value"] for r in rows}
    return params, tasks, cells


def _fmt(value, scale=100.0):
    return f"{value * scale:5.2f}" if value is not None else f"{MDASH:^5s}"


def to_markdown(rows: List[dict], scale: float = 100.0) -> str:
    params, tasks, cells = pivot(rows)
    lines = ["| | " + " | ".join(t.upper() for t in tasks) + " |",
             "|---" * (len(tasks) + 1) + "|"]
    for p in params:
        cols = [_fmt(cells.get((p, t)), scale) for t in tasks]
        lines.append(f"| {p} | " + " | ".join(cols) + " |")
    return "\n".join(lines) + "\n"


def to_latex(rows: List[dict], scale: float = 100.0,
             caption: str = "Fine-tuning on GLUE tasks.",
             label: str = "tab:glue-fine-tuning") -> str:
    """LaTeX table, booktabs-style, em-dash for missing cells."""
    params, tasks, cells = pivot(rows)
    head = " & ".join([""] + [t.upper() for t in tasks]) + r" \\"
    body = [
        " & ".join([str(p)] + [_fmt(cells.get((p, t)), scale)
                               for t in tasks]) + r" \\"
        for p in params
    ]
    return "\n".join([
        r"\begin{table}",
        rf"\caption{{{caption}}}",
        rf"\label{{{label}}}",
        r"\begin{tabular}{l" + "r" * len(tasks) + "}",
        r"\toprule", head, r"\midrule", *body, r"\bottomrule",
        r"\end{tabular}", r"\end{table}", ""])


def to_csv(rows: List[dict]) -> str:
    lines = ["task,param,metric,value"]
    for r in sorted(rows, key=lambda r: (r["task"], r["param"])):
        lines.append(f'{r["task"]},{r["param"]},{r["metric"]},{r["value"]}')
    return "\n".join(lines) + "\n"
