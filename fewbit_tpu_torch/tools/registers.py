"""Registers, spills and static shared memory of the package's CUDA kernels,
as ``ptxas`` reports them.

    python3 -m fewbit_tpu_torch.tools.registers [name ...]

Compiles each ``fewbit_tpu_torch/csrc/<name>.cu`` (all of them without
arguments) with the library's own flags plus ``-Xptxas -v``, one ``nvcc``
per source, all started together, and prints one line per kernel
instantiation: its demangled name, registers per thread, bytes of spill
stores and loads, and static shared memory; then the compiler's warnings
(``ptxas`` says there when it serializes a kernel's ``wgmma``s, C7520), and
one line per source with the wall seconds its ``nvcc`` took (all sources
compiling at once, as the library's build does, so they share the host's
cores).  A 288-thread block of the tensor-core kernels may have 168
registers a thread; so may the 384-thread blocks of the flash backward
kernels, which ``ptxas`` reports at that figure whatever their warpgroups
take after ``setmaxnreg`` (40 for the producer, 232 for the consumers);
256-thread blocks (bf16 F2 above head dimension 64, the wide kernels'
bf16) 255.  Needs ``nvcc``; builds nothing that the library loads.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from fewbit_tpu_torch.ops._build import CSRC, NVCC_FLAGS, _nvcc

__all__ = ("report", "main")

_ENTRY = re.compile(r"Compiling entry function '([^']+)' for '(sm_\w+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def _demangle(names):
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    clean = []
    for line in out.splitlines():
        line = line.replace("(anonymous namespace)::", "")
        line = re.sub(r"^void ", "", line)
        # Drop the parameter list: what follows the template arguments, or
        # the name of a kernel that has none.
        depth = 0
        for i, ch in enumerate(line):
            depth += ch == "<"
            depth -= ch == ">"
            if ch == "(" and depth == 0:
                line = line[:i]
                break
        clean.append(line)
    return clean


def report(sources):
    """``([(source, kernel, registers, spill stores, spill loads, static
    shared bytes), ...], {source: nvcc wall seconds}, [warning lines])``
    for the given ``.cu`` paths."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        def compile_one(src):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c",
                 "-o", str(Path(tmp) / f"{src.stem}.o"), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            return src, proc.stdout, proc.returncode, time.perf_counter() - t0

        with ThreadPoolExecutor(max(1, len(sources))) as pool:
            outs = list(pool.map(compile_one, sources))
    rows, seconds, warnings = [], {}, []
    for src, text, rc, sec in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}) on {src}:\n{text}")
        seconds[src.name] = sec
        warnings += [f"{src.name}: {line.strip()}"
                     for line in text.splitlines() if "warning" in line]
        chunks = _ENTRY.split(text)[1:]  # name, arch, body, name, ...
        names = _demangle(chunks[0::3])
        for name, body in zip(names, chunks[2::3]):
            spill = _SPILL.search(body)
            smem = _SMEM.search(body)
            rows.append((src.name, name, int(_USED.search(body).group(1)),
                         int(spill.group(1)), int(spill.group(2)),
                         int(smem.group(1)) if smem else 0))
    return rows, seconds, warnings


def main(argv=None):
    names = list(sys.argv[1:] if argv is None else argv)
    sources = ([CSRC / f"{n}.cu" for n in names] if names
               else sorted(CSRC.glob("*.cu")))
    rows, seconds, warnings = report(sources)
    for src, name, regs, stores, loads, smem in rows:
        print(f"{src}: {name}: {regs} registers, spill {stores} + {loads} B, "
              f"static smem {smem} B", flush=True)
    for line in warnings:
        print(line, flush=True)
    for src, sec in seconds.items():
        print(f"{src}: nvcc {sec:.1f} s", flush=True)
    return rows, seconds


if __name__ == "__main__":
    main()
