"""Registers, spills and shared memory of each kernel of the port's CUDA
sources, as ptxas reports them for sm_90a.

    python -m exoground_tpu_torch.tools.ptxas_usage flash_attn [more sources]

compiles ``csrc/<name>.cu`` with the library build's flags
(``_kernels.NVCC_FLAGS`` without the shared-library ones) and ``-Xptxas -v`` into a cubin
under ``build/ptxas/``, and prints one JSON line a kernel: its name with
its template arguments, registers, spill stores and loads (bytes), stack
frame (bytes) and static shared memory (bytes; the bodies' tiles are
dynamic and not in it). Needs nvcc (the card's machine); the sources build
in parallel, one nvcc each.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

from exoground_tpu_torch.ops import _kernels

_ENTRY = re.compile(r"Compiling entry function '(\S+)' for")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def _demangle(names):
    tool = shutil.which("cu++filt") or str(Path(_kernels._nvcc()).parent / "cu++filt")
    if not Path(tool).exists():
        tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else list(names)


def parse(log: str):
    """One dict a kernel from ptxas's verbose log."""
    rows, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"mangled": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = _PROPS.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = _SMEM.search(line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    for row, name in zip(rows, _demangle([r["mangled"] for r in rows])):
        row["kernel"] = name
    return rows


def usage(names):
    out_dir = _kernels.BUILD_DIR.parent / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    jobs = {n: subprocess.Popen([_kernels._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
                                 str(out_dir / f"{n}.cubin"), str(_kernels.CSRC / f"{n}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n in names}
    rows = []
    for n, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for csrc/{n}.cu:\n{log}")
        rows += [dict(source=n, **r) for r in parse(log)]
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="+", help="sources under csrc/, without .cu")
    args = ap.parse_args(argv)
    for row in usage(args.names):
        row.pop("mangled", None)
        print("ptxas", json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
