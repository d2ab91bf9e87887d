"""The MLP family's kernels timed back to back on the card.

    python3 exoground_tpu_torch/tools/mlp_bench.py [--hash TAG]

Imports ``exoground_tpu_torch`` from the working directory, so that, run from
the root of another checkout (an unpacked parent commit, say), it measures
that checkout's kernels.

By default, at the serving group's 19,456 and 29,184 rows (C 512) in bfloat16
and float32: the block MLP (exact and int8 bodies) beside its per-module
counterpart (``F.layer_norm`` + ``fused_mlp`` or ``fused_mlp_int8`` + the
add), the fused MLP and the int8 MLP, each 30 launches between two CUDA
events, in 5 rounds whose order alternates; one ``BENCH`` JSON line per shape
with the medians and every round. Back-to-back launches time the device, not
the Python work of a single call.

``--hash``: the fused MLP at phase 3's shapes of chip_smoke.py, the sha256 of
each output and the median of 20 single timed calls (``MLPCMP`` line), to
hold one checkout's kernel against another's bit for bit.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

import torch


def _events_ms(fn, launches: int) -> float:
    """Mean ms of ``launches`` back-to-back calls between two events."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(launches):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches


def _time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median ms of single calls between two events, after warm-up calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _inputs(rows, c, dtype, seed, ln=False):
    """x, (the LN weight and bias with ``ln``), the MLP weights, seeded."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def t(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    x = t(rows, c)
    norm = (1 + 0.1 * t(c), 0.1 * t(c)) if ln else None
    w = (t(4 * c, c, scale=c ** -0.5), t(4 * c, scale=0.02), t(c, 4 * c, scale=(4 * c) ** -0.5),
         t(c, scale=0.02))
    return x, norm, w


def bench(rounds: int = 5, launches: int = 30) -> None:
    import torch.nn.functional as F

    from exoground_tpu_torch.ops.fused_mlp import (
        block_mlp_plain, fused_block_mlp, fused_mlp, fused_mlp_int8)

    c = 512
    for rows in (19456, 29184):
        for dtype in (torch.bfloat16, torch.float32):
            x, (lw, lb), w = _inputs(rows, c, dtype, rows, ln=True)

            def per_module(mlp):
                return x + mlp(F.layer_norm(x, (c,), lw, lb, 1e-5), *w)

            fns = {
                "block": lambda: fused_block_mlp(x, lw, lb, *w),
                "per_module": lambda: per_module(fused_mlp),
                "fused_mlp": lambda: fused_mlp(x, *w),
                "block_int8": lambda: fused_block_mlp(x, lw, lb, *w, int8_cfc=True),
                "per_module_int8": lambda: per_module(fused_mlp_int8),
                "int8": lambda: fused_mlp_int8(x, *w),
            }
            res = {k: [] for k in fns}
            with torch.inference_mode():
                ref = block_mlp_plain(x, lw, lb, *w).float()
                err = ((fused_block_mlp(x, lw, lb, *w).float() - ref).abs().max()
                       / ref.abs().max()).item()
                for r in range(rounds):
                    for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                        res[k].append(_events_ms(fns[k], launches))
            print("BENCH", rows, str(dtype).split(".")[-1], f"err {err:.2e}",
                  json.dumps({k: round(statistics.median(v), 4) for k, v in res.items()}),
                  json.dumps({k: [round(u, 4) for u in v] for k, v in res.items()}), flush=True)


def hashes(tag: str) -> None:
    from exoground_tpu_torch.ops.fused_mlp import fused_mlp

    res = []
    for dtype in (torch.float32, torch.bfloat16):
        for rows, c in ((19456, 512), (29184, 512), (2048, 512), (4096, 512), (8192, 512),
                        (1, 512), (300, 640), (40, 1280)):
            x, _, w = _inputs(rows, c, dtype, rows * 7 + c)
            with torch.inference_mode():
                out = fused_mlp(x, *w)
                torch.cuda.synchronize()
                sha = hashlib.sha256(out.cpu().contiguous().view(torch.uint8).numpy().tobytes())
                ms = _time_ms(lambda: fused_mlp(x, *w)) if rows >= 2048 else None
            res.append(dict(rows=rows, C=c, dtype=str(dtype).split(".")[-1],
                            sha=sha.hexdigest()[:16], ms=ms))
    print("MLPCMP", tag, json.dumps(res), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hash", metavar="TAG", default=None,
                    help="print the fused MLP's output hashes and times under TAG")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    if not torch.cuda.is_available():
        raise SystemExit("mlp_bench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if args.hash is not None:
        hashes(args.hash)
    else:
        bench()


if __name__ == "__main__":
    main()
