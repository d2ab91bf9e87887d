"""The MIL-NCE grid kernel timed back to back on the card.

    python3 exoground_tpu_torch/tools/grid_bench.py

Imports ``exoground_tpu_torch`` from the working directory, so that, run from
the root of another checkout (an unpacked parent commit, say), it measures
that checkout's kernel.

At the four timed shapes of chip_smoke.py's phase 3b (S 6, C 512; B16: R 1024,
Cc 192; B64: R 4096, Cc 768; joint St 6 and dual St 1), in float32 and
bfloat16: the kernel's forward (``grid_lse2_forward``) and backward
(``grid_lse2_backward``) beside ``grid_lse2_plain``'s forward and its autograd
backward, each 30 launches between two CUDA events, in 5 rounds whose order
alternates; one ``GRID`` JSON line per shape with the medians and every round.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

SHAPES = ((6, 1024, 192, 512, 6), (6, 1024, 192, 512, 1), (6, 4096, 768, 512, 6),
          (6, 4096, 768, 512, 1))  # S, R, Cc, C, St


def _inputs(s, r, cc, c, st, dtype, seed):
    """l2-normalised features (as the loss gives them), all columns valid,
    random upstream grads, seeded."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.nn.functional.normalize(torch.randn(s, r, c, generator=g, device="cuda"), dim=-1)
    t = torch.nn.functional.normalize(torch.randn(st, cc, c, generator=g, device="cuda"), dim=-1)
    return (v.to(dtype), t.to(dtype), torch.ones(cc, dtype=torch.int32, device="cuda"),
            torch.randn(s, r, generator=g, device="cuda"),
            torch.randn(s, cc, generator=g, device="cuda"))


def bench(rounds: int = 5, launches: int = 30) -> None:
    from exoground_tpu_torch.ops.milnce_grid import (
        grid_lse2_backward, grid_lse2_forward, grid_lse2_plain)
    from exoground_tpu_torch.tools.mlp_bench import _events_ms

    inv = 1.0 / 0.07
    for s, r, cc, c, st in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            v, t, cv, gv, gt = _inputs(s, r, cc, c, st, dtype, seed=r + st)
            vden, tden = grid_lse2_forward(v, t, cv, inv)
            a, b = v.clone().requires_grad_(), t.clone().requires_grad_()
            pv, pt = grid_lse2_plain(a, b, cv.bool(), inv)

            def plain_fwd():
                with torch.no_grad():
                    return grid_lse2_plain(v, t, cv.bool(), inv)

            fns = {
                "fwd": lambda: grid_lse2_forward(v, t, cv, inv),
                "bwd": lambda: grid_lse2_backward(v, t, cv, vden, tden, gv, gt, inv),
                "plain_fwd": plain_fwd,
                "plain_bwd": lambda: torch.autograd.grad([pv, pt], [a, b], [gv, gt],
                                                         retain_graph=True),
            }
            res = {k: [] for k in fns}
            for rnd in range(rounds):
                for k in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
                    res[k].append(_events_ms(fns[k], launches))
            med = {k: round(statistics.median(x), 4) for k, x in res.items()}
            med["fwd+bwd / plain"] = round((med["fwd"] + med["bwd"])
                                           / (med["plain_fwd"] + med["plain_bwd"]), 3)
            print("GRID", f"S{s} R{r} Cc{cc} C{c} St{st}", str(dtype).split(".")[-1],
                  json.dumps(med), json.dumps({k: [round(u, 4) for u in x]
                                               for k, x in res.items()}), flush=True)


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    sys.path.insert(0, os.getcwd())
    if not torch.cuda.is_available():
        raise SystemExit("grid_bench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    bench()


if __name__ == "__main__":
    main()
