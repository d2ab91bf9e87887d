"""The MHA family's kernels timed back to back on the card.

    python3 exoground_tpu_torch/tools/mha_bench.py [--hash TAG]

Imports ``exoground_tpu_torch`` from the working directory, so that, run from
the root of another checkout (an unpacked parent commit, say), it measures
that checkout's kernels.

By default, at the serving group's windows (B 304, S 64 and 96, C 512, H 8,
one fully-masked window and ragged lengths) in bfloat16 and float32: the
block attention (exact and int8 bodies) beside its per-module counterpart
(``F.layer_norm`` + ``fused_mha`` or ``fused_mha_int8`` + the add), the fused
MHA and the int8 MHA, each 30 launches between two CUDA events, in 5 rounds
whose order alternates; one ``BENCH`` JSON line per shape with the medians
and every round. Back-to-back launches time the device, not the Python work
of a single call (the timing helpers are mlp_bench's).

``--hash``: the four kernels of the family (fused MHA, the int8 MHA and both
block-attention bodies) at phase 3's shapes of chip_smoke.py and the flash
forward at the global path's (S 2048, 2096 with 48 padding keys) and at head
size 128, float32 and bfloat16: the sha256 of each output and the fused MHA's
median of 20 single timed calls (``MHACMP`` line), to hold one checkout's
kernels against another's bit for bit.

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


def _inputs(b, s, c, dtype, seed):
    """x, the key padding (window 0 fully masked, ragged lengths), the LN
    weight and bias, the MHA weights, seeded."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def t(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    x = t(b, s, c)
    lens = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
    lens[0] = 0
    kpad = torch.arange(s, device="cuda")[None, :] >= lens[:, None]
    ln = (1 + 0.1 * t(c), 0.1 * t(c))
    w = (t(3 * c, c, scale=c ** -0.5), t(3 * c, scale=0.02), t(c, c, scale=c ** -0.5),
         t(c, scale=0.02))
    return x, kpad, ln, w


def bench(rounds: int = 5, launches: int = 30) -> None:
    import torch.nn.functional as F

    from exoground_tpu_torch.ops.attention import (
        block_attn_plain, fused_block_attn, fused_mha, fused_mha_int8)
    from exoground_tpu_torch.tools.mlp_bench import _events_ms

    c, h = 512, 8
    for s in (64, 96):
        for dtype in (torch.bfloat16, torch.float32):
            x, kpad, (lw, lb), w = _inputs(304, s, c, dtype, s)

            def per_module(mha):
                return x + mha(F.layer_norm(x, (c,), lw, lb, 1e-5), kpad, *w, h)

            fns = {
                "block": lambda: fused_block_attn(x, kpad, lw, lb, *w, h),
                "per_module": lambda: per_module(fused_mha),
                "fused_mha": lambda: fused_mha(x, kpad, *w, h),
                "block_int8": lambda: fused_block_attn(x, kpad, lw, lb, *w, h, int8_qkv=True),
                "per_module_int8": lambda: per_module(fused_mha_int8),
                "int8": lambda: fused_mha_int8(x, kpad, *w, h),
            }
            res = {k: [] for k in fns}
            with torch.inference_mode():
                ref = block_attn_plain(x, kpad, lw, lb, *w, h)[0].float()
                err = ((fused_block_attn(x, kpad, lw, lb, *w, h)[0].float() - ref).abs().max()
                       / ref.abs().max()).item()
                for r in range(rounds):
                    for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                        res[k].append(_events_ms(fns[k], launches))
            print("BENCH", f"B304 S{s}", str(dtype).split(".")[-1], f"err {err:.2e}",
                  json.dumps({k: round(statistics.median(v), 4) for k, v in res.items()}),
                  json.dumps({k: [round(u, 4) for u in v] for k, v in res.items()}), flush=True)


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def hashes(tag: str) -> None:
    from exoground_tpu_torch.ops.attention import (
        flash_forward, fused_block_attn, fused_mha, fused_mha_int8)
    from exoground_tpu_torch.tools.mlp_bench import _time_ms

    res = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, c, h in ((304, 64, 512, 8), (304, 96, 512, 8), (5, 33, 128, 4),
                           (3, 17, 128, 16), (4, 72, 640, 16), (3, 128, 384, 8),
                           (64, 128, 512, 8), (2, 50, 256, 16)):
            x, kpad, (lw, lb), w = _inputs(b, s, c, dtype, b * 7 + s + c)
            with torch.inference_mode():
                outs = {"fused_mha": fused_mha(x, kpad, *w, h),
                        "fused_mha_int8": fused_mha_int8(x, kpad, *w, h),
                        "block_attn": fused_block_attn(x, kpad, lw, lb, *w, h)[0],
                        "block_attn_int8": fused_block_attn(x, kpad, lw, lb, *w, h,
                                                            int8_qkv=True)[0]}
                torch.cuda.synchronize()
                ms = _time_ms(lambda: fused_mha(x, kpad, *w, h)) if b >= 64 else None
            res.append(dict(shape=f"B{b} S{s} C{c} H{h}", dtype=str(dtype).split(".")[-1],
                            sha={k: _sha(v) for k, v in outs.items()}, ms=ms))
        for bh, sq, d, pad in ((8, 2048, 64, 0), (8, 2096, 64, 48), (8, 300, 128, 20)):
            g = torch.Generator(device="cuda").manual_seed(sq + d)
            q, k, v = (torch.randn(bh, sq, d, generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            kpad = torch.zeros(1, sq, dtype=torch.int32, device="cuda")
            kpad[:, sq - pad:] = 1
            o, lse = flash_forward(q * d ** -0.5, k, v, kpad)
            res.append(dict(shape=f"flash BH{bh} S{sq} D{d} pad{pad}",
                            dtype=str(dtype).split(".")[-1],
                            sha={"flash_fwd": _sha(o) + "/" + _sha(lse)}, ms=None))
    print("MHACMP", tag, json.dumps(res), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hash", metavar="TAG", default=None,
                    help="print the fused MHA's output hashes and times under TAG")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    if not torch.cuda.is_available():
        raise SystemExit("mha_bench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if args.hash is not None:
        hashes(args.hash)
    else:
        bench()


if __name__ == "__main__":
    main()
