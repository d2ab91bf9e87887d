"""The MHA family's kernels timed back to back on the card.

    python3 exoground_tpu_torch/tools/mha_bench.py [--hash TAG | --wide TAG | --flash TAG]

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

``--hash`` also hashes the window core (``small_attention``) on the strided
views of a packed qkv at D 8, 40, 64, 128 (the fixed tiles), 136, 256 and
520 (the wide window kernel), S 17, 100 and 128, and the MHA family's wide
bodies (Dh 128 and 256, B 3 S 17 and 100), float32 and bfloat16
(``SMALLCMP`` line).

``--wide``: the wide-head bodies at the grounding model's full widths, B 64,
S 128 and 64, back to back (30 launches between two events, 3 rounds whose
order alternates, medians) beside one PyTorch call for the same function:
rows 1, 5 and 7 (fused MHA, the int8 MHA, both block bodies) in float32 and
bfloat16 at C 1024 and 2048 (8 heads: head sizes 128 and 256) beside
``F.multi_head_attention_forward``; row 9 (``small_attention`` on a packed
qkv's views, B64 H8) at D 128 and 256 beside SDPA; row 4 (flash) at D 256
and 128, the forward beside SDPA and the plain version and the backward pair
(dq then dk/dv) beside one SDPA backward, float32 and bfloat16; and, where the checkout has them, the
wgmma GEMMs alone (``ops.attention.wide_linear``, bf16 and f32) at the
bodies' products beside ``F.linear`` (float32 with TF32 off). One ``WIDE``
JSON line a shape under TAG; a body the checkout refuses prints
``refused``.

``--flash``: row 4 above D 128 (the cluster bodies): at D 136, 256, 520,
1024, 1032 and 2056 (B2 H2, Sq 96, Sk 77, a ragged key tail and an empty
batch row), float32 and bfloat16, the sha256 of o, lse, dq, dk and dv and
their largest error relative to max|flash_attention_plain| (``FLASHCMP``
line), then row 4's ``--wide`` lines and the same at B1 H8 S256 D2048 (two
pairs of slabs a CTA).

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


def _packed_qkv(b, s, h, d, dtype, seed):
    """q, k and v as the (B, H, S, D) strided views of one packed (B, S, 3HD)
    tensor (grounding's layout), and a key padding with a fully-masked
    window and ragged lengths."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device="cuda").to(dtype)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in qkv.chunk(3, -1))
    lens = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
    lens[0] = 0
    return q, k, v, torch.arange(s, device="cuda")[None, :] >= lens[:, None]


def small_hashes(tag: str) -> None:
    from exoground_tpu_torch.ops import attention as A

    res = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in (8, 40, 64, 128, 136, 256, 520):
            for s in (17, 100, 128):
                q, k, v, kpad = _packed_qkv(3, s, 2, d, dtype, d + s)
                with torch.inference_mode():
                    o = A.small_attention(q, k, v, kpad)
                res.append(dict(shape=f"small B3 H2 S{s} D{d}", dtype=str(dtype).split(".")[-1],
                                sha=_sha(o)))
        for c in (1024, 2048):
            for s in (17, 100):
                x, kpad, (lw, lb), w = _inputs(3, s, c, dtype, c + s)
                with torch.inference_mode():
                    outs = {"fused_mha": A.fused_mha(x, kpad, *w, 8),
                            "fused_mha_int8": A.fused_mha_int8(x, kpad, *w, 8),
                            "block_attn": A.fused_block_attn(x, kpad, lw, lb, *w, 8)[0],
                            "block_attn_int8": A.fused_block_attn(x, kpad, lw, lb, *w, 8,
                                                                  int8_qkv=True)[0]}
                res.append(dict(shape=f"wide B3 S{s} C{c} H8", dtype=str(dtype).split(".")[-1],
                                sha={k: _sha(v) for k, v in outs.items()}))
    print("SMALLCMP", tag, json.dumps(res), flush=True)


def _rounds(fns, rounds=3, launches=30):
    """Median back-to-back ms of each of ``fns`` over ``rounds`` rounds whose
    order alternates."""
    from exoground_tpu_torch.tools.mlp_bench import _events_ms

    res = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            res[k].append(_events_ms(fns[k], launches))
    return {k: round(statistics.median(v), 4) for k, v in res.items()}


def wide(tag: str) -> None:
    import torch.nn.functional as F

    from exoground_tpu_torch.ops import attention as A

    for dtype in (torch.bfloat16, torch.float32):
        for c, s in ((c, s) for c in (1024, 2048) for s in (128, 64)):
            x, kpad, (lw, lb), w = _inputs(64, s, c, dtype, c + s)
            with torch.inference_mode():
                fns = {
                    "row1 fused_mha": lambda: A.fused_mha(x, kpad, *w, 8),
                    "row5 fused_mha_int8": lambda: A.fused_mha_int8(x, kpad, *w, 8),
                    "row7 block_attn": lambda: A.fused_block_attn(x, kpad, lw, lb, *w, 8),
                    "row7 block_attn_int8": lambda: A.fused_block_attn(x, kpad, lw, lb, *w, 8,
                                                                       int8_qkv=True),
                    "library F.multi_head_attention_forward":
                        lambda: F.multi_head_attention_forward(
                            x.transpose(0, 1), x.transpose(0, 1), x.transpose(0, 1), c, 8, w[0],
                            w[1], None, None, False, 0.0, w[2], w[3], training=False,
                            key_padding_mask=kpad, need_weights=False),
                }
                print("WIDE", tag, json.dumps(dict(shape=f"B64 S{s} C{c} H8",
                                                   dtype=str(dtype).split(".")[-1],
                                                   ms_b2b=_rounds(fns))), flush=True)
    _wide_small(tag)
    _wide_flash(tag, ((64, 8, 128, 256), (64, 8, 64, 256), (64, 8, 128, 128), (64, 8, 64, 128)))
    if not hasattr(A, "wide_linear"):
        return
    _wide_gemm(tag)


def _wide_small(tag):
    """Row 9's WIDE lines: small_attention on a packed qkv's views beside SDPA
    on the same views (the boolean mask), back to back, B64 H8."""
    import torch.nn.functional as F

    from exoground_tpu_torch.ops import attention as A

    for dtype in (torch.float32, torch.bfloat16):
        for d in (128, 256):
            for s in (128, 64):
                q, k, v, kpad = _packed_qkv(64, s, 8, d, dtype, d + s)
                attend = (~kpad)[:, None, None, :]
                with torch.inference_mode():
                    fns = {"row9 small_attn": lambda: A.small_attention(q, k, v, kpad),
                           "library SDPA": lambda: F.scaled_dot_product_attention(
                               q, k, v, attn_mask=attend)}
                    print("WIDE", tag, json.dumps(dict(shape=f"B64 H8 S{s} D{d} packed qkv",
                                                       dtype=str(dtype).split(".")[-1],
                                                       ms_b2b=_rounds(fns))), flush=True)


def _wide_flash(tag, shapes=((64, 8, 128, 256), (64, 8, 64, 256))):
    """Row 4's WIDE lines: the forward beside SDPA and the plain version
    (flash_attention_plain) and the backward pair beside one SDPA backward,
    back to back, at each (B, H, S, D)."""
    import torch.nn.functional as F

    from exoground_tpu_torch.ops import attention as A

    for dtype in (torch.float32, torch.bfloat16):
        for b, h, s, d in shapes:
            g = torch.Generator(device="cuda").manual_seed(s + d)
            q, k, v, do = (torch.randn(b * h, s, d, generator=g, device="cuda").to(dtype)
                           for _ in range(4))
            q = (q * d ** -0.5).to(dtype)
            kpad = torch.zeros(b, s, dtype=torch.int32, device="cuda")
            kpad[0, s - 5:] = 1
            o, lse = A.flash_forward(q, k, v, kpad)
            delta = (do.float() * o.float()).sum(-1)
            attend = (kpad == 0)[:, None, None, :]
            q4, k4, v4, do4 = (t.view(b, h, s, d) for t in (q, k, v, do))
            q4g, k4g, v4g = (t.clone().requires_grad_() for t in (q4, k4, v4))
            lo = F.scaled_dot_product_attention(q4g, k4g, v4g, attn_mask=attend, scale=1.0)

            def pair():
                A.flash_dq(q, k, v, kpad, do, lse, delta)
                A.flash_dkv(q, k, v, kpad, do, lse, delta)

            fns = {
                "row4 fwd": lambda: A.flash_forward(q, k, v, kpad),
                "row4 dq + dk/dv": pair,
                "plain fwd": lambda: A.flash_attention_plain(q, k, v, kpad),
                "library SDPA fwd": lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=attend, scale=1.0),
                "library SDPA backward": lambda: torch.autograd.grad(
                    lo, [q4g, k4g, v4g], do4, retain_graph=True),
            }
            print("WIDE", tag, json.dumps(dict(shape=f"B{b} H{h} S{s} D{d}",
                                               dtype=str(dtype).split(".")[-1],
                                               ms_b2b=_rounds(fns))), flush=True)
            del lo


def flash(tag: str) -> None:
    from exoground_tpu_torch.ops import attention as A

    res = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in (136, 256, 520, 1024, 1032, 2056):
            g = torch.Generator(device="cuda").manual_seed(d)
            q, k, v, do = (torch.randn(4, n, d, generator=g, device="cuda").to(dtype)
                           for n in (96, 77, 77, 96))
            q = (q * d ** -0.5).to(dtype)
            kpad = torch.zeros(2, 77, dtype=torch.int32, device="cuda")
            kpad[:, 64:] = 1
            kpad[0] = 1  # a batch row with no valid key
            try:
                o, lse = A.flash_forward(q, k, v, kpad)
            except ValueError as e:  # a checkout whose wrappers refuse this head
                res.append(dict(shape=f"B2 H2 Sq96 Sk77 D{d}", dtype=str(dtype).split(".")[-1],
                                refused=str(e)))
                continue
            delta = (do.float() * o.float()).sum(-1)
            got = {"o": o, "lse": lse, "dq": A.flash_dq(q, k, v, kpad, do, lse, delta)}
            got["dk"], got["dv"] = A.flash_dkv(q, k, v, kpad, do, lse, delta)
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            po, _ = A.flash_attention_plain(qq, kk, vv, kpad)
            po.backward(do)
            want = {"o": po, "dq": qq.grad, "dk": kk.grad, "dv": vv.grad}
            rel = {n: (got[n].float() - w.float()).abs().max().item()
                   / max(w.float().abs().max().item(), 1e-30) for n, w in want.items()}
            res.append(dict(shape=f"B2 H2 Sq96 Sk77 D{d}", dtype=str(dtype).split(".")[-1],
                            sha="/".join(_sha(got[n]) for n in ("o", "lse", "dq", "dk", "dv")),
                            rel_err=rel))
    print("FLASHCMP", tag, json.dumps(res), flush=True)
    _wide_flash(tag)
    try:
        _wide_flash(tag, ((1, 8, 256, 2048),))
    except ValueError as e:
        print("WIDE", tag, json.dumps(dict(shape="B1 H8 S256 D2048", refused=str(e))), flush=True)


def _wide_gemm(tag: str) -> None:
    import torch.nn.functional as F

    from exoground_tpu_torch.ops import attention as A

    for dtype in (torch.bfloat16, torch.float32):
        for m, n, kk in ((8192, 6144, 2048), (8192, 2048, 2048), (8192, 3072, 1024),
                         (8192, 1024, 1024)):
            g = torch.Generator(device="cuda").manual_seed(n + kk)
            a = torch.randn(m, kk, generator=g, device="cuda").to(dtype)
            wt = (torch.randn(n, kk, generator=g, device="cuda") * kk ** -0.5).to(dtype)
            bias = torch.randn(n, generator=g, device="cuda").to(dtype)
            name = "wgmma_linear" if dtype == torch.bfloat16 else "wgmma_linear_tf32"
            flops = 2.0 * m * n * kk
            line = dict(shape=f"GEMM M{m} N{n} K{kk}", dtype=str(dtype).split(".")[-1])
            with torch.inference_mode():
                try:
                    A.wide_linear(a, wt, bias)
                except TypeError as e:  # a checkout whose GEMM takes bf16 only
                    line["refused"] = str(e)
                    fns = {}
                else:
                    fns = {name: lambda: A.wide_linear(a, wt, bias)}
                fns["library F.linear"] = lambda: F.linear(a, wt, bias)
                t = _rounds(fns)
            print("WIDE", tag, json.dumps(dict(line, ms_b2b=t, tflops={
                k: round(flops / v / 1e9, 1) for k, v in t.items()})), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hash", metavar="TAG", default=None,
                    help="print the fused MHA's output hashes and times under TAG")
    ap.add_argument("--wide", metavar="TAG", default=None,
                    help="time the wide-head bodies at full width under TAG")
    ap.add_argument("--flash", metavar="TAG", default=None,
                    help="hash and check flash's cluster bodies, then time row 4, under TAG")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    if not torch.cuda.is_available():
        raise SystemExit("mha_bench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if args.hash is not None:
        hashes(args.hash)
        small_hashes(args.hash)
    elif args.wide is not None:
        wide(args.wide)
    elif args.flash is not None:
        flash(args.flash)
    else:
        bench()


if __name__ == "__main__":
    main()
