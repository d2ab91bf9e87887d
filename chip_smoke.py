"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile every kernel of the main path from exoground_tpu_torch/csrc
     (one nvcc per source, started together), print the build seconds;
  3. kernels: each kernel against its plain PyTorch version on the card, on the
     same inputs, at the main-path shapes (fused MHA B=304 C=512 H=8 at S=64
     and S=96 with one fully-masked window and ragged tails; fused MLP at
     19456 rows, C=512; and at the global path's 2048, 2096 and 3322 rows)
     and small shapes that reach the kernels' other instantiations (head
     sizes 8, 40, 48; MLP widths 128, 640, 1024, 1280), in
     float32 (max error <= 1e-4 of max|plain|) and bfloat16 (<= 1e-2); times
     by CUDA events (median of several runs after warm-up) beside the plain
     version, one PyTorch library call where one computes the same function,
     and the card's bound;
  4. main path: AlignmentService over TemporalAligner E6D6 (width 512, 8 heads,
     4096-d inputs, seeded random weights through the JAX->port weight bridge)
     answers align() requests, three of them concurrent through the coalescing
     front (which must serve them in fewer batches than requests), with the
     launch counters reset just before and read just after; one request again
     on the CPU plain path for agreement; then FusedAlignEvaluator over the 8
     bench videos for R@1/AUC and frames/s (frames over the median of three
     timed sweeps after a warm-up, as the profile tool reports it).
  3b. grid kernel: the MIL-NCE grid kernel's forward (v_den, t_den) and
     backward (dv, dt for random upstream grads) against grid_lse2_plain on
     the card, at the train path's shapes (S 6, R = B*64, Cc = B*12, C 512
     for B 16 and 64, dual St = 1 and joint St = 6), a ragged (2, 36, 15,
     128) with three invalid columns and a column space above the TPU
     kernel's cap (1, 512, 3072, 512), in float32 (<= 1e-4 of max|plain|)
     and bfloat16 (<= 1e-2); forward and backward times beside the plain
     version's and the bound;
  5. train path: TANTrainer at the JAX package's train-bench configuration
     (TemporalAligner E6D6, width 512, 4096-d, alignability head, cotrain
     with keep agreement, loss threshold 0.7, EMA 0.999): one float32 step
     at B 4 on the card and on the CPU plain path from the same weights and
     batch (init loss: loss within 1e-4 relative, every grad within 1e-3 of
     its max|CPU|; the cotrain loss printed beside it), then a warm-up and
     10 timed steps at B 16 and 64 in float32 and bfloat16, with the launch
     counters reset just before and read just after each run: 2 grid
     forward and 2 grid backward launches per step, no fused MHA/MLP launch.
     Then the same with attn_impl='flash': one float32 cotrain step at B 4 on
     the card (flash kernels) and on the CPU (flash_attention_plain), loss
     within 1e-4 relative, grads within 1e-3 of max|CPU|, and 24 flash
     forward + 12 dq + 12 dk/dv launches; 10 timed steps at B 16 in float32
     and bfloat16 with those counts per step.
  3c. flash kernels: forward (o; lse on rows with a valid key, +1e30 exactly
     on the rest), dq and dk/dv against autograd of flash_attention_plain on
     the card for the same random upstream grad, at the global path's shapes
     (B1 H8 S2048 D64; Sq = Sk = 2096 with the last 48 keys padded; S4096;
     S1024 for the crossover), the train path's (B16 H8 S64 and S76), ragged
     tails, a batch row with no valid key and head sizes 32, 40 and 128, in
     float32 (<= 1e-4 of max|plain|) and bfloat16 (<= 1e-2); at the four
     long shapes each kernel's time beside the plain version's,
     attention_plain's (the 'xla' route), F.scaled_dot_product_attention's
     (a yardstick the port never calls) and the bound;
  6. global mode: test_alignment_htm(method='global') over three long videos
     (evals/bench_items.py::GLOBAL_VLENS) at E6D6 full width, auto dispatch,
     counted (12 flash forward and 12 fused MLP launches per video, no fused
     MHA); the first video again on the CPU plain path (sim within 1e-4 of
     max|CPU|, R@1 and AUC equal); then text_visual_sim at the JAX package's
     global bench shape (1 x 2048 frames, 48 texts) through flash (auto) and
     attention_plain ('xla'), float32 and bfloat16, median of 5 each
     (`global_bench {...}` lines).

Float32 products run in full float32 (TF32 off for matmul and cuDNN). The
line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H100_PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense, SXM
H100_BYTES_PER_S = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, warmup=3, reps=10) -> float:
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


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / H100_PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ----------------------------------------------------------------- phase 3
def mha_case(B, S, C, H, dtype, seed):
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.attention import fused_mha, mha_plain

    rng = np.random.RandomState(seed)
    dev = "cuda"

    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dtype, device=dev)

    x = t(B, S, C)
    w_in, b_in = t(3 * C, C, scale=C ** -0.5), t(3 * C, scale=0.02)
    w_out, b_out = t(C, C, scale=C ** -0.5), t(C, scale=0.02)
    lens = rng.randint(1, S + 1, B)
    lens[0] = 0  # one fully-masked window (a padded group window)
    lens[1] = S
    kpad = torch.tensor(np.arange(S)[None, :] >= lens[:, None], device=dev)
    with torch.inference_mode():
        n0 = _kernels.LAUNCHES["fused_mha"]
        out = fused_mha(x, kpad, w_in, b_in, w_out, b_out, H)
        torch.cuda.synchronize()
        if _kernels.LAUNCHES["fused_mha"] != n0 + 1:
            fail("fused_mha did not count its launch")
        ref = mha_plain(x, kpad, w_in, b_in, w_out, b_out, H)
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if not torch.isfinite(out.float()).all():
            fail(f"fused_mha non-finite output at B{B} S{S} C{C} {dtype}")
        ms = time_ms(lambda: fused_mha(x, kpad, w_in, b_in, w_out, b_out, H))
        plain_ms = time_ms(lambda: mha_plain(x, kpad, w_in, b_in, w_out, b_out, H))
        lib_ms = time_ms(lambda: torch.nn.functional.multi_head_attention_forward(
            x.transpose(0, 1), x.transpose(0, 1), x.transpose(0, 1), C, H, w_in, b_in,
            None, None, False, 0.0, w_out, b_out, training=False,
            key_padding_mask=kpad, need_weights=False))
    flops = 8.0 * B * S * C * C + 4.0 * B * S * S * C
    nbytes = (2 * B * S * C + 4 * C * C + 4 * C) * x.element_size() + B * S
    bms, by = bound_ms(flops, nbytes, dtype)
    rel = err / scale
    case = dict(shape=f"B{B} S{S} C{C} H{H}", dtype=str(dtype).split(".")[-1],
                max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bms, bound_by=by)
    print("fused_mha", json.dumps(case), flush=True)
    if not rel <= TOL[dtype]:
        fail(f"fused_mha disagrees with mha_plain: {case}")
    return case


def mlp_case(rows, C, dtype, seed):
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.fused_mlp import fused_mlp, mlp_plain

    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dtype, device="cuda")

    x = t(rows, C)
    fc_w, fc_b = t(4 * C, C, scale=C ** -0.5), t(4 * C, scale=0.02)
    pr_w, pr_b = t(C, 4 * C, scale=(4 * C) ** -0.5), t(C, scale=0.02)
    with torch.inference_mode():
        n0 = _kernels.LAUNCHES["fused_mlp"]
        out = fused_mlp(x, fc_w, fc_b, pr_w, pr_b)
        torch.cuda.synchronize()
        if _kernels.LAUNCHES["fused_mlp"] != n0 + 1:
            fail("fused_mlp did not count its launch")
        ref = mlp_plain(x, fc_w, fc_b, pr_w, pr_b)
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if not torch.isfinite(out.float()).all():
            fail(f"fused_mlp non-finite output at rows {rows} C{C} {dtype}")
        ms = time_ms(lambda: fused_mlp(x, fc_w, fc_b, pr_w, pr_b))
        plain_ms = time_ms(lambda: mlp_plain(x, fc_w, fc_b, pr_w, pr_b))
    flops = 16.0 * rows * C * C
    nbytes = (2 * rows * C + 8 * C * C + 5 * C) * x.element_size()
    bms, by = bound_ms(flops, nbytes, dtype)
    rel = err / scale
    case = dict(shape=f"rows{rows} C{C}", dtype=str(dtype).split(".")[-1],
                max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bms, bound_by=by)
    print("fused_mlp", json.dumps(case), flush=True)
    if not rel <= TOL[dtype]:
        fail(f"fused_mlp disagrees with mlp_plain: {case}")
    return case


# ---------------------------------------------------------------- phase 3b
def grid_case(S, R, Cc, C, St, dtype, seed, n_invalid=0, timed=False):
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.milnce_grid import (
        grid_lse2, grid_lse2_backward, grid_lse2_forward, grid_lse2_plain)

    rng = np.random.RandomState(seed)

    def unit(*shape):  # l2-normalized features, as the loss receives them
        x = rng.standard_normal(shape)
        return torch.tensor(x / np.linalg.norm(x, axis=-1, keepdims=True), dtype=dtype,
                            device="cuda")

    v, t = unit(S, R, C), unit(St, Cc, C)
    valid_np = np.ones(Cc, bool)
    valid_np[rng.choice(Cc, n_invalid, replace=False)] = False
    valid = torch.tensor(valid_np, device="cuda")
    g_v = torch.tensor(rng.standard_normal((S, R)), dtype=torch.float32, device="cuda")
    g_t = torch.tensor(rng.standard_normal((S, Cc)), dtype=torch.float32, device="cuda")
    inv = 1.0 / 0.07
    outs = []
    for impl in ("kernel", "plain"):
        a, b = v.clone().requires_grad_(), t.clone().requires_grad_()
        n0 = dict(_kernels.LAUNCHES)
        vd, td = grid_lse2(a, b, valid, inv, impl=impl)
        torch.autograd.backward([vd, td], [g_v, g_t])
        torch.cuda.synchronize()
        if impl == "kernel" and (_kernels.LAUNCHES["milnce_grid_fwd"] != n0["milnce_grid_fwd"] + 1
                                 or _kernels.LAUNCHES["milnce_grid_bwd"]
                                 != n0["milnce_grid_bwd"] + 1):
            fail("the grid kernel did not count its forward and backward launches")
        outs.append((vd.detach(), td.detach(), a.grad, b.grad))
    (kv, kt, kdv, kdt), (pv, pt, pdv, pdt) = outs
    errs = {}
    # t_den is judged on the valid columns (the invalid ones sit at
    # NEG_FILL + log R and would set the scale) and on the invalid ones apart
    for name, got, want in (("v_den", kv, pv), ("t_den", kt[:, valid], pt[:, valid]),
                            ("t_den_invalid", kt[:, ~valid], pt[:, ~valid]),
                            ("dv", kdv, pdv), ("dt", kdt, pdt)):
        if want.numel() == 0:
            continue
        if not torch.isfinite(got.float()).all():
            fail(f"grid kernel: non-finite {name} at S{S} R{R} Cc{Cc} C{C} St{St} {dtype}")
        err = (got.float() - want.float()).abs().max().item()
        errs[name] = (err, err / max(want.float().abs().max().item(), 1e-30))
    rel = max(r for _, r in errs.values())
    case = dict(shape=f"S{S} R{R} Cc{Cc} C{C} St{St}", dtype=str(dtype).split(".")[-1],
                max_abs_err=max(e for e, _ in errs.values()), max_rel_err=rel,
                rel_err={k: r for k, (_, r) in errs.items()})
    if timed:
        cv32 = valid.to(torch.int32)
        vden, tden = grid_lse2_forward(v, t, cv32, inv)
        fwd_ms = time_ms(lambda: grid_lse2_forward(v, t, cv32, inv))
        bwd_ms = time_ms(lambda: grid_lse2_backward(v, t, cv32, vden, tden, g_v, g_t, inv))
        with torch.no_grad():
            plain_fwd = time_ms(lambda: grid_lse2_plain(v, t, valid, inv))
        a, b = v.clone().requires_grad_(), t.clone().requires_grad_()
        pvd, ptd = grid_lse2_plain(a, b, valid, inv)
        plain_bwd = time_ms(lambda: torch.autograd.grad([pvd, ptd], [a, b], [g_v, g_t],
                                                        retain_graph=True))
        item = v.element_size()
        work = 2.0 * S * R * Cc * C
        io = (S * R + St * Cc) * C * item
        fb, fby = bound_ms(work, io + 4 * (S * R + S * Cc + Cc), dtype)
        bb, bby = bound_ms(3 * work, 2 * io + 4 * (2 * S * R + 2 * S * Cc + Cc), dtype)
        case.update(fwd_ms=fwd_ms, fwd_plain_ms=plain_fwd, fwd_bound_ms=fb, fwd_bound_by=fby,
                    bwd_ms=bwd_ms, bwd_plain_ms=plain_bwd, bwd_bound_ms=bb, bwd_bound_by=bby,
                    library_ms=None)
    print("milnce_grid", json.dumps(case), flush=True)
    if not rel <= TOL[dtype]:
        fail(f"the grid kernel disagrees with grid_lse2_plain: {case}")
    return case


# ---------------------------------------------------------------- phase 3c
def flash_case(B, H, Sq, Sk, D, dtype, seed, pad_tail=0, empty_row=False, timed=False):
    """The flash kernels (forward, dq, dk/dv) against autograd of
    flash_attention_plain on the same inputs; with ``timed``, each beside the
    plain version, attention_plain (the 'xla' route), the library call and
    the bound."""
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.attention import (
        attention_plain, flash_attention_plain, flash_dkv, flash_dq, flash_forward)

    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dtype, device="cuda")

    q = t(B * H, Sq, D, scale=D ** -0.5)  # pre-scaled, as flash_attention passes it
    k, v, do = t(B * H, Sk, D), t(B * H, Sk, D), t(B * H, Sq, D)
    kp = np.zeros((B, Sk), np.int32)
    if pad_tail:
        kp[:, Sk - pad_tail:] = 1
    if empty_row:
        kp[0] = 1  # a batch row with no valid key
    kpad = torch.tensor(kp, device="cuda")
    n0 = dict(_kernels.LAUNCHES)
    o, lse = flash_forward(q, k, v, kpad)
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = flash_dq(q, k, v, kpad, do, lse, delta)
    dk, dv = flash_dkv(q, k, v, kpad, do, lse, delta)
    torch.cuda.synchronize()
    if any(_kernels.LAUNCHES[n] != n0[n] + 1 for n in ("flash_fwd", "flash_dq", "flash_dkv")):
        fail("the flash kernels did not count their launches")
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    po, plse = flash_attention_plain(qq, kk, vv, kpad)
    torch.autograd.backward([po], [do])
    errs = {}
    for name, got, want in (("o", o, po), ("dq", dq, qq.grad), ("dk", dk, kk.grad),
                            ("dv", dv, vv.grad)):
        if not torch.isfinite(got.float()).all():
            fail(f"flash kernel: non-finite {name} at {(B, H, Sq, Sk, D)} {dtype}")
        err = (got.float() - want.float()).abs().max().item()
        errs[name] = (err, err / max(want.float().abs().max().item(), 1e-30))
    has_key = plse < 1e29
    lse_err = (lse[has_key] - plse[has_key]).abs().max().item() if has_key.any() else 0.0
    empty_exact = bool((lse[~has_key] == 1e30).all())
    rel = max(r for _, r in errs.values())
    case = dict(shape=f"B{B} H{H} Sq{Sq} Sk{Sk} D{D}", dtype=str(dtype).split(".")[-1],
                pad_tail=pad_tail, empty_row=empty_row,
                max_abs_err=max(e for e, _ in errs.values()), max_rel_err=rel,
                rel_err={n: r for n, (_, r) in errs.items()}, lse_abs_err=lse_err,
                empty_rows=int((~has_key).sum()), empty_lse_exact=empty_exact)
    if timed:
        item = q.element_size()
        nvalid = (kp == 0).sum(axis=1)  # the work this data needs: valid keys only
        pairs = float(H * Sq * nvalid.sum())
        io_q, io_k = B * H * Sq * D * item, B * H * Sk * D * item
        fb = bound_ms(4 * pairs * D, 2 * io_q + 2 * io_k + 4 * B * Sk + 4 * B * H * Sq, dtype)
        qb = bound_ms(6 * pairs * D, 3 * io_q + 2 * io_k + 12 * B * H * Sq + 4 * B * Sk, dtype)
        kb = bound_ms(8 * pairs * D, 2 * io_q + 4 * io_k + 8 * B * H * Sq + 4 * B * Sk, dtype)
        q4, k4, v4 = (x.view(B, H, -1, D) for x in (q, k, v))
        mask = torch.tensor(kp != 0, device="cuda")
        attend = ~mask[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with torch.no_grad():
            fwd_ms = time_ms(lambda: flash_forward(q, k, v, kpad))
            plain_fwd = time_ms(lambda: flash_attention_plain(q, k, v, kpad))
            xla_fwd = time_ms(lambda: attention_plain(q4, k4, v4, mask, scale=1.0))
            lib_fwd = time_ms(lambda: sdpa(q4, k4, v4, attn_mask=attend, scale=1.0))
        dq_ms = time_ms(lambda: flash_dq(q, k, v, kpad, do, lse, delta))
        dkv_ms = time_ms(lambda: flash_dkv(q, k, v, kpad, do, lse, delta))
        do4 = do.view(B, H, Sq, D)
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        po, _ = flash_attention_plain(qq, kk, vv, kpad)
        plain_dq = time_ms(lambda: torch.autograd.grad(po, [qq], do, retain_graph=True))
        plain_dkv = time_ms(lambda: torch.autograd.grad(po, [kk, vv], do, retain_graph=True))
        q4g, k4g, v4g = (x.view(B, H, -1, D).clone().requires_grad_() for x in (q, k, v))
        xo = attention_plain(q4g, k4g, v4g, mask, scale=1.0)
        xla_bwd = time_ms(lambda: torch.autograd.grad(xo, [q4g, k4g, v4g], do4,
                                                      retain_graph=True))
        lo = sdpa(q4g, k4g, v4g, attn_mask=attend, scale=1.0)
        lib_dq = time_ms(lambda: torch.autograd.grad(lo, [q4g], do4, retain_graph=True))
        lib_dkv = time_ms(lambda: torch.autograd.grad(lo, [k4g, v4g], do4, retain_graph=True))
        del po, xo, lo
        case.update(
            fwd_ms=fwd_ms, fwd_plain_ms=plain_fwd, fwd_library_ms=lib_fwd,
            fwd_bound_ms=fb[0], fwd_bound_by=fb[1], fwd_attention_plain_ms=xla_fwd,
            dq_ms=dq_ms, dq_plain_ms=plain_dq, dq_library_ms=lib_dq, dq_bound_ms=qb[0],
            dq_bound_by=qb[1], dkv_ms=dkv_ms, dkv_plain_ms=plain_dkv, dkv_library_ms=lib_dkv,
            dkv_bound_ms=kb[0], dkv_bound_by=kb[1], bwd_attention_plain_ms=xla_bwd)
        torch.cuda.empty_cache()
    print("flash", json.dumps(case), flush=True)
    if not rel <= TOL[dtype] or not empty_exact or not lse_err <= 1e-3:
        fail(f"the flash kernels disagree with flash_attention_plain: {case}")
    return case


# ----------------------------------------------------------------- phase 4
def main_path(card):
    from exoground_tpu_torch.evals import AlignEvalConfig, FusedAlignEvaluator
    from exoground_tpu_torch.evals.align_fused import _plan
    from exoground_tpu_torch.evals.bench_items import make_bench_items, make_bench_params
    from exoground_tpu_torch.models import TemporalAligner
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.serve import AlignmentService, AlignRequest
    from exoground_tpu_torch.utils.convert import load_tan_params

    model = TemporalAligner(num_encoder_layers=6, num_joint_layers=6, width=512,
                            heads=8, input_dim=4096, device="cpu")
    load_tan_params(model, make_bench_params(0))
    items = make_bench_items(4096, 4096)
    svc = AlignmentService(model, device="cuda")

    groups = []  # (joint S) of every group the service dispatched
    ev = svc._evaluator
    inner = ev._process

    def counting(cfg, dims, host_args):
        groups.append(dims[1] + host_args[4].shape[1])
        return inner(cfg, dims, host_args)

    batches = []  # requests per batch the coalescing front served
    front = svc._front
    serve_batch = front._serve_batch

    def counting_batch(payloads, mode):
        batches.append(len(payloads))
        return serve_batch(payloads, mode)

    ev._process = counting
    front._serve_batch = counting_batch
    reqs = [AlignRequest(video=it["video"], text_embeds=it["text_embed"],
                         start=it["start"], end=it["end"]) for it in items[:4]]

    _kernels.reset_launches()
    t0 = time.perf_counter()
    answers = [svc.align(reqs[0])]
    concurrent = [None] * 3
    barrier = threading.Barrier(3)

    def worker(i):
        barrier.wait()
        concurrent[i] = svc.align(reqs[1 + i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    ev._process = inner
    front._serve_batch = serve_batch
    if any(th.is_alive() for th in threads) or any(a is None for a in concurrent):
        fail("concurrent align() requests did not finish")
    answers += concurrent
    expect_mha = sum(6 + (6 if s <= 128 else 0) for s in groups)
    expect_mlp = 12 * len(groups)
    print(f"main path: {len(reqs)} align() requests in {len(batches)} front batches "
          f"(sizes {batches}), {len(groups)} group dispatches (joint S {groups}), "
          f"{wall:.3f} s, launches {launches}, {card}", flush=True)
    if sum(batches) != len(reqs) or not len(batches) < len(reqs):
        fail(f"the coalescing front served {len(reqs)} requests (3 concurrent) in "
             f"batches {batches}: no two shared a dispatch")
    if launches["fused_mha"] != expect_mha or launches["fused_mlp"] != expect_mlp:
        fail(f"launch counts {launches} != expected mha {expect_mha}, mlp {expect_mlp}")
    for req, ans in zip(reqs, answers):
        k, vlen = len(req.text_embeds), len(req.video)
        if not (len(ans["best_second"]) == k and all(0 <= s < vlen for s in ans["best_second"])
                and np.isfinite(ans["score"]).all()):
            fail(f"malformed align() answer for a {vlen}-frame video")

    # the same request on the CPU plain path (all texts active: identity order)
    req = AlignRequest(video=items[4]["video"], text_embeds=items[4]["text_embed"])
    gpu = svc.align(req)
    cpu_svc = AlignmentService(model, device="cpu")
    t0 = time.perf_counter()
    cpu = cpu_svc.align(req)
    cpu_s = time.perf_counter() - t0
    k = len(req.text_embeds)
    item = {"video": req.video, "start": np.zeros(k), "end": np.full(k, float(len(req.video))),
            "aligned": np.zeros(k, np.int64), "text_embed": req.text_embeds}
    cfg_all = cpu_svc._evaluator._cfg_for(True)
    (_, dims, host_args, _), = list(_plan([item], cfg_all))
    _, canvas = cpu_svc._evaluator._process(cfg_all, dims, host_args)
    top2 = torch.topk(canvas[:k, :len(req.video)], 2, dim=-1).values.numpy()
    g_score, c_score = np.asarray(gpu["score"]), np.asarray(cpu["score"])
    score_err = np.abs(g_score - c_score).max() / np.abs(c_score).max()
    tol = 1e-4 * np.abs(c_score).max()
    clear = top2[:, 0] - top2[:, 1] > tol
    same = np.asarray(gpu["best_second"]) == np.asarray(cpu["best_second"])
    print(f"card vs CPU plain path ({k} texts, CPU {cpu_s:.1f} s): score rel err "
          f"{score_err:.3e}, best_second equal on {int(same[clear].sum())}/"
          f"{int(clear.sum())} texts with a top-2 margin > {tol:.2e}", flush=True)
    if not score_err <= 1e-4 or not same[clear].all():
        fail("the card's align() disagrees with the CPU plain path")

    # the evaluator over the 8 bench videos, float32 and bfloat16
    frames = sum(len(it["video"]) for it in items)
    for dtype in ("float32", "bfloat16"):
        fev = FusedAlignEvaluator(model, AlignEvalConfig(compute_dtype=dtype), device="cuda")
        fev(items)  # warm-up: allocator, cuBLAS handles
        sweeps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = fev(items)
            torch.cuda.synchronize()
            sweeps.append(time.perf_counter() - t0)
        dt = statistics.median(sweeps)
        print(f"FusedAlignEvaluator {dtype}: R@1 {metrics['Recall']:.4f} AUC "
              f"{metrics['AUC']:.4f}, {frames} frames, sweeps {sweeps} s, median "
              f"{dt:.4f} s = {frames / dt:.1f} frames/s on {card}", flush=True)
        if not (0.0 <= metrics["Recall"] <= 1.0 and 0.0 <= metrics["AUC"] <= 1.0):
            fail(f"metrics out of range: {metrics}")
    return launches


# ----------------------------------------------------------------- phase 5
BENCH_TRAIN = dict(model="cotrain", learn_agreement=1, temporal_agreement_type="keep",
                   loss_threshold=0.7, use_alignability_head=1, momentum_m=0.999, lr=1e-4,
                   epochs=1, seed=0)


def _aligner():
    from exoground_tpu_torch.evals.bench_items import make_bench_params
    from exoground_tpu_torch.models import TemporalAligner
    from exoground_tpu_torch.utils.convert import load_tan_params

    model = TemporalAligner(num_encoder_layers=6, num_joint_layers=6, width=512, heads=8,
                            input_dim=4096, use_alignability_head=1, device="cpu")
    load_tan_params(model, make_bench_params(0, binary_head=True))
    return model


def train_agreement(model):
    """One float32 step's loss and grads on the card and on the CPU plain
    path, from the same weights, batch and pos-start draws."""
    import copy

    from exoground_tpu_torch.evals.bench_items import make_train_batch
    from exoground_tpu_torch.losses.milnce import TANLossConfig
    from exoground_tpu_torch.parallel import make_tan_train_step
    from exoground_tpu_torch.train import make_fused_optimizer

    batch_np = make_train_batch(4, seed=1)
    losses = {}
    for cfg_name, cfg in (("init", TANLossConfig(model="init")),
                          ("cotrain", TANLossConfig(
                              model="cotrain", learn_agreement=True,
                              temporal_agreement_type="keep", loss_threshold=0.7,
                              use_alignability_head=True))):
        res = {}
        for dev in ("cpu", "cuda"):
            m = copy.deepcopy(model).to(dev)
            params = {k: p.detach() for k, p in m.named_parameters()}
            step = make_tan_train_step(m, cfg, make_fused_optimizer(params),
                                       ema_momentum=0.999 if cfg.model == "cotrain" else None)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
            t0 = time.perf_counter()
            metrics, grads = step.loss_and_grads(params, params, batch,
                                                 torch.Generator().manual_seed(0))
            loss = float(metrics["loss"])
            res[dev] = (loss, {k: g.float().cpu() for k, g in grads.items() if g is not None},
                        time.perf_counter() - t0)
        losses[cfg_name] = (res["cpu"][0], res["cuda"][0])
        if cfg_name != "init":
            continue
        (lc, gc, sc), (lg, gg, sg) = res["cpu"], res["cuda"]
        loss_rel = abs(lg - lc) / abs(lc)
        worst = max(((gg[k] - gc[k]).abs().max().item()
                     / max(gc[k].abs().max().item(), 1e-30), k) for k in gc)
        print(f"train step card vs CPU (init, B4 f32, {len(gc)} grads, CPU {sc:.1f} s): loss "
              f"{lg:.6f} vs {lc:.6f} (rel {loss_rel:.2e}), worst grad {worst[1]} at "
              f"{worst[0]:.2e} of its max|CPU|", flush=True)
        if set(gg) != set(gc) or not loss_rel <= 1e-4 or not worst[0] <= 1e-3:
            fail("the card's train step disagrees with the CPU plain path")
    print(f"cotrain step-1 loss (B4 f32, discrete agreement choices may flip on near-ties): "
          f"card {losses['cotrain'][1]:.6f}, CPU {losses['cotrain'][0]:.6f}", flush=True)


# one cotrain step with attn_impl='flash' launches the flash forward in the
# online and the teacher forward of both towers (6 + 6 layers each) and the
# two backward kernels once per layer of the online forward
FLASH_FWD_PER_STEP = 2 * (6 + 6)
FLASH_BWD_PER_STEP = 6 + 6


def train_flash_agreement(model):
    """One float32 cotrain step at B 4 with attn_impl='flash' on the card
    (the flash kernels) and on the CPU (flash_attention_plain), from the same
    weights, batch and pos-start draws."""
    import copy

    from exoground_tpu_torch.evals.bench_items import make_train_batch
    from exoground_tpu_torch.losses.milnce import TANLossConfig
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.parallel import make_tan_train_step
    from exoground_tpu_torch.train import make_fused_optimizer

    batch_np = make_train_batch(4, seed=1)
    cfg = TANLossConfig(model="cotrain", learn_agreement=True, temporal_agreement_type="keep",
                        loss_threshold=0.7, use_alignability_head=True)
    res = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        m.attn_impl = "flash"
        params = {k: p.detach() for k, p in m.named_parameters()}
        step = make_tan_train_step(m, cfg, make_fused_optimizer(params), ema_momentum=0.999)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        n0 = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        metrics, grads = step.loss_and_grads(params, params, batch,
                                             torch.Generator().manual_seed(0))
        loss = float(metrics["loss"])
        res[dev] = (loss, {k: g.float().cpu() for k, g in grads.items() if g is not None},
                    time.perf_counter() - t0,
                    {n: _kernels.LAUNCHES[n] - n0[n] for n in ("flash_fwd", "flash_dq",
                                                                "flash_dkv")})
    (lc, gc, sc, _), (lg, gg, sg, launched) = res["cpu"], res["cuda"]
    loss_rel = abs(lg - lc) / abs(lc)
    worst = max(((gg[k] - gc[k]).abs().max().item()
                 / max(gc[k].abs().max().item(), 1e-30), k) for k in gc)
    print(f"flash train step card vs CPU (cotrain, B4 f32, {len(gc)} grads, CPU {sc:.1f} s): "
          f"loss {lg:.6f} vs {lc:.6f} (rel {loss_rel:.2e}), worst grad {worst[1]} at "
          f"{worst[0]:.2e} of its max|CPU|, card launches {launched}", flush=True)
    if set(gg) != set(gc) or not loss_rel <= 1e-4 or not worst[0] <= 1e-3:
        fail("the card's flash train step disagrees with the CPU plain path")
    if launched != {"flash_fwd": FLASH_FWD_PER_STEP, "flash_dq": FLASH_BWD_PER_STEP,
                    "flash_dkv": FLASH_BWD_PER_STEP}:
        fail(f"flash launches {launched} in one step != {FLASH_FWD_PER_STEP} forward, "
             f"{FLASH_BWD_PER_STEP} dq and dk/dv")


def train_path(model, card, batches=(16, 64), attn_impl="auto"):
    """Timed TANTrainer steps at ``batches``, float32 and bfloat16, with the
    configuration's ``attn_impl``; returns the launches of the timed steps."""
    import copy

    from exoground_tpu_torch.evals.bench_items import make_train_batch
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.train import ExperimentConfig, TANTrainer

    flash = attn_impl == "flash"
    totals = {k: 0 for k in _kernels.LAUNCHES}
    runs = []
    for b in batches:
        for amp in (False, True):
            cfg = ExperimentConfig(amp=amp, attn_impl=attn_impl, **BENCH_TRAIN)
            trainer = TANTrainer(copy.deepcopy(model), cfg, iters_per_epoch=1000,
                                 device="cuda")
            batch = trainer.to_device(trainer.prepare_batch(make_train_batch(b, seed=2)))
            target0 = {k: v.clone() for k, v in trainer.target_params.items()}
            losses = [float(trainer.train_step(batch)["loss"])]  # warm-up
            torch.cuda.synchronize()
            _kernels.reset_launches()
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                losses.append(float(trainer.train_step(batch)["loss"]))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            launches = dict(_kernels.LAUNCHES)
            for k, n in launches.items():
                totals[k] += n
            ms = statistics.median(times) * 1e3
            moved = sum((trainer.target_params[k] != target0[k]).sum().item() for k in target0)
            run = dict(batch=b, dtype="bfloat16" if amp else "float32", attn_impl=attn_impl,
                       step_ms=ms,
                       samples_per_s=b / ms * 1e3, step_ms_all=[t * 1e3 for t in times],
                       loss_first=losses[0], loss_last=losses[-1], ema_entries_moved=moved,
                       launches=launches, card=card)
            print("train", json.dumps(run), flush=True)
            runs.append(run)
            if not all(np.isfinite(losses)):
                fail(f"non-finite train loss: {run}")
            if moved == 0:
                fail(f"the EMA twin did not move: {run}")
            want_flash = ((10 * FLASH_FWD_PER_STEP, 10 * FLASH_BWD_PER_STEP,
                           10 * FLASH_BWD_PER_STEP) if flash else (0, 0, 0))
            if (launches["milnce_grid_fwd"] != 20 or launches["milnce_grid_bwd"] != 20
                    or launches["fused_mha"] or launches["fused_mlp"]
                    or (launches["flash_fwd"], launches["flash_dq"],
                        launches["flash_dkv"]) != want_flash):
                fail(f"train launches {launches} != 2 + 2 grid per step, 0 MHA/MLP, "
                     f"flash fwd/dq/dkv {want_flash} in 10 steps")
            del trainer, batch
            torch.cuda.empty_cache()
    return totals, runs


# ----------------------------------------------------------------- phase 6
def global_path(card):
    """HTM-Align global mode over long videos at E6D6 full width (auto
    dispatch: every encoder self-attention through the flash kernel),
    counted; the first video again on the CPU plain path; then
    text_visual_sim at the JAX package's global bench shape through flash
    and through attention_plain, float32 and bfloat16."""
    import copy

    from exoground_tpu_torch.evals.align import (
        AlignEvalConfig, make_tan_sim_fn, test_alignment_htm)
    from exoground_tpu_torch.evals.bench_items import (
        make_bench_params, make_global_bench_inputs, make_global_items)
    from exoground_tpu_torch.models import TemporalAligner
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.utils.convert import load_tan_params

    model = TemporalAligner(num_encoder_layers=6, num_joint_layers=6, width=512, heads=8,
                            input_dim=4096, device="cpu")
    load_tan_params(model, make_bench_params(0))
    gpu = copy.deepcopy(model).to("cuda")
    items = make_global_items(4096, 4096)
    cfg = AlignEvalConfig(method="global")
    sims = {"cuda": [], "cpu": []}

    def recording(fn, log):
        def rec(*args, **kw):
            out = fn(*args, **kw)
            log.append(out["sim"])
            return out
        return rec

    cuda_fn = recording(make_tan_sim_fn(gpu), sims["cuda"])
    _kernels.reset_launches()
    t0 = time.perf_counter()
    metrics = test_alignment_htm(items, cuda_fn, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    frames = sum(len(it["video"]) for it in items)
    n = len(items)
    print(f"global mode: {n} videos ({[len(it['video']) for it in items]} frames), R@1 "
          f"{metrics['Recall']:.4f} AUC {metrics['AUC']:.4f}, {wall:.3f} s (first call "
          f"included), launches {launches}, {card}", flush=True)
    want = dict(flash_fwd=12 * n, flash_dq=0, flash_dkv=0, fused_mha=0, fused_mlp=12 * n)
    if {k: launches[k] for k in want} != want:
        fail(f"global-mode launches {launches} != {want}")
    if not (0.0 <= metrics["Recall"] <= 1.0 and 0.0 <= metrics["AUC"] <= 1.0):
        fail(f"global-mode metrics out of range: {metrics}")
    for sim, it in zip(sims["cuda"], items):
        if sim.shape[-1] % 128 or sim.shape[1] != len(it["start"]) or not np.isfinite(sim).all():
            fail(f"malformed global-mode sim {sim.shape} for a {len(it['video'])}-frame video")

    # the first video on the CPU plain path
    first = items[:1]
    t0 = time.perf_counter()
    cpu_metrics = test_alignment_htm(first, recording(make_tan_sim_fn(model), sims["cpu"]),
                                     cfg)
    cpu_s = time.perf_counter() - t0
    card_metrics = test_alignment_htm(first, make_tan_sim_fn(gpu), cfg)
    g, c = sims["cuda"][0], sims["cpu"][0]
    rel = float(np.abs(g - c).max() / np.abs(c).max())
    print(f"global mode card vs CPU plain path ({len(first[0]['video'])} frames, CPU "
          f"{cpu_s:.1f} s): sim rel err {rel:.3e}, card {card_metrics}, CPU {cpu_metrics}",
          flush=True)
    if not rel <= 1e-4 or card_metrics != cpu_metrics:
        fail("the card's global mode disagrees with the CPU plain path")

    # text_visual_sim at the JAX bench shape: flash (auto) against plain (xla)
    inputs = make_global_bench_inputs(0)
    runs = []
    for dtype in (torch.float32, torch.bfloat16):
        m = copy.deepcopy(model).to(device="cuda", dtype=dtype)
        video = torch.tensor(inputs["video"], dtype=dtype, device="cuda")
        text = torch.tensor(inputs["text"], dtype=dtype, device="cuda")
        max_pos = m.temporal_pos_embed.shape[0]

        def call(impl):
            m.attn_impl = impl
            with torch.inference_mode():
                out = m.text_visual_sim(video, text, interpolate_from=max_pos)
            torch.cuda.synchronize()
            return out

        times = {None: [], "xla": []}
        outs = {impl: call(impl) for impl in times}  # warm-up
        call(None), call("xla")
        for _ in range(5):
            for impl in (None, "xla", "xla", None):
                t0 = time.perf_counter()
                call(impl)
                times[impl].append((time.perf_counter() - t0) * 1e3)
        _kernels.reset_launches()
        call(None)
        per_call = dict(_kernels.LAUNCHES)
        a, b = outs[None]["sim"].float(), outs["xla"]["sim"].float()
        agree = ((a - b).abs().max() / b.abs().max()).item()
        run = dict(dtype=str(dtype).split(".")[-1], shape="1 x 2048 frames, 48 texts",
                   flash_ms=statistics.median(times[None]),
                   plain_ms=statistics.median(times["xla"]),
                   flash_ms_all=times[None], plain_ms_all=times["xla"],
                   flash_vs_plain_sim_rel=agree, launches_per_call=per_call, card=card)
        print("global_bench", json.dumps(run), flush=True)
        runs.append(run)
        if per_call["flash_fwd"] != 12 or per_call["fused_mha"]:
            fail(f"the bench-shape call launched {per_call}, not 12 flash forwards")
        if not np.isfinite(a.cpu().numpy()).all() or not agree <= TOL[dtype]:
            fail(f"flash and plain routes disagree at the bench shape: {run}")
        del m, video, text, outs
        torch.cuda.empty_cache()
    return launches, runs


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: float32 products run in full float32")

    from exoground_tpu_torch.ops import _kernels

    # phase 1: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    print(smi, flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    _kernels.build()
    print(f"built {sorted(_kernels.SIGNATURES)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # phase 3: kernels against their plain versions
    mha_cases, mlp_cases = [], []
    for dtype in (torch.float32, torch.bfloat16):
        mha_cases.append(mha_case(304, 64, 512, 8, dtype, seed=1))
        mha_cases.append(mha_case(304, 96, 512, 8, dtype, seed=2))
        mha_cases.append(mha_case(5, 33, 128, 4, dtype, seed=3))
        mha_cases.append(mha_case(3, 17, 128, 16, dtype, seed=6))   # head size 8
        mha_cases.append(mha_case(4, 72, 640, 16, dtype, seed=7))   # head size 40
        mha_cases.append(mha_case(3, 128, 384, 8, dtype, seed=8))   # head size 48
        mlp_cases.append(mlp_case(19456, 512, dtype, seed=4))
        mlp_cases.append(mlp_case(210, 128, dtype, seed=5))
        mlp_cases.append(mlp_case(300, 640, dtype, seed=9))  # two column slabs
        mlp_cases.append(mlp_case(77, 1024, dtype, seed=10))
        mlp_cases.append(mlp_case(40, 1280, dtype, seed=11))  # x streamed, not resident
        # the global path's rows: dual and joint tower at the bench shape (2048
        # frames + 48 texts), joint tower of the 3000-frame video (3072 + 250):
        # 64 to 104 CTAs of 32 rows, the last one partly empty at 2096 and 3322
        for rows in (2048, 2096, 3322):
            mlp_cases.append(mlp_case(rows, 512, dtype, seed=12))

    # phase 3b: the grid kernel against its plain version
    grid_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        grid_cases.append(grid_case(6, 1024, 192, 512, 6, dtype, seed=20, timed=True))
        grid_cases.append(grid_case(6, 1024, 192, 512, 1, dtype, seed=21, timed=True))
        grid_cases.append(grid_case(6, 4096, 768, 512, 6, dtype, seed=22, timed=True))
        grid_cases.append(grid_case(6, 4096, 768, 512, 1, dtype, seed=23, timed=True))
        grid_cases.append(grid_case(2, 36, 15, 128, 1, dtype, seed=24, n_invalid=3))
        grid_cases.append(grid_case(1, 512, 3072, 512, 1, dtype, seed=25, n_invalid=5))

    # phase 3c: the flash kernels against their plain version
    flash_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        flash_cases.append(flash_case(1, 8, 2048, 2048, 64, dtype, seed=30, timed=True))
        flash_cases.append(flash_case(1, 8, 2096, 2096, 64, dtype, seed=31, pad_tail=48,
                                      timed=True))
        flash_cases.append(flash_case(1, 8, 4096, 4096, 64, dtype, seed=32, timed=True))
        flash_cases.append(flash_case(1, 8, 1024, 1024, 64, dtype, seed=33, timed=True))
        flash_cases.append(flash_case(16, 8, 64, 64, 64, dtype, seed=34))
        flash_cases.append(flash_case(16, 8, 76, 76, 64, dtype, seed=35))
        flash_cases.append(flash_case(1, 8, 96, 200, 64, dtype, seed=36, pad_tail=60))
        flash_cases.append(flash_case(2, 2, 130, 257, 32, dtype, seed=37, empty_row=True))
        flash_cases.append(flash_case(2, 4, 300, 300, 128, dtype, seed=38, pad_tail=20))
        flash_cases.append(flash_case(2, 3, 50, 70, 40, dtype, seed=39, empty_row=True))

    # phase 4: the serving path, counted
    launches = main_path(card)

    # phase 5: the train path, counted (auto at B 16 and 64, then the flash
    # kernels under attn_impl='flash' at B 16)
    model = _aligner()
    train_agreement(model)
    train_launches, _ = train_path(model, card)
    launches.update({k: train_launches[k] for k in ("milnce_grid_fwd", "milnce_grid_bwd")})
    train_flash_agreement(model)
    flash_train_launches, _ = train_path(model, card, batches=(16,), attn_impl="flash")

    # phase 6: global mode over long videos, counted
    global_launches, _ = global_path(card)
    flash_launches = {
        "flash_fwd": {"global mode (phase 6)": global_launches["flash_fwd"],
                      "train attn_impl=flash (phase 5)": flash_train_launches["flash_fwd"]},
        "flash_dq": {"train attn_impl=flash (phase 5)": flash_train_launches["flash_dq"]},
        "flash_dkv": {"train attn_impl=flash (phase 5)": flash_train_launches["flash_dkv"]},
    }
    launches.update({k: sum(v.values()) for k, v in flash_launches.items()})

    def entry(name, source, replaces, cases):
        head = cases[0]  # main-path shape, float32
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": head["max_abs_err"],
                "max_rel_err": head["max_rel_err"], "ms": head["ms"],
                "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "shape": head["shape"],
                "dtype": head["dtype"], "cases": cases}

    def grid_entry(part, replaces):
        cases = [{k: v for k, v in c.items() if not k.startswith("bwd" if part == "fwd" else
                                                                  "fwd")}
                 for c in grid_cases]
        for c in cases:
            for k in ("ms", "plain_ms", "bound_ms", "bound_by"):
                if f"{part}_{k}" in c:
                    c[k] = c.pop(f"{part}_{k}")
        return entry(f"milnce_grid_{part}", "exoground_tpu_torch/csrc/milnce_grid.cu",
                     replaces, cases)

    def flash_entry(part, replaces):
        parts = ("fwd", "dq", "dkv")
        cases = []
        for c in flash_cases:
            c = {k: v for k, v in c.items()
                 if not any(k.startswith(f"{p}_") for p in parts if p != part)}
            for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
                if f"{part}_{k}" in c:
                    c[k] = c.pop(f"{part}_{k}")
            cases.append(c)
        e = entry(f"flash_{part}", "exoground_tpu_torch/csrc/flash_attn.cu", replaces, cases)
        e["launches_by_path"] = flash_launches[f"flash_{part}"]
        return e

    print(json.dumps({"kernels": [
        entry("fused_mha", "exoground_tpu_torch/csrc/fused_mha.cu",
              "exoground_tpu/ops/attention.py:761", mha_cases),
        entry("fused_mlp", "exoground_tpu_torch/csrc/fused_mlp.cu",
              "exoground_tpu/ops/fused_mlp.py:244", mlp_cases),
        grid_entry("fwd", "exoground_tpu/ops/milnce_grid.py:184"),
        grid_entry("bwd", "exoground_tpu/ops/milnce_grid.py:231"),
        flash_entry("fwd", "exoground_tpu/ops/attention.py:279"),
        flash_entry("dq", "exoground_tpu/ops/attention.py:329"),
        flash_entry("dkv", "exoground_tpu/ops/attention.py:347"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
