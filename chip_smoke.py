"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile every kernel of the main path from exoground_tpu_torch/csrc
     (one nvcc per source, started together), print the build seconds;
  3. kernels: each kernel against its plain PyTorch version on the card, on the
     same inputs, at the main-path shapes (fused MHA B=304 C=512 H=8 at S=64
     and S=96 with one fully-masked window and ragged tails; fused MLP at
     19456 rows, C=512) and small shapes that reach the kernels' other
     instantiations (head sizes 8, 40, 48; MLP widths 128, 640, 1024, 1280), in
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

    # phase 4: the main path, counted
    launches = main_path(card)

    def entry(name, source, replaces, cases):
        head = cases[0]  # main-path shape, float32
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": head["max_abs_err"],
                "max_rel_err": head["max_rel_err"], "ms": head["ms"],
                "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "shape": head["shape"],
                "dtype": head["dtype"], "cases": cases}

    print(json.dumps({"kernels": [
        entry("fused_mha", "exoground_tpu_torch/csrc/fused_mha.cu",
              "exoground_tpu/ops/attention.py:761", mha_cases),
        entry("fused_mlp", "exoground_tpu_torch/csrc/fused_mlp.cu",
              "exoground_tpu/ops/fused_mlp.py:244", mlp_cases),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
