"""Where the main path's time goes on the card.

    python -m exoground_tpu_torch.tools.profile_main_path [--out DIR]
        [--train | --global | --ground] [--block] [--int8] [--resident]

Runs FusedAlignEvaluator over the 8 bench videos (TemporalAligner E6D6,
width 512, 4096-d inputs, seeded weights) in float32 and bfloat16: one
warm-up sweep, three timed sweeps (host clock around work that ends in
``torch.cuda.synchronize()``), then one sweep under ``torch.profiler``.
Prints, per dtype, one JSON line: frames/s (frames over the median timed
sweep, as chip_smoke.py reports it), the device busy share of the
profiled sweep (sum of kernel times over its wall time), the MHA family's
device time by kernel (row prologue, bf16 tile, f32 tile, the int8 f32
body's (window, head) kernel, out-projection) and its share of the busy
time, and the kernels that took the most device time.

``--train`` profiles the train path instead: TANTrainer cotrain steps at
the JAX package's train-bench configuration (E6D6 with the alignability
head, keep agreement, loss threshold 0.7, EMA 0.999) at batch 16 and 64 in
float32 and bfloat16: two warm-up steps, five timed steps (median), then
one step under ``torch.profiler``; one JSON line per run.

``--global`` profiles the global mode instead: one ``text_visual_sim`` at
the JAX package's global bench shape (1 x 2048 frames, 48 texts, E6D6, auto
dispatch: every encoder self-attention through the flash kernel) in float32
and bfloat16: two warm-up calls, five timed calls (median), then one call
under ``torch.profiler``; one JSON line per dtype with the device time by
kernel, the idle share and the flash and fused-MLP shares of the busy time.

``--int8`` profiles the int8 serving mode instead: the same sweeps in the
JAX bench's int8 configuration (bfloat16 compute, float16 transfer,
matmul_dtype='int8', int8_min_cols=1024: every encoder layer through the
int8 fused-MHA and fused-MLP kernels), with the int8 MLP's device time.

``--block`` profiles the whole-block path instead of the per-module one:
the model built with attn_impl="fused", mlp_impl="fused", so every encoder
layer runs two launches, the block-attention and block-MLP kernels (their
int8 bodies with ``--int8``), with the block MLP's share of the busy time
(the block attention's kernels are the MHA family's, counted there).

``--resident`` profiles the resident sweep instead of the streaming one
(with ``--int8`` and ``--block`` too): the 8 bench videos are uploaded once
(``FusedAlignEvaluator.preload``), and each timed and profiled sweep is a
``run_preloaded``, so the sweep holds no upload.

``--ground`` profiles keystep grounding served instead: ``GroundingService``
over ``GroundingModel`` at the configuration scripts/train_grounding.sh
trains (``evals/bench_items.py::GROUNDING``: the MLP view-invariant
pre-pass, the trunk E6D6, width 512, 4096-d; seeded weights), float32, one
bucket of 64 requests (``make_grounding_requests``): one warm-up call, five
timed ``ground_batch`` calls (median), then one call under
``torch.profiler``; one JSON line per attention impl, 'small' (every window
through the window-attention kernel) and 'auto' (the fused-MHA kernel on
self-attention), in one process, with the window kernel's and the fused
kernels' shares of the busy time.

With ``--out`` the Chrome traces are written there. Needs a CUDA device;
raises otherwise.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from exoground_tpu_torch.evals import AlignEvalConfig, FusedAlignEvaluator
from exoground_tpu_torch.evals.bench_items import (
    INT8_SERVING,
    make_bench_items,
    make_bench_params,
)
from exoground_tpu_torch.models import TemporalAligner
from exoground_tpu_torch.ops import _kernels
from exoground_tpu_torch.utils.convert import load_tan_params


def _sweep(run) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _device_rows(prof):
    # device-side events only (kernels, memcpy, memset): the CPU-side aten
    # ops that launched them carry the same time again
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    return rows


def profile_sweeps(model, items, out_dir=None, resident=False, **cfg) -> dict:
    """The main path in one configuration (``cfg``: AlignEvalConfig
    fields), labelled by its compute dtype, with '_int8' under
    matmul_dtype='int8', '_block' for the whole-block model and
    '_resident' for ``run_preloaded`` sweeps over a preload."""
    cfg = AlignEvalConfig(**cfg)
    block = getattr(model, "attn_impl", None) == "fused"
    label = (cfg.compute_dtype + ("_int8" if cfg.matmul_dtype == "int8" else "")
             + ("_block" if block else "") + ("_resident" if resident else ""))
    ev = FusedAlignEvaluator(model, cfg, device="cuda")
    run = (functools.partial(ev.run_preloaded, ev.preload(items)) if resident
           else functools.partial(ev, items))
    _sweep(run)  # warm-up
    times = [_sweep(run) for _ in range(3)]
    frames = sum(len(it["video"]) for it in items)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _sweep(run)
    rows = _device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, f"main_path_{label}.json"))
    # by kernel name: the MHA family's (csrc/mha_tile.cuh, shared by fused
    # MHA, the int8 MHA and both block-attention bodies: the row prologue,
    # the bf16 tile, the f32 3xTF32 tile, the int8 f32 body's (window, head)
    # kernel, the out-projection), the int8 MLP and the block MLP (both bodies)
    attn_us = {k: sum(us for us, _, key in rows if name in key)
               for k, name in (("row_prologue", "row_prologue_kernel"),
                               ("tile_bf16", "mha_tc_kernel"),
                               ("tile_tf32", "mha_tf32_kernel"),
                               ("window_head_f32", "window_head_kernel"),
                               ("out_projection", "linear_bias"))}
    int8_us = {"mlp_int8": sum(us for us, _, key in rows if "fused_mlp_int8" in key)}
    block_us = {"block_mlp": sum(us for us, _, key in rows if "block_mlp" in key)}
    return {
        "dtype": label,
        "path": "block" if block else "per_module",
        "resident": resident,
        "transfer_dtype": cfg.transfer_dtype,
        "matmul_dtype": cfg.matmul_dtype,
        "int8_min_cols": cfg.int8_min_cols,
        "frames": frames,
        "sweep_s": sorted(times),
        "frames_per_s": frames / statistics.median(times),
        "profiled_sweep_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "attention_kernels_ms": {k: us / 1e3 for k, us in attn_us.items()},
        "attention_share_of_busy": sum(attn_us.values()) / max(busy_us, 1e-9),
        "int8_kernels_ms": {k: us / 1e3 for k, us in int8_us.items()},
        "block_kernels_ms": {k: us / 1e3 for k, us in block_us.items()},
        "block_kernels_share_of_busy": sum(block_us.values()) / max(busy_us, 1e-9),
        "top_kernels": [{"name": k[:80], "calls": c, "device_ms": us / 1e3}
                        for us, c, k in rows[:12]],
    }


def profile_train(model, batch_size: int, amp: bool, out_dir=None) -> dict:
    import copy

    from exoground_tpu_torch.evals.bench_items import make_train_batch
    from exoground_tpu_torch.train import ExperimentConfig, TANTrainer

    cfg = ExperimentConfig(model="cotrain", learn_agreement=1, temporal_agreement_type="keep",
                           loss_threshold=0.7, use_alignability_head=1, momentum_m=0.999,
                           lr=1e-4, epochs=1, seed=0, amp=amp)
    trainer = TANTrainer(copy.deepcopy(model), cfg, iters_per_epoch=1000, device="cuda")
    batch = trainer.to_device(trainer.prepare_batch(make_train_batch(batch_size, seed=2)))

    def step() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(trainer.train_step(batch)["loss"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    step(), step()  # warm-up
    times = [step() for _ in range(5)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = step()
    rows = _device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    dtype = "bfloat16" if amp else "float32"
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, f"train_b{batch_size}_{dtype}.json"))
    grid_us = sum(us for us, _, k in rows if "grid_" in k)
    return {
        "batch": batch_size,
        "dtype": dtype,
        "step_ms": statistics.median(times) * 1e3,
        "samples_per_s": batch_size / statistics.median(times),
        "profiled_step_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "grid_kernels_ms": grid_us / 1e3,
        "top_kernels": [{"name": k[:80], "calls": c, "device_ms": us / 1e3}
                        for us, c, k in rows[:12]],
    }


def profile_global(model, dtype: str, out_dir=None) -> dict:
    import copy

    from exoground_tpu_torch.evals.bench_items import make_global_bench_inputs

    tdt = getattr(torch, dtype)
    m = copy.deepcopy(model).to(device="cuda", dtype=tdt)
    inputs = make_global_bench_inputs(0)
    video = torch.tensor(inputs["video"], dtype=tdt, device="cuda")
    text = torch.tensor(inputs["text"], dtype=tdt, device="cuda")
    max_pos = m.temporal_pos_embed.shape[0]

    def call() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            m.text_visual_sim(video, text, interpolate_from=max_pos)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    call(), call()  # warm-up
    times = [call() for _ in range(5)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = call()
    rows = _device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, f"global_{dtype}.json"))
    flash_us = sum(us for us, _, k in rows if "flash_" in k)
    mlp_us = sum(us for us, _, k in rows if "fused_mlp" in k)
    return {
        "dtype": dtype,
        "shape": "1 x 2048 frames, 48 texts",
        "call_ms": statistics.median(times) * 1e3,
        "call_ms_all": [t * 1e3 for t in times],
        "profiled_call_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "flash_ms": flash_us / 1e3,
        "flash_share_of_busy": flash_us / busy_us,
        "fused_mlp_ms": mlp_us / 1e3,
        "fused_mlp_share_of_busy": mlp_us / busy_us,
        "top_kernels": [{"name": k[:80], "calls": c, "device_ms": us / 1e3}
                        for us, c, k in rows[:12]],
    }


def profile_ground(svc, requests, impl: str, out_dir=None) -> dict:
    """``svc`` (a GroundingService on the card) under attention ``impl``."""
    svc.model.attn_impl = impl

    def call() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.ground_batch(requests)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    call()  # warm-up
    times = [call() for _ in range(5)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = call()
    rows = _device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, f"ground_{impl}.json"))
    # fused MHA: the f32 tile and its out-projection
    share = {k: sum(us for us, _, key in rows if any(n in key for n in names))
             / max(busy_us, 1e-9)
             for k, names in (("small_attn", ("small_attn",)),
                              ("fused_mha", ("mha_tf32_kernel", "linear_bias")),
                              ("fused_mlp", ("fused_mlp",)))}
    med = statistics.median(times)
    return {
        "impl": impl,
        "requests": len(requests),
        "call_ms": med * 1e3,
        "call_ms_all": [t * 1e3 for t in times],
        "requests_per_s": len(requests) / med,
        "profiled_call_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "share_of_busy": share,
        "top_kernels": [{"name": k[:80], "calls": c, "device_ms": us / 1e3}
                        for us, c, k in rows[:12]],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for Chrome traces")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true", help="profile the train path")
    mode.add_argument("--global", dest="global_mode", action="store_true",
                      help="profile global-mode text_visual_sim at the bench shape")
    mode.add_argument("--ground", action="store_true",
                      help="profile GroundingService ('small' and 'auto')")
    ap.add_argument("--int8", action="store_true",
                    help="profile the int8 serving mode (the JAX bench's int8 row)")
    ap.add_argument("--block", action="store_true",
                    help="profile the whole-block path (attn_impl and mlp_impl 'fused')")
    ap.add_argument("--resident", action="store_true",
                    help="profile run_preloaded sweeps over a preload (no upload a sweep)")
    args = ap.parse_args()
    if (args.int8 or args.block or args.resident) and (args.train or args.global_mode
                                                         or args.ground):
        ap.error("--int8, --block and --resident profile the serving sweeps, not --train, "
                 "--global or --ground")
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _kernels.build()
    if args.ground:
        from exoground_tpu_torch.evals.bench_items import (
            GROUNDING, make_grounding_params, make_grounding_requests)
        from exoground_tpu_torch.models import GroundingModel
        from exoground_tpu_torch.serve import GroundingService
        from exoground_tpu_torch.utils.convert import load_grounding_params

        gm = GroundingModel(**GROUNDING, device="cpu")
        load_grounding_params(gm, make_grounding_params(0))
        svc = GroundingService(gm, device="cuda")
        requests = make_grounding_requests(0, 64)
        for impl in ("small", "auto"):
            print(json.dumps({"card": card, **profile_ground(svc, requests, impl, args.out)}),
                  flush=True)
        return
    if args.train:
        model = TemporalAligner(use_alignability_head=1, device="cpu")
        load_tan_params(model, make_bench_params(0, binary_head=True))
        for b in (16, 64):
            for amp in (False, True):
                print(json.dumps({"card": card, **profile_train(model, b, amp, args.out)}),
                      flush=True)
        return
    impls = dict(attn_impl="fused", mlp_impl="fused") if args.block else {}
    model = TemporalAligner(device="cpu", **impls)
    load_tan_params(model, make_bench_params(0))
    if args.global_mode:
        for dtype in ("float32", "bfloat16"):
            print(json.dumps({"card": card, **profile_global(model, dtype, args.out)}),
                  flush=True)
        return
    items = make_bench_items(4096, 4096)
    configs = ([INT8_SERVING] if args.int8
               else [dict(compute_dtype=dtype) for dtype in ("float32", "bfloat16")])
    for cfg in configs:
        print(json.dumps({"card": card, **profile_sweeps(model, items, args.out,
                                                          resident=args.resident, **cfg)}),
              flush=True)


if __name__ == "__main__":
    main()
