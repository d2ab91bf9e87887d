"""Where the main path's time goes on the card.

    python -m exoground_tpu_torch.tools.profile_main_path [--out DIR]
        [--train | --global | --ground | --cli [--fused_steps N]] [--block] [--int8]
        [--resident]

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

``--cli`` profiles the training command line instead: the trainer that
``train/main.py`` builds (``build_htm_tan``) for ``--dataset htm-370k
--model cotrain --fused_steps N`` (``--fused_steps``, default 1) at B64
over a seeded tree (``tools/synth_htm.py``: 1,000 videos of 200-600 s,
512-d features, ASR at the tree's default cadence, the word2vec tower at
the MIL-NCE shapes; 14 steps an epoch) in float32 with 8 and 1 loader
threads and in bfloat16 with 8: one warm-up epoch, one timed epoch (each
step's wall time and its wait for data, the ``Data`` meter, and
``train/trainer.py::epoch_summary``'s window rate), then one epoch under
``torch.profiler`` (its device busy and idle share, the grid's device
time); one JSON line each. Then the steady state: one epoch of 200 steps
(8 threads) at the default ASR cadence, in float32 and bfloat16, each with
the train reader deferred (the batch's windows gathered by the native
reader in collate, as the command line reads) and per item: its window rate
whole and over its second half, the device busy and idle share of 16 steps
of its second half (the device's activity alone under ``torch.profiler``),
beside the reader's host cost an item, collate included (and its shares
under cProfile); one JSON line each.

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


CLI_TREE = dict(n_videos=1000, vlen=(200, 600), dim=512, vocab=66249, embed_dim=300,
                hidden=2048, out_dim=512, n_align=8, seed=0)
# the steady state: one epoch of CLI_LONG_STEPS at B64 over 200 feature
# arrays, at the tree's sourced ASR cadence; CLI_WINDOW steps of its second
# half profiled
CLI_LONG_STEPS, CLI_WINDOW = 200, 16


def _cli_run(root, amp: bool, workers: int, epochs: int, fused_steps: int = 1):
    from exoground_tpu_torch.train import main as cli
    from exoground_tpu_torch.train.config import parse_args

    argv = ["--dataset", "htm-370k", "--model", "cotrain", "--data_root", root,
            "--batch_size", "64", "--epochs", str(epochs), "--num_workers", str(workers),
            "--print_freq", "1000", "--fused_steps", str(fused_steps)] + (
                ["--amp"] if amp else [])
    return cli.build_htm_tan(parse_args(argv), "cuda")


def _epoch_fields(stats) -> dict:
    from exoground_tpu_torch.train.trainer import epoch_summary

    return {**epoch_summary([stats]),
            "step_ms_all": [round(t * 1e3, 1) for t in stats["step_s"]],
            "data_ms_all": [round(t * 1e3, 1) for t in stats["data_s"]]}


def profile_cli(root, amp: bool, workers: int, fused_steps: int, out_dir=None) -> dict:
    """Train epochs of the command line's trainer on the tree at ``root``."""
    run = _cli_run(root, amp, workers, 3, fused_steps)
    tr = run.trainer
    try:
        for epoch in (0, 1):  # warm-up, timed
            run.train_loader.set_epoch(epoch)
            tr.train_epoch(run.train_loader, epoch)
        run.train_loader.set_epoch(2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train_epoch(run.train_loader, 2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        run.close()
    rows = _device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    dtype = "bfloat16" if amp else "float32"
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, f"cli_{dtype}_w{workers}.json"))
    return {
        "dtype": dtype,
        "loader_threads": workers,
        "batch": 64,
        "fused_steps": fused_steps,
        **_epoch_fields(tr.epoch_stats[1]),
        "profiled_epoch_s": wall,
        "profiled_steps": tr.epoch_stats[2]["steps"],
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "grid_kernels_ms": sum(us for us, _, k in rows if "grid_" in k) / 1e3,
        "top_kernels": [{"name": k[:80], "calls": c, "device_ms": us / 1e3}
                        for us, c, k in rows[:12]],
    }


def _item_profile(ds, n: int = 256) -> dict:
    """Host time of the reader's items, read one after another and collated
    64 at a time (the deferred reader gathers the windows in collate), and
    the shares of it (under cProfile, over other items) in the sentence
    trim, the tokenizer, ``np.pad``, ``np.load``, the per-item
    ``RandomState``, the native gather and ``FeatureStore.length``."""
    import cProfile
    import pstats

    def read(first):
        for lo in range(first, first + n, 64):
            ds.collate_fn([ds[i % len(ds)] for i in range(lo, lo + 64)])

    t0 = time.perf_counter()
    read(0)
    out = {"item_ms": (time.perf_counter() - t0) / n * 1e3,
           "defer_video_io": ds.defer_video_io,
           "sentences_per_item": sum(len(ds[i]["_texts"]["text"]) for i in range(64)) / 64}
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    read(n)
    prof.disable()
    total = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats

    def share(fn_name, file_part):
        return sum(v[3] for k, v in stats.items()
                   if k[2] == fn_name and file_part in k[0]) / total

    out["share_of_item"] = {
        "clip_sentences": share("_clip_sentences", "htm"),
        "tokenizer": share("__call__", "word2vec"), "np_pad": share("pad", "_arraypad"),
        "np_load": share("load", "_npyio"), "random_state": share("_rng", "htm"),
        "native_gather": share("gather_windows", "native"),
        "length": share("length", "data/io")}
    return out


class _StepWindow:
    """Profiles the device's activity over the steps [start, start + steps)
    of an epoch, by wrapping the trainer's step calls (a group of the N-step
    runner counts N); the wall between the two synchronizes at its edges."""

    def __init__(self, tr, start: int, steps: int):
        self.start, self.stop, self.batch_key = start, start + steps, tr.batch_key
        self.done, self.prof, self.rows, self.wall = 0, None, None, None
        for name in ("_do_step", "_do_fused"):
            setattr(tr, name, self._wrap(getattr(tr, name)))

    def _wrap(self, real):
        def call(batch):
            if self.prof is None and self.rows is None and self.done >= self.start:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
            out = real(batch)
            rows = batch[self.batch_key]
            self.done += rows.shape[0] if rows.dim() == 4 else 1
            if self.prof is not None and self.done >= self.stop:
                torch.cuda.synchronize()
                self.wall = time.perf_counter() - self.t0
                self.steps = self.done - self.start
                self.prof.__exit__(None, None, None)
                self.rows, self.prof = _device_rows(self.prof), None
            return out

        return call


def profile_cli_steady(root, asr_gap: float, amp: bool, fused_steps: int, defer: bool) -> dict:
    """One long epoch (8 loader threads) on the tree at ``root``, timed,
    with the train reader deferred or per item: the whole window, and its
    second half apart (the loader long past its start); the device busy and
    idle share of CLI_WINDOW steps of the second half; the reader's host
    cost an item beside it."""
    run = _cli_run(root, amp, 8, 1, fused_steps)
    tr = run.trainer
    run.train_loader.dataset.defer_video_io = defer
    try:
        host = _item_profile(run.train_loader.dataset)
        window = _StepWindow(tr, CLI_LONG_STEPS // 2, CLI_WINDOW)
        run.train_loader.set_epoch(0)
        t0 = time.perf_counter()
        tr.train_epoch(run.train_loader, 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        run.close()
    from exoground_tpu_torch.train.trainer import epoch_summary

    stats = tr.epoch_stats[0]
    half = stats["steps"] // 2
    second = dict(samples=stats["samples"] * (stats["steps"] - half) // stats["steps"],
                  step_s=stats["step_s"][half:],
                  data_s=stats["data_s"][half:])
    busy_s = sum(r[0] for r in window.rows) / 1e6
    return {"dtype": "bfloat16" if amp else "float32", "loader_threads": 8, "batch": 64,
            "fused_steps": fused_steps, "defer_video_io": defer, "asr_gap_s": asr_gap,
            "epoch_s": wall, **epoch_summary([stats]),
            "second_half": epoch_summary([second]),
            "window": {"steps": window.steps, "wall_s": window.wall,
                       "device_busy_ms_a_step": busy_s / window.steps * 1e3,
                       "device_idle_share": 1.0 - busy_s / window.wall},
            "host": host}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for Chrome traces")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true", help="profile the train path")
    mode.add_argument("--global", dest="global_mode", action="store_true",
                      help="profile global-mode text_visual_sim at the bench shape")
    mode.add_argument("--ground", action="store_true",
                      help="profile GroundingService ('small' and 'auto')")
    mode.add_argument("--cli", action="store_true",
                      help="profile the training command line's epochs")
    ap.add_argument("--int8", action="store_true",
                    help="profile the int8 serving mode (the JAX bench's int8 row)")
    ap.add_argument("--block", action="store_true",
                    help="profile the whole-block path (attn_impl and mlp_impl 'fused')")
    ap.add_argument("--resident", action="store_true",
                    help="profile run_preloaded sweeps over a preload (no upload a sweep)")
    ap.add_argument("--fused_steps", type=int, default=1,
                    help="with --cli: the command line's --fused_steps")
    args = ap.parse_args()
    if args.fused_steps != 1 and not args.cli:
        ap.error("--fused_steps goes with --cli")
    if (args.int8 or args.block or args.resident) and (args.train or args.global_mode
                                                         or args.ground or args.cli):
        ap.error("--int8, --block and --resident profile the serving sweeps, not --train, "
                 "--global, --ground or --cli")
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
    if args.cli:
        import shutil
        import tempfile

        from exoground_tpu_torch.tools.synth_htm import make_htm_tree

        from exoground_tpu_torch.tools.synth_htm import ASR_GAP_S

        os.makedirs("build", exist_ok=True)
        work = tempfile.mkdtemp(prefix="cli_", dir=os.path.abspath("build"))
        try:
            root = make_htm_tree(os.path.join(work, "htm"), **CLI_TREE)
            for amp, workers in ((False, 8), (False, 1), (True, 8)):
                print(json.dumps({"card": card, **profile_cli(root, amp, workers,
                                                              args.fused_steps, args.out)}),
                      flush=True)
            shutil.rmtree(root)
            # 5% of the videos go to validation
            videos = -(-CLI_LONG_STEPS * 64 * 100 // 95) + 64
            long_root = make_htm_tree(os.path.join(work, "long"),
                                      **dict(CLI_TREE, n_videos=videos, feature_files=200))
            for amp in (False, True):
                for defer in (False, True):
                    print(json.dumps({"card": card, **profile_cli_steady(
                        long_root, ASR_GAP_S, amp, args.fused_steps, defer)}), flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return
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
