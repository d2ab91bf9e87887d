"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile every kernel of the main path from exoground_tpu_torch/csrc
     (one nvcc per source, started together), print the build seconds;
  3. kernels: each kernel against its plain PyTorch version on the card, on the
     same inputs, at the main-path shapes (fused MHA B=304 C=512 H=8 at S=64
     and S=96 with one fully-masked window and ragged tails, and B=64 S=128,
     the window the bf16 body's 128-row tile holds whole; fused MLP at the
     serving towers' 19456 and 29184 rows, C=512, the global path's 2048,
     2096 and 3322 rows, grounding's 4096 and 8192 and 1 row, each with its
     launch plan: row tile, slab, hidden split, CTAs) and small shapes that
     reach the kernels' other instantiations (head sizes 8, 16, 32, 40, 48;
     MLP widths 128, 640, 1024, 1280, the last with x streamed), in
     float32 (max error <= 1e-4 of max|plain|) and bfloat16 (<= 1e-2); times
     by CUDA events (median of several runs after warm-up) beside the plain
     version, one PyTorch library call where one computes the same function,
     and the card's bound (float32: both routes, the CUDA cores and 3xTF32);
     fused MHA at B304 S64 and S96 also back to back (30 calls between two
     events) beside the plain version and F.multi_head_attention_forward;
  3d. int8 kernels: fused_mha_int8 and fused_mlp_int8 against mha_int8_plain and
     mlp_int8_plain on the card (a fully-masked window, ragged lengths and a zero
     row in every case), at the int8 path's shapes (MHA B304 S64 and S96 C512 H8;
     MLP 19456 and 29184 rows, C512), timed beside the plain version,
     torch._int_mm of the int8 product alone (a yardstick), the exact kernel of
     the same dtype and the bound (float32: both routes of the exact product,
     the CUDA cores and 3xTF32); and at small shapes (head sizes 8, 32, 40,
     48, S 128; MLP widths 128, 640 and 4224, x streamed, and 1 row, the hidden
     split 16 ways), float32 (<= 1e-4 of max|plain|) and bfloat16 (<= 1e-2);
     each MLP case with its launch plan;
  3e. block kernels: fused_block_attn and fused_block_mlp, exact and int8 bodies,
     against block_attn_plain / block_mlp_plain and their int8 twins on the
     card (a fully-masked window, ragged lengths and a zero row in every case;
     the output and x_norm apart), at the block path's shapes (B304 S64 and S96
     C512 H8; 19456 and 29184 rows, C512), timed beside the plain version, the
     per-module kernels of the same run (F.layer_norm + fused_mha / fused_mlp
     or their int8 twins + the add; no single PyTorch call computes a block)
     and the bound (float32 MLP: both routes, as in 3d); and at small shapes
     (S 17 with head size 8, S 128 with head size 48, head size 40; MLP widths
     128, 640 and x streamed: 1280 exact, 4224 int8; 4096 rows and 1 row, where
     the hidden is split over CTAs and the reduction adds the residual),
     float32 (<= 1e-4 of max|plain|, int8 bodies <= 1e-3; x_norm <= 1e-5) and
     bfloat16 (<= 1e-2); each MLP case with its launch plan; the int8
     block-attention cases also beside the exact fused_mha of the same call;
     then one `bar ✓/✗` line for each time bar of the attention kernels
     (attention_bars: the float32 fused MHA against F.multi_head_attention_forward
     and the float32 flash forward against SDPA among them; printed, not
     failed on; judged on back-to-back launches, single calls beside);
  4. main path: AlignmentService over TemporalAligner E6D6 (width 512, 8 heads,
     4096-d inputs, seeded random weights through the JAX->port weight bridge)
     answers align() requests, three of them concurrent through the coalescing
     front (which must serve them in fewer batches than requests), with the
     launch counters reset just before and read just after; one request again
     on the CPU plain path for agreement; then FusedAlignEvaluator over the 8
     bench videos for R@1/AUC and frames/s (frames over the median of three
     timed sweeps after a warm-up, as the profile tool reports it).
  4b. int8 path: FusedAlignEvaluator in the JAX bench's int8 configuration
     (bfloat16 compute, float16 transfer, matmul_dtype='int8', int8_min_cols
     1024) over the 8 bench videos with the counters reset just before and read
     just after (12 fused_mha_int8 + 12 fused_mlp_int8 launches per group, no
     fused_mha/fused_mlp); one video in float32 + int8 on the card and on the CPU
     plain path (score rel. error <= 1e-3, best_second equal where the top-2
     margin exceeds 1e-3 of max|score|); R@1, AUC and frames/s (median of 3
     sweeps, in turns) beside the exact bfloat16 run (`int8_bench {...}`);
     one AlignmentService(matmul_dtype='int8') request (no int8 launch: the
     service keeps int8_min_cols 0); one sweep each with int8 and int4 transfer.
     Phases 4 and 4b launch no block kernel ('auto' keeps the per-module ones).
  4c. block path: TemporalAligner(attn_impl="fused", mlp_impl="fused") in
     FusedAlignEvaluator over the 8 bench videos in float32, bfloat16 and the
     int8 row, each counted over one sweep (per group 12 block_attn + 12
     block_mlp launches, or their int8 twins, and no per-module kernel while
     the joint S <= 128); frames/s (median of 3 sweeps) in turns with the
     'auto' per-module model, R@1 and AUC beside its (`block_bench {...}`);
     AlignmentService.align on the card against the CPU plain path in float32
     (score rel. error <= 1e-4) and one video through the evaluator in
     float32 + int8 (<= 1e-3), best_second equal where the top-2 margin clears
     the tolerance.
  4e. resident serving: FusedAlignEvaluator over the 8 bench videos (one
     group) in float32 and bfloat16: preload (median of 3), run_preloaded in
     turns with the streaming sweep (median of 3 each), 16 dispatch_preloaded
     sweeps queued before the first reduce, run_many over 4 seeded
     checkpoints in turns with 4 x (update_params; run_preloaded),
     run_queries over 4 make_query_batch batches, preproject and preproject
     + int8 (int8_min_cols 1024); frames/s of each (`resident_bench {...}`).
     Fails unless the resident and streaming packed results agree (score
     rows within 1e-5 of max|score| in float32, 1e-2 in bfloat16; R@1 and AUC
     equal in float32), run_many row i equals the sequential run (also in
     float32 + int8, each checkpoint quantizing its own weights), each query
     batch equals its lone run, preproject is within 1e-4 (float32) of the
     unsplit run, and every counted run launched 12 fused MHA + 12 fused MLP
     kernels a group per sweep, checkpoint and query (rows 5 and 6 under
     int8); then the whole-block model in float32: one counted resident
     sweep (12 block_attn + 12 block_mlp launches) equal to its streaming
     sweep.
  3b. grid kernel: the MIL-NCE grid kernel's forward (v_den, t_den) and
     backward (dv, dt for random upstream grads) against grid_lse2_plain on
     the card, at the train path's shapes (S 6, R = B*64, Cc = B*12, C 512
     for B 16 and 64, dual St = 1 and joint St = 6), a ragged (2, 36, 15,
     128) with three invalid columns, a column space above the TPU
     kernel's cap (1, 512, 3072, 512), two output slabs (2, 100, 70,
     640) and the command line's shapes of phase 8 (a B64 step: 6, 4096,
     2048, 512; its B27 validation batch: 6, 1728, 864, 512; dual and
     joint, three quarters of the columns invalid), in float32 (<= 1e-4
     of max|plain|) and bfloat16 (<= 1e-2); the backward run twice must
     give the same bytes; forward and backward
     times (single calls and 30 back to back) beside the plain version's
     and the bound (float32: both routes); then one `bar ✓/✗` line a B64
     case (grid_bars: the kernel's forward + backward back to back at most
     the plain version's);
  5. train path: TANTrainer at the JAX package's train-bench configuration
     (TemporalAligner E6D6, width 512, 4096-d, alignability head, cotrain
     with keep agreement, loss threshold 0.7, EMA 0.999): one float32 step
     at B 4 on the card and on the CPU plain path from the same weights and
     batch (init loss: loss within 1e-4 relative, every grad within 1e-3 of
     its max|CPU|; the cotrain loss printed beside it), then a warm-up and
     10 timed steps at B 16 in float32 and bfloat16 (B 64's eager step is
     timed in phase 5b, beside its replay), with the launch
     counters reset just before and read just after each run: 2 grid
     forward and 2 grid backward launches per step, no fused MHA/MLP launch.
     Then the same with attn_impl='flash': one float32 cotrain step at B 4 on
     the card (flash kernels) and on the CPU (flash_attention_plain), loss
     within 1e-4 relative, grads within 1e-3 of max|CPU|, and 24 flash
     forward + 12 dq + 12 dk/dv launches; 10 timed steps at B 16 in float32
     and bfloat16 with those counts per step.
  5b. the train step as a replayed CUDA graph (make_tan_train_step(scan_steps=4)
     through TANTrainer(fused_steps=4)) at phase 5's configuration, B 64 in
     float32 and bfloat16 and B 16 under attn_impl='flash': from one state and
     one generator seed, 8 eager steps on one trainer and two 4-step calls (an
     eager warm-up group, then a replay of the captured graph) on another;
     fails unless the losses agree within 1e-5 relative and every parameter,
     EMA-twin and moment tensor within 1e-4 of its max|eager| (bit for bit
     expected; the exact max printed), both counts are 8, the replay's
     launches are 2 + 2 grid a step (and 24 + 12 + 12 flash under flash) by
     the replay counter, and a profiled replay names 4x the grid (and flash)
     kernels of a profiled eager step; one `graph_bench {...}` line a case:
     the eager step (median of 10) against the replay's ms / 4 (median of
     5), one replay's device time by CUDA events, capture seconds and the
     graph pool's MB.
  3c. flash kernels: forward (o; lse on rows with a valid key, +1e30 exactly
     on the rest), dq and dk/dv against autograd of flash_attention_plain on
     the card for the same random upstream grad, at the global path's shapes
     (B1 H8 S2048 D64; Sq = Sk = 2096 with the last 48 keys padded; S4096;
     S1024 for the crossover), the train path's (B16 H8 S64 and S76), ragged
     tails, a batch row with no valid key and head sizes 16, 32, 40, 96 and
     128, in
     float32 (<= 1e-4 of max|plain|) and bfloat16 (<= 1e-2); at the four
     long shapes each kernel's time beside the plain version's,
     attention_plain's (the 'xla' route), F.scaled_dot_product_attention's
     (a yardstick the port never calls) and the bound (float32: both
     routes), and the forward and SDPA back to back;
  6. global mode: test_alignment_htm(method='global') over three long videos
     (evals/bench_items.py::GLOBAL_VLENS) at E6D6 full width, auto dispatch,
     counted (12 flash forward and 12 fused MLP launches per video, no fused
     MHA); the first video again on the CPU plain path (sim within 1e-4 of
     max|CPU|, R@1 and AUC equal); then text_visual_sim at the JAX package's
     global bench shape (1 x 2048 frames, 48 texts) through flash (auto) and
     attention_plain ('xla'), float32 and bfloat16, median of 5 each
     (`global_bench {...}` lines).

  3f. window-attention kernel: small_attention (csrc/small_attn.cu) against
     small_attention_plain on the card (a fully-masked window and ragged
     lengths in every case) at the grounding path's windows (B64 H8, S 64
     and 128) and the aligner's (B304 H8, S 64 and 96), D 64, on contiguous
     tensors and on the strided views mha_plain makes of a packed (B, S, 3C)
     qkv, timed beside the plain version, F.scaled_dot_product_attention
     with the boolean mask on the same tensors (a yardstick the path never
     calls) and the bound; at S 17 D 32, and on packed views at head sizes
     8, 40 and 128 with S 17 and 100; float32 (<= 1e-4 of max|plain|) and
     bfloat16 (<= 1e-2);
  4d. the aligner under attn_impl='small': FusedAlignEvaluator over the 8
     bench videos in float32 and bfloat16, counted (12 small_attn launches
     per group, no fused MHA), frames/s (median of 3 sweeps) in turns with
     'auto' (`small_bench {...}`), one video against the CPU plain path
     (score rel. error <= 1e-4);
  7. keystep grounding served: GroundingService over GroundingModel (the MLP
     view-invariant pre-pass, the trunk E6D6, width 512, 8 heads, 4096-d,
     seeded weights; scripts/train_grounding.sh's model) in float32 under
     attn_impl 'small' and 'auto': one ground_batch of 64 requests (one
     bucket), then 1 ground() alone and 3 concurrent, counted per forward
     ('small': 30 small_attn + 24 fused_mlp; 'auto': 24 fused_mha + 24
     fused_mlp; the fused MLP's calls of one forward by rows), each
     ground() against its batch row, the card against the
     CPU service (start/end <= 1e-4 of max|CPU|), requests/s and ms per
     batch (median of 3, in turns; `ground_bench {...}`), and one int8 batch
     of 16 under 'small' (30 small_attn launches and nothing else; against
     the CPU within 2x the CPU's own change under a 1e-7 relative change of
     the inputs, at least 1e-3: a rounding step upstream flips int8 steps).
  8. the training command line: ``exoground_tpu_torch.train.main`` (``--dataset
     htm-370k --model cotrain``, E6D6 width 512, seq 64, text bucket 32, token
     length 32, B64, seed 0) over a seeded tree under build/ (tools/synth_htm.py:
     540 videos of 200-600 s with 512-d features, 27 of them validation;
     sentencified ASR at one 8-word sentence every 14 s, the JAX package's
     command-line test's cadence, htm_vlen.csv, htm_align.json over 8 videos, a
     66,249-word s3d_dict.npy and a seeded s3d_howto100m.pth with the MIL-NCE
     text module's shapes), 2 epochs of 8 steps with --eval_freq 1, then
     the same 2 epochs at --fused_steps 4 (epoch 0 an eager group and a
     replay, epoch 1 two replays; one capture) whose epoch-0 checkpoint must
     match the --fused_steps 1 run's (parameters, EMA twin and moments within
     1e-4 of max|.|, bit for bit expected; same counts), then
     --resume from the epoch-0 checkpoint (parameters, EMA twin, moments, step
     count, iteration, start epoch 1 and best restored exactly, checked as
     load_checkpoint returns) and --test; each run counted (the grid 2 + 2 a
     step and 2 forwards a validation batch; fused MHA and MLP 24 + 24 a
     validation batch, online and EMA teacher, and 12 + 12 a group of each
     HTM-Align eval; no other kernel); then the card against the CPU with the
     command line's build_htm_tan on the whole first batch, B64 (step and
     validation loss rel. error <= 1e-4, the tower's pooled output <= 1e-5 of
     max|CPU|, f32), and the train reader's host ms an item, deferred through
     the native gather against per-item reads on the same tree; one
     `cli_bench {...}` line (samples/s over the whole
     window of steps and waits for data, the window's seconds, the median
     step, which is a loader-idle one at 8 steps an epoch, the Data meter's
     share, the --fused_steps 4 run's samples/s, median step, Data share and
     capture seconds, the reader's ms an item, validation ms, HTM-Align s,
     checkpoint MB and save s, launches, the phase's seconds). The tree is
     removed after.

Float32 products of the plain versions and library calls run in full
float32 (TF32 off for matmul and cuDNN); the f32 bodies of the fused MLP
family, the MHA family (but the int8 qkv product's), the flash forward and
the grid kernel run 3xTF32 on the tensor cores, which keeps float32
accuracy (csrc/tc.cuh says why). The script's seconds, then the kernels
JSON, precede the last line, {"ok": true, "device": {...}}.
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


def b2b_ms(fn, launches=30) -> float:
    """Mean ms of ``launches`` back-to-back calls between two CUDA events,
    after one warm-up call: the device's time, without the Python work
    before a single call's first launch."""
    from exoground_tpu_torch.tools.mlp_bench import _events_ms

    return _events_ms(fn, launches)


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / H100_PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


H100_TF32_FLOPS = 495e12  # dense TF32 tensor-core rate, SXM
H100_INT8_OPS = 1979e12  # dense int8 tensor-core rate, SXM


def routes_bound(int8_ops: float, exact_flops: float, nbytes: float, dtype) -> dict:
    """The bound of a kernel: its int8 product (if any) at the int8 rate
    plus its exact products at the dtype's rate, or its bytes at the memory
    rate, whichever is larger. In float32 the exact products take the lesser
    of two routes, the CUDA cores (FLOPs / 67 TFLOP/s) and 3xTF32 on the
    tensor cores (3 x FLOPs / 495 TFLOP/s); both bounds are returned. The
    MLP and MHA families and the flash kernels take it."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_int8 = int8_ops / H100_INT8_OPS * 1e3
    if dtype != torch.float32:
        t_ops = t_int8 + exact_flops / H100_PEAK_FLOPS[dtype] * 1e3
        return dict(bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")
    t_cuda = t_int8 + exact_flops / H100_PEAK_FLOPS[dtype] * 1e3
    t_tf32 = t_int8 + 3.0 * exact_flops / H100_TF32_FLOPS * 1e3
    t_ops = min(t_cuda, t_tf32)
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_cuda_cores_ms=max(t_cuda, t_bytes), bound_3xtf32_ms=max(t_tf32, t_bytes))


# ----------------------------------------------------------------- phase 3
def mha_case(B, S, C, H, dtype, seed, b2b=False):
    """fused_mha against mha_plain on the card, timed beside the plain
    version, F.multi_head_attention_forward (a yardstick the port never
    calls) and the bound (float32: both routes); with ``b2b`` each also
    back to back (30 calls between two events: the device's time)."""
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

        def library():
            return torch.nn.functional.multi_head_attention_forward(
                x.transpose(0, 1), x.transpose(0, 1), x.transpose(0, 1), C, H, w_in, b_in,
                None, None, False, 0.0, w_out, b_out, training=False,
                key_padding_mask=kpad, need_weights=False)

        lib_ms = time_ms(library)
        times = {}
        if b2b:
            times = dict(ms_b2b=b2b_ms(lambda: fused_mha(x, kpad, w_in, b_in, w_out, b_out, H)),
                         plain_ms_b2b=b2b_ms(
                             lambda: mha_plain(x, kpad, w_in, b_in, w_out, b_out, H)),
                         library_ms_b2b=b2b_ms(library))
    flops = 8.0 * B * S * C * C + 4.0 * B * S * S * C
    nbytes = (2 * B * S * C + 4 * C * C + 4 * C) * x.element_size() + B * S
    rel = err / scale
    case = dict(shape=f"B{B} S{S} C{C} H{H}", dtype=str(dtype).split(".")[-1],
                max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **times, **routes_bound(0.0, flops, nbytes, dtype))
    print("fused_mha", json.dumps(case), flush=True)
    if not rel <= TOL[dtype]:
        fail(f"fused_mha disagrees with mha_plain: {case}")
    return case


def mlp_case(rows, C, dtype, seed):
    """The fused MLP kernel against mlp_plain on the card, timed, with its
    launch plan (row tile, slab, hidden split, CTAs). The f32 bound is the
    lesser of two routes, the CUDA cores (FLOPs / 67 TFLOP/s) and the
    kernel's 3xTF32 on the tensor cores (3 x FLOPs / 495 TFLOP/s)."""
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.fused_mlp import fused_mlp, mlp_launch_plan, mlp_plain

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
    nbytes = (2 * rows * C + 8 * C * C + 5 * C) * x.element_size()
    rel = err / scale
    case = dict(shape=f"rows{rows} C{C}", dtype=str(dtype).split(".")[-1],
                max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                library_ms=None, **routes_bound(0.0, 16.0 * rows * C * C, nbytes, dtype),
                plan=mlp_launch_plan(rows, C))
    print("fused_mlp", json.dumps(case), flush=True)
    if not rel <= TOL[dtype]:
        fail(f"fused_mlp disagrees with mlp_plain: {case}")
    return case


def mlp_kernel_cases():
    """Phase 3's fused-MLP cases, float32 then bfloat16: the serving group's
    dual and joint towers (19456 and 29184 rows), the widths 128, 640 (two
    column slabs), 1024 and 1280 (x streamed, not resident), the global
    path's rows (dual and joint tower at the bench shape, 2048 frames + 48
    texts; joint tower of the 3000-frame video, 3072 + 250), grounding's
    4096 and 8192 rows (phase 7 prints the rows of its calls) and 1 row."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(mlp_case(19456, 512, dtype, seed=4))
        cases.append(mlp_case(29184, 512, dtype, seed=15))
        cases.append(mlp_case(210, 128, dtype, seed=5))
        cases.append(mlp_case(300, 640, dtype, seed=9))
        cases.append(mlp_case(77, 1024, dtype, seed=10))
        cases.append(mlp_case(40, 1280, dtype, seed=11))
        for rows in (2048, 2096, 3322):
            cases.append(mlp_case(rows, 512, dtype, seed=12))
        cases.append(mlp_case(4096, 512, dtype, seed=16))
        cases.append(mlp_case(8192, 512, dtype, seed=17))
        cases.append(mlp_case(1, 512, dtype, seed=18))
    return cases


# ---------------------------------------------------------------- phase 3d

def _int8_inputs(rng, dtype, x_shape):
    """Random x with its second row, where there is one, zero (a zero row
    quantizes with scale 1)."""
    x = torch.tensor(rng.standard_normal(x_shape), dtype=dtype, device="cuda")
    rows = x.view(-1, x_shape[-1])
    if len(rows) > 1:
        rows[1].zero_()
    return x


def mha_int8_case(B, S, C, H, dtype, seed, timed=False):
    """fused_mha_int8 against mha_int8_plain on the card: one fully-masked
    window (a padded group window), ragged lengths and a zero row; with
    ``timed``, beside the plain version, torch._int_mm of the int8 qkv
    product alone (a yardstick), the exact fused_mha in the same dtype and
    the bound."""
    from exoground_tpu_torch.ops import _kernels, quant
    from exoground_tpu_torch.ops.attention import fused_mha, fused_mha_int8, mha_int8_plain

    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dtype, device="cuda")

    x = _int8_inputs(rng, dtype, (B, S, C))
    w_in, b_in = t(3 * C, C, scale=C ** -0.5), t(3 * C, scale=0.02)
    w_out, b_out = t(C, C, scale=C ** -0.5), t(C, scale=0.02)
    lens = rng.randint(1, S + 1, B)
    lens[0] = 0
    lens[-1] = S
    kpad = torch.tensor(np.arange(S)[None, :] >= lens[:, None], device="cuda")
    args = (x, kpad, w_in, b_in, w_out, b_out, H)
    with torch.inference_mode():
        n0 = _kernels.LAUNCHES["fused_mha_int8"]
        out = fused_mha_int8(*args)
        torch.cuda.synchronize()
        if _kernels.LAUNCHES["fused_mha_int8"] != n0 + 1:
            fail("fused_mha_int8 did not count its launch")
        ref = mha_int8_plain(*args)
        if not torch.isfinite(out.float()).all():
            fail(f"fused_mha_int8 non-finite output at B{B} S{S} C{C} {dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        case = dict(shape=f"B{B} S{S} C{C} H{H}", dtype=str(dtype).split(".")[-1],
                    max_abs_err=err, max_rel_err=err / scale, library_ms=None)
        if timed:
            xq, _ = quant._quant_last_axis(x)
            wq, _ = quant._quant_first_axis(w_in)
            xq2 = xq.reshape(-1, C)
            case.update(ms=time_ms(lambda: fused_mha_int8(*args)),
                        plain_ms=time_ms(lambda: mha_int8_plain(*args)),
                        int_mm_ms=time_ms(lambda: quant._int_mm(xq2, wq)),
                        exact_kernel_ms=time_ms(lambda: fused_mha(*args)),
                        ms_b2b=b2b_ms(lambda: fused_mha_int8(*args)),
                        exact_kernel_ms_b2b=b2b_ms(lambda: fused_mha(*args)))
            item = x.element_size()
            nbytes = (2 * B * S * C + 4 * C * C + 4 * C) * item + 4 * B * S
            case.update(routes_bound(6.0 * B * S * C * C,
                                     2.0 * B * S * C * C + 4.0 * B * S * S * C, nbytes, dtype))
    print("fused_mha_int8", json.dumps(case), flush=True)
    if not case["max_rel_err"] <= TOL[dtype]:
        fail(f"fused_mha_int8 disagrees with mha_int8_plain: {case}")
    return case


def mlp_int8_case(rows, C, dtype, seed, timed=False):
    """fused_mlp_int8 against mlp_int8_plain on the card, with its launch
    plan; with ``timed``, beside the plain version, torch._int_mm of the int8
    c_fc product alone, the exact fused_mlp in the same dtype and the bound
    (both routes of the exact part in float32)."""
    from exoground_tpu_torch.ops import _kernels, quant
    from exoground_tpu_torch.ops.fused_mlp import (
        fused_mlp, fused_mlp_int8, mlp_int8_plain, mlp_launch_plan)

    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dtype, device="cuda")

    x = _int8_inputs(rng, dtype, (rows, C))
    fc_w, fc_b = t(4 * C, C, scale=C ** -0.5), t(4 * C, scale=0.02)
    pr_w, pr_b = t(C, 4 * C, scale=(4 * C) ** -0.5), t(C, scale=0.02)
    args = (x, fc_w, fc_b, pr_w, pr_b)
    with torch.inference_mode():
        n0 = _kernels.LAUNCHES["fused_mlp_int8"]
        out = fused_mlp_int8(*args)
        torch.cuda.synchronize()
        if _kernels.LAUNCHES["fused_mlp_int8"] != n0 + 1:
            fail("fused_mlp_int8 did not count its launch")
        ref = mlp_int8_plain(*args)
        if not torch.isfinite(out.float()).all():
            fail(f"fused_mlp_int8 non-finite output at rows {rows} C{C} {dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        case = dict(shape=f"rows{rows} C{C}", dtype=str(dtype).split(".")[-1],
                    max_abs_err=err, max_rel_err=err / scale, library_ms=None,
                    plan=mlp_launch_plan(rows, C))
        if timed:
            xq, _ = quant._quant_last_axis(x)
            wq, _ = quant._quant_first_axis(fc_w)
            case.update(ms=time_ms(lambda: fused_mlp_int8(*args)),
                        plain_ms=time_ms(lambda: mlp_int8_plain(*args)),
                        int_mm_ms=time_ms(lambda: quant._int_mm(xq, wq)),
                        exact_kernel_ms=time_ms(lambda: fused_mlp(*args)))
            nbytes = (2 * rows * C + 8 * C * C + 5 * C) * x.element_size()
            case.update(routes_bound(8.0 * rows * C * C, 8.0 * rows * C * C, nbytes, dtype))
    print("fused_mlp_int8", json.dumps(case), flush=True)
    if not case["max_rel_err"] <= TOL[dtype]:
        fail(f"fused_mlp_int8 disagrees with mlp_int8_plain: {case}")
    return case


def int8_kernel_cases():
    """Phase 3d: both int8 kernels at the main path's shapes (timed) and at
    small shapes that reach their other instantiations."""
    mha, mlp = [], []
    for dtype in (torch.float32, torch.bfloat16):
        mha.append(mha_int8_case(304, 64, 512, 8, dtype, seed=40, timed=True))
        mha.append(mha_int8_case(304, 96, 512, 8, dtype, seed=41, timed=True))
        mha.append(mha_int8_case(5, 33, 128, 4, dtype, seed=42))
        mha.append(mha_int8_case(3, 17, 128, 16, dtype, seed=43))  # head size 8
        mha.append(mha_int8_case(4, 72, 640, 16, dtype, seed=44))  # head size 40
        mha.append(mha_int8_case(2, 128, 384, 8, dtype, seed=45))  # head size 48, S 128
        mlp.append(mlp_int8_case(19456, 512, dtype, seed=46, timed=True))
        mlp.append(mlp_int8_case(29184, 512, dtype, seed=47, timed=True))
        mlp.append(mlp_int8_case(210, 128, dtype, seed=48))
        mlp.append(mlp_int8_case(300, 640, dtype, seed=49))  # two column slabs
        mlp.append(mlp_int8_case(40, 4224, dtype, seed=50))  # x streamed, not resident
        mlp.append(mlp_int8_case(1, 512, dtype, seed=51))  # the hidden split 16 ways
    return mha, mlp


# ---------------------------------------------------------------- phase 3e
BLOCK_KERNELS = ("block_attn", "block_attn_int8", "block_mlp", "block_mlp_int8")
# the int8 bodies: a last-bit LN difference may move one value across a .5
# rounding boundary, one int8 step of one of C terms
BLOCK_TOL = {(torch.float32, False): 1e-4, (torch.float32, True): 1e-3,
             (torch.bfloat16, False): 1e-2, (torch.bfloat16, True): 1e-2}
X_NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _ln_params(rng, C, dtype):
    return (torch.tensor(1.0 + 0.1 * rng.standard_normal(C), dtype=dtype, device="cuda"),
            torch.tensor(0.1 * rng.standard_normal(C), dtype=dtype, device="cuda"))


def _block_check(kind, case, dtype, int8):
    print(kind, json.dumps(case), flush=True)
    if not case["max_rel_err"] <= BLOCK_TOL[(dtype, int8)]:
        fail(f"{kind} disagrees with its plain version: {case}")
    if not case.get("x_norm_rel_err", 0.0) <= X_NORM_TOL[dtype]:
        fail(f"{kind} x_norm disagrees with its plain version: {case}")


def block_attn_case(B, S, C, H, dtype, seed, int8=False, timed=False):
    """fused_block_attn (exact or int8 body) against block_attn_plain /
    block_attn_int8_plain on the card: one fully-masked window, ragged
    lengths, a zero row; the output and x_norm apart. With ``timed``, beside
    the plain version, the per-module kernels of the same run
    (F.layer_norm + fused_mha or fused_mha_int8 + the add; no single
    PyTorch call computes the block), for the int8 body the exact fused_mha
    on the same x, and the bound."""
    import torch.nn.functional as F

    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.attention import (
        block_attn_int8_plain, block_attn_plain, fused_block_attn, fused_mha, fused_mha_int8)

    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dtype, device="cuda")

    x = _int8_inputs(rng, dtype, (B, S, C))
    ln_w, ln_b = _ln_params(rng, C, dtype)
    w_in, b_in = t(3 * C, C, scale=C ** -0.5), t(3 * C, scale=0.02)
    w_out, b_out = t(C, C, scale=C ** -0.5), t(C, scale=0.02)
    lens = rng.randint(1, S + 1, B)
    lens[0] = 0  # a padded group window
    lens[-1] = S
    kpad = torch.tensor(np.arange(S)[None, :] >= lens[:, None], device="cuda")
    name = "block_attn_int8" if int8 else "block_attn"
    plain = block_attn_int8_plain if int8 else block_attn_plain
    args = (x, kpad, ln_w, ln_b, w_in, b_in, w_out, b_out, H)
    with torch.inference_mode():
        n0 = _kernels.LAUNCHES[name]
        out, xn = fused_block_attn(*args, int8_qkv=int8)
        torch.cuda.synchronize()
        if _kernels.LAUNCHES[name] != n0 + 1:
            fail(f"{name} did not count its launch")
        ref, ref_n = plain(*args)
        if not (torch.isfinite(out.float()).all() and torch.isfinite(xn.float()).all()):
            fail(f"{name} non-finite output at B{B} S{S} C{C} {dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        n_err = (xn.float() - ref_n.float()).abs().max().item()
        case = dict(shape=f"B{B} S{S} C{C} H{H}", dtype=str(dtype).split(".")[-1],
                    max_abs_err=err, max_rel_err=err / ref.float().abs().max().item(),
                    x_norm_rel_err=n_err / ref_n.float().abs().max().item(), library_ms=None)
        if timed:
            mha = fused_mha_int8 if int8 else fused_mha

            def per_module():
                xn_ = F.layer_norm(x, (C,), ln_w, ln_b, 1e-5)
                return x + mha(xn_, kpad, w_in, b_in, w_out, b_out, H), xn_

            case.update(ms=time_ms(lambda: fused_block_attn(*args, int8_qkv=int8)),
                        plain_ms=time_ms(lambda: plain(*args)), per_module_ms=time_ms(per_module),
                        ms_b2b=b2b_ms(lambda: fused_block_attn(*args, int8_qkv=int8)),
                        per_module_ms_b2b=b2b_ms(per_module))
            if int8:  # the exact fused MHA of the same call, the int8 MHA's yardstick
                case["exact_kernel_ms"] = time_ms(
                    lambda: fused_mha(x, kpad, w_in, b_in, w_out, b_out, H))
            nbytes = (3 * B * S * C + 4 * C * C + 6 * C) * x.element_size() + 4 * B * S
            attn_flops = 4.0 * B * S * S * C
            int8_ops = 6.0 * B * S * C * C if int8 else 0.0
            case.update(routes_bound(int8_ops, 8.0 * B * S * C * C + attn_flops - int8_ops,
                                     nbytes, dtype))
    _block_check(name, case, dtype, int8)
    return case


def block_mlp_case(rows, C, dtype, seed, int8=False, timed=False):
    """fused_block_mlp (exact or int8 body) against block_mlp_plain /
    block_mlp_int8_plain on the card, a zero row included, with its launch
    plan; with ``timed``, beside the plain version, the per-module kernels
    (F.layer_norm + fused_mlp or fused_mlp_int8 + the add) and the bound
    (both routes of the exact part in float32)."""
    import torch.nn.functional as F

    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.fused_mlp import (
        block_mlp_int8_plain, block_mlp_plain, fused_block_mlp, fused_mlp, fused_mlp_int8,
        mlp_launch_plan)

    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=dtype, device="cuda")

    x = _int8_inputs(rng, dtype, (rows, C))
    ln_w, ln_b = _ln_params(rng, C, dtype)
    fc_w, fc_b = t(4 * C, C, scale=C ** -0.5), t(4 * C, scale=0.02)
    pr_w, pr_b = t(C, 4 * C, scale=(4 * C) ** -0.5), t(C, scale=0.02)
    name = "block_mlp_int8" if int8 else "block_mlp"
    plain = block_mlp_int8_plain if int8 else block_mlp_plain
    args = (x, ln_w, ln_b, fc_w, fc_b, pr_w, pr_b)
    with torch.inference_mode():
        n0 = _kernels.LAUNCHES[name]
        out = fused_block_mlp(*args, int8_cfc=int8)
        torch.cuda.synchronize()
        if _kernels.LAUNCHES[name] != n0 + 1:
            fail(f"{name} did not count its launch")
        ref = plain(*args)
        if not torch.isfinite(out.float()).all():
            fail(f"{name} non-finite output at rows {rows} C{C} {dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        case = dict(shape=f"rows{rows} C{C}", dtype=str(dtype).split(".")[-1],
                    max_abs_err=err, max_rel_err=err / ref.float().abs().max().item(),
                    library_ms=None, plan=mlp_launch_plan(rows, C))
        if timed:
            mlp = fused_mlp_int8 if int8 else fused_mlp

            def per_module():
                return x + mlp(F.layer_norm(x, (C,), ln_w, ln_b, 1e-5), fc_w, fc_b, pr_w, pr_b)

            case.update(ms=time_ms(lambda: fused_block_mlp(*args, int8_cfc=int8)),
                        plain_ms=time_ms(lambda: plain(*args)), per_module_ms=time_ms(per_module))
            nbytes = (2 * rows * C + 8 * C * C + 7 * C) * x.element_size()
            int8_ops = 8.0 * rows * C * C if int8 else 0.0
            case.update(routes_bound(int8_ops, 16.0 * rows * C * C - int8_ops, nbytes,
                                         dtype))
    _block_check(name, case, dtype, int8)
    return case


# The bars the attention kernels are held to (printed as checks, not
# failures: they compare times). The float32 int8 bodies' times of the
# (window, head) design they replaced, H100 80GB HBM3 at 700 W (PERF.md §6,
# row 5 and row 7's int8 body), at B304 S64 / S96.
INT8_F32_EARLIER_MS = {"fused_mha_int8": (1.665, 2.378), "block_attn_int8": (1.860, 2.683)}


def attention_bars(mha_cases, flash_cases, mha8_cases, block_cases):
    """One ✓/✗ line a bar, at B304 S64 and S96 (flash: S2048, S2096 padded,
    S4096 and S1024): the float32 fused MHA at most F.multi_head_attention_forward
    and the float32 flash forward at most SDPA, both with TF32 off; the block
    attention within 1.05x its per-module kernels (float32, bfloat16, and the
    int8 body in bfloat16) and the int8 MHA in bfloat16 at most the exact
    fused MHA, each judged on back-to-back launches (the device's time) with
    the single calls beside; and the float32 int8 bodies' single calls no
    slower than the design they replaced (single calls, as those times were
    taken)."""
    def timed(cases, key="ms_b2b"):
        return [c for c in cases if key in c]

    def line(bar, ok, detail):
        print(f"bar {'✓' if ok else '✗'} {bar}: {detail}", flush=True)

    def versus(c, key, limit, own="ms"):
        b2b, single = c[f"{own}_b2b"] / c[f"{key}_b2b"], c[own] / c[key]
        return b2b <= limit, (f"back to back {c[own + '_b2b']:.3f} / {c[key + '_b2b']:.3f} ms = "
                              f"{b2b:.3f}; single call {c[own]:.3f} / {c[key]:.3f} ms = "
                              f"{single:.3f} ({'✓' if single <= limit else '✗'})")

    for c in timed(mha_cases):
        if c["dtype"] == "float32":
            line(f"fused_mha float32 {c['shape']} <= F.multi_head_attention_forward",
                 *versus(c, "library_ms", 1.0))
    for c in timed(flash_cases, "fwd_ms_b2b"):
        if c["dtype"] == "float32":
            line(f"flash_fwd float32 {c['shape']} <= SDPA",
                 *versus(c, "fwd_library_ms", 1.0, own="fwd_ms"))
    for name, cases in (("block_attn", block_cases["block_attn"]),
                        ("block_attn_int8", block_cases["block_attn_int8"])):
        for c in timed(cases):
            if name == "block_attn_int8" and c["dtype"] == "float32":
                continue
            line(f"{name} {c['dtype']} {c['shape']} <= 1.05 x per-module",
                 *versus(c, "per_module_ms", 1.05))
    for c in timed(mha8_cases):
        if c["dtype"] == "bfloat16":
            line(f"fused_mha_int8 bfloat16 {c['shape']} <= exact fused_mha",
                 *versus(c, "exact_kernel_ms", 1.0))
    for name, cases in (("fused_mha_int8", mha8_cases),
                        ("block_attn_int8", block_cases["block_attn_int8"])):
        f32 = [c for c in timed(cases) if c["dtype"] == "float32"]
        for c, earlier in zip(f32, INT8_F32_EARLIER_MS[name]):
            line(f"{name} float32 {c['shape']} <= {earlier} ms (the (window, head) design)",
                 c["ms"] <= earlier, f"single call {c['ms']:.3f} ms")


def block_kernel_cases():
    """Phase 3e: the four block kernels at the main path's shapes (timed)
    and at small shapes that reach their other instantiations: S 17 with
    head size 8, S 128 (the largest shared-memory layout) with head size 48,
    head size 40; MLP widths 128, 640 (two column slabs) and x streamed
    (1280 exact, 4224 int8), and 4,096 rows and 1 row, where the hidden is
    split over CTAs and the reduction adds the residual. Returns {name:
    cases}, float32 at B304 S64 / 19,456 rows first."""
    out = {name: [] for name in BLOCK_KERNELS}
    for int8 in (False, True):
        sfx = "_int8" if int8 else ""
        attn, mlp = out["block_attn" + sfx], out["block_mlp" + sfx]
        for dtype in (torch.float32, torch.bfloat16):
            attn.append(block_attn_case(304, 64, 512, 8, dtype, 60, int8, timed=True))
            attn.append(block_attn_case(304, 96, 512, 8, dtype, 61, int8, timed=True))
            attn.append(block_attn_case(3, 17, 128, 16, dtype, 62, int8))
            attn.append(block_attn_case(2, 128, 384, 8, dtype, 63, int8))
            attn.append(block_attn_case(4, 72, 640, 16, dtype, 64, int8))
            mlp.append(block_mlp_case(19456, 512, dtype, 65, int8, timed=True))
            mlp.append(block_mlp_case(29184, 512, dtype, 66, int8, timed=True))
            mlp.append(block_mlp_case(210, 128, dtype, 67, int8))
            mlp.append(block_mlp_case(300, 640, dtype, 68, int8))
            mlp.append(block_mlp_case(40, 4224 if int8 else 1280, dtype, 69, int8))
            # the hidden split (4 and 16 ways) with the residual in the reduction
            mlp.append(block_mlp_case(4096, 512, dtype, 70, int8))
            mlp.append(block_mlp_case(1, 512, dtype, 71, int8))
    return out


# ---------------------------------------------------------------- phase 3f
def small_case(B, H, S, D, dtype, seed, timed=False, packed=False):
    """The window-attention kernel (through ``small_attention``) against
    small_attention_plain on the card: one fully-masked window and ragged
    lengths. ``packed``: q, k and v are the strided views mha_plain's head
    split makes of a packed (B, S, 3C) qkv, strides (S*3C, D, 3C, 1), as the
    aligner and grounding hand them over; else contiguous (B, H, S, D)
    tensors. With ``timed``, beside the plain version,
    F.scaled_dot_product_attention with the boolean mask on the same
    tensors (a yardstick the path never calls) and the bound max(4 BH S^2 D
    / peak, 4 BH S D bytes / 3.35 TB/s)."""
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.attention import (
        _split_heads, small_attention, small_attention_plain)

    rng = np.random.RandomState(seed)
    if packed:
        qkv = torch.tensor(rng.standard_normal((B, S, 3 * H * D)), dtype=dtype, device="cuda")
        q, k, v = (_split_heads(t, H) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.tensor(rng.standard_normal((B, H, S, D)), dtype=dtype, device="cuda")
                   for _ in range(3))
    lens = rng.randint(1, S + 1, B)
    lens[0] = 0  # a fully-masked window
    lens[-1] = S
    mask = torch.tensor(np.arange(S)[None, :] >= lens[:, None], device="cuda")
    kpad = mask.to(torch.int32)
    qs = q * (1.0 / D ** 0.5)
    with torch.inference_mode():
        n0 = _kernels.LAUNCHES["small_attn"]
        out = small_attention(q, k, v, mask)
        torch.cuda.synchronize()
        if _kernels.LAUNCHES["small_attn"] != n0 + 1:
            fail("small_attn did not count its launch")
        ref = small_attention_plain(qs, k, v, kpad)
        if not torch.isfinite(out.float()).all():
            fail(f"small_attn non-finite output at B{B} H{H} S{S} D{D} {dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        case = dict(shape=f"B{B} H{H} S{S} D{D}" + (" packed qkv" if packed else ""),
                    dtype=str(dtype).split(".")[-1], max_abs_err=err,
                    max_rel_err=err / ref.float().abs().max().item(),
                    masked_window_err=(out[0].float() - ref[0].float()).abs().max().item())
        if timed:
            attend = ~mask[:, None, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            bms, by = bound_ms(4.0 * B * H * S * S * D, 4.0 * B * H * S * D * q.element_size(),
                               dtype)
            case.update(ms=time_ms(lambda: small_attention(q, k, v, mask)),
                        plain_ms=time_ms(lambda: small_attention_plain(qs, k, v, kpad)),
                        library_ms=time_ms(lambda: sdpa(q, k, v, attn_mask=attend)),
                        bound_ms=bms, bound_by=by)
    print("small_attn", json.dumps(case), flush=True)
    if not case["max_rel_err"] <= TOL[dtype]:
        fail(f"small_attn disagrees with small_attention_plain: {case}")
    return case


def small_kernel_cases():
    """Phase 3f: the window kernel at the grounding path's windows (B64 H8,
    S 64 and 128) and the aligner's (B304 H8, S 64 and 96), D 64, timed, on
    contiguous tensors and on the strided views of a packed qkv; an odd
    shape (S 17, D 32); head sizes 8, 40 and 128 at S 17 and 100 on packed
    views; float32 and bfloat16."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for packed in (False, True):
            cases.append(small_case(64, 8, 128, 64, dtype, seed=70, timed=True, packed=packed))
            cases.append(small_case(64, 8, 64, 64, dtype, seed=71, timed=True, packed=packed))
            cases.append(small_case(304, 8, 64, 64, dtype, seed=72, timed=True, packed=packed))
            cases.append(small_case(304, 8, 96, 64, dtype, seed=73, timed=True, packed=packed))
        cases.append(small_case(3, 2, 17, 32, dtype, seed=74))
        for d in (8, 40, 128):
            for s in (17, 100):
                cases.append(small_case(3, 2, s, d, dtype, seed=75 + d + s, packed=True))
    return cases


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
    # the backward twice on the same inputs: the same bytes (no atomics)
    cv32 = valid.to(torch.int32)
    vden, tden = grid_lse2_forward(v, t, cv32, inv)
    first = grid_lse2_backward(v, t, cv32, vden, tden, g_v, g_t, inv)
    again = grid_lse2_backward(v, t, cv32, vden, tden, g_v, g_t, inv)
    torch.cuda.synchronize()
    case["bwd_bit_identical"] = all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                                    for x, y in zip(first, again))
    if not case["bwd_bit_identical"]:
        fail(f"grid backward differs between two runs at {case['shape']} {case['dtype']}")
    if timed:
        def fwd():
            return grid_lse2_forward(v, t, cv32, inv)

        def bwd():
            return grid_lse2_backward(v, t, cv32, vden, tden, g_v, g_t, inv)

        def plain_fwd():
            with torch.no_grad():
                return grid_lse2_plain(v, t, valid, inv)

        a, b = v.clone().requires_grad_(), t.clone().requires_grad_()
        pvd, ptd = grid_lse2_plain(a, b, valid, inv)

        def plain_bwd():
            return torch.autograd.grad([pvd, ptd], [a, b], [g_v, g_t], retain_graph=True)

        item = v.element_size()
        work = 2.0 * S * R * Cc * C
        io = (S * R + St * Cc) * C * item
        fb = routes_bound(0.0, work, io + 4 * (S * R + S * Cc + Cc), dtype)
        bb = routes_bound(0.0, 3 * work, 2 * io + 4 * (2 * S * R + 2 * S * Cc + Cc), dtype)
        case.update(fwd_ms=time_ms(fwd), fwd_ms_b2b=b2b_ms(fwd), fwd_plain_ms=time_ms(plain_fwd),
                    fwd_plain_ms_b2b=b2b_ms(plain_fwd),
                    **{f"fwd_{k}": x for k, x in fb.items()},
                    bwd_ms=time_ms(bwd), bwd_ms_b2b=b2b_ms(bwd), bwd_plain_ms=time_ms(plain_bwd),
                    bwd_plain_ms_b2b=b2b_ms(plain_bwd),
                    **{f"bwd_{k}": x for k, x in bb.items()}, library_ms=None)
    print("milnce_grid", json.dumps(case), flush=True)
    if not rel <= TOL[dtype]:
        fail(f"the grid kernel disagrees with grid_lse2_plain: {case}")
    return case


def grid_bars(grid_cases):
    """One ✓/✗ line for each B64 case (R 4096: joint and dual, float32 and
    bfloat16): the kernel's forward + backward back to back at most
    grid_lse2_plain's forward + autograd backward back to back, so that
    'auto' never pays more than the plain path there (printed, not failed
    on; single calls beside)."""
    for c in grid_cases:
        if "fwd_ms_b2b" not in c or " R4096 " not in f" {c['shape']} ":
            continue
        own, plain = c["fwd_ms_b2b"] + c["bwd_ms_b2b"], c["fwd_plain_ms_b2b"] + c["bwd_plain_ms_b2b"]
        single = (c["fwd_ms"] + c["bwd_ms"]) / (c["fwd_plain_ms"] + c["bwd_plain_ms"])
        print(f"bar {'✓' if own <= plain else '✗'} milnce_grid {c['dtype']} {c['shape']} "
              f"fwd+bwd <= grid_lse2_plain: back to back {own:.3f} / {plain:.3f} ms = "
              f"{own / plain:.3f}; single call {single:.3f} ({'✓' if single <= 1 else '✗'})",
              flush=True)


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
        bounds = {}
        for part, flops, nbytes in (
                ("fwd", 4 * pairs * D, 2 * io_q + 2 * io_k + 4 * B * Sk + 4 * B * H * Sq),
                ("dq", 6 * pairs * D, 3 * io_q + 2 * io_k + 12 * B * H * Sq + 4 * B * Sk),
                ("dkv", 8 * pairs * D, 2 * io_q + 4 * io_k + 8 * B * H * Sq + 4 * B * Sk)):
            bounds.update({f"{part}_{k}": v
                           for k, v in routes_bound(0.0, flops, nbytes, dtype).items()})
        q4, k4, v4 = (x.view(B, H, -1, D) for x in (q, k, v))
        mask = torch.tensor(kp != 0, device="cuda")
        attend = ~mask[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        with torch.no_grad():
            fwd_ms = time_ms(lambda: flash_forward(q, k, v, kpad))
            plain_fwd = time_ms(lambda: flash_attention_plain(q, k, v, kpad))
            xla_fwd = time_ms(lambda: attention_plain(q4, k4, v4, mask, scale=1.0))
            lib_fwd = time_ms(lambda: sdpa(q4, k4, v4, attn_mask=attend, scale=1.0))
            fwd_b2b = b2b_ms(lambda: flash_forward(q, k, v, kpad))
            lib_fwd_b2b = b2b_ms(lambda: sdpa(q4, k4, v4, attn_mask=attend, scale=1.0))
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
            fwd_ms_b2b=fwd_b2b, fwd_library_ms_b2b=lib_fwd_b2b, fwd_attention_plain_ms=xla_fwd,
            dq_ms=dq_ms, dq_plain_ms=plain_dq, dq_library_ms=lib_dq, dkv_ms=dkv_ms,
            dkv_plain_ms=plain_dkv, dkv_library_ms=lib_dkv, bwd_attention_plain_ms=xla_bwd,
            **bounds)
        torch.cuda.empty_cache()
    print("flash", json.dumps(case), flush=True)
    if not rel <= TOL[dtype] or not empty_exact or not lse_err <= 1e-3:
        fail(f"the flash kernels disagree with flash_attention_plain: {case}")
    return case


# ----------------------------------------------------------------- phase 4
def _serving_aligner(**impls):
    """TemporalAligner E6D6, width 512, 8 heads, 4096-d inputs, on the CPU
    with the seeded bench weights (through the JAX->port weight bridge);
    ``impls``: attn_impl / mlp_impl."""
    from exoground_tpu_torch.evals.bench_items import make_bench_params
    from exoground_tpu_torch.models import TemporalAligner
    from exoground_tpu_torch.utils.convert import load_tan_params

    model = TemporalAligner(num_encoder_layers=6, num_joint_layers=6, width=512,
                            heads=8, input_dim=4096, device="cpu", **impls)
    load_tan_params(model, make_bench_params(0))
    return model


def _card_vs_cpu(label, gpu, cpu, cpu_ev, cfg, item, rel_tol):
    """Score rel. error, and best_second (argmax) equality on the texts
    whose top-2 margin in the CPU evaluator's canvas for ``item`` clears
    rel_tol of max|score|; fails beyond rel_tol."""
    from exoground_tpu_torch.evals.align_fused import _placed_plan

    (_, dims, args, _), = list(_placed_plan([item], cfg, "cpu"))
    _, canvas = cpu_ev._process(cfg, dims, args)
    k, vlen = len(item["start"]), len(item["video"])
    top2 = torch.topk(canvas[:k, :vlen], 2, dim=-1).values.numpy()
    g_score, c_score = np.asarray(gpu["score"]), np.asarray(cpu["score"])
    score_err = float(np.abs(g_score - c_score).max() / np.abs(c_score).max())
    tol = rel_tol * np.abs(c_score).max()
    clear = top2[:, 0] - top2[:, 1] > tol
    key = "best_second" if "best_second" in gpu else "argmax"
    same = np.asarray(gpu[key]) == np.asarray(cpu[key])
    print(f"{label}: score rel err {score_err:.3e}, best_second equal on "
          f"{int(same[clear].sum())}/{int(clear.sum())} texts with a top-2 margin > "
          f"{tol:.2e}", flush=True)
    if not score_err <= rel_tol or not same[clear].all():
        fail(f"{label}: the card disagrees with the CPU plain path")


def _service_vs_cpu(label, model, req, gpu):
    """The card's align() answer ``gpu`` to ``req`` against the CPU plain
    path's (float32, score rel. error <= 1e-4)."""
    from exoground_tpu_torch.serve import AlignmentService

    cpu_svc = AlignmentService(model, device="cpu")
    t0 = time.perf_counter()
    cpu = cpu_svc.align(req)
    cpu_s = time.perf_counter() - t0
    k = len(req.text_embeds)
    item = {"video": req.video, "start": np.zeros(k), "end": np.full(k, float(len(req.video))),
            "aligned": np.zeros(k, np.int64), "text_embed": req.text_embeds}
    # all texts active: the evaluator's canvas rows are in the request's order
    _card_vs_cpu(f"{label} ({k} texts, CPU {cpu_s:.1f} s)", gpu, cpu, cpu_svc._evaluator,
                 cpu_svc._evaluator._cfg_for(True), item, 1e-4)


def _int8_video_vs_cpu(label, model, item, kernels):
    """One video in float32 + int8 (int8_min_cols 1024) through the
    evaluator on the card and on the CPU plain path (score rel. error
    <= 1e-3); fails unless each of ``kernels`` launched on the card."""
    from exoground_tpu_torch.evals import AlignEvalConfig, FusedAlignEvaluator
    from exoground_tpu_torch.ops import _kernels

    cfg32 = AlignEvalConfig(matmul_dtype="int8", int8_min_cols=1024, all_texts_active=True)
    _kernels.reset_launches()
    gpu = FusedAlignEvaluator(model, cfg32, device="cuda").predict([item])[0]
    torch.cuda.synchronize()
    launches = {n: _kernels.LAUNCHES[n] for n in kernels}
    cpu_ev = FusedAlignEvaluator(model, cfg32, device="cpu")
    t0 = time.perf_counter()
    cpu = cpu_ev.predict([item])[0]
    cpu_s = time.perf_counter() - t0
    _card_vs_cpu(f"{label} card vs CPU plain path (f32 + int8, {len(item['start'])} texts, CPU "
                 f"{cpu_s:.1f} s, card launches {launches})", gpu, cpu, cpu_ev, cfg32, item, 1e-3)
    if not all(launches.values()):
        fail(f"the float32 {label} run launched {launches}")


def main_path(card):
    from exoground_tpu_torch.evals import AlignEvalConfig, FusedAlignEvaluator
    from exoground_tpu_torch.evals.bench_items import make_bench_items
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.serve import AlignmentService, AlignRequest

    model = _serving_aligner()
    items = make_bench_items(4096, 4096)
    svc = AlignmentService(model, device="cuda")

    groups = []  # (joint S) of every group the service dispatched
    ev = svc._evaluator
    inner = ev._process

    def counting(cfg, dims, host_args):
        groups.append(dims[1] + host_args[6].shape[1])  # seq_len + Npad (text_idx)
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
    if (launches["fused_mha"] != expect_mha or launches["fused_mlp"] != expect_mlp
            or any(launches[k] for k in BLOCK_KERNELS)):
        fail(f"launch counts {launches} != expected mha {expect_mha}, mlp {expect_mlp}, "
             "no block kernel ('auto' keeps the per-module kernels)")
    for req, ans in zip(reqs, answers):
        k, vlen = len(req.text_embeds), len(req.video)
        if not (len(ans["best_second"]) == k and all(0 <= s < vlen for s in ans["best_second"])
                and np.isfinite(ans["score"]).all()):
            fail(f"malformed align() answer for a {vlen}-frame video")

    # the same request on the CPU plain path (all texts active: identity order)
    req = AlignRequest(video=items[4]["video"], text_embeds=items[4]["text_embed"])
    _service_vs_cpu("card vs CPU plain path", model, req, svc.align(req))

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


# ---------------------------------------------------------------- phase 4b
def _wall(run) -> tuple:
    """(host seconds, result) of ``run()`` between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _timed_sweep(ev, items) -> tuple:
    return _wall(lambda: ev(items))


def int8_path(card):
    """The int8 serving mode at E6D6 full width: FusedAlignEvaluator in the
    JAX bench's int8 configuration over the 8 bench videos, counted (12
    int8 MHA + 12 int8 MLP launches per group, none of the exact kernels);
    one video in float32 + int8 on the card and on the CPU plain path; R@1,
    AUC and frames/s (median of 3 sweeps, in turns) beside the exact
    bfloat16 run; one AlignmentService(matmul_dtype='int8') request (the JAX
    service's policy, int8_min_cols 0: no int8 kernel launch); one sweep
    each with transfer_dtype int8 and int4."""
    from exoground_tpu_torch.evals import AlignEvalConfig, FusedAlignEvaluator
    from exoground_tpu_torch.evals.bench_items import INT8_SERVING, make_bench_items
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.serve import AlignmentService, AlignRequest

    model = _serving_aligner()
    items = make_bench_items(4096, 4096)
    frames = sum(len(it["video"]) for it in items)
    ev = FusedAlignEvaluator(model, AlignEvalConfig(**INT8_SERVING), device="cuda")
    groups = []
    inner = ev._process

    def counting(cfg, dims, host_args):
        groups.append(dims[1] + host_args[6].shape[1])  # joint S
        return inner(cfg, dims, host_args)

    ev._process = counting
    _kernels.reset_launches()
    t0 = time.perf_counter()
    metrics = ev(items)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    ev._process = inner
    want = dict(fused_mha_int8=sum(6 + (6 if s <= 128 else 0) for s in groups),
                fused_mlp_int8=12 * len(groups), fused_mha=0, fused_mlp=0,
                **{k: 0 for k in BLOCK_KERNELS})
    print(f"int8 path: {len(groups)} group dispatches (joint S {groups}), {wall:.3f} s "
          f"(first sweep), launches {launches}, {card}", flush=True)
    if {k: launches[k] for k in want} != want:
        fail(f"int8 path launches {launches} != {want}")

    # one video, float32 + int8, on the card and on the CPU plain path
    _int8_video_vs_cpu("int8", model, items[4], ("fused_mha_int8", "fused_mlp_int8"))

    # R@1, AUC and frames/s beside the exact bfloat16 run, in turns
    exact = FusedAlignEvaluator(
        model, AlignEvalConfig(compute_dtype="bfloat16", transfer_dtype="float16"),
        device="cuda")
    exact(items)  # warm-up
    runs = {"int8": [], "exact": []}
    res = {"int8": metrics}
    for rep in range(3):
        for name in (("int8", "exact") if rep % 2 == 0 else ("exact", "int8")):
            dt, res[name] = _timed_sweep(ev if name == "int8" else exact, items)
            runs[name].append(dt)
    out = {}
    for name in ("int8", "exact"):
        dt = statistics.median(runs[name])
        out[name] = dict(recall=res[name]["Recall"], auc=res[name]["AUC"],
                         sweeps_s=runs[name], frames_per_s=frames / dt)
    print("int8_bench", json.dumps(dict(config=INT8_SERVING, frames=frames, card=card, **out)),
          flush=True)
    for name, m in out.items():
        if not (0.0 <= m["recall"] <= 1.0 and 0.0 <= m["auc"] <= 1.0):
            fail(f"{name} metrics out of range: {m}")

    # the service's int8 mode: every projection quantized, unfused
    it = items[0]
    svc = AlignmentService(model, matmul_dtype="int8", device="cuda")
    _kernels.reset_launches()
    ans = svc.align(AlignRequest(video=it["video"], text_embeds=it["text_embed"],
                                 start=it["start"], end=it["end"]))
    torch.cuda.synchronize()
    svc_launches = dict(_kernels.LAUNCHES)
    print(f"AlignmentService(matmul_dtype='int8'): launches {svc_launches}", flush=True)
    if any(svc_launches[k] for k in ("fused_mha_int8", "fused_mlp_int8", "fused_mha",
                                     "fused_mlp")):
        fail(f"the int8 service launched {svc_launches}; its policy quantizes every "
             "projection on the unfused path")
    if not (len(ans["best_second"]) == len(it["text_embed"])
            and all(0 <= s < len(it["video"]) for s in ans["best_second"])
            and np.isfinite(ans["score"]).all()):
        fail("malformed int8 align() answer")

    # one sweep each with int8 and int4 transfer (after a warm-up sweep)
    for td in ("int8", "int4"):
        tev = FusedAlignEvaluator(model, AlignEvalConfig(**dict(INT8_SERVING, transfer_dtype=td)),
                                  device="cuda")
        tev(items)
        dt, m = _timed_sweep(tev, items)
        print(f"int8 path, transfer_dtype {td}: R@1 {m['Recall']:.4f} AUC {m['AUC']:.4f}, "
              f"{dt:.4f} s = {frames / dt:.1f} frames/s on {card}", flush=True)
        if not (0.0 <= m["Recall"] <= 1.0 and 0.0 <= m["AUC"] <= 1.0):
            fail(f"transfer {td} metrics out of range: {m}")
    return launches


# ---------------------------------------------------------------- phase 4c
def block_path(card):
    """The whole-block path at E6D6 full width: TemporalAligner(attn_impl=
    "fused", mlp_impl="fused") in FusedAlignEvaluator over the 8 bench
    videos in float32, bfloat16 and the JAX bench's int8 row, each counted
    over one sweep (per group 12 block_attn + 12 block_mlp launches, or
    their int8 twins, and no per-module kernel while the joint S <= 128);
    frames/s (median of 3 sweeps) in turns with the 'auto' per-module model
    of the same configuration, R@1 and AUC beside its; then the card
    against the CPU plain path: AlignmentService.align in float32 (<= 1e-4)
    and one video through the evaluator in float32 + int8 (<= 1e-3; the
    service keeps int8_min_cols 0, which takes no block kernel)."""
    from exoground_tpu_torch.evals import AlignEvalConfig, FusedAlignEvaluator
    from exoground_tpu_torch.evals.bench_items import INT8_SERVING, make_bench_items
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.serve import AlignmentService, AlignRequest

    block_model = _serving_aligner(attn_impl="fused", mlp_impl="fused")
    auto_model = _serving_aligner()
    items = make_bench_items(4096, 4096)
    frames = sum(len(it["video"]) for it in items)
    totals = {k: 0 for k in BLOCK_KERNELS}
    for label, fields in (("float32", dict(compute_dtype="float32")),
                          ("bfloat16", dict(compute_dtype="bfloat16")), ("int8", INT8_SERVING)):
        cfg = AlignEvalConfig(**fields)
        block_ev = FusedAlignEvaluator(block_model, cfg, device="cuda")
        auto_ev = FusedAlignEvaluator(auto_model, cfg, device="cuda")
        groups = []
        inner = block_ev._process

        def counting(cfg_, dims, host_args, _inner=inner, _groups=groups):
            _groups.append(dims[1] + host_args[6].shape[1])  # joint S
            return _inner(cfg_, dims, host_args)

        block_ev._process = counting
        _kernels.reset_launches()
        t0 = time.perf_counter()
        metrics = {"block": block_ev(items)}
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        block_ev._process = inner
        sfx = "_int8" if label == "int8" else ""
        other = "" if sfx else "_int8"
        short = sum(1 for s in groups if s <= 128)
        # a joint S > 128 moves that group's 6 joint layers to the per-module
        # path: the MLP kernel and the unfused attention
        want = {"block_attn" + sfx: 6 * len(groups) + 6 * short,
                "block_mlp" + sfx: 6 * len(groups) + 6 * short,
                "fused_mlp" + sfx: 6 * (len(groups) - short), "fused_mha" + sfx: 0,
                "block_attn" + other: 0, "block_mlp" + other: 0,
                "fused_mha" + other: 0, "fused_mlp" + other: 0}
        got = {k: launches[k] for k in want}
        print(f"block path {label}: {len(groups)} group dispatches (joint S {groups}), "
              f"{first:.3f} s (first sweep), launches {launches}, {card}", flush=True)
        if got != want:
            fail(f"block path {label} launches {got} != {want}")
        for k in BLOCK_KERNELS:
            totals[k] += launches[k]
        auto_ev(items)  # warm-up
        runs = {"block": [], "per_module": []}
        for rep in range(3):
            for name in (("block", "per_module") if rep % 2 == 0 else ("per_module", "block")):
                dt, metrics[name] = _timed_sweep(block_ev if name == "block" else auto_ev, items)
                runs[name].append(dt)
        out = {name: dict(recall=metrics[name]["Recall"], auc=metrics[name]["AUC"],
                          sweeps_s=runs[name], frames_per_s=frames / statistics.median(runs[name]))
               for name in runs}
        print("block_bench", json.dumps(dict(config=label, fields=fields, frames=frames, card=card,
                                             **out)), flush=True)
        for name, m in out.items():
            if not (0.0 <= m["recall"] <= 1.0 and 0.0 <= m["auc"] <= 1.0):
                fail(f"block path {label} {name} metrics out of range: {m}")
        del block_ev, auto_ev
        torch.cuda.empty_cache()

    # the card against the CPU plain path: the service in float32, then one
    # video in float32 + int8 through the evaluator
    item = items[4]
    req = AlignRequest(video=item["video"], text_embeds=item["text_embed"])
    _kernels.reset_launches()
    gpu = AlignmentService(block_model, device="cuda").align(req)
    torch.cuda.synchronize()
    svc_launches = {n: _kernels.LAUNCHES[n] for n in ("block_attn", "block_mlp")}
    _service_vs_cpu(f"block path service card vs CPU plain path (card launches {svc_launches})",
                    block_model, req, gpu)
    if not all(svc_launches.values()):
        fail(f"the block-path service launched {svc_launches}")
    _int8_video_vs_cpu("block path int8", block_model, item, ("block_attn_int8", "block_mlp_int8"))
    return totals


# ---------------------------------------------------------------- phase 4d
def aligner_small_path(card):
    """TemporalAligner(attn_impl="small") in FusedAlignEvaluator over the 8
    bench videos in float32 and bfloat16, each counted over one sweep (per
    group 12 small_attn launches, 6 dual S64 + 6 joint, no fused MHA);
    frames/s (median of 3 sweeps) in turns with the 'auto' model; one video
    in float32 on the card against the CPU plain path (score <= 1e-4)."""
    from exoground_tpu_torch.evals import AlignEvalConfig, FusedAlignEvaluator
    from exoground_tpu_torch.evals.bench_items import make_bench_items
    from exoground_tpu_torch.ops import _kernels

    small_model = _serving_aligner(attn_impl="small")
    auto_model = _serving_aligner()
    items = make_bench_items(4096, 4096)
    frames = sum(len(it["video"]) for it in items)
    total = 0
    for dtype in ("float32", "bfloat16"):
        cfg = AlignEvalConfig(compute_dtype=dtype)
        small_ev = FusedAlignEvaluator(small_model, cfg, device="cuda")
        auto_ev = FusedAlignEvaluator(auto_model, cfg, device="cuda")
        groups = []
        inner = small_ev._process

        def counting(cfg_, dims, host_args, _inner=inner, _groups=groups):
            _groups.append(dims[1] + host_args[6].shape[1])  # joint S
            return _inner(cfg_, dims, host_args)

        small_ev._process = counting
        _kernels.reset_launches()
        metrics = {"small": small_ev(items)}
        torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
        small_ev._process = inner
        short = sum(1 for s in groups if s <= 128)
        want = {"small_attn": 6 * len(groups) + 6 * short, "fused_mha": 0,
                "fused_mlp": 12 * len(groups)}
        got = {k: launches[k] for k in want}
        print(f"aligner 'small' {dtype}: {len(groups)} group dispatches (joint S {groups}), "
              f"launches {launches}, {card}", flush=True)
        if got != want:
            fail(f"aligner 'small' {dtype} launches {got} != {want}")
        total += launches["small_attn"]
        auto_ev(items)  # warm-up
        runs = {"small": [], "auto": []}
        for rep in range(3):
            for name in (("small", "auto") if rep % 2 == 0 else ("auto", "small")):
                dt, metrics[name] = _timed_sweep(small_ev if name == "small" else auto_ev, items)
                runs[name].append(dt)
        out = {name: dict(recall=metrics[name]["Recall"], auc=metrics[name]["AUC"],
                          sweeps_s=runs[name], frames_per_s=frames / statistics.median(runs[name]))
               for name in runs}
        print("small_bench", json.dumps(dict(config=dtype, frames=frames, card=card, **out)),
              flush=True)
        for name, m in out.items():
            if not (0.0 <= m["recall"] <= 1.0 and 0.0 <= m["auc"] <= 1.0):
                fail(f"aligner 'small' {dtype} {name} metrics out of range: {m}")
        del small_ev, auto_ev
        torch.cuda.empty_cache()

    # one video in float32 on the card and on the CPU plain path
    item = items[4]
    cfg = AlignEvalConfig(all_texts_active=True)
    gpu = FusedAlignEvaluator(small_model, cfg, device="cuda").predict([item])[0]
    cpu_ev = FusedAlignEvaluator(small_model, cfg, device="cpu")
    t0 = time.perf_counter()
    cpu = cpu_ev.predict([item])[0]
    _card_vs_cpu(f"aligner 'small' card vs CPU plain path (f32, {len(item['start'])} texts, "
                 f"CPU {time.perf_counter() - t0:.1f} s)", gpu, cpu, cpu_ev, cfg, item, 1e-4)
    return total


# ---------------------------------------------------------------- phase 4e
def _counted(run, kernels):
    """``run()`` with the launch counters set to 0 just before and read just
    after; returns (its result, the counts of ``kernels``)."""
    from exoground_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, {k: _kernels.LAUNCHES[k] for k in kernels}


def _packed(pending) -> np.ndarray:
    """The (4, Ntot) packed results of a dispatched sweep, group by group."""
    seen, out = set(), []
    for rec in pending:
        if rec[-1] is not None and id(rec[-1]) not in seen:
            seen.add(id(rec[-1]))
            out.append(np.asarray(rec[-1]))
    return np.concatenate(out, axis=1)


def _agree(label, got, want, tol) -> float:
    """max|got - want| over the score rows, relative to max|want score|;
    fails beyond ``tol``."""
    err = float(np.abs(got[1:] - want[1:]).max() / np.abs(want[1]).max())
    if not err <= tol:
        fail(f"{label}: packed results differ by {err:.3e} of max|score| (> {tol})")
    return err


def _expect(pre, per_sweep, int8):
    """Launches of ``per_sweep`` sweeps (k checkpoints or q batches) of a
    resident handle: per group 6 dual + 6 joint MHA launches (the joint
    tower while its S = seq_len + Npad <= 128) and 12 MLP launches."""
    sfx = "_int8" if int8 else ""
    mha = mlp = 0
    for entry in pre.entries:
        if entry[0] == "group":
            joint_s = entry[1][1] + entry[2][6].shape[-1]
            mha += 6 + (6 if joint_s <= 128 else 0)
            mlp += 12
    other = "" if int8 else "_int8"
    return {"fused_mha" + sfx: mha * per_sweep, "fused_mlp" + sfx: mlp * per_sweep,
            "fused_mha" + other: 0, "fused_mlp" + other: 0}


def _check_counts(label, got, want):
    if got != want:
        fail(f"{label}: launches {got} != {want}")


def resident_path(card):
    """Resident serving at E6D6 full width over the 8 bench videos (one group),
    float32 and bfloat16: preload (median of 3), run_preloaded in turns with
    the streaming sweep (median of 3 each), 16 dispatch_preloaded sweeps
    queued before the first reduce; run_many over 4 seeded checkpoints
    against 4 x (update_params; run_preloaded); run_queries over 4
    make_query_batch batches against each batch alone; preproject, and
    preproject + int8 (int8_min_cols 1024). Each counted run has its counts
    set to 0 just before and read just after (12 fused MHA + 12 fused MLP
    launches a group per sweep, checkpoint and query; rows 5 and 6 under
    int8). Fails unless resident == streaming (score rows within 1e-5 of
    max|score| in float32, 1e-2 in bfloat16; R@1 and AUC equal in float32),
    run_many row i == the sequential run (also under int8, where each
    checkpoint quantizes its own weights), each query batch == its lone run
    (R@1 equal, AUC within 1e-4, scores within the same bars) and
    preproject within 1e-4 (float32; 1e-2 bfloat16) of the unsplit run.
    Prints one `resident_bench {...}` line a dtype. Then the whole-block
    model in float32: one counted resident sweep (12 block_attn + 12
    block_mlp launches) equal to its streaming sweep. Returns the launch
    totals."""
    from exoground_tpu_torch.evals import AlignEvalConfig, FusedAlignEvaluator
    from exoground_tpu_torch.evals.align_fused import _dispatch, _placed_plan
    from exoground_tpu_torch.evals.bench_items import (
        make_bench_items, make_bench_params, make_query_batch)
    from exoground_tpu_torch.utils.convert import load_tan_params

    kernels = ("fused_mha", "fused_mlp", "fused_mha_int8", "fused_mlp_int8")
    model = _serving_aligner()
    items = make_bench_items(4096, 4096)
    frames = sum(len(it["video"]) for it in items)
    state_dicts = []
    for seed in (1, 2, 3, 4):
        m = _serving_aligner()
        load_tan_params(m, make_bench_params(seed))
        state_dicts.append(m.state_dict())
    base_sd = model.state_dict()
    queries = [make_query_batch(items, seed) for seed in range(4)]
    totals = {k: 0 for k in kernels}

    def count(label, run, want):
        out, got = _counted(run, kernels)
        _check_counts(label, got, want)
        for k in kernels:
            totals[k] += got[k]
        return out

    for dtype in ("float32", "bfloat16"):
        tol = 1e-5 if dtype == "float32" else TOL[torch.bfloat16]
        pp_tol = 1e-4 if dtype == "float32" else TOL[torch.bfloat16]
        cfg = AlignEvalConfig(compute_dtype=dtype)
        ev = FusedAlignEvaluator(model, cfg, device="cuda")
        ev(items)  # warm-up: allocator, cuBLAS handles
        pre_s = []
        for _ in range(3):
            dt, pre = _wall(lambda: ev.preload(items))
            pre_s.append(dt)
        res = {}
        res["resident"] = count(f"resident {dtype} run_preloaded", lambda: ev.run_preloaded(pre),
                                _expect(pre, 1, False))
        # resident against streaming, packed result by packed result
        resident = _packed(ev.dispatch_preloaded(pre))
        streaming = _packed(_dispatch(_placed_plan(items, cfg, ev.device), ev._process, cfg))
        res["streaming"] = ev(items)
        errs = {"resident_vs_streaming": _agree(f"resident vs streaming {dtype}", resident,
                                                streaming, tol)}
        if dtype == "float32" and res["resident"] != res["streaming"]:
            fail(f"resident metrics {res['resident']} != streaming {res['streaming']}")
        runs = {"streaming": [], "resident": []}
        for rep in range(3):
            for name in (("streaming", "resident") if rep % 2 == 0 else ("resident", "streaming")):
                dt, _ = _wall(lambda: ev(items) if name == "streaming" else ev.run_preloaded(pre))
                runs[name].append(dt)
        # 16 sweeps queued before the first reduce
        n_pipe = 16

        def pipelined():
            pend = [ev.dispatch_preloaded(pre) for _ in range(n_pipe)]
            return [ev.reduce_preloaded(p, pre) for p in pend]

        pipelined()  # warm-up
        dt_pipe, piped = _wall(pipelined)
        if any(m != res["resident"] for m in piped):
            fail(f"a pipelined {dtype} sweep reduced to other metrics")

        # run_many over 4 checkpoints against 4 x (update_params; run_preloaded)
        stacked = ev.stack_checkpoints(state_dicts)
        k = stacked.k
        many = count(f"run_many {dtype}", lambda: ev.run_many(pre, stacked), _expect(pre, k, False))

        def sequential():
            out = []
            for sd in state_dicts:
                ev.update_params(sd)
                out.append(ev.run_preloaded(pre))
            return out

        seq = sequential()
        many_packed = [_packed(p) for p in ev.dispatch_many(pre, stacked)]
        errs["run_many_vs_sequential"] = 0.0
        for i, sd in enumerate(state_dicts):
            ev.update_params(sd)
            errs["run_many_vs_sequential"] = max(errs["run_many_vs_sequential"], _agree(
                f"run_many row {i} {dtype}", many_packed[i], _packed(ev.dispatch_preloaded(pre)),
                tol))
        if many != seq:
            fail(f"run_many {dtype} {many} != sequential {seq}")
        runs["run_many"], runs["sequential"] = [], []
        for rep in range(3):
            for name in (("run_many", "sequential") if rep % 2 == 0 else ("sequential", "run_many")):
                dt, _ = _wall(lambda: ev.run_many(pre, stacked) if name == "run_many"
                              else sequential())
                runs[name].append(dt)
        ev.update_params(base_sd)
        del stacked

        # q query batches over the resident corpus against each batch alone
        q = len(queries)
        dt_pq, pq = _wall(lambda: ev.preload_queries(queries))
        got_q = count(f"run_queries {dtype}", lambda: ev.run_queries(pq), _expect(pq, q, False))
        preds_q = ev.predict_queries(pq)
        errs["queries_vs_lone"] = 0.0
        for i, batch in enumerate(queries):
            lone = ev(batch)
            if (got_q[i]["Recall"] != lone["Recall"]
                    or abs(got_q[i]["AUC"] - lone["AUC"]) > 1e-4):
                fail(f"query batch {i} {dtype}: {got_q[i]} against its lone run {lone}")
            score_q = np.concatenate([p["score"] for p in preds_q[i]])
            score_l = np.concatenate([p["score"] for p in ev.predict(batch)])
            err = float(np.abs(score_q - score_l).max() / np.abs(score_l).max())
            if not err <= tol:
                fail(f"query batch {i} {dtype}: scores differ by {err:.3e} of max|score|")
            errs["queries_vs_lone"] = max(errs["queries_vs_lone"], err)
        runs["run_queries"] = [_wall(lambda: ev.run_queries(pq))[0] for _ in range(3)]
        del pq

        # preproject, and preproject + int8 (int8_min_cols 1024)
        pp_runs = {}
        for name, fields in (("preproject", {}),
                             ("preproject_int8", dict(matmul_dtype="int8", int8_min_cols=1024))):
            pev = FusedAlignEvaluator(
                model, AlignEvalConfig(compute_dtype=dtype, preproject=True, **fields),
                device="cuda")
            dt_pre, ppre = _wall(lambda: pev.preload(items))
            res[name] = count(f"{name} {dtype}", lambda: pev.run_preloaded(ppre),
                              _expect(ppre, 1, bool(fields)))
            if not fields:
                errs["preproject_vs_unsplit"] = _agree(
                    f"preproject vs unsplit {dtype}", _packed(pev.dispatch_preloaded(ppre)),
                    resident, pp_tol)
            pev.run_preloaded(ppre)
            pp_runs[name] = dict(preload_s=dt_pre,
                                 sweeps_s=[_wall(lambda: pev.run_preloaded(ppre))[0]
                                           for _ in range(3)])
            del pev, ppre

        if dtype == "float32":
            # the int8 weight cache under run_many: each checkpoint
            # quantizes its own weights (rows 5 and 6 on the card)
            qev = FusedAlignEvaluator(
                model, AlignEvalConfig(matmul_dtype="int8", int8_min_cols=1024), device="cuda")
            qpre = qev.preload(items)
            qstack = qev.stack_checkpoints(state_dicts)
            many8 = count("run_many float32 + int8", lambda: qev.run_many(qpre, qstack),
                          _expect(qpre, k, True))
            seq8 = []
            for sd in state_dicts:
                qev.update_params(sd)
                seq8.append(qev.run_preloaded(qpre))
            if many8 != seq8 or len({(m["Recall"], m["AUC"]) for m in many8}) < 2:
                fail(f"run_many float32 + int8 {many8} != sequential {seq8}")
            print(f"resident float32 + int8: run_many over {k} checkpoints == sequential "
                  f"{many8}", flush=True)
            del qev, qpre, qstack

        med = {name: statistics.median(v) for name, v in runs.items()}
        out = dict(
            dtype=dtype, frames=frames, card=card, preload_s=pre_s,
            streaming=dict(sweeps_s=runs["streaming"], frames_per_s=frames / med["streaming"]),
            resident=dict(sweeps_s=runs["resident"], frames_per_s=frames / med["resident"]),
            pipelined=dict(sweeps=n_pipe, wall_s=dt_pipe, frames_per_s=n_pipe * frames / dt_pipe),
            run_many=dict(k=k, sweeps_s=runs["run_many"], frames_per_s=k * frames / med["run_many"]),
            sequential=dict(k=k, sweeps_s=runs["sequential"],
                            frames_per_s=k * frames / med["sequential"]),
            run_queries=dict(q=q, preload_s=dt_pq, sweeps_s=runs["run_queries"],
                             frames_per_s=q * frames / med["run_queries"]),
            **{name: dict(v, frames_per_s=frames / statistics.median(v["sweeps_s"]))
               for name, v in pp_runs.items()},
            errors_of_max_score=errs,
            metrics={name: res[name] for name in ("streaming", "resident", "preproject",
                                                  "preproject_int8")})
        print("resident_bench", json.dumps(out), flush=True)
        del ev, pre
        torch.cuda.empty_cache()
    # the whole-block model (rows 7 and 8): resident == streaming, counted
    block_model = _serving_aligner(attn_impl="fused", mlp_impl="fused")
    cfg = AlignEvalConfig()
    bev = FusedAlignEvaluator(block_model, cfg, device="cuda")
    bpre = bev.preload(items)
    block_kernels = ("block_attn", "block_mlp", "fused_mha", "fused_mlp")
    bres, got = _counted(lambda: bev.run_preloaded(bpre), block_kernels)
    want = {"block_attn": 12, "block_mlp": 12, "fused_mha": 0, "fused_mlp": 0}
    _check_counts("resident block path float32", got, want)
    totals.update(block_attn=got["block_attn"], block_mlp=got["block_mlp"])
    err = _agree("resident vs streaming, block path float32", _packed(bev.dispatch_preloaded(bpre)),
                 _packed(_dispatch(_placed_plan(items, cfg, bev.device), bev._process, cfg)), 1e-5)
    if bres != bev(items):
        fail(f"resident block-path metrics {bres} != streaming {bev(items)}")
    print(f"resident block path float32: launches {got}, resident vs streaming {err:.3e} of "
          f"max|score|, {bres}", flush=True)
    missing = [k for k, n in totals.items() if not n]
    if missing:
        fail(f"the resident path launched no {missing}")
    return totals


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


def train_path(model, card, batches=(16,), attn_impl="auto"):
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


# ---------------------------------------------------------------- phase 5b
GRAPH_N = 4  # steps a replayed graph (--fused_steps 4)
# (batch, compute dtype, attn_impl) of the replayed train step
GRAPH_CASES = ((64, False, "auto"), (64, True, "auto"), (16, False, "flash"))


def _kernel_names(prof, parts=("grid_", "flash_")) -> dict:
    """Device kernels of a profiled run whose name holds one of ``parts``,
    with their counts."""
    from torch.autograd import DeviceType

    return {e.key[:60]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and any(p in e.key for p in parts)}


def graph_case(model, card, raw, amp, attn_impl):
    """From one state, one generator seed and the 2N prepared batches
    ``raw``: 2N eager steps on one trainer and two scan_steps=N calls (an
    eager warm-up group, then a replay of the captured graph) on another;
    the states and the losses compared; the replay counted and profiled;
    eager and replayed steps timed. Returns the replay's launches."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.train import ExperimentConfig, TANTrainer

    n = GRAPH_N
    b = raw[0]["video"].shape[0]
    trainers = {}
    for fused in (1, n):
        cfg = ExperimentConfig(amp=amp, attn_impl=attn_impl, fused_steps=fused, **BENCH_TRAIN)
        trainers[fused] = TANTrainer(copy.deepcopy(model), cfg, iters_per_epoch=1000,
                                     device="cuda")
    eager, graph = trainers[1], trainers[n]
    groups = [graph.to_device({k: np.stack([r[k] for r in raw[g * n:(g + 1) * n]])
                               for k in raw[0]}) for g in (0, 1)]
    batches = [eager.to_device(r) for r in raw]
    eager_losses = [float(eager.train_step(x)["loss"]) for x in batches]
    graph_losses = graph._do_fused(groups[0])["loss"].tolist()  # eager warm-up, capture
    torch.cuda.synchronize()
    _kernels.reset_launches()
    graph_losses += graph._do_fused(groups[1])["loss"].tolist()  # the replay
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    (g,) = graph.fused_step.graphs.values()

    loss_rel = max(abs(a - e) / abs(e) for a, e in zip(graph_losses, eager_losses))
    worst, bit_equal = (0.0, ""), True
    for name, got, want in (("params", graph.params, eager.params),
                            ("ema", graph.target_params, eager.target_params),
                            ("mu", graph.opt_state.mu, eager.opt_state.mu),
                            ("nu", graph.opt_state.nu, eager.opt_state.nu)):
        for k in want:
            bit_equal &= torch.equal(got[k], want[k])
            err = ((got[k].float() - want[k].float()).abs().max()
                   / want[k].float().abs().max().clamp_min(1e-30)).item()
            worst = max(worst, (err, f"{name} {k}"))
    counts = (graph.opt_state.count, eager.opt_state.count)
    want = {k: 0 for k in launches}
    want.update(milnce_grid_fwd=2 * n, milnce_grid_bwd=2 * n)
    if attn_impl == "flash":
        want.update(flash_fwd=n * FLASH_FWD_PER_STEP, flash_dq=n * FLASH_BWD_PER_STEP,
                    flash_dkv=n * FLASH_BWD_PER_STEP)

    # the kernels the card ran (its activity alone): one eager step, then
    # one replay
    x = batches[0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eager.train_step(x)
        torch.cuda.synchronize()
    names_eager = _kernel_names(prof)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph._do_fused(groups[1])
        torch.cuda.synchronize()
    names_graph = _kernel_names(prof)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    eager_ms = statistics.median(wall(lambda: float(eager.train_step(x)["loss"]))
                                 for _ in range(10)) * 1e3
    replay_ms = statistics.median(wall(lambda: graph._do_fused(groups[1])["loss"].tolist())
                                  for _ in range(5)) * 1e3 / n
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    graph._do_fused(groups[1])
    ev1.record()
    torch.cuda.synchronize()
    bench = dict(card=card, batch=b, dtype="bfloat16" if amp else "float32",
                 attn_impl=attn_impl, n=n, eager_step_ms=round(eager_ms, 3),
                 replay_step_ms=round(replay_ms, 3),
                 replay_busy_ms=round(ev0.elapsed_time(ev1), 3),
                 capture_s=round(g.capture_s, 3), pool_mb=round(g.pool_bytes / 2**20, 1),
                 loss_rel=float(f"{loss_rel:.3g}"), max_err=float(f"{worst[0]:.3g}"),
                 worst=worst[1], bit_equal=bit_equal, launches={k: v for k, v in
                                                                launches.items() if v})
    print("graph_bench", json.dumps(bench), flush=True)
    print(f"graph replay profile, kernels by name (eager step / replay of {n}): "
          f"{names_eager} / {names_graph}", flush=True)
    if not all(np.isfinite(graph_losses)) or not loss_rel <= 1e-5 or not worst[0] <= 1e-4:
        fail(f"the replayed steps disagree with the eager steps: {bench}")
    if counts != (2 * n, 2 * n):
        fail(f"optimizer counts {counts} after {2 * n} steps each")
    _check_counts(f"graph replay {bench['dtype']} {attn_impl}", launches, want)
    if not names_eager or names_graph != {k: n * c for k, c in names_eager.items()}:
        fail(f"the replay's profile does not hold {n} x the eager step's kernels: "
             f"{names_eager} / {names_graph}")
    del eager, graph, trainers, groups, batches
    torch.cuda.empty_cache()
    return launches


def graph_path(model, card):
    """Phase 5b: the train step as a replayed CUDA graph (scan_steps=N) at
    B64 float32 and bfloat16, and B16 under attn_impl='flash'; returns the
    replays' launches by case."""
    from exoground_tpu_torch.evals.bench_items import make_train_batch

    # the host arrays prepare_batch gives, shared by the cases of a batch size
    raw = {b: [make_train_batch(b, seed=40 + i) for i in range(2 * GRAPH_N)]
           for b in sorted({c[0] for c in GRAPH_CASES})}
    return {f"B{b} {'bf16' if amp else 'f32'} {impl}": graph_case(model, card, raw[b], amp,
                                                                  impl)
            for b, amp, impl in GRAPH_CASES}


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


# ----------------------------------------------------------------- phase 7
GROUND_LAUNCHES = {"small": dict(small_attn=30, fused_mha=0, fused_mlp=24),
                   "auto": dict(small_attn=0, fused_mha=24, fused_mlp=24)}


def grounding_path(card):
    """Keystep grounding served: GroundingService over GroundingModel at
    the configuration scripts/train_grounding.sh trains (the MLP VI
    pre-pass, the trunk E6D6, width 512, 8 heads, 4096-d; seeded weights),
    float32, under attn_impl 'small' and 'auto': per impl one ground_batch
    of 64 requests (one bucket: 64-frame video windows, 64 narrations),
    then 1 ground() alone and 3 concurrent, counted per forward ('small':
    30 small_attn, 24 fused_mlp, no fused MHA; 'auto': 24 fused_mha, 24
    fused_mlp); each ground() against its row of ground_batch; the card
    against the same service on the CPU (<= 1e-4 of max|CPU|); requests/s
    (median of 3 batches, in turns); one int8 batch of 16 under 'small'
    (only the window kernel launches) against the CPU at the int8 mode's
    rounding-flip floor. Returns the small_attn launches of the 'small'
    run."""
    import copy

    from exoground_tpu_torch.evals.bench_items import (
        GROUNDING, make_grounding_params, make_grounding_requests)
    from exoground_tpu_torch.models import GroundingModel
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.serve import GroundingService
    from exoground_tpu_torch.utils.convert import load_grounding_params

    cpu_model = GroundingModel(**GROUNDING, attn_impl="small", device="cpu")
    load_grounding_params(cpu_model, make_grounding_params(0))
    reqs = make_grounding_requests(0, 64)
    svc = GroundingService(copy.deepcopy(cpu_model), device="cuda")
    forwards = []
    run = svc._run

    def counting(*args):
        forwards.append(args[1])  # the bucket's batch
        return run(*args)

    svc._run = counting

    def as_array(answers):
        return np.concatenate([np.stack([a["start"], a["end"]], -1) for a in answers])

    def served(impl):
        svc.model.attn_impl = impl
        svc.ground_batch(reqs)  # warm-up
        torch.cuda.synchronize()
        forwards.clear()
        _kernels.reset_launches()
        batch = svc.ground_batch(reqs)
        alone = [svc.ground(reqs[0]["video"], reqs[0]["narration_embeds"])]
        concurrent = [None] * 3
        barrier = threading.Barrier(3)

        def worker(i):
            barrier.wait()
            r = reqs[1 + i]
            concurrent[i] = svc.ground(r["video"], r["narration_embeds"])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
        if any(th.is_alive() for th in threads) or any(a is None for a in concurrent):
            fail("concurrent ground() requests did not finish")
        singles = alone + concurrent
        n = len(forwards)
        per_forward = {k: launches[k] / n for k in ("small_attn", "fused_mha", "fused_mlp")}
        got = as_array(batch)
        one = as_array(singles)
        row_err = float(np.abs(one - got[:len(one)]).max() / np.abs(got).max())
        print(f"grounding '{impl}': 64 + 4 requests in {n} forwards (batches {forwards}), "
              f"launches {launches}, per forward {per_forward}, ground() vs its ground_batch "
              f"row rel err {row_err:.2e}, {card}", flush=True)
        if per_forward != GROUND_LAUNCHES[impl] or any(
                launches[k] for k in ("fused_mha_int8", "fused_mlp_int8", *BLOCK_KERNELS)):
            fail(f"grounding '{impl}' launches {launches} in {n} forwards != "
                 f"{GROUND_LAUNCHES[impl]} per forward")
        if not (got.shape == (sum(len(r["narration_embeds"]) for r in reqs), 2)
                and np.isfinite(got).all()) or not row_err <= 1e-5:
            fail(f"grounding '{impl}': malformed answers or ground() != its batch row")
        return got, launches["small_attn"]

    outs = {impl: served(impl) for impl in ("small", "auto")}

    # the rows of the fused MLP's calls in one forward (phase 3 times them)
    from exoground_tpu_torch.ops import blocks
    mlp_rows = {}
    real_mlp = blocks.fused_mlp

    def recording(x, *weights):
        rows = x.numel() // x.shape[-1]
        mlp_rows[rows] = mlp_rows.get(rows, 0) + 1
        return real_mlp(x, *weights)

    blocks.fused_mlp = recording
    try:
        svc.ground_batch(reqs)
        torch.cuda.synchronize()
    finally:
        blocks.fused_mlp = real_mlp
    print(f"grounding: fused_mlp calls of one forward by rows {mlp_rows}", flush=True)
    t0 = time.perf_counter()
    cpu = as_array(GroundingService(cpu_model, device="cpu").ground_batch(reqs))
    cpu_s = time.perf_counter() - t0
    for impl, (got, _) in outs.items():
        rel = float(np.abs(got - cpu).max() / np.abs(cpu).max())
        print(f"grounding '{impl}' card vs CPU plain path (64 requests, CPU {cpu_s:.1f} s): "
              f"start/end rel err {rel:.3e}", flush=True)
        if not rel <= 1e-4:
            fail(f"grounding '{impl}': the card disagrees with the CPU plain path")

    # requests/s, median of 3 batches of 64, in turns
    times = {"small": [], "auto": []}
    for rep in range(3):
        for impl in (("small", "auto") if rep % 2 == 0 else ("auto", "small")):
            svc.model.attn_impl = impl
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.ground_batch(reqs)
            torch.cuda.synchronize()
            times[impl].append(time.perf_counter() - t0)
    bench = {impl: dict(batch_ms=statistics.median(t) * 1e3, batch_ms_all=[x * 1e3 for x in t],
                        requests_per_s=len(reqs) / statistics.median(t))
             for impl, t in times.items()}
    print("ground_bench", json.dumps(dict(requests=len(reqs), card=card, **bench)), flush=True)

    # the int8 mode under 'small': every projection quantized (int8_min_cols
    # 0), so of the kernels only the window core launches. Its answers move
    # by about their int8 error when an input moves by one rounding step
    # (~1e-7: the card's and the CPU's float32 sums differ by that much
    # before every quantizer), so the card is held against the CPU at the
    # CPU's own response to a 1e-7 relative change of the video features
    # (2x that, at least 1e-3)
    int8_reqs = reqs[:16]
    int8_svc = GroundingService(svc.model, matmul_dtype="int8", device="cuda")
    int8_svc.model.attn_impl = "small"
    _kernels.reset_launches()
    got = as_array(int8_svc.ground_batch(int8_reqs))
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    t0 = time.perf_counter()
    cpu_svc = GroundingService(cpu_model, matmul_dtype="int8", device="cpu")
    cpu8 = as_array(cpu_svc.ground_batch(int8_reqs))
    rng = np.random.RandomState(1)
    nudged = [dict(r, video=r["video"] * (1.0 + 1e-7 * rng.standard_normal(r["video"].shape))
                   .astype(np.float32)) for r in int8_reqs]
    floor = float(np.abs(as_array(cpu_svc.ground_batch(nudged)) - cpu8).max()
                  / np.abs(cpu8).max())
    exact = float(np.abs(got - outs["small"][0][:len(got)]).max() / np.abs(cpu8).max())
    rel = float(np.abs(got - cpu8).max() / np.abs(cpu8).max())
    limit = max(1e-3, 2.0 * floor)
    print(f"grounding int8 'small' ({len(int8_reqs)} requests) card vs CPU plain path (CPU "
          f"{time.perf_counter() - t0:.1f} s): rel err {rel:.3e}, limit {limit:.3e} (the CPU's "
          f"own change under 1e-7 input noise {floor:.3e}); card int8 vs card exact "
          f"{exact:.3e}; launches {launches}", flush=True)
    if not rel <= limit or launches["small_attn"] != 30 or any(
            n for k, n in launches.items() if k != "small_attn"):
        fail("grounding int8: the card disagrees with the CPU or launched other kernels")
    return outs["small"][1]


# ----------------------------------------------------------------- phase 8
# The training command line at the HTM TAN configuration: E6D6 width 512 on
# 512-d S3D video features, seq 64, text bucket 32, token length 32, B 64,
# the word2vec tower at the MIL-NCE text module's shapes (66,250 x 300
# embedding, fc1 300 -> 2048, fc2 2048 -> 512). 540 videos: the 5% split
# puts 27 in validation (one batch) and 513 in training (8 steps at B64).
CLI_VIDEOS, CLI_BATCH, CLI_EPOCHS = 540, 64, 2
CLI_VAL_BATCHES = 1  # ceil(27 / 64) a validation pass
CLI_ALIGN_GROUPS = 1  # 8 htm_align.json videos, 8 to a group


def _cli_argv(root):
    return ["--dataset", "htm-370k", "--model", "cotrain", "--data_root", root,
            "--seq_len", "64", "--batch_size", str(CLI_BATCH), "--epochs", str(CLI_EPOCHS),
            "--eval_freq", "1", "--num_workers", "8", "--print_freq", "4", "--seed", "0"]


def _cli_expect(steps, val_passes, evals):
    """Launches of the command line: 2 grid forward + 2 backward a train
    step (dual and joint) and 2 grid forward a validation batch; fused MHA
    and MLP 12 + 12 a validation forward (online and EMA teacher under
    cotrain) and 12 + 12 a group of each HTM-Align eval."""
    mha = 2 * 12 * CLI_VAL_BATCHES * val_passes + 12 * CLI_ALIGN_GROUPS * evals
    want = {k: 0 for k in ("fused_mha_int8", "fused_mlp_int8", "flash_fwd", "flash_dq",
                           "flash_dkv", "block_attn", "block_mlp", "block_attn_int8",
                           "block_mlp_int8", "small_attn")}
    want.update(milnce_grid_fwd=2 * steps + 2 * CLI_VAL_BATCHES * val_passes,
                milnce_grid_bwd=2 * steps, fused_mha=mha, fused_mlp=mha)
    return want


def _loader_item_ms(ds, n=256) -> dict:
    """Host ms an item of the command line's train reader over one tree:
    deferred (the batch's windows gathered in collate by the native reader,
    as the command line reads) and per item, each on a fresh store, in
    turns; n items read one after another and collated 64 at a time; the
    better of two runs each."""
    from exoground_tpu_torch.data import FeatureStore, HTMFeatureDataset

    runs = {True: [], False: []}
    for defer in (False, True, False, True):
        d = HTMFeatureDataset(ds.cfg, ds.tokenizer, mode="train", asr=ds.asr,
                              store=FeatureStore(ds.cfg.video_feature_root,
                                                 ds.cfg.feature_suffixes),
                              defer_video_io=defer)
        t0 = time.perf_counter()
        for lo in range(0, n, 64):
            d.collate_fn([d[i % len(d)] for i in range(lo, lo + 64)])
        runs[defer].append((time.perf_counter() - t0) / n * 1e3)
    return {"deferred_native": round(min(runs[True]), 3),
            "per_item": round(min(runs[False]), 3)}


def _ckpt_agreement(path, ref_path) -> dict:
    """A checkpoint against another: parameters, EMA twin and both moments,
    each tensor's max error over its max|ref|; bit equality; counts."""
    got, want = (torch.load(p, map_location="cpu", weights_only=True)
                 for p in (path, ref_path))
    worst, equal = 0.0, True
    for a, b in ((got["state_dict"], want["state_dict"]),
                 (got["target_state_dict"], want["target_state_dict"]),
                 (got["optimizer"]["mu"], want["optimizer"]["mu"]),
                 (got["optimizer"]["nu"], want["optimizer"]["nu"])):
        if set(a) != set(b):
            return dict(max_err=float("inf"), bit_equal=False, same_counts=False)
        for k in b:
            equal &= torch.equal(a[k], b[k])
            worst = max(worst, ((a[k].float() - b[k].float()).abs().max()
                                / b[k].float().abs().max().clamp_min(1e-30)).item())
    return dict(max_err=worst, bit_equal=equal,
                same_counts=(got["iteration"], got["optimizer"]["count"])
                == (want["iteration"], want["optimizer"]["count"]))


def cli_agreement(argv):
    """The card against the CPU: one trainer each, built by the command
    line's build_htm_tan from the same seed, on the whole first batch (B64,
    the shapes phase 8 trains and validates at): the first step's loss and
    the validation loss (f32, rel. error <= 1e-4) and the tower's pooled
    output (<= 1e-5 of max|CPU|). Returns the errors and the reader's host
    cost an item (``_loader_item_ms``)."""
    from exoground_tpu_torch.models.word2vec import word2vec_forward
    from exoground_tpu_torch.train import main as cli
    from exoground_tpu_torch.train.config import parse_args

    runs = {dev: cli.build_htm_tan(parse_args(argv), dev) for dev in ("cpu", "cuda")}
    try:
        raw = next(iter(runs["cpu"].train_loader))
        res = {}
        for dev, run in runs.items():
            tr = run.trainer
            batch = tr.to_device(tr.prepare_batch(raw))
            metrics, _ = tr.step.loss_and_grads(tr.params, tr.target_params, batch,
                                                torch.Generator().manual_seed(0))
            tok = batch["token"].reshape(-1, batch["token"].shape[-1])
            pooled = word2vec_forward(tr._tower_params, tok, tok != 0)["pooler_output"]
            res[dev] = (float(metrics["loss"]), tr.evaluate([raw], 0), pooled.cpu())
        item_ms = _loader_item_ms(runs["cpu"].train_loader.dataset)
    finally:
        for run in runs.values():
            run.close()
    (lc, vc, pc), (lg, vg, pg) = res["cpu"], res["cuda"]
    errs = dict(step_loss=abs(lg - lc) / abs(lc), val_loss=abs(vg - vc) / abs(vc),
                tower=float((pg - pc).abs().max() / pc.abs().max()))
    print(f"cli card vs CPU (the first batch, B{len(raw['video'])}, f32): "
          f"step loss {lg:.6f} vs {lc:.6f}, "
          f"val loss {vg:.6f} vs {vc:.6f}, rel errors {errs}", flush=True)
    if not (errs["step_loss"] <= 1e-4 and errs["val_loss"] <= 1e-4 and errs["tower"] <= 1e-5):
        fail(f"the command line's trainer on the card disagrees with the CPU: {errs}")
    return errs, item_ms


def _spy_trainers():
    """Record each TANTrainer the command line builds, and check each
    ``load_checkpoint`` as it returns: resume must restore the checkpoint's
    parameters, EMA twin, optimizer state, iteration, epoch and best
    exactly. Returns (trainers, loads, undo)."""
    from exoground_tpu_torch.train.trainer import TANTrainer

    trainers, loads = [], []
    real_init, real_load = TANTrainer.__init__, TANTrainer.load_checkpoint

    def init(self, *a, **k):
        real_init(self, *a, **k)
        trainers.append(self)

    def load(self, path, mode="resume"):
        real_load(self, path, mode)
        blob = torch.load(path, map_location="cpu", weights_only=True)

        def same(got, want):
            return set(got) == set(want) and all(torch.equal(got[k].cpu(), want[k])
                                                 for k in want)

        rec = dict(mode=mode, params=same(self.params, blob["state_dict"]))
        if mode == "resume":
            opt = blob["optimizer"]
            rec.update(ema=same(self.target_params, blob["target_state_dict"]),
                       mu=same(self.opt_state.mu, opt["mu"]),
                       nu=same(self.opt_state.nu, opt["nu"]),
                       count=self.opt_state.count == opt["count"],
                       iteration=self.iteration == blob["iteration"],
                       start_epoch=self.start_epoch == blob["epoch"] + 1 == 1,
                       best_acc=self.best_acc == blob["best_acc"])
        loads.append(rec)

    TANTrainer.__init__, TANTrainer.load_checkpoint = init, load

    def undo():
        TANTrainer.__init__, TANTrainer.load_checkpoint = real_init, real_load

    return trainers, loads, undo


def cli_path(card):
    """Phase 8: ``exoground_tpu_torch.train.main`` on the card over a seeded
    tree (cotrain, 2 epochs, validation and HTM-Align every epoch), then
    ``--resume`` from epoch 0 and ``--test``; each run counted; the card
    against the CPU. Returns the first run's launches."""
    import glob
    import os
    import shutil
    import tempfile

    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.tools.synth_htm import make_htm_tree
    from exoground_tpu_torch.train import main as cli
    from exoground_tpu_torch.train.trainer import epoch_summary

    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="cli_", dir=build)
    cwd = os.getcwd()
    trainers, loads, undo = _spy_trainers()
    try:
        t0 = time.perf_counter()
        root = make_htm_tree(os.path.join(work, "htm"), n_videos=CLI_VIDEOS, vlen=(200, 600),
                             dim=512, vocab=66249, embed_dim=300, hidden=2048, out_dim=512,
                             n_align=8, seed=0)
        tree_s = time.perf_counter() - t0
        os.chdir(work)  # set_path writes log<prefix>/ under the cwd
        argv = _cli_argv(root)

        def run(extra=()):
            _kernels.reset_launches()
            t0 = time.perf_counter()
            out = cli.main(argv + list(extra))
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, dict(_kernels.LAUNCHES)

        best, run_s, launches = run()
        tr = trainers[-1]
        steps = sum(s["steps"] for s in tr.epoch_stats)
        if steps != CLI_EPOCHS * 8 or not np.isfinite(best):
            fail(f"cli: {steps} steps (want {CLI_EPOCHS * 8}), best {best}")
        _check_counts("cli run", launches, _cli_expect(steps, CLI_EPOCHS, CLI_EPOCHS))
        (e0,) = glob.glob(os.path.join(work, "log", "*", "model", "epoch0.pth.tar"))
        ckpt_mb = os.path.getsize(e0) / 2**20

        # the same run at --fused_steps 4: epoch 0 an eager group (the
        # capture's warm-up) and a replay, epoch 1 two replays
        best4, fused_s, launches4 = run(["--fused_steps", str(GRAPH_N), "--prefix", "_f4"])
        tr4 = trainers[-1]
        steps4 = sum(s["steps"] for s in tr4.epoch_stats)
        if steps4 != CLI_EPOCHS * 8 or not np.isfinite(best4) or tr4.fused_step.captures != 1:
            fail(f"cli --fused_steps {GRAPH_N}: {steps4} steps (want {CLI_EPOCHS * 8}), "
                 f"best {best4}, {tr4.fused_step.captures} captures (want 1)")
        _check_counts(f"cli --fused_steps {GRAPH_N}", launches4,
                      _cli_expect(steps4, CLI_EPOCHS, CLI_EPOCHS))
        (e0f,) = glob.glob(os.path.join(work, "log_f4", "*", "model", "epoch0.pth.tar"))
        fused_vs_single = _ckpt_agreement(e0f, e0)
        print(f"cli --fused_steps {GRAPH_N} epoch-0 checkpoint vs --fused_steps 1: "
              f"{fused_vs_single}", flush=True)
        if not (fused_vs_single["max_err"] <= 1e-4 and fused_vs_single["same_counts"]):
            fail(f"--fused_steps {GRAPH_N} trained another model: {fused_vs_single}")

        best2, resume_s, launches2 = run(["--resume", e0])
        tr2 = trainers[-1]
        steps2 = sum(s["steps"] for s in tr2.epoch_stats)
        if not loads or loads[-1]["mode"] != "resume" or not all(loads[-1].values()):
            fail(f"--resume did not restore exactly: {loads}")
        if steps2 != 8 or not np.isfinite(best2):
            fail(f"cli --resume: {steps2} steps (want 8), best {best2}")
        _check_counts("cli --resume", launches2, _cli_expect(steps2, 1, 1))

        res, test_s, launches3 = run(["--test", e0])
        if loads[-1] != dict(mode="test", params=True) or not all(
                np.isfinite(v) for v in res.values()):
            fail(f"cli --test: {res}, load {loads[-1]}")
        _check_counts("cli --test", launches3, _cli_expect(0, 0, 1))
        undo()
        errs, item_ms = cli_agreement(argv)
    finally:
        undo()
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)

    stats = tr.epoch_stats
    summary = epoch_summary(stats)
    fused_summary = {k: epoch_summary(tr4.epoch_stats)[k] for k in
                     ("samples_per_s", "window_s", "step_ms_median", "data_share")}
    bench = dict(
        card=card, steps=steps, batch=CLI_BATCH,
        # over the whole window, every step and every wait for data: what a
        # user pays a sample
        samples_per_s=round(summary["samples_per_s"], 1),
        window_s=round(summary["window_s"], 3),
        # at 8 steps an epoch the loader has read the epoch before most steps
        # run, so the median step is a loader-idle one
        step_ms_median_loader_idle=round(summary["step_ms_median"], 2),
        data_share=round(summary["data_share"], 4),
        data_share_after_first=round(summary["data_share_after_first"], 4),
        step_ms_all=[round(t * 1e3, 1) for s in stats for t in s["step_s"]],
        val_ms=[round(s["val_s"] * 1e3, 1) for s in stats],
        downstream_s=[round(s["downstream_s"], 3) for s in stats],
        ckpt_mb=round(ckpt_mb, 1), save_s=[round(s["save_s"], 3) for s in stats],
        fused_steps=dict(n=GRAPH_N, **{k: round(v, 4) for k, v in fused_summary.items()},
                         run_s=round(fused_s, 1),
                         capture_s=[round(g.capture_s, 3) for g in tr4.fused_step.graphs.values()],
                         ckpt_vs_single=dict(max_err=float(f"{fused_vs_single['max_err']:.3g}"),
                                             bit_equal=fused_vs_single["bit_equal"])),
        loader_item_ms=item_ms,
        run_s=round(run_s, 1), resume_s=round(resume_s, 1), test_s=round(test_s, 1),
        tree_s=round(tree_s, 1), best=best, test=res,
        err={k: float(f"{v:.3g}") for k, v in errs.items()},
        launches={k: v for k, v in launches.items() if v},
        phase_s=round(time.perf_counter() - t_phase, 1))
    print("cli_bench", json.dumps(bench), flush=True)
    return launches, launches4


def main():
    t_start = time.perf_counter()
    phase_s, t_phase = {}, [t_start, None]

    def mark(phase):
        """Close the phase before ``phase`` (its seconds in ``phase_s``)."""
        now = time.perf_counter()
        if t_phase[1] is not None:
            phase_s[t_phase[1]] = round(now - t_phase[0], 1)
        t_phase[:] = [now, phase]
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: float32 products run in full float32")

    from exoground_tpu_torch.ops import _kernels

    mark("1")
    # phase 1: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    print(smi, flush=True)

    mark("2")
    # phase 2: build
    t0 = time.perf_counter()
    _kernels.build()
    print(f"built {sorted(_kernels.SIGNATURES)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    mark("3")
    # phase 3: kernels against their plain versions
    mha_cases, mlp_cases = [], []
    for dtype in (torch.float32, torch.bfloat16):
        mha_cases.append(mha_case(304, 64, 512, 8, dtype, seed=1, b2b=True))
        mha_cases.append(mha_case(304, 96, 512, 8, dtype, seed=2, b2b=True))
        mha_cases.append(mha_case(5, 33, 128, 4, dtype, seed=3))
        mha_cases.append(mha_case(3, 17, 128, 16, dtype, seed=6))   # head size 8
        mha_cases.append(mha_case(4, 72, 640, 16, dtype, seed=7))   # head size 40
        mha_cases.append(mha_case(3, 128, 384, 8, dtype, seed=8))   # head size 48
        # the window the bf16 body's 128-row tile serves whole, and head size 16
        mha_cases.append(mha_case(64, 128, 512, 8, dtype, seed=13))
        mha_cases.append(mha_case(2, 50, 256, 16, dtype, seed=14))
    mlp_cases += mlp_kernel_cases()

    mark("3b")
    # phase 3b: the grid kernel against its plain version
    grid_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        grid_cases.append(grid_case(6, 1024, 192, 512, 6, dtype, seed=20, timed=True))
        grid_cases.append(grid_case(6, 1024, 192, 512, 1, dtype, seed=21, timed=True))
        grid_cases.append(grid_case(6, 4096, 768, 512, 6, dtype, seed=22, timed=True))
        grid_cases.append(grid_case(6, 4096, 768, 512, 1, dtype, seed=23, timed=True))
        grid_cases.append(grid_case(2, 36, 15, 128, 1, dtype, seed=24, n_invalid=3))
        grid_cases.append(grid_case(1, 512, 3072, 512, 1, dtype, seed=25, n_invalid=5))
        grid_cases.append(grid_case(2, 100, 70, 640, 2, dtype, seed=26, n_invalid=2))
        # the command line's shapes (phase 8): a B64 train step (R 64 x 64,
        # Cc 64 x text bucket 32, most columns padding) and its B27
        # validation batch
        grid_cases.append(grid_case(6, 4096, 2048, 512, 6, dtype, seed=27, n_invalid=1536,
                                    timed=True))
        grid_cases.append(grid_case(6, 4096, 2048, 512, 1, dtype, seed=28, n_invalid=1536,
                                    timed=True))
        grid_cases.append(grid_case(6, 1728, 864, 512, 6, dtype, seed=29, n_invalid=648))
        grid_cases.append(grid_case(6, 1728, 864, 512, 1, dtype, seed=30, n_invalid=648))
    grid_bars(grid_cases)

    mark("3c")
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
        flash_cases.append(flash_case(2, 2, 70, 90, 16, dtype, seed=41, pad_tail=9))
        flash_cases.append(flash_case(1, 2, 100, 130, 96, dtype, seed=42, empty_row=True))

    mark("3d")
    # phase 3d: the int8 kernels against their plain versions
    mha8_cases, mlp8_cases = int8_kernel_cases()

    mark("3e")
    # phase 3e: the whole-block kernels against their plain versions
    block_cases = block_kernel_cases()
    attention_bars(mha_cases, flash_cases, mha8_cases, block_cases)

    mark("3f")
    # phase 3f: the window-attention kernel against its plain version
    small_cases = small_kernel_cases()

    mark("4")
    # phase 4: the serving path, counted
    launches = main_path(card)

    mark("4b")
    # phase 4b: the int8 serving mode, counted
    int8_launches = int8_path(card)
    launches.update({k: int8_launches[k] for k in ("fused_mha_int8", "fused_mlp_int8")})

    mark("4c")
    # phase 4c: the whole-block path, counted
    launches.update(block_path(card))

    mark("4e")
    # phase 4e: resident serving, counted
    resident_launches = resident_path(card)

    mark("4d")
    # phase 4d: the aligner under attn_impl='small', counted
    small_launches = {"aligner attn_impl=small (phase 4d)": aligner_small_path(card)}

    mark("5")
    # phase 5: the train path, counted (auto at B 16, then the flash
    # kernels under attn_impl='flash' at B 16)
    model = _aligner()
    train_agreement(model)
    train_launches, _ = train_path(model, card)
    launches.update({k: train_launches[k] for k in ("milnce_grid_fwd", "milnce_grid_bwd")})
    train_flash_agreement(model)
    flash_train_launches, _ = train_path(model, card, attn_impl="flash")

    mark("5b")
    # phase 5b: the train step replayed as a CUDA graph, counted by replay
    graph_launches = graph_path(model, card)

    mark("6")
    # phase 6: global mode over long videos, counted
    global_launches, _ = global_path(card)
    flash_launches = {
        "flash_fwd": {"global mode (phase 6)": global_launches["flash_fwd"],
                      "train attn_impl=flash (phase 5)": flash_train_launches["flash_fwd"]},
        "flash_dq": {"train attn_impl=flash (phase 5)": flash_train_launches["flash_dq"]},
        "flash_dkv": {"train attn_impl=flash (phase 5)": flash_train_launches["flash_dkv"]},
    }
    for k in ("flash_fwd", "flash_dq", "flash_dkv"):
        flash_launches[k]["train attn_impl=flash, graph replay (phase 5b)"] = (
            graph_launches["B16 f32 flash"][k])
    launches.update({k: sum(v.values()) for k, v in flash_launches.items()})

    mark("7")
    # phase 7: keystep grounding served, counted; its 'small' run is this
    # slice's main path
    launches["small_attn"] = grounding_path(card)

    mark("8")
    # phase 8: the training command line, counted (this slice's main path),
    # at --fused_steps 1 and 4
    cli_launches, cli_fused_launches = cli_path(card)
    small_launches = {"grounding attn_impl=small (phase 7)": launches["small_attn"],
                      **small_launches}

    def entry(name, source, replaces, cases):
        head = cases[0]  # main-path shape, float32
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": head["max_abs_err"],
                "max_rel_err": head["max_rel_err"], "ms": head["ms"],
                "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "shape": head["shape"],
                "dtype": head["dtype"], "cases": cases}

    def int8_entry(name, source, replaces, cases):
        e = entry(name, source, replaces, cases)
        e.update(int_mm_ms=cases[0]["int_mm_ms"], exact_kernel_ms=cases[0]["exact_kernel_ms"])
        return e

    def block_entry(name, source, replaces):
        e = entry(name, f"exoground_tpu_torch/csrc/{source}", replaces, block_cases[name])
        e.update(per_module_ms=block_cases[name][0]["per_module_ms"],
                 launches_by_path={"block path (phase 4c)": launches[name]})
        if name in resident_launches:
            e["launches_by_path"]["resident path (phase 4e)"] = resident_launches[name]
        if "exact_kernel_ms" in block_cases[name][0]:
            e["exact_kernel_ms"] = block_cases[name][0]["exact_kernel_ms"]
        return e

    def grid_entry(part, replaces):
        cases = [{k: v for k, v in c.items() if not k.startswith("bwd" if part == "fwd" else
                                                                  "fwd")}
                 for c in grid_cases]
        for c in cases:
            for k in ("ms", "plain_ms", "bound_ms", "bound_by", "ms_b2b", "plain_ms_b2b",
                      "bound_cuda_cores_ms", "bound_3xtf32_ms"):
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
            for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "ms_b2b",
                      "library_ms_b2b", "bound_cuda_cores_ms", "bound_3xtf32_ms"):
                if f"{part}_{k}" in c:
                    c[k] = c.pop(f"{part}_{k}")
            cases.append(c)
        e = entry(f"flash_{part}", "exoground_tpu_torch/csrc/flash_attn.cu", replaces, cases)
        e["launches_by_path"] = flash_launches[f"flash_{part}"]
        return e

    def by_path(e, first_path):
        e["launches_by_path"] = {first_path: launches[e["name"]],
                                 "resident path (phase 4e)": resident_launches[e["name"]]}
        return e

    kernels = [
        by_path(entry("fused_mha", "exoground_tpu_torch/csrc/fused_mha.cu",
                      "exoground_tpu/ops/attention.py:761", mha_cases), "main path (phase 4)"),
        by_path(entry("fused_mlp", "exoground_tpu_torch/csrc/fused_mlp.cu",
                      "exoground_tpu/ops/fused_mlp.py:244", mlp_cases), "main path (phase 4)"),
        by_path(int8_entry("fused_mha_int8", "exoground_tpu_torch/csrc/fused_mha_int8.cu",
                           "exoground_tpu/ops/attention.py:777", mha8_cases),
                "int8 path (phase 4b)"),
        by_path(int8_entry("fused_mlp_int8", "exoground_tpu_torch/csrc/fused_mlp_int8.cu",
                           "exoground_tpu/ops/fused_mlp.py:200", mlp8_cases),
                "int8 path (phase 4b)"),
        grid_entry("fwd", "exoground_tpu/ops/milnce_grid.py:184"),
        grid_entry("bwd", "exoground_tpu/ops/milnce_grid.py:231"),
        flash_entry("fwd", "exoground_tpu/ops/attention.py:279"),
        flash_entry("dq", "exoground_tpu/ops/attention.py:329"),
        flash_entry("dkv", "exoground_tpu/ops/attention.py:347"),
        block_entry("block_attn", "block_attn.cu", "exoground_tpu/ops/attention.py:891"),
        block_entry("block_mlp", "block_mlp.cu", "exoground_tpu/ops/fused_mlp.py:336"),
        block_entry("block_attn_int8", "block_attn_int8.cu", "exoground_tpu/ops/attention.py:927"),
        block_entry("block_mlp_int8", "block_mlp.cu", "exoground_tpu/ops/fused_mlp.py:359"),
        dict(entry("small_attn", "exoground_tpu_torch/csrc/small_attn.cu",
                   "exoground_tpu/ops/attention.py:514", small_cases),
             launches_by_path=small_launches),
    ]
    for e in kernels:
        if e["name"] in ("milnce_grid_fwd", "milnce_grid_bwd"):
            e["launches_by_path"] = {"train path (phase 5)": launches[e["name"]]}
        if e["name"] in ("milnce_grid_fwd", "milnce_grid_bwd"):
            e["launches_by_path"].update({
                f"train step, graph replay {case} (phase 5b)": n[e["name"]]
                for case, n in graph_launches.items()})
        if e["name"] in ("milnce_grid_fwd", "milnce_grid_bwd", "fused_mha", "fused_mlp"):
            e["launches_by_path"]["training command line (phase 8)"] = cli_launches[e["name"]]
            e["launches_by_path"][f"training command line --fused_steps {GRAPH_N} (phase 8)"] = (
                cli_fused_launches[e["name"]])
    mark(None)
    print("phase_s", json.dumps(phase_s), flush=True)
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
