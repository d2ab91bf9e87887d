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
     and the float32 flash forward and its dq + dk/dv pair against SDPA's
     forward and backward among them; printed, not
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
     and bfloat16 with those counts per step. Then the optax chain
     (make_optimizer: accumulation over 2, global-norm clip at half the
     grads' norm, so the device-side norm and select act): one float32 B 4
     step's grads on the card and on the CPU, and four chain updates from
     them (the second and fourth emit; the fourth moves the parameters):
     loss within 1e-4 relative, grads and updated parameters within 1e-3 of
     max|CPU|.
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
     graph pool's MB. A fourth case runs B 64 float32 under --backprop_freq
     2 (the optax chain: the 4 mini-batches of a replay accumulate and every
     second updates; the accumulator compared too), and one
     `graph_accum {...}` line sets its step times and pool beside the fused
     optimizer's case. Then the carried-cast A/B (``carry_cast_bench``): a
     replayed bf16 group carries the compute-dtype casts of the parameters
     from step to step (parallel/train_step.py::_CarriedCasts); on the B64
     TAN step and on a grounding step (train_grounding.sh's trunk, batch 16,
     64 frames, 16 narrations), from one state, a runner as built against
     the same runner recasting the masters each step: the same warm-up
     group and one replay each (TAN: 2 + 2 grid launches a step; grounding:
     none, counted), the parameters, EMA twin and moments after it equal bit
     for bit, then replays timed in turns (recast, carried, carried, recast;
     the median ms a step of each).
  3c. flash kernels: forward (o; lse on rows with a valid key, +1e30 exactly
     on the rest), dq and dk/dv against autograd of flash_attention_plain on
     the card for the same random upstream grad, at the global path's shapes
     (B1 H8 S2048 D64; Sq = Sk = 2096 with the last 48 keys padded; S4096;
     S1024 for the crossover), the train path's (B16 H8 S64 and S76), ragged
     tails, a batch row with no valid key and head sizes 16, 32, 40, 96 and
     128, in
     float32 (<= 1e-4 of max|plain|) and bfloat16 (<= 1e-2); at the four
     long shapes and at the train steps' (B16 H8 S64, S76 and S128) each
     kernel's time beside the plain version's, attention_plain's (the 'xla'
     route), F.scaled_dot_product_attention's (a yardstick the port never
     calls) and the bound (float32: both routes), and back to back the
     forward beside SDPA's and the backward pair (dq then dk/dv, every body
     on the tensor cores) beside SDPA's backward (one call gives all three
     grads), judged at the four long shapes by attention_bars;
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
  7b. keystep grounding at --feature_dim 1024 and 2048 (8 heads: head sizes
     128 and 256, the wide-head bodies): the same model at those widths
     (seeded weights: make_grounding_params at C 1024, the model's own
     seeded init at C 2048), float32, GroundingService
     batches of 64 requests counted per forward: C 1024 under 'auto' (24
     fused_mha + 24 fused_mlp), 'small' (30 small_attn + 24 fused_mlp) and
     'fused' (18 block_attn + 18 block_mlp + 6 fused_mha + 6 fused_mlp), then
     its forward under quant.matmul_impl('int8', min_cols=2048) under 'auto'
     (24 fused_mha_int8 + 24 fused_mlp_int8) and 'fused' (their block twins
     and 6 + 6); C 2048 under 'auto' and 'small'; behind the wrappers, as
     the libraries count them (wide_gnd_launches), each MHA-family launch
     one wide_window and two wgmma_linear_tf32 (int8: one), each small_attn
     launch at D 128 and above one wide_window; 4 requests of each run
     against the CPU under the same impl (<= 1e-4 of max|CPU|; int8 at
     phase 7's floor over 3 noise draws); requests/s of each
     (`wide_ground_bench {...}`); then at C 2048 the forwards of
     WIDE_GND_HOPPER, each counted per forward against the f32 'auto' card
     answer of the same batch: f32 'flash' (30 flash_fwd through the cluster
     body + 24 fused_mlp; <= 1e-4) and a bf16 copy under 'auto' (24 fused_mha
     with 48 wgmma_linear and 24 wide_window + 24 fused_mlp) and 'flash'
     (within 2x the bf16
     model's error on its plain versions, at least 1e-3). The wide cases of
     the kernel phases: 3 (fused MHA at Dh 72, 96, 128, 256, each at two of
     S 17, 64, 96, 128 and each S at two heads, one fully-masked window
     each, and the full widths C 1024 / 2048 timed at B64 S128 and S64,
     single calls and back to back beside the library's back-to-back time;
     Dh 520 at S 17 (C 8320, 16 heads: a window of many slabs); the wgmma
     GEMMs alone, `wgmma_linear {...}` (bf16) and `wgmma_linear_tf32 {...}`
     (f32, 3xTF32), at the bodies' products with TFLOP/s and at M, N, K
     tails), 3d and 3e (the same for the int8 MHA and both block bodies;
     each call's wgmma GEMM and window kernel launches, as the library
     counted them, held to the design), 3c (flash at D 136, 192, 256, 520,
     1024 and 1032 with a ragged tail and an empty row, D 60 through
     flash_attention's zero-column padding, D 128 and 256 timed at B64 H8
     S128 and S64) and 3f (the window core at D 60, 136, 192, 256 and 520,
     S 17 and 100, and D 128 / 256 timed at B64 H8 S128 and S64, single
     calls and back to back beside SDPA; each wide call's window kernel
     launch counted).
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
     HTM-Align eval; no other kernel); then one epoch each at --backprop_freq 2
     (--fused_steps 1 and 4: the same launches, the epoch-0 checkpoints
     equal bit for bit, the accumulator and mini step too), then --resume
     from that run's epoch-0 checkpoint written again as a JAX package file
     (write_jax_checkpoint: the flax msgpack map of the JAX trainer, its
     MultiStepsState at full width; the restored parameters, EMA twin,
     moments, accumulator and counts bit for bit the port file's; its
     load_checkpoint seconds and peak host MB), then --resume from the same
     tree written as the JAX package's orbax checkpoint directory (OCDBT,
     zarr v2, zstd: restored bit for bit, the msgpack resume's launches;
     `orbax_resume {...}`: the directory's MB, write / read /
     load_checkpoint seconds, decode MB/s), and one epoch at
     --no-fused_optimizer (the optax chain; its epoch-0 checkpoint within
     1e-5 of max|.| of the first run's); then the card against the CPU with the
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
  8b. a JAX package checkpoint resumed on the card: for each committed
     fixture (exoground_tpu_torch/testdata/: the fused optimizer's state and
     the optax chain's MultiStepsState at --backprop_freq 2, written by the
     JAX TANTrainer of tests/jax_tan_fixtures.py at width 32, each as a
     msgpack file and as an orbax directory of the same state), a TANTrainer
     of the fixture's configuration on the card runs load_checkpoint(mode=
     "resume"), what --resume runs, through the pure-Python msgpack reader
     or the port's orbax reader (OCDBT, zarr v2, the system's libzstd);
     every restored tensor (parameters, EMA twin, moments, accumulator) must
     equal the msgpack fixture's array bit for bit, with the counts; then one step
     on the card against the same resume and step on the CPU (loss within
     1e-4 relative; the parameters, EMA twin, moments and accumulator after
     it within 1e-3 of each tensor's max|CPU|, the parameters moved); one
     `jax_resume {...}` line with the file's read seconds.
  9. grounding training through the command line: ``exoground_tpu_torch.train.main``
     with the repo's scripts' flags (scripts/train_vi.sh, train_grounding.sh,
     train_joint_model.sh, train_joint_model_lemma.sh; E6D6 width 512, 8 heads,
     4096-d EgoVLPv2 video and narration features, seq 64, B16), one epoch each
     over seeded trees under build/ (tools/synth_egoexo.py, takes with an ego
     and 4 exo cameras: 4 training takes of 150 s for the view-invariant and
     grounding scripts (18 steps), 2 of 120 s for the joint script (16),
     whose curriculum makes 11 windows a start, each tree with 1 validation
     and 1 test take; LEMMA 3 videos of 150 s and 1 each to validate and
     test): the view-invariant run,
     the grounding run on its checkpoint (--vi_encoder_path), the grounding
     run again at --feature_dim 1024 under --attn_impl flash (flash at D 128
     in the steps) and --resume from its epoch-0 checkpoint for a second
     epoch under 'auto' (the wide-head fused MHA in validation), the joint run
     eager, at --fused_steps 4 (its epoch-0 checkpoint bit for bit the eager
     run's, one capture, the replays' pos starts not all equal), --amp and
     --attn_impl flash, test_joint_model.sh's --test on the eager checkpoint
     (the IoU by camera rank) and the LEMMA run; each counted (24 fused MHA +
     24 fused MLP a validation forward, none in the train steps, flash
     forward, dq and dk/dv in the flash run's steps, nothing else); then the
     card against the CPU on the joint model from the same seed: the eval step
     on the first validation batch (24 + 24 launches; scalars 1e-4 relative or
     1e-6 absolute, the IoU>=θ fractions within one narration, the IoU map
     1e-4 of max|CPU|), the eval forward's interval predictions and
     high-dim features there (1e-4 of max|CPU|; an untrained model's IoU
     map is mostly 0, so the predictions carry the check)
     and one train step (metrics as the scalars); one `gnd_bench {...}` line a
     training run (samples/s over the epoch and its second half before the
     last 4 steps, which are profiled for the device's busy ms a step and idle
     share; validation ms), `gnd_agreement {...}` and `gnd_phase {...}`.
     The grounding run's epoch-0 file (the port's own torch.save checkpoint)
     is served on the card through GroundingService.from_checkpoint into a
     fresh model of the run's configuration (16 requests, one bucket: 24 + 24
     launches), its intervals within 1e-4 of max|.| of the in-memory model's
     ground_batch (`gnd_served_checkpoint {...}`); then the same weights
     written as the JAX package's orbax checkpoint directory (its param tree
     by jax_grounding_tree, through the port's save_state_orbax) and served
     the same way (`gnd_served_orbax {...}`: equal to the port file's service
     bit for bit, the same launches). The trees are removed after.
  10. the inference front at phase 8's model (TemporalAligner E6D6 width 512,
     8 heads, 512-d video and text; seeded) with the word2vec tower at the
     MIL-NCE widths (66,249 words x 300 -> 2,048 -> 512) and its tokenizer
     (32 words) on the card: AlignmentService(tokenizer=, text_tower=) over 4
     raw-text requests (64 sentences of a ~300 s video, with and without
     timestamps) and one align_batch_requests call of 'texts' entries, card
     vs the same service on the CPU (score within 1e-4 of max|CPU|,
     best_second equal where the CPU's top-2 margin clears it), raw texts
     equal to the same request as the tower's embeddings, then 128 of them
     timed (`front_raw_bench {...}`: mean, p50, p90 ms); serve_http on
     127.0.0.1 with phase 7's grounding model under 'auto': /align,
     /align_batch, /ground and /ground_batch over one keep-alive connection,
     each equal to the direct call on the card; 400 serial /align requests
     (`front_http_bench {...}`: requests/s, p50/p99 ms, the npz decode's
     share), then 8 concurrent clients, one burst against the serial answers
     and 40 requests each on its keep-alive connection (requests/s, p50/p99
     ms over the 320, every answer held to its serial one); YouCook2
     retrieval (tools/synth_yc2.py: 128 videos of 200-600 s, 512-d, 6-10
     segments of 5-90 s and a few of 257-300 s; half-val, 10 clips an item,
     adaptive windows, seq_len 64) with raw sentences through the tower
     (`front_yc2_bench {...}`: the twelve metrics, items/s), 16 items card vs
     CPU (video and text features within 1e-4 of max|CPU|, metrics equal).
     Each run counted: 12 + 12 fused MHA / MLP a group (the joint tower's
     MHA while S <= 128), 24 + 24 a grounding forward, 6 fused MLP a YouCook2
     item and 6 fused MHA where its windows are <= 128 tokens. The tree is
     removed after.
  11. data parallelism on the card: the grid kernel against grid_lse2_plain
     at the shapes gathered negatives give it (R 4096 = B64 x T64, C 512, 6
     stages, St 6 joint and St 1 dual, Cc = W x 64 x 32 = 4,096 and 8,192
     text columns for W 2 and 4 ranks, half of them padding), float32 (<=
     1e-4 of max|plain|) and bfloat16 (<= 1e-2), forward and backward, the
     W 4 shapes timed beside the bound; tan_loss at each rank r's column
     offset r x 64 with the gathered padding mask, kernel against plain, on
     the loss and the grads of the features (`dp_loss {...}` lines); phase
     8's command line with --gather_negatives (one epoch, no HTM-Align) in
     a world-1 NCCL group (python -m torch.distributed.run --standalone
     --nproc_per_node 1), eager and at --fused_steps 4 with --multihost,
     each against the same run without a group bit for bit (losses,
     parameters, EMA twin, moments), its collectives counted a step and a
     replay and its kernels counted; AlignmentService(eval_devices=2)
     clamped to the one card, scoring bit for bit as at 1 (`dp_bench
     {...}`: the replayed step's ms in and out of the group beside phase
     5b's). The tree is removed after.
  12. the end-to-end S3D finetune (scripts/train_e2e.sh): ``exoground_tpu_torch.
     train.main --dataset htm-aa --model s3d --freezeBN --batch_size 16
     --num_frames 16 --fps 5 --lr_backbone 1e-5`` over a seeded tree under
     build/ (tools/synth_htm_aa.py: 20 videos, 48 aligned rows kept by the vlen
     filter, a full MIL-NCE-layout s3d_howto100m.pth with its BN stats, fc
     1024 -> 512 and the text module 66,249 x 300 -> 2,048 -> 512; mp4s only
     where ffmpeg exists, else the reader's grey clips, counted), one epoch of 3
     steps from the converted trunk, then --resume for a second (parameters,
     stats, moments and count restored bit for bit, checked as load_checkpoint
     returns); then the card against the CPU in the same dtype on patterned
     clips (S3D_LIMITS): the forward on 2 clips of 16 x 224², embedding and
     pooled trunk, frozen stats and train_bn (the new stats too), float32 (TF32
     off) within 1e-4 of max|CPU|, bfloat16 within 2e-2, train_bn in float64
     within 1e-9, and one make_s3d_nce_step's loss, grads and stats at B 4,
     freeze_early, float32 under --freezeBN and train_bn (loss 1e-4 relative,
     grads and stats 1e-4 of max|CPU|, the early blocks' grads exactly 0) and
     float64 under train_bn (stats 1e-9, loss and grads 1e-7: they leave the
     step as float32); where train-mode BN over 2-4 clips amplifies rounding
     (float32's and bfloat16's pooled trunk, float32's step grads) fixed
     limits from the card's readings; controls: cuDNN's TF32 leaves the float32
     limit, PyTorch's own BatchNorm (unbiased running variance) the stats
     limits; the steps, the command line and the timed trainer run under
     PyTorch's default cuDNN flags (TF32 allowed), the step keeping its
     float32 in float32;
     S3DTrainer at B 16 on uint8 clips under --freezeBN in float32 and --amp:
     the median of 10 steps after 3, clips/s, busy ms a step and idle share of
     5 profiled steps, the no-grad forward's clips/s, the peak memory; a
     4-step replayed group (make_s3d_nce_step(scan_steps=4), train_bn, B 4,
     cuDNN deterministic and deterministic algorithms) bit for bit with 4
     eager steps; the nine kernels' counters 0 in every run (``s3d command
     line``, ``s3d agreement``, ``s3d timing``, ``s3d scan_steps`` and one
     short ``s3d_bench {...}`` line). The tree is removed after.
  13. sequence parallelism (parallel/sequence.py): sequence_parallel_sim over
     the three global-mode videos (evals/bench_items.py::GLOBAL_VLENS, 2,048,
     2,400 and 3,000 frames with their 170-250 sentences) at phase 6's model
     (E6D6 width 512, 4096-d, seeded through the JAX->port bridge), dual and
     joint towers, interpolate_from 64, in a world-1 NCCL group of this
     process (at world 1 the rotation is the identity: nothing is sent),
     counted a video (12 fused MLP launches, 6 dual + 6 joint; 2 gathers;
     nothing else), against text_visual_sim's last stage under
     attn_impl='xla' (<= 1e-4 absolute on both similarities, f32, TF32 off)
     and beside 'auto' (flash: the gap printed, not failed on); the first
     video again on the CPU without a group (<= 1e-4); ms a video of the ring
     and both model paths, median of 3 in turns; apart from the ring, the
     rotation's NCCL send/recv of one layer's K/V/mask block from the rank to
     itself, the block received equal to the block sent, its ms printed
     beside (`seq_bench {...}`).
  14. the feature-extraction tool (tools/extract_features.py) over 300 seeded
     frames of 224² (the card's machine has no ffmpeg) at fps 1 (two buckets
     of 256, the last ragged) and fps 8, with an image encoder built here
     from port modules (a 32-pixel patch projection, two
     ResidualAttentionBlocks at width 768 / 12 heads on 50 tokens, LN, a
     projection to 512) cast as the tool casts it (bf16, norms in float32),
     counted (2 fused MHA + 2 fused MLP launches a bucket, bf16), fps 1 on
     the card against the CPU (<= 1e-2 of max|CPU|), frames/s of a call and
     of a call handed the cast module (median of 3, `extract_bench {...}`).

Float32 products of the plain versions and library calls run in full
float32 (TF32 off for matmul and cuDNN); the f32 bodies of the fused MLP
family, the MHA family (but the int8 qkv product's), the flash forward and
the grid kernel run 3xTF32 on the tensor cores, which keeps float32
accuracy (csrc/tc.cuh says why). The script's seconds, then the kernels
JSON, precede the last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import io
import itertools
import json
import statistics
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H100_PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense, SXM
H100_BYTES_PER_S = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def card_normal(rng, shape, scale=1.0, dtype=torch.float32):
    """Standard normal draws of ``shape`` times ``scale`` in ``dtype``, made
    on the card by a generator seeded from ``rng``: the kernel cases' inputs
    reach 17 M values at full width, which numpy drew at ~1 s a case of host
    time."""
    g = torch.Generator(device="cuda").manual_seed(int(rng.randint(2 ** 31)))
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


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
def check_wgmma_launches(name, n0, C, H, dtype, int8):
    """After one call of an MHA-family wrapper: the wide bodies' launches
    that its library reported (counted in C where it launches them, read by
    the wrapper after the call; ``n0`` the counts before it) are the bodies'
    design: above a head of 64 the wgmma GEMM of the call's type
    (wgmma_linear in bf16, wgmma_linear_tf32 in f32) twice in the exact
    bodies (qkv and out-projection) and once in the int8 ones (the
    out-projection), the other type's none, and the window kernel once;
    none of them at a head of 64."""
    from exoground_tpu_torch.ops import _kernels

    wide = C // H > 64
    gemm, other = (("wgmma_linear", "wgmma_linear_tf32") if dtype == torch.bfloat16
                   else ("wgmma_linear_tf32", "wgmma_linear"))
    want = {gemm: (1 if int8 else 2) if wide else 0, other: 0, "wide_window": int(wide)}
    got = {k: _kernels.LAUNCHES[k] - n0[k] for k in want}
    if got != want:
        fail(f"{name} at C{C} H{H} {dtype}: the library launched the wide bodies {got}, "
             f"the design {want}")


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
        return card_normal(rng, shape, scale, dtype)

    x = t(B, S, C)
    w_in, b_in = t(3 * C, C, scale=C ** -0.5), t(3 * C, scale=0.02)
    w_out, b_out = t(C, C, scale=C ** -0.5), t(C, scale=0.02)
    lens = rng.randint(1, S + 1, B)
    lens[0] = 0  # one fully-masked window (a padded group window)
    lens[1] = S
    kpad = torch.tensor(np.arange(S)[None, :] >= lens[:, None], device=dev)
    with torch.inference_mode():
        n0, wg0 = _kernels.LAUNCHES["fused_mha"], dict(_kernels.LAUNCHES)
        out = fused_mha(x, kpad, w_in, b_in, w_out, b_out, H)
        torch.cuda.synchronize()
        if _kernels.LAUNCHES["fused_mha"] != n0 + 1:
            fail("fused_mha did not count its launch")
        check_wgmma_launches("fused_mha", wg0, C, H, dtype, False)
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


def wgmma_linear_case(M, N, K, seed, res=False, timed=False, dtype=torch.bfloat16):
    """The wide-head bodies' wgmma GEMM of ``dtype`` alone
    (ops.attention.wide_linear: y = a . w^T + bias (+ res); bf16, or f32 in
    3xTF32, counted as wgmma_linear_tf32) against wide_linear_plain on the
    card, its launch counted; with ``timed``, single calls and back to back
    beside the plain version, F.linear on the same operands (a yardstick the
    port never calls; f32 with TF32 off) and the bound (2*M*N*K FLOPs at the
    bf16 rate, in f32 the lesser of the CUDA cores and 3xTF32, or the bytes
    of a, w, bias, res and y)."""
    import torch.nn.functional as F

    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.attention import wide_linear, wide_linear_plain

    name = "wgmma_linear" if dtype == torch.bfloat16 else "wgmma_linear_tf32"
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return card_normal(rng, shape, scale, dtype)

    a, w, b = t(M, K), t(N, K, scale=K ** -0.5), t(N, scale=0.02)
    r = t(M, N) if res else None
    with torch.inference_mode():
        n0 = _kernels.LAUNCHES[name]
        y = wide_linear(a, w, b, r)
        torch.cuda.synchronize()
        if _kernels.LAUNCHES[name] != n0 + 1:
            fail(f"{name} did not count its launch")
        ref = wide_linear_plain(a, w, b, r)
        if not torch.isfinite(y.float()).all():
            fail(f"{name} non-finite output at M{M} N{N} K{K}")
        err = (y.float() - ref.float()).abs().max().item()
        case = dict(shape=f"M{M} N{N} K{K}" + (" + res" if res else ""),
                    dtype=str(dtype).split(".")[-1], max_abs_err=err,
                    max_rel_err=err / ref.float().abs().max().item())
        if timed:
            flops = 2.0 * M * N * K
            nbytes = a.element_size() * (M * K + N * K + N + M * N * (2 if res else 1))
            lib = (lambda: F.linear(a, w, b) + r) if res else (lambda: F.linear(a, w, b))
            case.update(ms=time_ms(lambda: wide_linear(a, w, b, r)),
                        plain_ms=time_ms(lambda: wide_linear_plain(a, w, b, r)),
                        library_ms=time_ms(lib),
                        ms_b2b=b2b_ms(lambda: wide_linear(a, w, b, r)),
                        library_ms_b2b=b2b_ms(lib), **routes_bound(0.0, flops, nbytes, dtype))
            case["tflops_b2b"] = flops / case["ms_b2b"] / 1e9
            case["library_tflops_b2b"] = flops / case["library_ms_b2b"] / 1e9
        else:
            case.update(ms=None, plain_ms=None, library_ms=None, bound_ms=None, bound_by=None)
    print(name, json.dumps(case), flush=True)
    if not case["max_rel_err"] <= TOL[dtype]:
        fail(f"{name} disagrees with wide_linear_plain: {case}")
    return case


def wgmma_linear_cases(dtype):
    """The GEMM of ``dtype`` at the wide bodies' products, timed: the qkv (N
    = 3C) and the out-projection (N = C, the block bodies' residual) at C
    2048 and 1024, B64 S128 (M 8192); then M, N and K tails (WIDE_MHA_GRID's
    C 1152 and 768 at S 17 and 64, B3; K 72 and 264, N 24 and 2056: none a
    multiple of the tile)."""
    out = [wgmma_linear_case(8192, 6144, 2048, 300, timed=True, dtype=dtype),
           wgmma_linear_case(8192, 2048, 2048, 301, res=True, timed=True, dtype=dtype),
           wgmma_linear_case(8192, 3072, 1024, 302, timed=True, dtype=dtype),
           wgmma_linear_case(8192, 1024, 1024, 303, res=True, timed=True, dtype=dtype)]
    for i, (m, n, k, res) in enumerate(((51, 3456, 1152, False), (51, 1152, 1152, True),
                                        (192, 2304, 768, False), (192, 768, 768, True),
                                        (17, 24, 72, True), (130, 2056, 264, False))):
        out.append(wgmma_linear_case(m, n, k, 310 + i, res=res, dtype=dtype))
    return out


def mlp_case(rows, C, dtype, seed):
    """The fused MLP kernel against mlp_plain on the card, timed, with its
    launch plan (row tile, slab, hidden split, CTAs). The f32 bound is the
    lesser of two routes, the CUDA cores (FLOPs / 67 TFLOP/s) and the
    kernel's 3xTF32 on the tensor cores (3 x FLOPs / 495 TFLOP/s)."""
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.fused_mlp import fused_mlp, mlp_launch_plan, mlp_plain

    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return card_normal(rng, shape, scale, dtype)

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
    x = card_normal(rng, x_shape, dtype=dtype)
    rows = x.view(-1, x_shape[-1])
    if len(rows) > 1:
        rows[1].zero_()
    return x


def _mha_library(x, kpad, w_in, b_in, w_out, b_out, H, ln=None):
    """F.multi_head_attention_forward on (B, S, C) x (after F.layer_norm and
    with the residual added, given ``ln``): the exact MHA (block) in one
    PyTorch call, a yardstick the port never calls."""
    import torch.nn.functional as F

    a = x if ln is None else F.layer_norm(x, (x.shape[-1],), *ln, 1e-5)
    o = F.multi_head_attention_forward(
        a.transpose(0, 1), a.transpose(0, 1), a.transpose(0, 1), x.shape[-1], H, w_in, b_in,
        None, None, False, 0.0, w_out, b_out, training=False, key_padding_mask=kpad,
        need_weights=False)[0].transpose(0, 1)
    return o if ln is None else x + o


def mha_int8_case(B, S, C, H, dtype, seed, timed=False, b2b=True, library_b2b=False):
    """fused_mha_int8 against mha_int8_plain on the card: one fully-masked
    window (a padded group window), ragged lengths and a zero row; with
    ``timed``, beside the plain version, torch._int_mm of the int8 qkv
    product alone (a yardstick), the exact fused_mha in the same dtype and
    the bound, and with ``b2b`` the kernel and the exact one back to back
    (``library_b2b``: the exact F.multi_head_attention_forward too, the
    int8 MHA's nearest library call)."""
    from exoground_tpu_torch.ops import _kernels, quant
    from exoground_tpu_torch.ops.attention import fused_mha, fused_mha_int8, mha_int8_plain

    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return card_normal(rng, shape, scale, dtype)

    x = _int8_inputs(rng, dtype, (B, S, C))
    w_in, b_in = t(3 * C, C, scale=C ** -0.5), t(3 * C, scale=0.02)
    w_out, b_out = t(C, C, scale=C ** -0.5), t(C, scale=0.02)
    lens = rng.randint(1, S + 1, B)
    lens[0] = 0
    lens[-1] = S
    kpad = torch.tensor(np.arange(S)[None, :] >= lens[:, None], device="cuda")
    args = (x, kpad, w_in, b_in, w_out, b_out, H)
    with torch.inference_mode():
        n0, wg0 = _kernels.LAUNCHES["fused_mha_int8"], dict(_kernels.LAUNCHES)
        out = fused_mha_int8(*args)
        torch.cuda.synchronize()
        if _kernels.LAUNCHES["fused_mha_int8"] != n0 + 1:
            fail("fused_mha_int8 did not count its launch")
        check_wgmma_launches("fused_mha_int8", wg0, C, H, dtype, True)
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
                        exact_kernel_ms=time_ms(lambda: fused_mha(*args)))
            if b2b:
                case.update(ms_b2b=b2b_ms(lambda: fused_mha_int8(*args)),
                            exact_kernel_ms_b2b=b2b_ms(lambda: fused_mha(*args)))
            if b2b and library_b2b:
                case["exact_library_ms_b2b"] = b2b_ms(lambda: _mha_library(*args))
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
        return card_normal(rng, shape, scale, dtype)

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


def block_attn_case(B, S, C, H, dtype, seed, int8=False, timed=False, b2b=True,
                    library_b2b=False):
    """fused_block_attn (exact or int8 body) against block_attn_plain /
    block_attn_int8_plain on the card: one fully-masked window, ragged
    lengths, a zero row; the output and x_norm apart. With ``timed``, beside
    the plain version, the per-module kernels of the same run
    (F.layer_norm + fused_mha or fused_mha_int8 + the add; no single
    PyTorch call computes the block), for the int8 body the exact fused_mha
    on the same x, and the bound; with ``b2b`` the block and the per-module
    kernels back to back too (``library_b2b``: F.layer_norm +
    F.multi_head_attention_forward + the add, the exact block in library
    calls)."""
    import torch.nn.functional as F

    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.attention import (
        block_attn_int8_plain, block_attn_plain, fused_block_attn, fused_mha, fused_mha_int8)

    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return card_normal(rng, shape, scale, dtype)

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
        n0, wg0 = _kernels.LAUNCHES[name], dict(_kernels.LAUNCHES)
        out, xn = fused_block_attn(*args, int8_qkv=int8)
        torch.cuda.synchronize()
        if _kernels.LAUNCHES[name] != n0 + 1:
            fail(f"{name} did not count its launch")
        check_wgmma_launches(name, wg0, C, H, dtype, int8)
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
                        plain_ms=time_ms(lambda: plain(*args)), per_module_ms=time_ms(per_module))
            if b2b:
                case.update(ms_b2b=b2b_ms(lambda: fused_block_attn(*args, int8_qkv=int8)),
                            per_module_ms_b2b=b2b_ms(per_module))
            if b2b and library_b2b:
                case["exact_library_ms_b2b"] = b2b_ms(lambda: _mha_library(
                    x, kpad, w_in, b_in, w_out, b_out, H, ln=(ln_w, ln_b)))
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
        return card_normal(rng, shape, scale, dtype)

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
        if c["dtype"] == "float32" and c["bar"]:
            line(f"flash_fwd float32 {c['shape']} <= SDPA",
                 *versus(c, "fwd_library_ms", 1.0, own="fwd_ms"))
    for c in timed(flash_cases, "pair_ms_b2b"):
        if c["dtype"] == "float32" and c["bar"]:
            line(f"flash f32 dq + dk/dv {c['shape']} <= SDPA backward",
                 *versus(c, "pair_library_ms", 1.0, own="pair_ms"))
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
def small_case(B, H, S, D, dtype, seed, timed=False, packed=False, b2b=False):
    """The window-attention kernel (through ``small_attention``) against
    small_attention_plain on the card: one fully-masked window and ragged
    lengths; above the fixed tiles (D > MAX_SMALL_TILE_D) the wide window
    kernel, whose launch the library counts (``wide_window``). ``packed``:
    q, k and v are the strided views mha_plain's head split makes of a
    packed (B, S, 3C) qkv, strides (S*3C, D, 3C, 1), as the aligner and
    grounding hand them over; else contiguous (B, H, S, D) tensors. With
    ``timed``, beside the plain version, F.scaled_dot_product_attention with
    the boolean mask on the same tensors (a yardstick the path never calls)
    and the bound max(4 BH S^2 D FLOPs by routes_bound (float32: the lesser
    of the CUDA cores and 3xTF32, both given), 4 BH S D bytes / 3.35 TB/s);
    with ``b2b`` the kernel and SDPA back to back too."""
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.attention import (
        MAX_SMALL_TILE_D, _split_heads, small_attention, small_attention_plain)

    rng = np.random.RandomState(seed)
    if packed:
        qkv = card_normal(rng, (B, S, 3 * H * D), dtype=dtype)
        q, k, v = (_split_heads(t, H) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (card_normal(rng, (B, H, S, D), dtype=dtype) for _ in range(3))
    lens = rng.randint(1, S + 1, B)
    lens[0] = 0  # a fully-masked window
    lens[-1] = S
    mask = torch.tensor(np.arange(S)[None, :] >= lens[:, None], device="cuda")
    kpad = mask.to(torch.int32)
    qs = q * (1.0 / D ** 0.5)
    with torch.inference_mode():
        n0, w0 = _kernels.LAUNCHES["small_attn"], _kernels.LAUNCHES["wide_window"]
        out = small_attention(q, k, v, mask)
        torch.cuda.synchronize()
        if _kernels.LAUNCHES["small_attn"] != n0 + 1:
            fail("small_attn did not count its launch")
        wide = int(-(-D // 8) * 8 > MAX_SMALL_TILE_D)
        if _kernels.LAUNCHES["wide_window"] - w0 != wide:
            fail(f"small_attn at D{D}: {_kernels.LAUNCHES['wide_window'] - w0} wide window "
                 f"launches, the design {wide}")
        ref = small_attention_plain(qs, k, v, kpad)
        if not torch.isfinite(out.float()).all():
            fail(f"small_attn non-finite output at B{B} H{H} S{S} D{D} {dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        case = dict(shape=f"B{B} H{H} S{S} D{D}" + (" packed qkv" if packed else ""),
                    dtype=str(dtype).split(".")[-1], max_abs_err=err,
                    max_rel_err=err / ref.float().abs().max().item(),
                    masked_window_err=(out[0].float() - ref[0].float()).abs().max().item(),
                    wide_window=bool(wide))
        if timed:
            attend = ~mask[:, None, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            case.update(ms=time_ms(lambda: small_attention(q, k, v, mask)),
                        plain_ms=time_ms(lambda: small_attention_plain(qs, k, v, kpad)),
                        library_ms=time_ms(lambda: sdpa(q, k, v, attn_mask=attend)),
                        **routes_bound(0, 4.0 * B * H * S * S * D,
                                       4.0 * B * H * S * D * q.element_size(), dtype))
            if b2b:
                case.update(ms_b2b=b2b_ms(lambda: small_attention(q, k, v, mask)),
                            library_ms_b2b=b2b_ms(lambda: sdpa(q, k, v, attn_mask=attend)))
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
    # the work of this run's data: a padded column needs no product (its
    # t_den is a fill, its dt zero), so the products and the inputs count
    # the valid columns alone; the outputs (t_den, dt) are written whole
    item, cv = v.element_size(), Cc - n_invalid
    work = 2.0 * S * R * cv * C
    fwd_bytes = (S * R + St * cv) * C * item + 4 * (S * R + S * Cc + Cc)
    bwd_bytes = (2 * S * R + St * cv + St * Cc) * C * item + 4 * (2 * S * R + 2 * S * cv + Cc)
    fb = routes_bound(0.0, work, fwd_bytes, dtype)
    bb = routes_bound(0.0, 3 * work, bwd_bytes, dtype)
    case.update({f"fwd_{k}": x for k, x in fb.items()}, **{f"bwd_{k}": x for k, x in bb.items()})
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

        case.update(fwd_ms=time_ms(fwd), fwd_ms_b2b=b2b_ms(fwd), fwd_plain_ms=time_ms(plain_fwd),
                    fwd_plain_ms_b2b=b2b_ms(plain_fwd),
                    bwd_ms=time_ms(bwd), bwd_ms_b2b=b2b_ms(bwd), bwd_plain_ms=time_ms(plain_bwd),
                    bwd_plain_ms_b2b=b2b_ms(plain_bwd), library_ms=None)
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
def flash_case(B, H, Sq, Sk, D, dtype, seed, pad_tail=0, empty_row=False, timed=False,
               bar=False):
    """The flash kernels (forward, dq, dk/dv) against autograd of
    flash_attention_plain on the same inputs; with ``timed``, each beside the
    plain version, attention_plain (the 'xla' route), the library call and
    the bound, and the forward and the backward pair (dq then dk/dv) back to
    back beside SDPA's forward and backward; ``bar``: attention_bars judges
    this case."""
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.attention import (
        attention_plain, flash_attention_plain, flash_dkv, flash_dq, flash_forward)

    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return card_normal(rng, shape, scale, dtype)

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
                head_size=D, pad_tail=pad_tail, empty_row=empty_row,
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

        def bwd():
            flash_dq(q, k, v, kpad, do, lse, delta)
            flash_dkv(q, k, v, kpad, do, lse, delta)

        bwd_ms, bwd_b2b = time_ms(bwd), b2b_ms(bwd)
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

        def lib_bwd():
            torch.autograd.grad(lo, [q4g, k4g, v4g], do4, retain_graph=True)

        lib_bwd_ms, lib_bwd_b2b = time_ms(lib_bwd), b2b_ms(lib_bwd)
        del po, xo, lo
        case.update(
            fwd_ms=fwd_ms, fwd_plain_ms=plain_fwd, fwd_library_ms=lib_fwd,
            fwd_ms_b2b=fwd_b2b, fwd_library_ms_b2b=lib_fwd_b2b, fwd_attention_plain_ms=xla_fwd,
            dq_ms=dq_ms, dq_plain_ms=plain_dq, dq_library_ms=lib_dq, dkv_ms=dkv_ms,
            dkv_plain_ms=plain_dkv, dkv_library_ms=lib_dkv, bwd_attention_plain_ms=xla_bwd,
            pair_ms=bwd_ms, pair_ms_b2b=bwd_b2b, pair_library_ms=lib_bwd_ms,
            pair_library_ms_b2b=lib_bwd_b2b,
            pair_bound_ms=bounds["dq_bound_ms"] + bounds["dkv_bound_ms"], bar=bar,
            **bounds)
        torch.cuda.empty_cache()
    print("flash", json.dumps(case), flush=True)
    if not rel <= TOL[dtype] or not empty_exact or not lse_err <= 1e-3:
        fail(f"the flash kernels disagree with flash_attention_plain: {case}")
    return case


def flash_kernel_cases():
    """Phase 3c's cases, float32 then bfloat16: the global path's long shapes
    (timed, judged by attention_bars), the train steps' (timed), ragged tails,
    an empty batch row and head sizes 16, 32, 40, 96 and 128."""
    flash_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        flash_cases.append(flash_case(1, 8, 2048, 2048, 64, dtype, seed=30, timed=True,
                                      bar=True))
        flash_cases.append(flash_case(1, 8, 2096, 2096, 64, dtype, seed=31, pad_tail=48,
                                      timed=True, bar=True))
        flash_cases.append(flash_case(1, 8, 4096, 4096, 64, dtype, seed=32, timed=True,
                                      bar=True))
        flash_cases.append(flash_case(1, 8, 1024, 1024, 64, dtype, seed=33, timed=True,
                                      bar=True))
        # the train steps' shapes: TAN dual and joint (T64, N12), grounding's
        # joint self-attention (S128; its 64 x 64 cross-attention is B16 S64)
        flash_cases.append(flash_case(16, 8, 64, 64, 64, dtype, seed=34, timed=True))
        flash_cases.append(flash_case(16, 8, 76, 76, 64, dtype, seed=35, timed=True))
        flash_cases.append(flash_case(16, 8, 128, 128, 64, dtype, seed=43, timed=True))
        flash_cases.append(flash_case(1, 8, 96, 200, 64, dtype, seed=36, pad_tail=60))
        flash_cases.append(flash_case(2, 2, 130, 257, 32, dtype, seed=37, empty_row=True))
        flash_cases.append(flash_case(2, 4, 300, 300, 128, dtype, seed=38, pad_tail=20))
        flash_cases.append(flash_case(2, 3, 50, 70, 40, dtype, seed=39, empty_row=True))
        flash_cases.append(flash_case(2, 2, 70, 90, 16, dtype, seed=41, pad_tail=9))
        flash_cases.append(flash_case(1, 2, 100, 130, 96, dtype, seed=42, empty_row=True))
        # D 96 again with a batch row that has valid keys (above, the one row is empty)
        flash_cases.append(flash_case(2, 2, 100, 130, 96, dtype, seed=44, pad_tail=10,
                                      empty_row=True))
    return flash_cases


# ------------------------------------------- wide heads (phases 3, 3c-3f)
# The head sizes past the fixed head tiles, served by the wide-head bodies
# (csrc/wide_window.cuh): the MHA family's (C, H) at Dh 72, 96 and 128, each
# at two of the windows S 17, 64, 96 and 128 (B 3, one fully-masked window
# each), Dh 256 at the full width only;
# the flash and window cores at D 60 (not a multiple of 8: the wrappers pad),
# 136, 192 and 256 with ragged tails and an empty row; and the grounding
# model's full widths, C 1024 (Dh 128) and C 2048 (Dh 256) at 8 heads, timed
# at B64 S128 (its joint windows) and B64 S64.
# (C, H, S); C 2048 at S 64 and 128 runs in the full-width cases alone (B64),
# not at B3 too, to keep the script well within its time limit
WIDE_MHA_GRID = ((1152, 16, 17), (1152, 16, 128), (768, 8, 64), (768, 8, 96), (1024, 8, 17),
                 (1024, 8, 96), (8320, 16, 17))  # the last: head size 520, a window of many slabs
WIDE_CORE_D = (60, 136, 192, 256)
WIDE_FULL_C = (1024, 2048)
WIDE_FULL_BS = ((64, 128), (64, 64))


def wide_mha_family_cases(label, case, seed, **timed):
    """``case(B, S, C, H, dtype, seed, **kw)`` (mha_case, mha_int8_case or a
    block_attn_case partial) over the wide-head grid, then at the full widths
    with ``timed`` (single calls and back to back, beside the library call's
    back-to-back time: a single call moved by +-20% between hosts), float32
    then bfloat16. Prints the seconds it took."""
    t0, out = time.perf_counter(), []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (c, h, s) in enumerate(WIDE_MHA_GRID):
            out.append(case(3, s, c, h, dtype, seed + i))
        for i, c in enumerate(WIDE_FULL_C):
            for j, (b, s) in enumerate(WIDE_FULL_BS):
                out.append(case(b, s, c, 8, dtype, seed + 16 + 2 * i + j, **timed))
    print(f"wide cases of {label}: {len(out)} in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def flash_padded_case(B, H, Sq, Sk, D, dtype, seed, pad_tail=0, empty_row=False):
    """``flash_attention`` (the public entry, under autograd) at a head size
    that is not a multiple of 8: the wrapper pads q, k and v with zero
    columns to the next multiple and slices o; o and the three gradients
    against autograd of flash_attention_plain on the unpadded inputs, one
    launch of each kernel counted."""
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    rng = np.random.RandomState(seed)

    def t(*shape):
        return card_normal(rng, shape, dtype=dtype)

    q, k, v, do = t(B, H, Sq, D), t(B, H, Sk, D), t(B, H, Sk, D), t(B, H, Sq, D)
    kp = np.zeros((B, Sk), bool)
    if pad_tail:
        kp[:, Sk - pad_tail:] = True
    if empty_row:
        kp[0] = True
    mask = torch.tensor(kp, device="cuda")
    n0 = dict(_kernels.LAUNCHES)
    got = [x.clone().requires_grad_() for x in (q, k, v)]
    o = flash_attention(*got, mask)
    o.backward(do)
    torch.cuda.synchronize()
    if any(_kernels.LAUNCHES[n] != n0[n] + 1 for n in ("flash_fwd", "flash_dq", "flash_dkv")):
        fail("flash_attention at a padded head size did not count its three launches")
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    po, _ = flash_attention_plain(ref[0].reshape(B * H, Sq, D) * D ** -0.5,
                                  ref[1].reshape(B * H, Sk, D), ref[2].reshape(B * H, Sk, D),
                                  mask.to(torch.int32))
    po.reshape(B, H, Sq, D).backward(do)
    errs = {}
    for name, g, w in (("o", o, po.reshape(B, H, Sq, D)), ("dq", got[0].grad, ref[0].grad),
                       ("dk", got[1].grad, ref[1].grad), ("dv", got[2].grad, ref[2].grad)):
        if not torch.isfinite(g.float()).all():
            fail(f"flash_attention: non-finite {name} at {(B, H, Sq, Sk, D)} {dtype}")
        err = (g.float() - w.float()).abs().max().item()
        errs[name] = (err, err / max(w.float().abs().max().item(), 1e-30))
    rel = max(r for _, r in errs.values())
    case = dict(shape=f"B{B} H{H} Sq{Sq} Sk{Sk} D{D} (flash_attention, padded to "
                f"{-(-D // 8) * 8})", dtype=str(dtype).split(".")[-1], pad_tail=pad_tail,
                empty_row=empty_row, max_abs_err=max(e for e, _ in errs.values()),
                max_rel_err=rel, rel_err={n: r for n, (_, r) in errs.items()})
    print("flash", json.dumps(case), flush=True)
    if not rel <= TOL[dtype]:
        fail(f"flash_attention at a padded head size disagrees with its plain version: {case}")
    return case


def wide_flash_cases():
    """Phase 3c's wide heads, float32 then bfloat16: D 136, 192 and 256 (the
    cluster bodies, one slab a CTA) with a ragged tail and an empty batch
    row, D 520 (nine slabs: two a CTA, a cluster of five), D 1024 (a
    cluster of eight) and D 1032 (two pairs of slabs a CTA) with a ragged
    tail and an empty row, D 60 through flash_attention's padding, and the full
    widths' D 128 and 256 timed at B64 H8 S128 and S64."""
    t0, out = time.perf_counter(), []
    for dtype in (torch.float32, torch.bfloat16):
        for i, d in enumerate(WIDE_CORE_D[1:]):
            out.append(flash_case(2, 2, 130, 200, d, dtype, seed=150 + i, pad_tail=30,
                                  empty_row=True))
            out.append(flash_case(1, 3, 77, 64, d, dtype, seed=155 + i, pad_tail=5))
        out.append(flash_case(2, 2, 96, 77, 520, dtype, seed=158, pad_tail=13, empty_row=True))
        # a cluster of 8 (the widest the portable limit admits, the most
        # shared memory), and two pairs a CTA (a cluster of 5)
        for d in (1024, 1032):
            out.append(flash_case(2, 2, 96, 77, d, dtype, seed=d, pad_tail=13, empty_row=True))
        out.append(flash_padded_case(2, 2, 100, 130, 60, dtype, seed=159, pad_tail=10,
                                     empty_row=True))
        for i, d in enumerate((128, 256)):
            for j, (b, s) in enumerate(WIDE_FULL_BS):
                out.append(flash_case(b, 8, s, s, d, dtype, seed=160 + 2 * i + j, timed=True))
    print(f"wide cases of flash: {len(out)} in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def wide_small_cases():
    """Phase 3f's wide heads, float32 then bfloat16: D 60, 136, 192, 256 and
    520 (a window of 17 / 9 score steps) at S 17 and 100 (a fully-masked
    window and ragged lengths; packed-qkv views and contiguous tensors), and
    the full widths' D 128 and 256 timed at B64 H8 S128 and S64 on the
    packed views grounding hands over, single calls and back to back."""
    t0, out = time.perf_counter(), []
    for dtype in (torch.float32, torch.bfloat16):
        for i, d in enumerate(WIDE_CORE_D + (520,)):
            out.append(small_case(3, 2, 17, d, dtype, seed=170 + i, packed=True))
            out.append(small_case(3, 2, 100, d, dtype, seed=175 + i))
        for i, d in enumerate((128, 256)):
            for j, (b, s) in enumerate(WIDE_FULL_BS):
                out.append(small_case(b, 8, s, d, dtype, seed=180 + 2 * i + j, timed=True,
                                      packed=True, b2b=True))
    print(f"wide cases of small_attn: {len(out)} in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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
    rel_tol of max|score|; fails beyond rel_tol. ``cpu_ev`` may also be an
    evaluator on the card, whose answers ``cpu`` then holds ``gpu`` to."""
    from exoground_tpu_torch.evals.align_fused import _placed_plan

    (_, dims, args, _), = list(_placed_plan([item], cfg, cpu_ev.device))
    _, canvas = cpu_ev._process(cfg, dims, args)
    k, vlen = len(item["start"]), len(item["video"])
    top2 = torch.topk(canvas[:k, :vlen], 2, dim=-1).values.float().cpu().numpy()
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


def train_chain_agreement(model):
    """The optax chain on the card against the CPU: one float32 B 4 step's
    loss and grads, then four make_optimizer updates from those grads
    (accumulation over 2, so the second and fourth emit, the fourth at the
    full lr: MultiSteps' warmup is at least one inner step, whose lr is 0;
    global-norm clip at half the grads' norm on the CPU, so the clip acts on
    both devices)."""
    import copy

    from exoground_tpu_torch.evals.bench_items import make_train_batch
    from exoground_tpu_torch.losses.milnce import TANLossConfig
    from exoground_tpu_torch.parallel import make_tan_train_step
    from exoground_tpu_torch.train import make_optimizer

    batch_np = make_train_batch(4, seed=3)
    cfg = TANLossConfig(model="init")
    res, clip = {}, None
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        params = {k: p.detach() for k, p in m.named_parameters()}
        step = make_tan_train_step(m, cfg, make_optimizer(params))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        metrics, grads = step.loss_and_grads(params, params, batch,
                                             torch.Generator().manual_seed(0))
        if clip is None:
            clip = 0.5 * float(torch.linalg.vector_norm(torch.stack(
                [g.float().norm() for g in grads.values() if g is not None])))
        # Adam eps 1e-3: the key bias's exact grad is 0, and eps 1e-8 would
        # turn the two devices' float noise there into lr-sized updates of
        # either sign (tests/test_torch_train.py)
        tx = make_optimizer(params, lr=1e-3, warmup_iterations=0, total_iterations=100,
                            accumulate_steps=2, grad_clip=clip, grad_clip_mode="global")
        tx.eps = 1e-3
        state = tx.init(params)
        before = {k: v.clone() for k, v in params.items()}
        for _ in range(4):
            tx.step(params, state, grads)
        moved = max((params[k] - before[k]).abs().max().item() for k in params)
        res[dev] = (float(metrics["loss"]),
                    {k: g.float().cpu() for k, g in grads.items() if g is not None},
                    {k: v.cpu() for k, v in params.items()}, (state.count, moved > 0))
    (lc, gc, pc, nc), (lg, gg, pg, ng) = res["cpu"], res["cuda"]
    loss_rel = abs(lg - lc) / abs(lc)

    def worst(got, want):
        return max(((got[k] - want[k]).abs().max().item()
                    / max(want[k].abs().max().item(), 1e-30), k) for k in want)

    wg, wp = worst(gg, gc), worst(pg, pc)
    print(f"optax chain card vs CPU (init, B4 f32, accumulate 2, global clip {clip:.4g}): "
          f"loss rel {loss_rel:.2e}, worst grad {wg[1]} at {wg[0]:.2e}, worst updated "
          f"parameter {wp[1]} at {wp[0]:.2e} of its max|CPU|", flush=True)
    if (set(gg) != set(gc) or (nc, ng) != ((4, True), (4, True)) or not loss_rel <= 1e-4
            or not wg[0] <= 1e-3 or not wp[0] <= 1e-3):
        fail("the optax chain's step on the card disagrees with the CPU plain path")


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
# (batch, compute dtype, attn_impl, --backprop_freq) of the replayed train step
GRAPH_CASES = ((64, False, "auto", 1), (64, True, "auto", 1), (16, False, "flash", 1),
               (64, False, "auto", 2))


def _kernel_names(prof, parts=("grid_", "flash_")) -> dict:
    """Device kernels of a profiled run whose name holds one of ``parts``,
    with their counts."""
    from torch.autograd import DeviceType

    return {e.key[:60]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and any(p in e.key for p in parts)}


def graph_case(model, card, raw, amp, attn_impl, backprop_freq=1):
    """From one state, one generator seed and the 2N prepared batches
    ``raw``: 2N eager steps on one trainer and two scan_steps=N calls (an
    eager warm-up group, then a replay of the captured graph) on another;
    the states (and under ``backprop_freq`` > 1 the optax chain's
    accumulator) and the losses compared; the replay counted and profiled;
    eager and replayed steps timed. Returns the replay's launches and the
    ``graph_bench`` line's dict."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.train import ExperimentConfig, TANTrainer

    n = GRAPH_N
    b = raw[0]["video"].shape[0]
    trainers = {}
    for fused in (1, n):
        cfg = ExperimentConfig(amp=amp, attn_impl=attn_impl, fused_steps=fused,
                               backprop_freq=backprop_freq, **BENCH_TRAIN)
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
                            ("nu", graph.opt_state.nu, eager.opt_state.nu),
                            ("acc", getattr(graph.opt_state, "acc_grads", {}),
                             getattr(eager.opt_state, "acc_grads", {}))):
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
                 attn_impl=attn_impl, backprop_freq=backprop_freq,
                 optimizer=type(graph.tx).__name__, n=n, eager_step_ms=round(eager_ms, 3),
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
    return launches, bench


CARRY_AB_ROUNDS = 5  # interleaved rounds of the carried-cast A/B (recast, carried x2, recast)
# the grounding step of the A/B: train_grounding.sh's trunk (E6D6, width
# 512, 4096-d; batch 16, 64-frame windows) without its frozen pre-pass, 16
# narrations a window
CARRY_GND = dict(batch=16, frames=64, narrations=16)


def _carry_ab(label, run, states, groups, want_launches) -> dict:
    """The carried-cast A/B of one replayed bf16 step: ``run[c](group)``
    runs a group of GRAPH_N steps on the runner that carries its casts (c
    True, as the port builds it) or recasts the masters each step (c False:
    the same runner with ``carry_casts`` turned off), both from one state
    and one generator seed; ``states[c]()`` gives its trees by name. The
    warm-up group (eager, then the capture) and one replay each, counted;
    the trees after the replay must be equal bit for bit; then replays
    timed in turns (recast, carried, carried, recast; the median ms a step
    of each)."""
    from exoground_tpu_torch.ops import _kernels

    n = GRAPH_N
    losses, replay_launches = {}, {}
    for c in (False, True):
        losses[c] = run[c](groups[0])["loss"].tolist()  # eager warm-up, capture
        torch.cuda.synchronize()
        _kernels.reset_launches()
        losses[c] += run[c](groups[1])["loss"].tolist()  # the replay
        torch.cuda.synchronize()
        replay_launches[c] = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        if replay_launches[c] != want_launches:
            fail(f"{label} carried casts {c}: replay launches {replay_launches[c]}")
    bit_equal = losses[False] == losses[True]
    carried = states[True]()
    for name, want in states[False]().items():
        for k in want:
            if not torch.equal(carried[name][k], want[k]):
                bit_equal = False
                print(f"{label}: carried vs recast {name} {k} differs", flush=True)
    times = {False: [], True: []}
    for _ in range(CARRY_AB_ROUNDS):
        for c in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run[c](groups[1])["loss"].tolist()
            times[c].append((time.perf_counter() - t0) * 1e3 / n)
    return dict(recast_step_ms=round(statistics.median(times[False]), 3),
                carried_step_ms=round(statistics.median(times[True]), 3),
                recast_all=[round(t, 3) for t in times[False]],
                carried_all=[round(t, 3) for t in times[True]], bit_equal=bit_equal,
                losses_equal=losses[False] == losses[True],
                replay_launches={"carried" if c else "recast": v
                                 for c, v in replay_launches.items()})


def carry_cast_case(model, card, raw):
    """Phase 5b's carried-cast A/B (``_carry_ab``), on the replayed bf16 B64
    TAN step (the trainer's, from one state) and on the replayed bf16
    grounding step (CARRY_GND, seeded weights, one state): the port carries
    its casts in both (``ScanStep.carry_casts``), the A/B turns it off on
    one runner to time the recast. Returns the ``carry_cast_bench`` dict,
    by step."""
    import copy

    from exoground_tpu_torch.losses.grounding import GroundingLossConfig
    from exoground_tpu_torch.models import ExoGroundingTransformer
    from exoground_tpu_torch.parallel import make_grounding_train_step
    from exoground_tpu_torch.train import ExperimentConfig, FusedAdamWEMA, TANTrainer

    n = GRAPH_N
    bench = dict(card=card, dtype="bfloat16", n=n)
    trainers = {}
    for c in (False, True):
        cfg = ExperimentConfig(amp=True, fused_steps=n, **BENCH_TRAIN)
        trainers[c] = TANTrainer(copy.deepcopy(model), cfg, iters_per_epoch=1000, device="cuda")
        if not trainers[c].fused_step.carry_casts:
            fail("the replayed bf16 TAN step does not carry its casts")
    trainers[False].fused_step.carry_casts = False
    groups = [trainers[False].to_device({k: np.stack([r[k] for r in raw[g * n:(g + 1) * n]])
                                         for k in raw[0]}) for g in (0, 1)]
    bench["tan"] = dict(batch=raw[0]["video"].shape[0], **_carry_ab(
        "TAN", {c: tr._do_fused for c, tr in trainers.items()},
        {c: (lambda tr=tr: {"params": tr.params, "ema": tr.target_params,
                            "mu": tr.opt_state.mu, "nu": tr.opt_state.nu})
         for c, tr in trainers.items()},
        groups, {"milnce_grid_fwd": 2 * n, "milnce_grid_bwd": 2 * n}))
    del trainers, groups

    torch.manual_seed(0)
    gnd = ExoGroundingTransformer(num_encoder_layers=6, num_decoder_layers=6, feature_dim=512,
                                  video_embed_dim=4096, text_embed_dim=4096, device="cuda")
    gnd.train()
    b, t, k = CARRY_GND["batch"], CARRY_GND["frames"], CARRY_GND["narrations"]
    rng = np.random.RandomState(60)
    groups = []
    for _ in range(2):
        starts = rng.rand(n, b, k).astype(np.float32) * 0.7
        dur = 0.05 + rng.rand(n, b, k).astype(np.float32) * 0.25
        npad = np.arange(k)[None, None, :] >= rng.randint(4, k + 1, (n, b, 1))
        vpad = np.arange(t)[None, None, :] >= rng.randint(16, t + 1, (n, b, 1))
        groups.append({key: torch.from_numpy(v).cuda() for key, v in dict(
            video_features=rng.randn(n, b, t, 4096).astype(np.float32),
            narration_features=rng.randn(n, b, k, 4096).astype(np.float32),
            video_padding_mask=vpad, narration_padding_mask=npad,
            starts=starts, ends=starts + dur, mean=starts + dur / 2,
            duration=dur).items()})
    params0 = {key: v.detach() for key, v in gnd.named_parameters()}
    arms = {}
    for c in (False, True):
        params = {key: v.clone() for key, v in params0.items()}
        tx = FusedAdamWEMA(params, lr=1e-4, weight_decay=1e-5, total_iterations=1000,
                           warmup_iterations=1)
        step = make_grounding_train_step(gnd, GroundingLossConfig(model="grounding"), tx,
                                         compute_dtype="bfloat16", scan_steps=n)
        if not step.carry_casts:
            fail("the replayed bf16 grounding step does not carry its casts")
        step.carry_casts = c
        arms[c] = (step, params, tx.init(params), torch.Generator().manual_seed(5))

    def run(c):
        step, params, opt, gen = arms[c]
        return lambda group: step(params, None, opt, group, gen)[3]

    bench["grounding"] = dict(**CARRY_GND, **_carry_ab(
        "grounding", {c: run(c) for c in arms},
        {c: (lambda a=a: {"params": a[1], "mu": a[2].mu, "nu": a[2].nu})
         for c, a in arms.items()}, groups, {}))
    print("carry_cast_bench", json.dumps(bench), flush=True)
    bad = [name for name in ("tan", "grounding") if not bench[name]["bit_equal"]]
    if bad:
        fail(f"carried and recast casts disagree after a replay: {bad}")
    del arms, groups, gnd
    torch.cuda.empty_cache()
    return bench


def graph_path(model, card):
    """Phase 5b: the train step as a replayed CUDA graph (scan_steps=N) at
    B64 float32 and bfloat16, B16 under attn_impl='flash' and B64 float32
    under --backprop_freq 2; returns the replays' launches by case."""
    from exoground_tpu_torch.evals.bench_items import make_train_batch

    # the host arrays prepare_batch gives, shared by the cases of a batch size
    raw = {b: [make_train_batch(b, seed=40 + i) for i in range(2 * GRAPH_N)]
           for b in sorted({c[0] for c in GRAPH_CASES})}
    out = {}
    for b, amp, impl, k in GRAPH_CASES:
        name = f"B{b} {'bf16' if amp else 'f32'} {impl}" + (f" backprop_freq {k}" if k > 1
                                                              else "")
        out[name] = graph_case(model, card, raw[b], amp, impl, k)
    GRAPH_BENCH.update({name: bench for name, (_, bench) in out.items()})
    GRAPH_BENCH["carry_cast"] = carry_cast_case(model, card, raw[64])
    fused, chain = out["B64 f32 auto"][1], out["B64 f32 auto backprop_freq 2"][1]
    print("graph_accum", json.dumps(dict(
        card=card, batch=64, dtype="float32", n=GRAPH_N,
        **{f"{key}_{name}": bench[key] for name, bench in (("fused", fused), ("k2", chain))
           for key in ("eager_step_ms", "replay_step_ms", "replay_busy_ms", "pool_mb")},
        replay_busy_ms_added=round(chain["replay_busy_ms"] - fused["replay_busy_ms"], 3))),
        flush=True)
    return {name: launches for name, (launches, _) in out.items()}


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


# ---------------------------------------------------------------- phase 7b
# Keystep grounding at the full widths of --feature_dim 1024 and 2048: 8
# heads, so head sizes 128 and 256, served by the wide-head bodies. Launches
# per forward by impl, at every width: the trunk's 18 encoder blocks (video,
# text, joint) and 6 decoder blocks; 'small' adds the decoder's 6
# cross-attentions (square 64 x 64 windows) to the window core; 'fused'
# takes the whole-block path in the encoders and fused MHA in the decoder.
# Under quant.matmul_impl('int8', min_cols=2048) the gate quantizes the
# 3C-column qkv and the 4C-column c_fc but not the C-column products at C
# 1024 (the JAX gate, attention.py:1098-1099), so the int8 kernels launch.
WIDE_GND_LAUNCHES = {
    "auto": dict(fused_mha=24, fused_mlp=24),
    "small": dict(small_attn=30, fused_mlp=24),
    "fused": dict(block_attn=18, block_mlp=18, fused_mha=6, fused_mlp=6),
    "int8 auto": dict(fused_mha_int8=24, fused_mlp_int8=24),
    "int8 fused": dict(block_attn_int8=18, block_mlp_int8=18, fused_mha_int8=6,
                       fused_mlp_int8=6),
}


def wide_gnd_launches(impl, width):
    """WIDE_GND_LAUNCHES[impl] with the wide bodies behind the wrappers, a
    float32 forward at feature_dim ``width`` (8 heads; heads above 64):
    every MHA-family launch runs the window kernel once and the f32 wgmma
    GEMM twice (exact: qkv and out-projection) or once (int8: the
    out-projection); small_attn runs the window kernel above
    MAX_SMALL_TILE_D."""
    from exoground_tpu_torch.ops.attention import MAX_SMALL_TILE_D

    want = dict(WIDE_GND_LAUNCHES[impl])
    exact = want.get("fused_mha", 0) + want.get("block_attn", 0)
    int8 = want.get("fused_mha_int8", 0) + want.get("block_attn_int8", 0)
    small = want.get("small_attn", 0) if width // 8 > MAX_SMALL_TILE_D else 0
    want.update(wgmma_linear_tf32=2 * exact + int8, wide_window=exact + int8 + small)
    return {k: v for k, v in want.items() if v}


WIDE_GND_REQS = 64  # requests a served batch: one bucket of 64-frame windows, 64 narrations
WIDE_GND_CPU_REQS = 4  # of them run again on the CPU for agreement
WIDE_GND_INT8_MIN_COLS = 2048
# the int8 floor's noise draws: at C 1024 one draw's change ranged 5e-4-7e-3
# on the CPU (values at a quantizer's rounding boundary are many), so the
# floor is the largest of a few
WIDE_GND_NOISE_DRAWS = 3


def _ground_preds(svc, reqs, ctx, model=None):
    """interval_preds (B, K, 2) of one bucket of ``reqs`` through the
    service's model as ``GroundingService._run`` feeds it, under ``ctx``
    (the service's own matmul context replaced, so that a quant policy
    other than its own can be served); ``model``: another model on the
    same device in its stead, the features cast to its type."""
    model = svc.model if model is None else model
    dtype = next(model.parameters()).dtype
    b, kpad, t = len(reqs), 64, svc.seq_len
    host, dv, dt = svc._pack(reqs, list(range(b)), kpad)
    buf = torch.from_numpy(host).to(svc.device)
    video, narr, vmask, nmask = torch.split(buf, [b * t * dv, b * kpad * dt, b * t, b * kpad])
    with torch.no_grad(), ctx:
        preds = model(video.view(b, t, dv).to(dtype), narr.view(b, kpad, dt).to(dtype),
                      vmask.view(b, t) > 0, nmask.view(b, kpad) > 0,
                      deterministic=True)["interval_preds"]
    return preds.float().cpu().numpy()


def _served_rows(results, preds, reqs):
    """(start, end) rows of each request's narrations, stacked: from
    ``ground_batch(..., use_center_duration=False)`` results, and from
    ``_ground_preds``'s (B, K, 2) for the same requests (its padded
    narration rows dropped)."""
    got = np.concatenate([np.stack([r["start"], r["end"]], -1) for r in results])
    want = np.concatenate([preds[i, :r["narration_embeds"].shape[0]]
                           for i, r in enumerate(reqs)])
    return got, want


# Phase 7b's C 2048 forwards through the flash cluster bodies and the wgmma
# GEMM: per forward, the float32 model under 'flash' (24 self-attentions and
# the decoder's 6 cross-attentions through the flash forward, D 256), and a
# bfloat16 copy under 'auto' (row 1's wide body, both projections on the
# wgmma GEMM) and 'flash'; held to the float32 'auto' card answer of the same
# batch (f32: 1e-4 of max|ref|; bf16: twice the error of the same bf16 model
# on its plain versions, disable_fused_kernels() and 'xla', at least 1e-3).
WIDE_GND_HOPPER = {
    "f32 'flash'": dict(flash_fwd=30, flash_fwd_cluster=30, fused_mlp=24),
    "bf16 'auto'": dict(fused_mha=24, fused_mlp=24, wgmma_linear=48, wide_window=24),
    "bf16 'flash'": dict(flash_fwd=30, flash_fwd_cluster=30, fused_mlp=24),
}


def wide_hopper_forwards(svc, reqs, check):
    """The forwards of WIDE_GND_HOPPER over the counted batch ``reqs`` of
    ``svc`` (the C 2048 service, float32), each counted per forward by
    ``check``; returns the launches by run and prints the agreement."""
    import copy

    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.fused_mlp import disable_fused_kernels

    def rel(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    def counted(label, model, impl, ctx=None):
        model.attn_impl = impl
        _ground_preds(svc, reqs, contextlib.nullcontext(), model)  # warm-up
        torch.cuda.synchronize()
        _kernels.reset_launches()
        got = _ground_preds(svc, reqs, ctx or contextlib.nullcontext(), model)
        torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
        if label is not None:
            check(f"C2048 {label}", launches, 1, WIDE_GND_HOPPER[label])
        return got, launches

    t0, out, errs = time.perf_counter(), {}, {}
    svc.model.attn_impl = "auto"
    ref = _ground_preds(svc, reqs, contextlib.nullcontext())  # the f32 'auto' card answer
    got, out["C2048 f32 'flash'"] = counted("f32 'flash'", svc.model, "flash")
    errs["f32 'flash'"] = rel(got, ref)
    svc.model.attn_impl = "auto"
    bmodel = copy.deepcopy(svc.model).to(torch.bfloat16)
    plain, n_plain = counted(None, bmodel, "xla", disable_fused_kernels())
    if any(n_plain.values()):
        fail(f"wide grounding C2048 bf16 plain: kernel launches {n_plain}")
    errs["bf16 plain (disable_fused_kernels, 'xla')"] = floor = rel(plain, ref)
    limit = max(1e-3, 2.0 * floor)
    for impl in ("auto", "flash"):
        got, out[f"C2048 bf16 '{impl}'"] = counted(f"bf16 '{impl}'", bmodel, impl)
        err = errs[f"bf16 '{impl}'"] = rel(got, ref)
        if not (np.isfinite(got).all() and err <= limit):
            fail(f"wide grounding C2048 bf16 '{impl}': rel err {err:.3e} against the f32 "
                 f"'auto' answer, limit {limit:.3e}")
    if not errs["f32 'flash'"] <= TOL[torch.float32]:
        fail(f"wide grounding C2048 f32 'flash': rel err {errs}")
    del bmodel
    torch.cuda.empty_cache()
    print("wide grounding C2048 hopper forwards (rel err against the f32 'auto' card answer "
          f"of the {len(reqs)}-request batch; bf16 limit {limit:.3e}):", json.dumps(errs),
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def wide_grounding_path(card):
    """Phase 7b: GroundingModel (the MLP VI pre-pass, the trunk E6D6, 8 heads,
    4096-d; seeded weights: make_grounding_params at C 1024, loaded through
    load_grounding_params, the model's own init from a seed at C 2048) at
    feature_dim 1024 (Dh 128) and 2048 (Dh 256), float32, served by
    GroundingService: C 1024 under 'auto' (row 1's wide body and row 2 at C
    1024), 'small' (row 9 at D 128) and 'fused' (row 7's wide body, row 8),
    then its forward under quant.matmul_impl('int8', min_cols=2048) under
    'auto' (rows 5 and 6) and 'fused' (row 7's int8 body); C 2048 under
    'auto' and 'small' (rows 1 and 9 at 256). Each run counted per forward
    (wide_gnd_launches); the counted forward's first WIDE_GND_CPU_REQS
    requests against the CPU's answer to them (<= 1e-4 of max|CPU| in f32;
    int8 at phase 7's floor: twice the CPU's largest own change under 1e-7
    input noise over WIDE_GND_NOISE_DRAWS draws, at least 1e-3, taken once
    under 'auto' for both paths); requests/s of a 64-request batch (median
    of 3, in turns). Returns the launches by run."""
    import copy

    from exoground_tpu_torch.evals.bench_items import (
        GROUNDING, make_grounding_params, make_grounding_requests)
    from exoground_tpu_torch.models import GroundingModel
    from exoground_tpu_torch.ops import _kernels, blocks, quant
    from exoground_tpu_torch.serve import GroundingService
    from exoground_tpu_torch.utils.convert import load_grounding_params

    t_phase = time.perf_counter()
    reqs = make_grounding_requests(5, WIDE_GND_REQS)
    few = reqs[:WIDE_GND_CPU_REQS]
    counted, bench = {}, {}

    def on_cpu(cpu_svc, impl, r, ctx):
        """The CPU's answer under ``impl``, its blocks dispatched as on the
        card (on the CPU 'fused' would keep the per-module path: the MLP's
        'auto' resolves to 'xla' there), so that the whole-block path's
        plain versions are the reference of its kernels."""
        cpu_svc.model.attn_impl = impl
        real = blocks.resolve_mlp_impl
        blocks.resolve_mlp_impl = lambda mlp_impl, c, device: real(mlp_impl, c, "cuda")
        try:
            return _ground_preds(cpu_svc, r, ctx)
        finally:
            blocks.resolve_mlp_impl = real

    def check(label, launches, n_fwd, want):
        per = {k: v / n_fwd for k, v in launches.items() if v}
        print(f"wide grounding {label}: {n_fwd} forwards, launches {launches}, {card}",
              flush=True)
        if per != want:
            fail(f"wide grounding {label}: launches per forward {per} != {want}")

    def rel(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    setup_s = {}  # host seconds building each width's model and its card copy
    for width, impls in ((1024, ("auto", "small", "fused")), (2048, ("auto", "small"))):
        t0 = time.perf_counter()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(width)
            cpu_model = GroundingModel(**dict(GROUNDING, feature_dim=width), device="cpu")
        if width == 1024:
            load_grounding_params(cpu_model, make_grounding_params(0, width=width))
        # C 2048 keeps the model's own init from that seed: make_grounding_params
        # draws its 1.2 B values one at a time in numpy (~1 min of host time)
        cpu_svc = GroundingService(cpu_model, device="cpu")
        svc = GroundingService(copy.deepcopy(cpu_model), device="cuda")
        setup_s[f"C{width}"] = round(time.perf_counter() - t0, 1)
        times = {impl: [] for impl in impls}
        for impl in impls:
            svc.model.attn_impl = impl
            svc.ground_batch(reqs)  # warm-up
            torch.cuda.synchronize()
            _kernels.reset_launches()
            served = svc.ground_batch(reqs, use_center_duration=False)
            torch.cuda.synchronize()
            launches = dict(_kernels.LAUNCHES)
            label = f"C{width} '{impl}'"
            check(label, launches, 1, wide_gnd_launches(impl, width))
            counted[label] = launches
            t0 = time.perf_counter()
            cpu = on_cpu(cpu_svc, impl, few, contextlib.nullcontext())
            cpu_s = time.perf_counter() - t0
            got, want = _served_rows(served[:len(few)], cpu, few)
            err = rel(got, want)
            print(f"wide grounding {label} card vs CPU (the counted {len(reqs)}-request "
                  f"batch's first {len(few)}, CPU {cpu_s:.1f} s): rel err {err:.3e}",
                  flush=True)
            if not (np.isfinite(got).all() and err <= TOL[torch.float32]):
                fail(f"wide grounding {label}: the card disagrees with the CPU ({err:.3e})")
        for rep in range(3):
            for impl in (impls if rep % 2 == 0 else impls[::-1]):
                svc.model.attn_impl = impl
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                svc.ground_batch(reqs)
                torch.cuda.synchronize()
                times[impl].append(time.perf_counter() - t0)
        for impl, ts in times.items():
            bench[f"C{width} {impl}"] = dict(batch_ms=statistics.median(ts) * 1e3,
                                             requests_per_s=len(reqs) / statistics.median(ts))
        if width != 1024:
            counted.update(wide_hopper_forwards(svc, reqs, check))
            continue
        # the int8 kernels at C 1024, through the model under the JAX gate's policy
        def ctx():
            return quant.matmul_impl("int8", min_cols=WIDE_GND_INT8_MIN_COLS)

        draws = []
        for seed in range(WIDE_GND_NOISE_DRAWS):
            rng = np.random.RandomState(seed)
            draws.append([dict(r, video=(r["video"] * (1.0 + 1e-7 * rng.standard_normal(
                r["video"].shape))).astype(np.float32)) for r in few])
        # the floor is the quantized model's sensitivity to its inputs, taken
        # once (under 'auto') for both paths
        cpu8 = on_cpu(cpu_svc, "auto", few, ctx())
        floor = max(rel(on_cpu(cpu_svc, "auto", nudged, ctx()), cpu8) for nudged in draws)
        limit = max(1e-3, 2.0 * floor)
        for impl in ("auto", "fused"):
            if impl != "auto":
                cpu8 = on_cpu(cpu_svc, impl, few, ctx())
            svc.model.attn_impl = impl
            _kernels.reset_launches()
            got = _ground_preds(svc, reqs, ctx())
            torch.cuda.synchronize()
            launches = dict(_kernels.LAUNCHES)
            label = f"C{width} int8 '{impl}' (min_cols {WIDE_GND_INT8_MIN_COLS})"
            check(label, launches, 1, wide_gnd_launches(f"int8 {impl}", width))
            counted[label] = launches
            err = rel(got[:len(few)], cpu8)
            print(f"wide grounding {label} card vs CPU: rel err {err:.3e}, limit {limit:.3e} "
                  f"(the CPU's largest own change under 1e-7 input noise, "
                  f"{WIDE_GND_NOISE_DRAWS} draws: {floor:.3e})", flush=True)
            if not (np.isfinite(got).all() and err <= limit):
                fail(f"wide grounding {label}: the card disagrees with the CPU")
        del svc, cpu_svc, cpu_model
        torch.cuda.empty_cache()
    print("wide_ground_bench", json.dumps(dict(requests=len(reqs), card=card, **bench,
                                               setup_s=setup_s,
                                               phase_s=round(time.perf_counter() - t_phase, 1))),
          flush=True)
    return counted


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
    from exoground_tpu_torch.ops import _kernels

    mha = 2 * 12 * CLI_VAL_BATCHES * val_passes + 12 * CLI_ALIGN_GROUPS * evals
    want = {k: 0 for k in _kernels.LAUNCHES}  # every counter but these at 0
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
    """A checkpoint against another: parameters, EMA twin (if any), both moments and
    the optax chain's accumulator where both have one, each tensor's max
    error over its max|ref|; bit equality; counts (and the mini step)."""
    got, want = (torch.load(p, map_location="cpu", weights_only=True)
                 for p in (path, ref_path))
    worst, equal = 0.0, True
    trees = [(got["state_dict"], want["state_dict"]),
             (got.get("target_state_dict", {}), want.get("target_state_dict", {})),
             (got["optimizer"]["mu"], want["optimizer"]["mu"]),
             (got["optimizer"]["nu"], want["optimizer"]["nu"])]
    if "acc_grads" in got["optimizer"] or "acc_grads" in want["optimizer"]:
        trees.append((got["optimizer"].get("acc_grads", {}),
                      want["optimizer"].get("acc_grads", {})))
    for a, b in trees:
        if set(a) != set(b):
            return dict(max_err=float("inf"), bit_equal=False, same_counts=False)
        for k in b:
            equal &= torch.equal(a[k], b[k])
            worst = max(worst, ((a[k].float() - b[k].float()).abs().max()
                                / b[k].float().abs().max().clamp_min(1e-30)).item())
    return dict(max_err=worst, bit_equal=equal,
                same_counts=(got["iteration"], got["optimizer"]["count"],
                             got["optimizer"].get("mini_step"))
                == (want["iteration"], want["optimizer"]["count"],
                    want["optimizer"].get("mini_step")))


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


def _jax_param_tree(sd) -> dict:
    """A port TemporalAligner state dict as the JAX package's param tree
    (exoground_tpu/utils/convert.py::convert_tan_state_dict's output; the
    inverse of utils/convert.py::tan_state_dict_from_jax): Linear and
    in_proj weights transposed back to kernels, LayerNorm weights as scales,
    ``resblocks.i`` as ``resblocks_i``; the reference's unused ``mlp``,
    which no JAX tree holds, left out."""
    from exoground_tpu_torch.utils.convert import UNUSED_REFERENCE_KEYS

    tree = {}
    for key, v in sd.items():
        if key in UNUSED_REFERENCE_KEYS:
            continue
        a = v.numpy()
        *path, leaf = key.split(".")
        if path and path[-1] == "out_proj":
            path, leaf = path[:-1], f"out_proj_{leaf}"
        if leaf.endswith("weight"):
            leaf, a = (leaf[:-6] + "kernel", a.T) if a.ndim == 2 else ("scale", a)
        node = tree
        for i, name in enumerate(path):
            if name.isdigit():
                continue
            if i + 1 < len(path) and path[i + 1].isdigit():
                name = f"{name}_{path[i + 1]}"
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


def _msgpack(f, node) -> None:
    """``node`` (dicts of str keys, str, int, float, numpy arrays and
    scalars) written to ``f`` as flax.serialization.msgpack_serialize writes
    it: an array as ext type 1, whose payload is the msgpack of (shape,
    dtype name, C-order bytes)."""
    if isinstance(node, dict):
        n = len(node)
        f.write(bytes([0x80 | n]) if n < 16 else struct.pack(">BH", 0xDE, n))
        for k, v in node.items():
            _msgpack(f, str(k))
            _msgpack(f, v)
    elif isinstance(node, str):
        b = node.encode()
        f.write((bytes([0xA0 | len(b)]) if len(b) < 32 else struct.pack(">BB", 0xD9, len(b)))
                + b)
    elif isinstance(node, float):
        f.write(struct.pack(">Bd", 0xCB, node))
    elif isinstance(node, int):
        f.write(bytes([node]) if 0 <= node < 0x80 else struct.pack(">Bq", 0xD3, node))
    else:
        a = np.asarray(node)
        if not a.flags.c_contiguous:
            a = np.ascontiguousarray(a)
        head = io.BytesIO()
        head.write(bytes([0x93, 0x90 | a.ndim]))
        for d in a.shape:
            _msgpack(head, int(d))
        _msgpack(head, a.dtype.name)
        head.write(struct.pack(">BI", 0xC6, a.nbytes))
        head = head.getvalue()
        f.write(struct.pack(">BIb", 0xC9, len(head) + a.nbytes, 1) + head)
        f.write(a.tobytes() if a.ndim == 0 else a.data)


def jax_checkpoint_tree(port_path) -> dict:
    """The port checkpoint at ``port_path`` as the JAX trainer's
    ``_ckpt_state`` tree: the trees through ``_jax_param_tree``, the
    optimizer's state in the JAX layout of the port's (the fused ``{count,
    mu, nu}``, or the chain's ``MultiStepsState`` under accumulation,
    nested as the committed jax_tan_multisteps_k2 fixture holds it)."""
    blob = torch.load(port_path, map_location="cpu", weights_only=True)
    opt = blob["optimizer"]
    count = np.int32(opt["count"])
    state = {"count": count, "mu": _jax_param_tree(opt["mu"]), "nu": _jax_param_tree(opt["nu"])}
    if "acc_grads" in opt:
        state = {"mini_step": np.int32(opt["mini_step"]), "gradient_step": count,
                 "inner_opt_state": {"0": {"0": state, "1": {"inner_state": {}},
                                           "2": {"count": count}}},
                 "acc_grads": _jax_param_tree(opt["acc_grads"]), "skip_state": {}}
    return {"epoch": int(blob["epoch"]), "state_dict": _jax_param_tree(blob["state_dict"]),
            "best_acc": float(blob["best_acc"]), "optimizer": state,
            "iteration": int(blob["iteration"]),
            "target_state_dict": _jax_param_tree(blob["target_state_dict"])}


def write_jax_checkpoint(source, path, fmt="flax_msgpack") -> int:
    """``source`` (a port checkpoint's path, or the tree
    ``jax_checkpoint_tree`` made of one) written to ``path`` as the JAX
    package writes its own: one flax msgpack map
    (exoground_tpu/train/checkpoint.py::save_state) or, ``fmt`` "orbax", an
    orbax checkpoint directory (its save_state_orbax, through the port's
    ``save_state_orbax``). Returns the bytes written."""
    import os

    from exoground_tpu_torch.train.checkpoint import save_state_orbax
    from exoground_tpu_torch.utils.orbax import directory_bytes

    tree = source if isinstance(source, dict) else jax_checkpoint_tree(source)
    if fmt == "orbax":
        save_state_orbax(path, tree)
        return directory_bytes(path)
    with open(path, "wb") as f:
        _msgpack(f, tree)
    return os.path.getsize(path)


def jax_grounding_tree(model) -> dict:
    """A port grounding model's parameters as the JAX package's param tree
    (the inverse of utils/convert.py::grounding_state_dict_from_jax): each
    tensor at its ``jax_name``, Dense and attention kernels transposed back;
    the buffers (a sine table) and the reference's unused ``mlp``, in no
    JAX tree, left out."""
    from exoground_tpu_torch.utils.convert import UNUSED_REFERENCE_KEYS, jax_name

    skip = set(UNUSED_REFERENCE_KEYS) | {name for name, _ in model.named_buffers()}
    tree = {}
    for name, t in model.state_dict().items():
        if name in skip:
            continue
        *path, leaf = jax_name(name, model).split("/")
        a = t.detach().cpu().numpy()
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a.T if leaf.endswith("kernel") and a.ndim == 2 else a)
    return tree


def _host_cost(fn) -> tuple:
    """fn()'s wall seconds and the host memory it took at its peak: the
    process's resident set, sampled every millisecond by a thread over the
    call (the reader and the bridge release the GIL in their copies), its
    largest value less its value before, in MB."""
    import os

    page = os.sysconf("SC_PAGE_SIZE")

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page

    before, peak, done = rss(), [0], threading.Event()

    def sample():
        while not done.is_set():
            peak[0] = max(peak[0], rss())
            done.wait(1e-3)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        fn()
    finally:
        secs = time.perf_counter() - t0
        done.set()
        sampler.join()
    return secs, (max(peak[0], rss()) - before) / 2**20


def _spy_trainers(refs=None):
    """Record each TANTrainer the command line builds, and check each
    ``load_checkpoint`` as it returns: resume must restore the checkpoint's
    parameters, EMA twin, optimizer state (the accumulator and mini step
    under accumulation), iteration, epoch and best exactly. ``refs`` maps a
    JAX-format file to the port file it was written from
    (``write_jax_checkpoint``), whose state it must restore (the unused
    ``mlp``, in no JAX tree, aside). Each load's seconds and peak host MB
    (``_host_cost``) go into ``costs``. Returns (trainers, loads, costs,
    undo)."""
    from exoground_tpu_torch.train import optimizer_state_dict
    from exoground_tpu_torch.train.trainer import TANTrainer
    from exoground_tpu_torch.utils.convert import UNUSED_REFERENCE_KEYS

    refs = {} if refs is None else refs
    trainers, loads, costs = [], [], []
    real_init, real_load = TANTrainer.__init__, TANTrainer.load_checkpoint

    def init(self, *a, **k):
        real_init(self, *a, **k)
        trainers.append(self)

    def load(self, path, mode="resume"):
        secs, peak_mb = _host_cost(lambda: real_load(self, path, mode))
        costs.append(dict(path=path, s=secs, peak_mb=peak_mb))
        blob = torch.load(refs.get(path, path), map_location="cpu", weights_only=True)
        skip = set(UNUSED_REFERENCE_KEYS) if path in refs else set()

        def same(got, want):
            return set(got) == set(want) and all(torch.equal(got[k].cpu(), want[k])
                                                 for k in set(want) - skip)

        rec = dict(mode=mode, params=same(self.params, blob["state_dict"]))
        if mode == "resume":
            opt, state = blob["optimizer"], optimizer_state_dict(self.opt_state)
            rec.update(ema=same(self.target_params, blob["target_state_dict"]),
                       mu=same(state["mu"], opt["mu"]), nu=same(state["nu"], opt["nu"]),
                       count=state["count"] == opt["count"],
                       iteration=self.iteration == blob["iteration"],
                       start_epoch=self.start_epoch == blob["epoch"] + 1 == 1,
                       best_acc=self.best_acc == blob["best_acc"])
            if "acc_grads" in opt:
                rec.update(acc=same(state["acc_grads"], opt["acc_grads"]),
                           mini_step=state["mini_step"] == opt["mini_step"])
        loads.append(rec)

    TANTrainer.__init__, TANTrainer.load_checkpoint = init, load

    def undo():
        TANTrainer.__init__, TANTrainer.load_checkpoint = real_init, real_load

    return trainers, loads, costs, undo


def _orbax_resume(run, tree, path, tree_s, want_launches, loads, costs, trainers) -> dict:
    """Phase 8's orbax resume: the JAX tree of the --backprop_freq 2 run's
    epoch-0 checkpoint written as the JAX package's orbax directory
    (``write_jax_checkpoint(..., "orbax")``), read back alone (``load_state``:
    OCDBT, zarr, zstd), then ``--backprop_freq 2 --resume <directory>``: the
    spy holds the restored state to the port file's bit for bit, the run
    takes its 8 steps with the launches of the msgpack file's resume. Prints
    ``orbax_resume {...}`` (the directory's MB, write, read and
    load_checkpoint seconds, decode MB/s, the run's seconds)."""
    from exoground_tpu_torch.train.checkpoint import load_state

    t0 = time.perf_counter()
    dir_mb = write_jax_checkpoint(tree, path, "orbax") / 2**20
    write_s = time.perf_counter() - t0 + tree_s
    t0 = time.perf_counter()
    load_state(path)
    read_s = time.perf_counter() - t0
    best, run_s, launches = run(["--backprop_freq", "2", "--resume", path])
    tr = trainers[-1]
    steps = sum(s["steps"] for s in tr.epoch_stats)
    if (not loads or loads[-1]["mode"] != "resume" or not all(loads[-1].values())
            or "acc" not in loads[-1] or costs[-1]["path"] != path):
        fail(f"--resume from the orbax directory did not restore exactly: {loads[-1:]}")
    if steps != 8 or not np.isfinite(best) or getattr(tr.tx, "every_k", 1) != 2:
        fail(f"cli --backprop_freq 2 --resume <orbax directory>: {steps} steps (want 8), "
             f"best {best}")
    _check_counts("cli --backprop_freq 2 --resume <orbax directory>", launches,
                  _cli_expect(steps, 1, 1))
    if launches != want_launches:
        fail(f"--resume <orbax directory> launched {launches}, the msgpack file's resume "
             f"{want_launches}")
    row = dict(dir_mb=round(dir_mb, 1), write_s=round(write_s, 2), read_s=round(read_s, 2),
               decode_mb_per_s=round(dir_mb / read_s, 1),
               load_checkpoint_s=round(costs[-1]["s"], 3),
               peak_host_mb=round(costs[-1]["peak_mb"], 1), run_s=round(run_s, 1),
               restored_bit_equal=True, launches={k: v for k, v in launches.items() if v})
    print("orbax_resume", json.dumps(row), flush=True)
    return row


def cli_path(card):
    """Phase 8: ``exoground_tpu_torch.train.main`` on the card over a seeded
    tree (cotrain, 2 epochs, validation and HTM-Align every epoch), the same
    at ``--fused_steps 4``, ``--backprop_freq 2`` (and ``--resume`` from its
    checkpoint written as a JAX file), ``--no-fused_optimizer``, then
    ``--resume`` from epoch 0 and ``--test``; each run counted; the card
    against the CPU. Returns the launches of the first run, of the
    ``--fused_steps 4`` run and of the optax chain's runs by their flags."""
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
    jax0 = os.path.join(work, "jax_run", "model", "epoch0.pth.tar")
    jax_dir = os.path.join(work, "jax_run", "model", "epoch0.orbax")
    refs = {}  # a JAX-format file or directory: the port file it was written from
    trainers, loads, costs, undo = _spy_trainers(refs)
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

        # the optax chain: --backprop_freq 2 at --fused_steps 1 and 4 (one
        # epoch: 8 mini-batches, 4 updates), then --no-fused_optimizer; each
        # within warmup, where one epoch's schedule is two epochs'
        accum, accum_s = {}, {}
        for n in (1, GRAPH_N):
            best_k, accum_s[n], launches_k = run(["--backprop_freq", "2", "--fused_steps",
                                                  str(n), "--epochs", "1", "--prefix",
                                                  f"_k2f{n}"])
            trk = trainers[-1]
            steps_k = sum(s["steps"] for s in trk.epoch_stats)
            captures = trk.fused_step.captures if trk.fused_step is not None else 1
            if (steps_k != 8 or not np.isfinite(best_k) or captures != 1
                    or getattr(trk.tx, "every_k", 1) != 2):
                fail(f"cli --backprop_freq 2 --fused_steps {n}: {steps_k} steps (want 8), "
                     f"best {best_k}, {captures} captures, optimizer {type(trk.tx).__name__}")
            _check_counts(f"cli --backprop_freq 2 --fused_steps {n}", launches_k,
                          _cli_expect(steps_k, 1, 1))
            (path_k,) = glob.glob(os.path.join(work, f"log_k2f{n}", "*", "model",
                                               "epoch0.pth.tar"))
            accum[n] = (path_k, launches_k)
        accum_vs_single = _ckpt_agreement(accum[GRAPH_N][0], accum[1][0])
        print(f"cli --backprop_freq 2 --fused_steps {GRAPH_N} epoch-0 checkpoint vs "
              f"--fused_steps 1: {accum_vs_single}", flush=True)
        if not (accum_vs_single["bit_equal"] and accum_vs_single["same_counts"]):
            fail(f"--backprop_freq 2 --fused_steps {GRAPH_N} trained another model: "
                 f"{accum_vs_single}")
        # the --backprop_freq 2 run's epoch-0 checkpoint (a MultiStepsState
        # at full width) written again as a JAX package file, then --resume
        # from it: the spy holds the restored state to the port file's
        os.makedirs(os.path.dirname(jax0))  # --resume writes beside its file
        refs[jax0] = refs[jax_dir] = accum[1][0]
        t0 = time.perf_counter()
        jax_tree = jax_checkpoint_tree(accum[1][0])
        jax_tree_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax_mb = write_jax_checkpoint(jax_tree, jax0) / 2**20
        jax_write_s = time.perf_counter() - t0 + jax_tree_s
        best_j, jax_resume_s, launches_j = run(["--backprop_freq", "2", "--resume", jax0])
        trj = trainers[-1]
        steps_j = sum(s["steps"] for s in trj.epoch_stats)
        if (not loads or loads[-1]["mode"] != "resume" or not all(loads[-1].values())
                or "acc" not in loads[-1] or costs[-1]["path"] != jax0):
            fail(f"--resume from the JAX-format file did not restore exactly: {loads[-1:]}")
        if steps_j != 8 or not np.isfinite(best_j) or getattr(trj.tx, "every_k", 1) != 2:
            fail(f"cli --backprop_freq 2 --resume <JAX file>: {steps_j} steps (want 8), "
                 f"best {best_j}")
        _check_counts("cli --backprop_freq 2 --resume <JAX file>", launches_j,
                      _cli_expect(steps_j, 1, 1))
        jax_resume = dict(file_mb=round(jax_mb, 1), write_s=round(jax_write_s, 2),
                          load_checkpoint_s=round(costs[-1]["s"], 3),
                          peak_host_mb=round(costs[-1]["peak_mb"], 1),
                          run_s=round(jax_resume_s, 1), restored_bit_equal=True)
        print(f"cli --resume from its --backprop_freq 2 checkpoint written as a JAX file: "
              f"{jax_resume}", flush=True)
        orbax_resume = _orbax_resume(run, jax_tree, jax_dir, jax_tree_s, launches_j, loads,
                                     costs, trainers)
        del jax_tree

        best_nf, nofused_s, launches_nf = run(["--no-fused_optimizer", "--epochs", "1",
                                               "--prefix", "_nf"])
        trn = trainers[-1]
        if type(trn.tx).__name__ != "OptaxChain" or not np.isfinite(best_nf):
            fail(f"--no-fused_optimizer: optimizer {type(trn.tx).__name__}, best {best_nf}")
        _check_counts("cli --no-fused_optimizer", launches_nf,
                      _cli_expect(sum(s["steps"] for s in trn.epoch_stats), 1, 1))
        (e0n,) = glob.glob(os.path.join(work, "log_nf", "*", "model", "epoch0.pth.tar"))
        chain_vs_fused = _ckpt_agreement(e0n, e0)
        print(f"cli --no-fused_optimizer epoch-0 checkpoint vs the fused optimizer's: "
              f"{chain_vs_fused}", flush=True)
        if not (chain_vs_fused["max_err"] <= 1e-5 and chain_vs_fused["same_counts"]):
            fail(f"--no-fused_optimizer trained another model: {chain_vs_fused}")

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
    print("cli_chain", json.dumps(dict(
        card=card, backprop_freq_2_run_s={n: round(t, 1) for n, t in accum_s.items()},
        backprop_freq_2_f4_vs_f1=dict(max_err=float(f"{accum_vs_single['max_err']:.3g}"),
                                      bit_equal=accum_vs_single["bit_equal"]),
        jax_file_resume=jax_resume, orbax_resume=orbax_resume,
        no_fused_optimizer_run_s=round(nofused_s, 1),
        no_fused_vs_fused=dict(max_err=float(f"{chain_vs_fused['max_err']:.3g}"),
                               bit_equal=chain_vs_fused["bit_equal"]))), flush=True)
    return launches, launches4, {f"--backprop_freq 2 --fused_steps {n}": accum[n][1]
                                 for n in accum} | {
        "--backprop_freq 2 --resume <JAX file>": launches_j,
        "--backprop_freq 2 --resume <orbax directory>": orbax_resume["launches"],
        "--no-fused_optimizer": launches_nf}


# ---------------------------------------------------------------- phase 8b
# The committed JAX-written fixtures (tests/jax_tan_fixtures.py writes them
# with the JAX package): the aligner's fields, the feature width and the
# trainer's configuration they were trained with.
JAX_FIXTURE_MODEL = dict(num_encoder_layers=1, num_joint_layers=1, width=32, heads=2,
                         max_pos=64, use_alignability_head=1, random_pos_start=0)
JAX_FIXTURE_DIM = 24
JAX_FIXTURE_CONFIG = dict(model="cotrain", learn_agreement=1, loss_threshold=0.7,
                          use_alignability_head=1, lr=1e-3, momentum_m=0.9, epochs=2, seed=0,
                          print_freq=100)
JAX_FIXTURE_LAYOUTS = {"fused": dict(), "multisteps_k2": dict(backprop_freq=2)}


def _fixture_batch(seed, b=4, t=16, n=5) -> dict:
    """tests/jax_tan_fixtures.py's ``batch``."""
    rng = np.random.RandomState(seed)
    start = rng.randint(0, t - 4, (b, n)).astype(np.float32)
    return {"video": rng.randn(b, t, JAX_FIXTURE_DIM).astype(np.float32),
            "text": rng.randn(b, n, JAX_FIXTURE_DIM).astype(np.float32),
            "video_padding_mask": np.zeros((b, t), bool),
            "text_padding_mask": np.zeros((b, n), bool), "start": start, "end": start + 2}


def _fixture_trees(tr, blob) -> dict:
    """name: (the trainer's tensors, the bridged file's) for the parameters,
    EMA twin, moments and, under accumulation, the accumulator; the file's
    keys are the ones compared (the reference's unused mlp is in no JAX
    tree)."""
    from exoground_tpu_torch.train import optimizer_state_dict

    state, opt = optimizer_state_dict(tr.opt_state), blob["optimizer"]
    trees = {"params": (tr.params, blob["state_dict"]),
             "ema": (tr.target_params, blob["target_state_dict"]),
             "mu": (state["mu"], opt["mu"]), "nu": (state["nu"], opt["nu"])}
    if "acc_grads" in opt:
        trees["acc"] = (state["acc_grads"], opt["acc_grads"])
    return trees


def jax_resume_path(card):
    """Phase 8b: each committed JAX checkpoint, its msgpack file and its
    orbax directory, resumed on the card by TANTrainer.load_checkpoint (what
    --resume runs), every restored tensor held bit for bit to the msgpack
    file's arrays, then one step against the same
    resume and step on the CPU: the loss, and the parameters, EMA twin,
    moments and accumulator after it (each tensor within 1e-3 of its
    max|CPU|; the step must move the parameters: both fixtures' next step
    is an update)."""
    import os

    from exoground_tpu_torch.models import TemporalAligner
    from exoground_tpu_torch.train import ExperimentConfig, TANTrainer, optimizer_state_dict
    from exoground_tpu_torch.train.checkpoint import load_state
    from exoground_tpu_torch.utils.convert import tan_checkpoint_from_jax

    from exoground_tpu_torch.utils.orbax import directory_bytes

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "exoground_tpu_torch",
                        "testdata")
    out = {}
    for (layout, kw), suffix in itertools.product(JAX_FIXTURE_LAYOUTS.items(),
                                                  (".pth.tar", ".orbax")):
        # the msgpack file's state is the one every restore is held to
        blob = tan_checkpoint_from_jax(load_state(os.path.join(here, f"jax_tan_{layout}.pth.tar")))
        path = os.path.join(here, f"jax_tan_{layout}{suffix}")
        t0 = time.perf_counter()
        tan_checkpoint_from_jax(load_state(path))
        read_s = time.perf_counter() - t0
        res = {}
        for dev in ("cuda", "cpu"):
            torch.manual_seed(1)  # not the file's weights: the resume brings them
            tr = TANTrainer(TemporalAligner(**JAX_FIXTURE_MODEL, video_dim=JAX_FIXTURE_DIM,
                                            text_dim=JAX_FIXTURE_DIM, device=dev),
                            ExperimentConfig(**JAX_FIXTURE_CONFIG, **kw), iters_per_epoch=4,
                            device=dev)
            tr.tx.eps = 1e-3  # the fixtures' Adam eps
            t0 = time.perf_counter()
            tr.load_checkpoint(path, mode="resume")
            load_s = time.perf_counter() - t0
            trees = _fixture_trees(tr, blob)
            unequal = [f"{name} {k}" for name, (got, want) in trees.items() for k in want
                       if not torch.equal(got[k].cpu(), want[k])]
            state = optimizer_state_dict(tr.opt_state)
            counts = ((state["count"], state.get("mini_step"), tr.iteration)
                      == (blob["optimizer"]["count"], blob["optimizer"].get("mini_step"),
                          blob["iteration"]))
            if unequal or not counts:
                fail(f"resume from the JAX checkpoint {layout}{suffix} on {dev}: unequal "
                     f"{unequal[:4]}, counts {counts}")
            loss = tr.train_epoch([_fixture_batch(10)], 1)
            state = optimizer_state_dict(tr.opt_state)
            after = {name: {k: got[k].float().cpu() for k in want}
                     for name, (got, want) in _fixture_trees(tr, blob).items()}
            res[dev] = (loss, load_s, after, (state["count"], state.get("mini_step")))
        rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        # the state after the step, each tensor's max error over its max|CPU|
        got, want = res["cuda"][2], res["cpu"][2]
        worst = {name: max((got[name][k] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                           for k, w in want[name].items()) for name in want}
        moved = max((want["params"][k] - w).abs().max().item()
                    for k, w in blob["state_dict"].items())
        name = layout if suffix == ".pth.tar" else f"{layout}.orbax"
        size = directory_bytes(path) if os.path.isdir(path) else os.path.getsize(path)
        out[name] = dict(file_kb=round(size / 1024, 1),
                           read_s=round(read_s, 4), load_checkpoint_s=round(res["cuda"][1], 4),
                           loss=res["cuda"][0], loss_cpu=res["cpu"][0],
                           loss_rel=float(f"{rel:.3g}"), restored_bit_equal=True,
                           after_step={k: float(f"{v:.3g}") for k, v in worst.items()},
                           counts=res["cuda"][3])
        if (not np.isfinite(res["cuda"][0]) or not rel <= 1e-4 or not moved > 0
                or res["cuda"][3] != res["cpu"][3] or not max(worst.values()) <= 1e-3):
            fail(f"the step after resuming {name} on the card disagrees with the CPU "
                 f"(parameters moved {moved:.3g}): {out[name]}")
    print("jax_resume", json.dumps(dict(card=card, **out)), flush=True)


# ---------------------------------------------------------------- phase 9
# The grounding scripts' configuration (scripts/train_*.sh: E6D6, width 512,
# 8 heads, 4096-d EgoVLPv2 video and narration features, seq 64, B16) over
# seeded trees (tools/synth_egoexo.py) cut in scale only, each take with an ego
# camera and 4 exo cameras: for the view-invariant and grounding scripts 4
# training takes of 150 s (18 steps), 1 validation and 1 test take (5
# batches); for the joint script, whose curriculum makes 11 windows of each
# start (every pair of the 5 cameras and the ego alone), 2 training takes of
# 120 s (16 steps), 1 validation and 1 test take (3 batches); LEMMA 3
# training videos of 150 s (3 steps) and 1 each to validate and test. (The
# takes were 220 / 180 / 200 s, 32 / 33 / 5 steps, before phase 7b and the
# --feature_dim 1024 runs: cut to keep the script within its time limit.)
GND_TAKES, GND_SECONDS = {"train": 4, "val": 1, "test": 1}, 150
GND_JOINT_TAKES, GND_JOINT_SECONDS = {"train": 2, "val": 1, "test": 1}, 120
GND_LEMMA, GND_LEMMA_SECONDS = {"train": 3, "val": 1, "test": 1}, 150
GND_PROFILED = 4  # steps at an epoch's end profiled for the device's busy time
_GND_EGO = ["--dataset", "egoexo4d", "--batch_size", "16", "--num_workers", "0",
            "--use_keysteps", "--views", "all", "--exos", "all", "--print_freq", "100"]
GND_SCRIPTS = {
    "vi": _GND_EGO + ["--epochs", "1", "--model", "view_invariant", "--use_distill_nce_loss",
                      "--minimum_four_exo_takes", "--same_view_negative"],
    "grounding": _GND_EGO + ["--epochs", "1", "--model", "grounding",
                             "--minimum_four_exo_takes"],
    "joint": _GND_EGO + ["--epochs", "1", "--model", "joint", "--minimum_four_exo_takes",
                         "--use_distill_nce_loss", "--same_view_negative", "--curriculum_train"],
    "lemma": ["--dataset", "lemma", "--batch_size", "16", "--num_workers", "0",
              "--use_keysteps", "--views", "all", "--exos", "all", "--print_freq", "100",
              "--epochs", "1", "--model", "joint", "--use_distill_nce_loss"],
}
GND_TEST_JOINT = _GND_EGO + ["--model", "joint", "--minimum_four_exo_takes",
                             "--use_distill_nce_loss", "--same_view_negative"]
GND_FWD = 24  # fused MHA and fused MLP launches a grounding forward (E6D6)


def _gnd_close(label, got, want, n_valid) -> float:
    """The card's scalars against the CPU's: 1e-4 relative or 1e-6 absolute
    (a cosine near 0), the IoU>=θ fractions within one narration's share (an
    IoU at θ may fall either side), the weights equal. Returns the largest
    relative error of the scalars above 1e-2 in size."""
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if k.startswith("_"):
            ok = g == w
        elif k.startswith("IoU>="):
            ok = abs(g - w) <= 1.0 / max(n_valid, 1) + 1e-6
        else:
            err = abs(g - w)
            ok = err <= 1e-4 * abs(w) or err <= 1e-6
            if abs(w) > 1e-2:
                worst = max(worst, err / abs(w))
        if not ok:
            fail(f"{label} {k}: card {g} vs CPU {w}")
    return worst


def gnd_agreement(argv) -> dict:
    """The card against the CPU on the joint script's model (the command
    line's build_egoexo from the same seed): the eval step on the first
    validation batch (the inference kernels on the card, counted) and one
    train step on the first training batch, float32."""
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.parallel import make_grounding_eval_step
    from exoground_tpu_torch.train import main as cli
    from exoground_tpu_torch.train.config import parse_args

    runs = {dev: cli.build_egoexo(parse_args(argv), dev) for dev in ("cpu", "cuda")}
    res, launches = {}, {}
    try:
        for dev, run in runs.items():
            tr = run.trainer
            vb = tr.prepare_batch(next(iter(run.val_loader)))
            tb = tr.prepare_batch(next(iter(run.train_loader)))
            step = make_grounding_eval_step(tr.model, tr.loss_cfg)
            vbt = tr.to_device(vb)
            _kernels.reset_launches()
            scal, ious = step(tr.params, vbt)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
            with torch.no_grad():  # the eval forward's outputs themselves
                out = tr.model(vbt["video_features"], vbt["narration_features"],
                               vbt["video_padding_mask"], vbt["narration_padding_mask"],
                               egocentric_video_embed=vbt["ego_video_features_flat"],
                               deterministic=True)
            tr.model.train()
            m = tr._do_step(tr.to_device(tb))
            res[dev] = ({k: float(v) for k, v in scal.items()}, ious.float().cpu().numpy(),
                        {k: float(v) for k, v in m.items()},
                        int((~vb["narration_padding_mask"]).sum()),
                        int((~tb["narration_padding_mask"]).sum()),
                        {k: out[k].float().cpu().numpy()
                         for k in ("interval_preds", "high_dim_features")})
    finally:
        for run in runs.values():
            run.close()
    (gs, gi, gm, nv, nt, go), (cs, ci, cm, _, _, co) = res["cuda"], res["cpu"]
    if launches != {"fused_mha": GND_FWD, "fused_mlp": GND_FWD}:
        fail(f"grounding eval step on the card: launches {launches}")
    eval_err = _gnd_close("grounding eval step", gs, cs, nv)
    errs = {k: float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-30))
            for k, g, c in (("iou_map", gi, ci), *((k, go[k], co[k]) for k in co))}
    for k, err in errs.items():
        if not err <= 1e-4:
            fail(f"grounding eval forward: {k} differs by {err:.3e} of max|CPU|")
    train_err = _gnd_close("grounding train step", gm, cm, nt)
    return dict(eval_scalars_rel=float(f"{eval_err:.3g}"),
                **{f"{k}_rel": float(f"{v:.3g}") for k, v in errs.items()},
                iou_nonzero=int((ci != 0).sum()), train_metrics_rel=float(f"{train_err:.3g}"),
                eval_launches=launches, loss_card=gm["loss"], loss_cpu=cm["loss"])


def served_checkpoint_case(card, rec, path):
    """Phase 9's serving check: ``GroundingService.from_checkpoint`` of the
    grounding run's epoch-0 file (a port ``torch.save`` file) into a fresh
    model of the run's configuration, on the card, against the in-memory
    model's ``ground_batch`` (phase 7's f32 bar: 1e-4 of max|in memory|; the
    same weights and kernels, so 0 expected); then the same weights as the
    JAX package's orbax directory (``jax_grounding_tree``, written beside
    the file by ``save_state_orbax``), served the same way: equal to the
    file's service bit for bit, with its launches."""
    import os

    from exoground_tpu_torch.evals.bench_items import make_grounding_requests
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.serve import GroundingService
    from exoground_tpu_torch.train import main as cli
    from exoground_tpu_torch.train.checkpoint import load_state, save_state_orbax
    from exoground_tpu_torch.utils.orbax import directory_bytes

    cfg = rec["cfg"]
    reqs = make_grounding_requests(3, 16, video_dim=cfg.video_feature_dim,
                                   text_dim=cfg.text_feature_dim)

    def serve(ckpt):
        t0 = time.perf_counter()
        served = GroundingService.from_checkpoint(ckpt, model=cli.build_model(cfg, device="cpu"))
        load_s = time.perf_counter() - t0
        _kernels.reset_launches()
        got = served.ground_batch(reqs)
        torch.cuda.synchronize()
        return got, load_s, {k: v for k, v in _kernels.LAUNCHES.items() if v}

    got, load_s, launches = serve(path)
    want = GroundingService(rec["trainer"].model).ground_batch(reqs)
    scale = max(np.abs(w[k]).max() for w in want for k in ("start", "end"))
    err = max(float(np.abs(np.asarray(g[k]) - np.asarray(w[k])).max())
              for g, w in zip(got, want) for k in ("start", "end")) / scale
    row = dict(card=card, requests=len(reqs), rel_err=float(f"{err:.3g}"),
               load_s=round(load_s, 2), launches=launches)
    print("gnd_served_checkpoint", json.dumps(row), flush=True)
    if not err <= TOL[torch.float32]:
        fail(f"grounding checkpoint served: {err:.3e} of max|in memory|")
    if launches != {"fused_mha": GND_FWD, "fused_mlp": GND_FWD}:
        fail(f"grounding checkpoint served: launches {launches}")

    orbax_dir = os.path.join(os.path.dirname(path), "epoch0.orbax")
    t0 = time.perf_counter()
    model = cli.build_model(cfg, device="cpu")
    model.load_state_dict(load_state(path)["state_dict"])
    save_state_orbax(orbax_dir, {"epoch": 0, "state_dict": jax_grounding_tree(model),
                                 "best_acc": 0.0})
    write_s = time.perf_counter() - t0
    got_o, load_o, launches_o = serve(orbax_dir)
    equal = all(np.array_equal(np.asarray(g[k]), np.asarray(w[k]))
                for g, w in zip(got_o, got) for k in ("start", "end"))
    row_o = dict(card=card, dir_mb=round(directory_bytes(orbax_dir) / 2**20, 1),
                 write_s=round(write_s, 2), load_s=round(load_o, 2), bit_equal=equal,
                 launches=launches_o)
    print("gnd_served_orbax", json.dumps(row_o), flush=True)
    if not equal or launches_o != launches:
        fail(f"grounding orbax directory served: {row_o}")
    return dict(row, orbax=row_o)


def grounding_train_path(card):
    """Phase 9: the grounding scripts through ``exoground_tpu_torch.train.main``
    on the card, one epoch each over a seeded full-width tree: train_vi.sh,
    train_grounding.sh (its VI encoder the first run's checkpoint; then
    ``--resume`` from its epoch 0 for epoch 1),
    train_joint_model.sh eager, at --fused_steps 4, --amp and --attn_impl
    flash, test_joint_model.sh's --test on the eager joint checkpoint, and
    train_joint_model_lemma.sh; each counted, the replayed joint epoch bit
    for bit the eager one with fresh pos starts every replay; then the card
    against the CPU. Returns the launches by run."""
    import glob
    import os
    import shutil
    import tempfile

    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.parallel import train_step as ts
    from exoground_tpu_torch.tools.profile_main_path import _StepWindow
    from exoground_tpu_torch.tools.synth_egoexo import make_egoexo_tree, make_lemma_tree
    from exoground_tpu_torch.train import main as cli
    from exoground_tpu_torch.train.trainer import epoch_summary

    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="gnd_", dir=build)
    cwd = os.getcwd()
    built, replays = [], []
    real_build, real_replay = cli.build_egoexo, ts._Graph.replay

    def build_spy(cfg, device, mesh=None):
        run = real_build(cfg, device, mesh)
        steps, n = len(run.train_loader), max(cfg.fused_steps, 1)
        start = steps - max(n, (min(GND_PROFILED, steps // 2) // n) * n)
        built.append(dict(cfg=cfg, trainer=run.trainer, steps=steps, start=start,
                          val_batches=len(run.val_loader),
                          window=None if cfg.test else _StepWindow(run.trainer, start,
                                                                   steps - start)))
        return run

    def replay_spy(self, batches, starts, scalars):
        replays.append(np.array(starts))
        return real_replay(self, batches, starts, scalars)

    def run(tag, argv):
        _kernels.reset_launches()
        t0 = time.perf_counter()
        out = cli.main(argv)
        torch.cuda.synchronize()
        rec = built[-1]
        rec.update(tag=tag, out=out, run_s=time.perf_counter() - t0,
                   launches=dict(_kernels.LAUNCHES))
        flash = rec["cfg"].attn_impl == "flash"
        want = {k: 0 for k in _kernels.LAUNCHES}
        if rec["cfg"].model != "view_invariant":
            want["fused_mlp"] = GND_FWD * rec["val_batches"]
            want["fused_mha"] = 0 if flash else GND_FWD * rec["val_batches"]
            if rec["cfg"].feature_dim // 8 > 64:  # 8 heads: the wide bodies behind fused_mha
                gemm = "wgmma_linear" if rec["cfg"].amp else "wgmma_linear_tf32"
                want[gemm], want["wide_window"] = 2 * want["fused_mha"], want["fused_mha"]
        got = dict(rec["launches"])
        if flash:
            if not all(got[k] > 0 for k in ("flash_fwd", "flash_dq", "flash_dkv")):
                fail(f"grounding {tag}: no flash launch in {got}")
            for k in ("flash_fwd", "flash_dq", "flash_dkv"):
                got[k] = 0
        _check_counts(f"grounding {tag}", got, want)
        print(f"grounding {tag}: rows 1/2/4 launches "
              f"{ {k: rec['launches'][k] for k in ('fused_mha', 'fused_mlp', 'flash_fwd', 'flash_dq', 'flash_dkv')} }",
              flush=True)
        return rec

    def bench(rec) -> dict:
        tr, w = rec["trainer"], rec["window"]
        st = tr.epoch_stats[0]
        half = st["steps"] // 2
        stop = rec["start"] if rec["start"] > half else st["steps"]
        rows = int(rec["cfg"].batch_size)
        steady = epoch_summary([dict(samples=rows * (stop - half), step_s=st["step_s"][half:stop],
                                     data_s=st["data_s"][half:stop])])
        out = dict(card=card, run=rec["tag"], steps=st["steps"], batch=rows,
                   samples_per_s=round(epoch_summary([st])["samples_per_s"], 1),
                   steady_samples_per_s=round(steady["samples_per_s"], 1),
                   steady_step_ms_median=round(steady["step_ms_median"], 2),
                   steady_data_share=round(steady["data_share"], 4),
                   val_ms=round(st["val_s"] * 1e3, 1), val_batches=rec["val_batches"],
                   run_s=round(rec["run_s"], 1))
        if w is not None and w.rows is not None:
            busy_s = sum(r[0] for r in w.rows) / 1e6
            out.update(profiled_steps=w.steps,
                       device_busy_ms_a_step=round(busy_s / w.steps * 1e3, 2),
                       device_idle_share=round(1.0 - busy_s / w.wall, 4))
        return out

    cli.build_egoexo, ts._Graph.replay = build_spy, replay_spy
    try:
        t0 = time.perf_counter()
        eg = make_egoexo_tree(os.path.join(work, "egoexo"), GND_TAKES, seconds=GND_SECONDS)
        ej = make_egoexo_tree(os.path.join(work, "egoexo_joint"), GND_JOINT_TAKES,
                              seconds=GND_JOINT_SECONDS, seed=1)
        lm = make_lemma_tree(os.path.join(work, "lemma"), GND_LEMMA, seconds=GND_LEMMA_SECONDS)
        tree_s = time.perf_counter() - t0
        os.chdir(work)
        root, jroot, lroot = ["--data_root", eg], ["--data_root", ej], ["--data_root", lm]
        recs = {"vi": run("vi", GND_SCRIPTS["vi"] + root + ["--prefix", "_vi"])}
        (vi_ckpt,) = glob.glob(os.path.join(work, "log_vi", "*", "model", "epoch0.pth.tar"))
        recs["grounding"] = run("grounding", GND_SCRIPTS["grounding"] + root + [
            "--vi_encoder_path", vi_ckpt, "--prefix", "_gnd"])
        (g0,) = glob.glob(os.path.join(work, "log_gnd", "*", "model", "epoch0.pth.tar"))
        served = served_checkpoint_case(card, recs["grounding"], g0)
        # --feature_dim 1024 (8 heads: head size 128): under --attn_impl flash
        # the steps run row 4's three bodies at D 128 (and its validation
        # forward the flash forward); then --resume from its epoch 0 for a
        # second epoch under 'auto', whose validation runs row 1's wide-head
        # body and row 2 at C 1024 (the resume check rides on it; it ran at
        # width 512 before)
        wide = GND_SCRIPTS["grounding"] + root + ["--vi_encoder_path", vi_ckpt,
                                                  "--feature_dim", "1024"]
        recs["grounding_c1024_flash"] = run("grounding --feature_dim 1024 --attn_impl flash",
                                            wide + ["--attn_impl", "flash", "--prefix", "_g1k"])
        (g1k,) = glob.glob(os.path.join(work, "log_g1k", "*", "model", "epoch0.pth.tar"))
        recs["grounding_resume"] = run("grounding --feature_dim 1024 --resume (auto)",
                                       wide + ["--epochs", "2", "--resume", g1k])
        resumed = recs["grounding_resume"]["trainer"]
        if ([s["epoch"] for s in resumed.epoch_stats] != [1]
                or resumed.iteration != 2 * recs["grounding_c1024_flash"]["steps"]):
            fail(f"grounding --resume: epochs {[s['epoch'] for s in resumed.epoch_stats]}, "
                 f"iteration {resumed.iteration}")
        joint = GND_SCRIPTS["joint"] + jroot
        recs["joint"] = run("joint", joint + ["--prefix", "_j"])
        (j0,) = glob.glob(os.path.join(work, "log_j", "*", "model", "epoch0.pth.tar"))
        replays.clear()
        recs["joint_f4"] = run(f"joint --fused_steps {GRAPH_N}",
                               joint + ["--fused_steps", str(GRAPH_N), "--prefix", "_jf"])
        (jf,) = glob.glob(os.path.join(work, "log_jf", "*", "model", "epoch0.pth.tar"))
        replayed = _ckpt_agreement(jf, j0)
        fresh = len({r.tobytes() for r in replays})
        captures = recs["joint_f4"]["trainer"].fused_step.captures
        print(f"grounding joint --fused_steps {GRAPH_N} vs eager: {replayed}, {len(replays)} "
              f"replays, {fresh} distinct pos-start draws, {captures} capture", flush=True)
        if not (replayed["bit_equal"] and replayed["same_counts"]) or captures != 1 or (
                len(replays) < 2 or fresh < 2):
            fail(f"grounding --fused_steps {GRAPH_N}: {replayed}, {len(replays)} replays, "
                 f"{fresh} distinct starts, {captures} captures")
        recs["joint_amp"] = run("joint --amp", joint + ["--amp", "--prefix", "_ja"])
        recs["joint_flash"] = run("joint --attn_impl flash",
                                  joint + ["--attn_impl", "flash", "--prefix", "_jfl"])
        recs["test"] = run("joint --test", GND_TEST_JOINT + jroot + ["--test", j0])
        res = recs["test"]["out"]
        ranks = sorted(k for k in res if k.startswith("Rank ") and k.endswith("mean IoU"))
        if not ranks or not all(np.isfinite(v) for v in res.values()):
            fail(f"grounding --test: no Rank bins or a non-finite result: {res}")
        print("grounding --test:", {k: round(v, 4) for k, v in res.items()}, flush=True)
        recs["lemma"] = run("lemma joint", GND_SCRIPTS["lemma"] + lroot + ["--prefix", "_lm"])
        for key, rec in recs.items():
            if key != "test" and not np.isfinite(rec["out"]):
                fail(f"grounding {rec['tag']}: best {rec['out']}")
    finally:
        cli.build_egoexo, ts._Graph.replay = real_build, real_replay
        os.chdir(cwd)
    try:
        agreement = gnd_agreement(GND_SCRIPTS["joint"] + jroot)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("gnd_agreement", json.dumps(dict(card=card, **agreement)), flush=True)
    for key, rec in recs.items():
        if key != "test":
            print("gnd_bench", json.dumps(bench(rec)), flush=True)
    print("gnd_phase", json.dumps(dict(
        card=card, tree_s=round(tree_s, 1), test_s=round(recs["test"]["run_s"], 1),
        replayed_vs_eager=dict(bit_equal=replayed["bit_equal"], replays=len(replays),
                               distinct_starts=fresh), served_checkpoint_rel=served["rel_err"],
        phase_s=round(time.perf_counter() - t_phase, 1))), flush=True)
    return {rec["tag"]: rec["launches"] for rec in recs.values()}


# ---------------------------------------------------------------- phase 10
# The inference front at the TAN configuration phase 8 trains: TemporalAligner
# E6D6 width 512, 8 heads, 512-d S3D video and 512-d text, the output of the
# word2vec tower at the MIL-NCE text module's shapes (66,249 words x 300 ->
# 2,048 -> 512; a sentence 32 words). Raw texts go through the tokenizer and
# the tower on the card, then the aligner (12 fused MHA + 12 fused MLP a group
# while the joint S <= 128); the HTTP front answers /align, /align_batch,
# /ground and /ground_batch (phase 7's model under 'auto': 24 + 24 a
# forward); YouCook2 retrieval runs the reference's protocol (10 clips an
# item, adaptive windows of 32-256 tokens, seq_len 64) over a seeded tree of
# 128 videos of 200-600 s (half-val: 64), the dual video tower once an item
# (6 fused MLP, and 6 fused MHA where a clip is <= 128 tokens).
FRONT_LAYERS, FRONT_VOCAB, FRONT_TOWER = 6, 66249, (300, 2048)  # tower: embedding, hidden
FRONT_TEXTS, FRONT_CLIENTS = 64, 8
# timed windows (after the counted and checked runs): raw-text align()
# requests, serial /align requests on one connection, /align requests each
# concurrent client sends on its own keep-alive connection
FRONT_RAW_TIMED, FRONT_SERIAL, FRONT_PER_CLIENT = 128, 400, 40
YC2_VIDEOS, YC2_CLIPS, YC2_SEQ, YC2_CHECKED = 128, 10, 64, 16


def _front_aligner():
    """The phase-8 aligner (512-d video and text), seeded, on the CPU."""
    from exoground_tpu_torch.models import TemporalAligner

    torch.manual_seed(0)
    return TemporalAligner(num_encoder_layers=FRONT_LAYERS, num_joint_layers=FRONT_LAYERS,
                           width=512, heads=8, video_dim=512, text_dim=512, device="cpu")


def _answers_agree(label, got, want, ev, video, te, start, end, tol=1e-4):
    """``got`` and ``want`` (align()-shaped answers to one request) through
    ``_card_vs_cpu`` on ``ev``'s canvas of the request's evaluator item (in
    the evaluator's order: sorted by midpoint with timestamps); align_score
    within ``tol`` of max|want| too."""
    from exoground_tpu_torch.serve import _request_item

    item, order = _request_item(video, np.asarray(te, np.float32), start, end)
    perm = [{k: np.asarray(a[k])[order] for k in ("best_second", "score")}
            for a in (got, want)]
    _card_vs_cpu(label, perm[0], perm[1], ev, ev._cfg_for(start is None), item, tol)
    a, b = np.asarray(got["align_score"]), np.asarray(want["align_score"])
    if not np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30):
        fail(f"{label}: align_score differs by {np.abs(a - b).max():.3e}")


def _clear_texts(ev, video, te, tol):
    """Of a request without timestamps, the texts whose top-2 margin in
    ``ev``'s canvas clears ``tol`` (absolute): where ``_card_vs_cpu`` holds
    best_second equal."""
    from exoground_tpu_torch.evals.align_fused import _placed_plan
    from exoground_tpu_torch.serve import _request_item

    item, _ = _request_item(video, np.asarray(te, np.float32), None, None)  # request order
    cfg = ev._cfg_for(True)
    (_, dims, args, _), = list(_placed_plan([item], cfg, ev.device))
    _, canvas = ev._process(cfg, dims, args)
    top2 = torch.topk(canvas[:len(te), :len(video)], 2, dim=-1).values.float().cpu().numpy()
    return top2[:, 0] - top2[:, 1] > tol


def _group_spy(svc):
    """Record the joint S of every group ``svc``'s evaluator runs and every
    query-batch handle it preloads; returns (groups, handles, undo)."""
    ev = svc._evaluator
    groups, handles = [], []
    inner, inner_pq = ev._process, ev.preload_queries

    def process(cfg, dims, host_args):
        groups.append(dims[1] + host_args[6].shape[1])  # seq_len + Npad (text_idx)
        return inner(cfg, dims, host_args)

    def preload_queries(*a, **k):
        handles.append(inner_pq(*a, **k))
        return handles[-1]

    ev._process, ev.preload_queries = process, preload_queries

    def undo():
        ev._process, ev.preload_queries = inner, inner_pq
    return groups, handles, undo


def _align_expect(groups, handles, n_queries):
    """fused MHA / MLP launches of ``groups`` (joint S each) and of the query
    handles (``n_queries`` batches each; ``_expect``): per group 6 dual + 6
    joint MHA (the joint tower while S <= 128) and 12 MLP."""
    mha = sum(6 + (6 if s <= 128 else 0) for s in groups)
    mlp = 12 * len(groups)
    for pq, q in zip(handles, n_queries):
        want = _expect(pq, q, False)
        mha, mlp = mha + want["fused_mha"], mlp + want["fused_mlp"]
    return mha, mlp


def _http(conn, path, arrays, status=200):
    """POST ``arrays`` (a dict, sent as npz, or the npz bytes) on the open
    connection; the JSON answer. Any other status than ``status`` fails with
    the body."""
    from exoground_tpu_torch.serve import _encode_npz

    conn.request("POST", path, arrays if isinstance(arrays, bytes) else _encode_npz(arrays))
    resp = conn.getresponse()
    body = resp.read()
    if resp.status != status:
        fail(f"POST {path}: HTTP {resp.status} (want {status}): {body[:2000]!r}")
    return json.loads(body)


def inference_front_path(card):
    """Phase 10: raw-text alignment serving, the HTTP front and YouCook2
    retrieval on the card, each counted; the card against the CPU. Returns
    the fused MHA / MLP launches by path."""
    import http.client
    import os
    import shutil
    import tempfile

    from exoground_tpu_torch import serve as serve_mod
    from exoground_tpu_torch.data import FeatureStore, YouCook2Config, YouCook2Dataset
    from exoground_tpu_torch.evals.bench_items import (
        GROUNDING, make_grounding_params, make_grounding_requests)
    from exoground_tpu_torch.evals.retrieval import test_retrieval_yc2
    from exoground_tpu_torch.models import GroundingModel
    from exoground_tpu_torch.models.word2vec import Word2VecModel, Word2VecTokenizer
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.serve import (
        AlignmentService, AlignRequest, GroundingService, serve_http)
    from exoground_tpu_torch.tools.synth_yc2 import make_yc2_tree, sentence
    from exoground_tpu_torch.utils.convert import (
        convert_word2vec_from_s3d, load_grounding_params, load_torch_checkpoint)

    t_phase = time.perf_counter()
    out = {}
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="yc2_", dir=build)
    try:
        t0 = time.perf_counter()
        root = make_yc2_tree(os.path.join(work, "yc2"), n_videos=YC2_VIDEOS, dim=512,
                             vocab=FRONT_VOCAB, embed_dim=FRONT_TOWER[0],
                             hidden=FRONT_TOWER[1], out_dim=512, seed=0)
        tree_s = time.perf_counter() - t0
        tower_params = convert_word2vec_from_s3d(
            load_torch_checkpoint(os.path.join(root, "s3d_howto100m.pth")))
        tok = Word2VecTokenizer.from_dict_file(os.path.join(root, "s3d_dict.npy"), max_words=32)
        towers = {d: Word2VecModel(tower_params, device=d) for d in ("cuda", "cpu")}
        model = _front_aligner()
        svc = AlignmentService(model, tokenizer=tok, text_tower=towers["cuda"], device="cuda")
        cpu_svc = AlignmentService(model, tokenizer=tok, text_tower=towers["cpu"], device="cpu")
        print(f"front: YouCook2 tree of {YC2_VIDEOS} videos and the tower ({FRONT_VOCAB} words x "
              f"{FRONT_TOWER[0]} -> {FRONT_TOWER[1]} -> 512) written in {tree_s:.1f} s",
              flush=True)

        # 1. raw texts: 64 sentences of a ~300 s video, with and without
        # timestamps, card vs CPU; raw == the tower's embeddings on the card
        rng = np.random.RandomState(10)
        reqs = []
        for vlen in (300, 284):
            texts = [sentence(rng, FRONT_VOCAB) for _ in range(FRONT_TEXTS)]
            texts[3] = "zzz qqq"  # no known word: the tower pools every position
            video = rng.standard_normal((vlen, 512)).astype(np.float32)
            centers = rng.rand(FRONT_TEXTS) * (vlen - 8) + 4
            start, end = np.maximum(centers - 4, 0), np.minimum(centers + 4, vlen)
            reqs += [AlignRequest(video=video, texts=texts),
                     AlignRequest(video=video, texts=texts, start=start, end=end)]
        svc.align(reqs[0])  # warm-up
        groups, handles, undo = _group_spy(svc)
        _kernels.reset_launches()
        t0 = time.perf_counter()
        gpu = [svc.align(r) for r in reqs]
        torch.cuda.synchronize()
        raw_s = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        undo()
        mha, mlp = _align_expect(groups, [], [])
        _check_counts("front raw-text align", {k: launches[k] for k in ("fused_mha", "fused_mlp")},
                      {"fused_mha": mha, "fused_mlp": mlp})
        out["raw-text align (phase 10)"] = {"fused_mha": mha, "fused_mlp": mlp}
        print(f"front raw-text align: {len(reqs)} requests of {FRONT_TEXTS} texts, "
              f"{len(groups)} groups (joint S {groups}), {raw_s * 1e3:.1f} ms, launches "
              f"{launches}", flush=True)
        raw_lat = []
        for i in range(FRONT_RAW_TIMED):  # the four requests in turn
            t0 = time.perf_counter()
            svc.align(reqs[i % len(reqs)])
            raw_lat.append(time.perf_counter() - t0)
        print("front_raw_bench", json.dumps(dict(
            requests=FRONT_RAW_TIMED, texts=FRONT_TEXTS, s=sum(raw_lat),
            mean_ms=sum(raw_lat) / len(raw_lat) * 1e3,
            p50_ms=float(np.percentile(raw_lat, 50)) * 1e3,
            p90_ms=float(np.percentile(raw_lat, 90)) * 1e3, card=card)), flush=True)
        t0 = time.perf_counter()
        cpu = [cpu_svc.align(r) for r in reqs]
        cpu_s = time.perf_counter() - t0
        for i, (r, g, c) in enumerate(zip(reqs, gpu, cpu)):
            te = cpu_svc._embed_texts(r.texts)
            _answers_agree(f"front raw-text align {i} card vs CPU (CPU {cpu_s:.1f} s)", g, c,
                           cpu_svc._evaluator, r.video, te, r.start, r.end)
            tower_err = float(np.abs(svc._embed_texts(r.texts) - te).max() / np.abs(te).max())
            same = svc.align(AlignRequest(video=r.video, text_embeds=svc._embed_texts(r.texts),
                                          start=r.start, end=r.end))
            print(f"front raw-text align {i}: the tower card vs CPU {tower_err:.3e} of max|CPU|, "
                  f"raw texts == their embeddings on the card: {same == g}", flush=True)
            if same != g or not tower_err <= 1e-4:
                fail(f"front raw-text align {i}: raw texts != their embeddings on the card, or "
                     f"the tower differs from the CPU's by {tower_err:.3e}")
        # align_batch_requests with 'texts' entries: 2 batches over 2 videos
        videos = [reqs[0].video, reqs[2].video]
        batches = [[{"texts": r.texts, "start": r.start, "end": r.end}
                    for r in (reqs[1 + 2 * b], reqs[3 - 2 * b])] for b in range(2)]
        batches[1] = [dict(e, texts=list(reversed(e["texts"])), start=e["start"][::-1],
                           end=e["end"][::-1]) for e in batches[1]]
        groups, handles, undo = _group_spy(svc)
        _kernels.reset_launches()
        got = svc.align_batch_requests(videos, batches)
        torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
        undo()
        mha, mlp = _align_expect(groups, handles, [len(batches)])
        _check_counts("front align_batch_requests", {k: launches[k] for k in
                                                     ("fused_mha", "fused_mlp")},
                      {"fused_mha": mha, "fused_mlp": mlp})
        out["raw-text align_batch_requests (phase 10)"] = {"fused_mha": mha, "fused_mlp": mlp}
        want = cpu_svc.align_batch_requests(videos, batches)
        for b, batch in enumerate(batches):
            for v, e in enumerate(batch):
                _answers_agree(f"front align_batch_requests [{b}][{v}] card vs CPU", got[b][v],
                               want[b][v], cpu_svc._evaluator, videos[v],
                               cpu_svc._embed_texts(e["texts"]), e["start"], e["end"])

        # 2. the HTTP front over loopback
        gmodel = GroundingModel(**GROUNDING, device="cpu")  # phase 7's, under 'auto'
        load_grounding_params(gmodel, make_grounding_params(0))
        gsvc = GroundingService(gmodel, device="cuda")
        greqs = make_grounding_requests(1, 8)
        server = serve_http(align_service=svc, ground_service=gsvc, host="127.0.0.1", port=0,
                            block=False)
        port = server.server_address[1]
        try:
            te = [svc._embed_texts(r.texts) for r in reqs]
            r0 = reqs[1]
            align_arrays = {"video": r0.video, "text_embed": te[1], "start": r0.start,
                            "end": r0.end}
            batch_arrays = {f"video_{j}": v for j, v in enumerate(videos)}
            batch_direct = []
            for i in range(2):
                row = []
                for j, r in enumerate((reqs[1 + 2 * i], reqs[3 - 2 * i])):
                    batch_arrays.update({f"text_embed_{i}_{j}": te[1 + 2 * i] if j == 0
                                         else te[3 - 2 * i], f"start_{i}_{j}": r.start,
                                         f"end_{i}_{j}": r.end})
                    row.append({"text_embeds": batch_arrays[f"text_embed_{i}_{j}"],
                                "start": r.start, "end": r.end})
                batch_direct.append(row)
            ground_arrays = {"video": greqs[0]["video"], "narration": greqs[0]["narration_embeds"]}
            gb_arrays = {}
            for i, r in enumerate(greqs):
                gb_arrays.update({f"video_{i}": r["video"], f"narration_{i}": r["narration_embeds"]})
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            _http(conn, "/align", align_arrays)  # warm-up
            groups, handles, undo = _group_spy(svc)
            forwards = []
            run = gsvc._run
            gsvc._run = lambda *a: forwards.append(a[1]) or run(*a)
            _kernels.reset_launches()
            answers = {"/align": _http(conn, "/align", align_arrays),
                       "/align_batch": _http(conn, "/align_batch", batch_arrays),
                       "/ground": _http(conn, "/ground", ground_arrays),
                       "/ground_batch": _http(conn, "/ground_batch", gb_arrays)}
            torch.cuda.synchronize()
            launches = dict(_kernels.LAUNCHES)
            undo()
            gsvc._run = run
            mha, mlp = _align_expect(groups, handles, [2])
            gfwd = {k: GROUND_LAUNCHES["auto"][k] * len(forwards) for k in ("fused_mha", "fused_mlp")}
            _check_counts("front HTTP routes", {k: launches[k] for k in ("fused_mha", "fused_mlp")},
                          {"fused_mha": mha + gfwd["fused_mha"], "fused_mlp": mlp + gfwd["fused_mlp"]})
            out["HTTP front, 4 routes (phase 10)"] = {"fused_mha": mha + gfwd["fused_mha"],
                                                      "fused_mlp": mlp + gfwd["fused_mlp"]}
            direct = {
                "/align": svc.align(AlignRequest(video=r0.video, text_embeds=te[1],
                                                 start=r0.start, end=r0.end)),
                "/align_batch": {"batches": svc.align_batch_requests(videos, batch_direct)},
                "/ground": gsvc.ground(greqs[0]["video"], greqs[0]["narration_embeds"]),
                "/ground_batch": {"requests": gsvc.ground_batch(greqs)}}
            for path, ans in answers.items():
                if ans != direct[path]:
                    fail(f"HTTP {path} answers differently from the direct call on the card")
            print(f"front HTTP: /align, /align_batch, /ground, /ground_batch over one keep-alive "
                  f"connection equal the direct calls; {len(groups)} groups, {len(forwards)} "
                  f"grounding forwards, launches {launches}", flush=True)

            # /align latency over loopback, serial, with the npz decode share
            decode_s = []
            real_decode = serve_mod._decode_npz

            def timed_decode(blob):
                t = time.perf_counter()
                arrays = real_decode(blob)
                decode_s.append(time.perf_counter() - t)
                return arrays

            serve_mod._decode_npz = timed_decode
            t = time.perf_counter()
            body = serve_mod._encode_npz(align_arrays)  # the client's side, once
            encode_s = time.perf_counter() - t
            lat = []
            t_all = time.perf_counter()
            try:
                for _ in range(FRONT_SERIAL):
                    t = time.perf_counter()
                    _http(conn, "/align", body)
                    lat.append(time.perf_counter() - t)
            finally:
                serve_mod._decode_npz = real_decode
            wall = time.perf_counter() - t_all
            conn.close()

            # 8 concurrent /align clients (no timestamps), each its own
            # request: one burst against the serial answers, then each
            # client sends FRONT_PER_CLIENT more on its connection (timed,
            # every answer held to its serial one)
            crng = np.random.RandomState(11)
            creqs = []
            for c in range(FRONT_CLIENTS):
                vlen = int(crng.randint(200, 320))
                creqs.append({"video": crng.standard_normal((vlen, 512)).astype(np.float32),
                              "text_embed": te[c % len(te)][:int(crng.randint(16, 65))]})
            bodies = [serve_mod._encode_npz(r) for r in creqs]
            serial = []
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            for b in bodies:
                serial.append(_http(conn, "/align", b))
            conn.close()
            burst = [None] * FRONT_CLIENTS
            sustained = [[] for _ in range(FRONT_CLIENTS)]
            clat = [[] for _ in range(FRONT_CLIENTS)]
            barrier = threading.Barrier(FRONT_CLIENTS, timeout=600)
            window, ends = [None], [None] * FRONT_CLIENTS

            def client(i):
                c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
                try:
                    barrier.wait()
                    burst[i] = _http(c, "/align", bodies[i])
                    if barrier.wait() == 0:
                        window[0] = time.perf_counter()
                    barrier.wait()
                    for _ in range(FRONT_PER_CLIENT):
                        t = time.perf_counter()
                        sustained[i].append(_http(c, "/align", bodies[i]))
                        clat[i].append(time.perf_counter() - t)
                    ends[i] = time.perf_counter()
                except BaseException:
                    barrier.abort()  # no other client waits on this one
                    raise
                finally:
                    c.close()

            threads = [threading.Thread(target=client, args=(i,)) for i in range(FRONT_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            if any(a is None for a in burst) or any(len(a) != FRONT_PER_CLIENT for a in sustained):
                fail("concurrent /align clients did not all get their answers")
            exact = sum(a == b for a, b in zip(burst, serial))
            for i, (a, b) in enumerate(zip(burst, serial)):
                _answers_agree(f"front concurrent /align {i} vs serial", a, b, svc._evaluator,
                               creqs[i]["video"], creqs[i]["text_embed"], None, None)
                # the sustained answers as _answers_agree holds the burst's
                tol = 1e-4 * np.abs(np.asarray(b["score"])).max()
                clear = _clear_texts(svc._evaluator, creqs[i]["video"], creqs[i]["text_embed"],
                                     tol)
                for got in sustained[i]:
                    for k in ("score", "align_score"):
                        g, w = np.asarray(got[k]), np.asarray(b[k])
                        if not np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30):
                            fail(f"front concurrent /align {i}: a sustained answer's {k} "
                                 f"differs from serial by {np.abs(g - w).max():.3e}")
                    same = np.asarray(got["best_second"]) == np.asarray(b["best_second"])
                    if not same[clear].all():
                        fail(f"front concurrent /align {i}: a sustained answer's best_second "
                             f"differs from serial where the top-2 margin clears {tol:.2e}")
            conc_lat = [t for c in clat for t in c]
            conc_s = max(ends) - window[0]
        finally:
            server.shutdown()
            server.server_close()
        http_bench = dict(
            requests=len(lat), texts=FRONT_TEXTS, frames=len(r0.video),
            requests_per_s=len(lat) / wall, p50_ms=float(np.percentile(lat, 50)) * 1e3,
            p99_ms=float(np.percentile(lat, 99)) * 1e3, npz_decode_share=sum(decode_s) / wall,
            npz_decode_ms=float(np.median(decode_s)) * 1e3, body_kb=len(body) / 1024,
            client_encode_ms=encode_s * 1e3,
            concurrent=dict(clients=FRONT_CLIENTS, requests=len(conc_lat),
                            s=conc_s, requests_per_s=len(conc_lat) / conc_s,
                            p50_ms=float(np.percentile(conc_lat, 50)) * 1e3,
                            p99_ms=float(np.percentile(conc_lat, 99)) * 1e3,
                            burst_exact=exact), card=card)
        print("front_http_bench", json.dumps(http_bench), flush=True)

        # 3. YouCook2 retrieval, raw sentences through the tower
        with open(os.path.join(root, "youcookii_annotations.json")) as f:
            anno = json.load(f)["database"]
        ds = YouCook2Dataset(YouCook2Config(num_clips=YC2_CLIPS, seq_len=-1),
                             FeatureStore(os.path.join(root, "features"), suffixes=(".pth.tar",)),
                             anno)
        gpu_model = svc._evaluator._model
        lengths = []

        def closures(m, tower, dev, record=False, memo=None):
            def visual(clips, mask, interp):
                if record:
                    lengths.append(clips.shape[1])
                key = (clips.tobytes(), interp)
                if memo is not None and key in memo:
                    return memo[key]
                with torch.inference_mode():
                    feats = m.get_visual_feature(torch.from_numpy(clips).to(dev),
                                                 torch.from_numpy(mask).to(dev),
                                                 interpolate_from=interp)
                    feats = feats[:, -1].float().cpu().numpy()  # the last stage
                if memo is not None:  # the CPU side computes each item once
                    memo[key] = feats
                return feats

            def text(lang):
                with torch.inference_mode():
                    return m.get_textual_feature(torch.from_numpy(lang).to(dev)).float().cpu().numpy()

            def embed(strs):
                enc = tok(strs)
                return tower(enc["input_ids"], attention_mask=enc["attention_mask"])[
                    "pooler_output"].float().cpu().numpy()
            return visual, text, embed

        gv, gt, ge = closures(gpu_model, towers["cuda"], "cuda", record=True)
        test_retrieval_yc2([ds[i] for i in range(4)], gv, gt, ge, seq_len=YC2_SEQ)  # warm-up
        lengths.clear()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        metrics = test_retrieval_yc2(ds, gv, gt, ge, seq_len=YC2_SEQ)  # items read as it goes
        torch.cuda.synchronize()
        yc2_s = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        short = sum(n <= 128 for n in lengths)
        want = {"fused_mha": 6 * short, "fused_mlp": 6 * len(lengths)}
        if len(lengths) != len(ds):
            fail(f"YouCook2: {len(lengths)} tower calls for {len(ds)} items")
        _check_counts("front YouCook2", {k: launches[k] for k in ("fused_mha", "fused_mlp")}, want)
        out["YouCook2 retrieval (phase 10)"] = want
        # 16 items spread over the window lengths: the card's features and
        # metrics against the CPU model's
        order = np.argsort(lengths, kind="stable")
        picked = [ds[int(i)] for i in order[np.linspace(0, len(ds) - 1, YC2_CHECKED).astype(int)]]
        cv, ct, ce = closures(model.eval(), towers["cpu"], "cpu", memo={})
        v_err = t_err = 0.0
        for it in picked:
            interp = YC2_SEQ if it["video"].shape[1] >= YC2_SEQ else None
            mask = np.zeros(it["video"].shape[:2], bool)
            want_v = cv(it["video"], mask, interp)
            v_err = max(v_err, float(np.abs(gv(it["video"], mask, interp) - want_v).max()
                                     / np.abs(want_v).max()))
            want_t = ct(ce([it["str"]]))
            t_err = max(t_err, float(np.abs(gt(ge([it["str"]])) - want_t).max()
                                     / np.abs(want_t).max()))
        m_gpu = test_retrieval_yc2(picked, gv, gt, ge, seq_len=YC2_SEQ)
        m_cpu = test_retrieval_yc2(picked, cv, ct, ce, seq_len=YC2_SEQ)
        lens = sorted(it["video"].shape[1] for it in picked)
        print(f"front YouCook2 card vs CPU on {len(picked)} items (windows {lens}): video features "
              f"rel err {v_err:.3e}, text features {t_err:.3e}, metrics equal "
              f"{m_gpu == m_cpu}", flush=True)
        if not (v_err <= 1e-4 and t_err <= 1e-4 and m_gpu == m_cpu):
            fail(f"YouCook2: the card disagrees with the CPU ({m_gpu} vs {m_cpu})")
        if not all(np.isfinite(v) for v in metrics.values()):
            fail(f"YouCook2 metrics not finite: {metrics}")
        yc2_bench = dict(videos=len({i["vid"] for i in ds.video_info}), items=len(ds),
                         clips=YC2_CLIPS, windows_le_128=short, windows_max=max(lengths),
                         s=yc2_s, items_per_s=len(ds) / yc2_s, metrics=metrics,
                         launches={k: launches[k] for k in ("fused_mha", "fused_mlp")}, card=card)
        print("front_yc2_bench", json.dumps(yc2_bench), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("front_phase", json.dumps(dict(phase_s=round(time.perf_counter() - t_phase, 1),
                                         launches=out)), flush=True)
    return out


# ---------------------------------------------------------------- phase 11
# Data parallelism on the one card. The grid kernel at the shapes gathered
# negatives give it: Cc = W x B x N text columns (W 2 and 4 ranks of B 64 at
# the text bucket 32: 4,096 and 8,192) against R = B x T = 4,096 video rows
# at width 512, 6 stages; tan_loss at each rank's column offset r x B with
# the gathered padding mask; phase 8's command line in a world-1 NCCL group
# (python -m torch.distributed.run --standalone --nproc_per_node 1), eager
# and at --fused_steps 4 with --multihost, each against the same run without
# a group (in this process) bit for bit; the alignment service at
# eval_devices=2; the step's collectives and the re-capture vote timed apart
# in a world-1 NCCL group of this process.
DP_B, DP_N, DP_T, DP_S, DP_C = 64, 32, 64, 6, 512
DP_WORLDS = (2, 4)
DP_EPOCHS = 1  # eager: 8 train steps and one validation batch a run
DP_F4_EPOCHS = 2  # --fused_steps 4: 16 steps, 4 groups, the last 3 replays
GRAPH_BENCH = {}  # phase 5b's graph_bench lines by case


def dp_loss_case(world, dtype, seed):
    """tan_loss on rank r's block for each r < ``world``: its features, the
    gathered text of every rank, the gathered padding mask and column offset
    r x B, on the grid kernel and on its plain version; the loss and the
    grads of the rank's video features and of the gathered text (the
    rank's gradient before the reduce-scatter) must agree."""
    from exoground_tpu_torch.losses.milnce import TANLossConfig, set_grid_impl, tan_loss
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.ops.masks import PAD_END, PAD_START

    rng = np.random.RandomState(seed)
    b, n, t, s, c = DP_B, DP_N, DP_T, DP_S, DP_C
    bc = world * b
    cfg = TANLossConfig(**{k: bool(v) if k in ("learn_agreement", "use_alignability_head")
                           else v for k, v in BENCH_TRAIN.items()
                           if k in ("model", "learn_agreement", "temporal_agreement_type",
                                    "loss_threshold", "use_alignability_head")})

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def unit(*shape):  # drawn on the card: ~10^8 numbers a case
        x = torch.randn(shape, generator=gen, device="cuda")
        return (x / x.norm(dim=-1, keepdim=True)).to(dtype)

    lengths = rng.randint(4, n + 1, bc)
    col_pad = np.arange(n)[None, :] >= lengths[:, None]  # (Bc, N): most columns padding
    text_d, text_j = unit(bc, n, c), unit(bc, s, n, c)
    cases = []
    for r in range(world):
        pad = col_pad[r * b:(r + 1) * b]
        start = rng.randint(0, t - 8, (b, n)).astype(np.float32)
        end = start + rng.randint(2, 8, (b, n))
        start[pad], end[pad] = PAD_START, PAD_END
        host = dict(start=start, end=end, text_padding_mask=pad,
                    video_padding_mask=np.zeros((b, t), bool),
                    abs_text_pos=np.stack([start / t, end / t], -1).astype(np.float32))
        dev = {k: torch.tensor(v, device="cuda") for k, v in host.items()}
        feats = dict(dual_feature_video=unit(b, s, t, c), joint_feature_video=unit(b, s, t, c),
                     **{f"ema-{k}": v for k, v in dict(
                         dual_feature_video=unit(b, s, t, c), dual_feature_text=unit(b, n, c),
                         joint_feature_video=unit(b, s, t, c),
                         joint_feature_text=unit(b, s, n, c)).items()},
                     dual_logits_alignability=torch.randn((b, n, 1), generator=gen,
                                                          device="cuda"),
                     joint_logits_alignability=torch.randn((b, s, n, 1), generator=gen,
                                                           device="cuda"))
        col_mask = torch.tensor(col_pad, device="cuda")
        outs, ms = {}, {}
        for impl in ("kernel", "plain"):
            set_grid_impl(impl)
            leaves = dict(video_d=feats["dual_feature_video"].clone().requires_grad_(),
                          video_j=feats["joint_feature_video"].clone().requires_grad_(),
                          text_d=text_d.clone().requires_grad_(),
                          text_j=text_j.clone().requires_grad_())

            def run():
                logits = dict(feats, dual_feature_video=leaves["video_d"],
                              joint_feature_video=leaves["video_j"],
                              dual_feature_text=leaves["text_d"],
                              joint_feature_text=leaves["text_j"])
                ld = tan_loss(dev["start"], dev["end"], logits, dev["video_padding_mask"],
                              dev["text_padding_mask"], cfg, abs_text_pos=dev["abs_text_pos"],
                              col_text_padding_mask=col_mask, col_offset=r * b)
                grads = torch.autograd.grad(ld["loss"], list(leaves.values()))
                return ld["loss"], grads

            n0 = dict(_kernels.LAUNCHES)
            loss, grads = run()
            torch.cuda.synchronize()
            fired = (_kernels.LAUNCHES["milnce_grid_fwd"] - n0["milnce_grid_fwd"],
                     _kernels.LAUNCHES["milnce_grid_bwd"] - n0["milnce_grid_bwd"])
            if fired != ((2, 2) if impl == "kernel" else (0, 0)):
                fail(f"tan_loss at col_offset {r * b} ({impl}): grid launches {fired}")
            outs[impl] = (loss.detach(), [g.detach() for g in grads])
            ms[impl] = time_ms(run, warmup=1, reps=3)
        set_grid_impl("auto")
        (kl, kg), (pl, pg) = outs["kernel"], outs["plain"]
        if not (torch.isfinite(kl) and all(torch.isfinite(g).all() for g in kg)):
            fail(f"tan_loss at col_offset {r * b}: non-finite loss or grads")
        errs = {"loss": abs(kl.item() - pl.item()) / max(abs(pl.item()), 1e-30)}
        for name, g, w in zip(leaves, kg, pg):
            errs[f"d_{name}"] = ((g.float() - w.float()).abs().max()
                                 / w.float().abs().max().clamp_min(1e-30)).item()
        case = dict(world=world, rank=r, col_offset=r * b, shape=f"B{b} S{s} T{t} Bc{bc} N{n} C{c}",
                    dtype=str(dtype).split(".")[-1], loss=kl.item(),
                    rel_err={k: float(f"{v:.3g}") for k, v in errs.items()},
                    kernel_ms=round(ms["kernel"], 3), plain_ms=round(ms["plain"], 3))
        print("dp_loss", json.dumps(case), flush=True)
        if not max(errs.values()) <= TOL[dtype]:
            fail(f"tan_loss on the grid kernel disagrees with its plain version: {case}")
        cases.append(case)
        del feats, outs, leaves
    torch.cuda.empty_cache()
    return cases


def _dp_run(argv, work, label, launcher):
    """One command-line run: under ``launcher`` (the interpreter's arguments
    before ``-m exoground_tpu_torch.train.main``) in a subprocess, or with
    ``launcher`` None in this process, its counters set to 0 first; returns
    its ``run_summary`` and seconds."""
    import contextlib
    import os

    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.parallel import collectives
    from exoground_tpu_torch.train import main as cli

    t0 = time.perf_counter()
    if launcher is None:
        _kernels.reset_launches()
        collectives.reset()
        out, cwd = io.StringIO(), os.getcwd()
        os.chdir(work)  # set_path writes log<prefix>/ under the cwd
        try:
            with contextlib.redirect_stdout(out):
                cli.main(argv)
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
        stdout = out.getvalue()
    else:
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run([sys.executable] + launcher
                              + ["-m", "exoground_tpu_torch.train.main"] + argv, cwd=work,
                              env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"dp {label}: rc {proc.returncode}\n{proc.stdout[-3000:]}\n"
                 f"{proc.stderr[-6000:]}")
        stdout = proc.stdout
    secs = time.perf_counter() - t0
    lines = [ln for ln in stdout.splitlines() if ln.startswith("run_summary ")]
    if len(lines) != 1:
        fail(f"dp {label}: {len(lines)} run_summary lines\n{stdout[-3000:]}")
    return json.loads(lines[0][len("run_summary "):]), secs


def _dp_expect(steps, val_batches, replays):
    """The collectives of a world-1 NCCL command-line run under
    --gather_negatives (cotrain, fused grid): the timestamp and the
    replicated state (one float32 broadcast); a train step gathers the dual
    and joint text features and the padding mask, reduce-scatters the two
    text gradients and all-reduces grads and metrics in one buffer; a
    validation batch all-reduces its weighted sums; a replay first agrees
    on re-capture (one all-reduce)."""
    return dict(all_reduce=steps + val_batches + replays, all_gather=3 * steps,
                reduce_scatter=2 * steps, broadcast=2, ppermute=0)


def dp_collectives_case(n_grad):
    """The collectives of one replayed --gather_negatives step, timed apart
    in a world-1 NCCL group of this process (CUDA events, median of 10):
    the all-reduce of the flat float32 grads (``n_grad``) and metrics, the
    gathers of the dual and joint text features and the padding mask, the
    reduce-scatters of the two text gradients (phase 8's shapes: B64, N32,
    S6, width 512, float32); and the re-capture vote on the host (gloo, as
    the step votes) beside the same vote on the card (an all-reduce there
    and ``.item()``), host ms, median of 200."""
    import torch.distributed as dist

    from exoground_tpu_torch.parallel import collectives
    from exoground_tpu_torch.parallel.mesh import free_port, make_mesh

    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = make_mesh(device=dev)
        if mesh.backend != "nccl":
            fail(f"dp collectives: backend {mesh.backend}")
        b, n, s, c = DP_B, DP_N, DP_S, DP_C
        grads = torch.randn(n_grad + 16, device=dev)
        text_d, text_j = torch.randn(b, n, c, device=dev), torch.randn(b, s, n, c, device=dev)
        mask = torch.zeros(b, n, dtype=torch.uint8, device=dev)
        out = {"all_reduce grads": time_ms(lambda: dist.all_reduce(grads))}
        for name, x in (("all_gather dual text", text_d), ("all_gather joint text", text_j),
                        ("all_gather mask", mask)):
            y = torch.empty_like(x)
            out[name] = time_ms(lambda x=x, y=y: dist.all_gather_into_tensor(y, x))
        for name, x in (("reduce_scatter dual text", text_d),
                        ("reduce_scatter joint text", text_j)):
            y = torch.empty_like(x)
            out[name] = time_ms(lambda x=x, y=y: dist.reduce_scatter_tensor(y, x))
        out["device sum"] = sum(out.values())

        def host_ms(fn, reps=200):
            fn()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ts)

        def card_vote():
            t = torch.tensor([0], dtype=torch.int32, device=dev)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            return bool(t.item())

        out["vote on the host (gloo), host ms"] = host_ms(
            lambda: collectives.any_rank(False, mesh))
        out["vote on the card, host ms"] = host_ms(card_vote)
    finally:
        dist.destroy_process_group()
    print("dp_collectives", json.dumps(out), flush=True)
    return out


def dp_path(card):
    """Phase 11: data parallelism on the card (see the section's comment).
    Returns (the grid cases, tan_loss cases, the kernel launches by run)."""
    import glob
    import os
    import shutil
    import tempfile

    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.serve import AlignmentService, AlignRequest
    from exoground_tpu_torch.tools.synth_htm import make_htm_tree

    t_phase = time.perf_counter()
    grid_cases, loss_cases = [], []
    for dtype in (torch.float32, torch.bfloat16):
        for w in DP_WORLDS:
            cc = w * DP_B * DP_N
            # most columns padding, as the text bucket gives them; the widest
            # (W 4) timed
            timed = w == DP_WORLDS[-1]
            grid_cases.append(grid_case(DP_S, DP_B * DP_T, cc, DP_C, DP_S, dtype, seed=60 + w,
                                        n_invalid=cc // 2, timed=timed))
            grid_cases.append(grid_case(DP_S, DP_B * DP_T, cc, DP_C, 1, dtype, seed=70 + w,
                                        n_invalid=cc // 2, timed=timed))
        loss_cases += dp_loss_case(DP_WORLDS[-1], dtype, seed=80)
    t_kernels = time.perf_counter() - t_phase

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="dp_", dir=build)
    torchrun = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1"]
    runs, secs = {}, {}
    try:
        root = make_htm_tree(os.path.join(work, "htm"), n_videos=CLI_VIDEOS, vlen=(200, 600),
                             dim=512, vocab=66249, embed_dim=300, hidden=2048, out_dim=512,
                             seed=0)
        os.remove(os.path.join(root, "htm_align.json"))  # no HTM-Align eval in these runs
        argv = [a for a in _cli_argv(root)] + ["--gather_negatives"]
        f4 = ["--epochs", str(DP_F4_EPOCHS), "--fused_steps", str(GRAPH_N)]
        for label, launcher, extra in (
                ("eager", None, ["--epochs", str(DP_EPOCHS)]),
                ("eager nccl", torchrun, ["--epochs", str(DP_EPOCHS)]),
                ("f4", None, f4), ("f4 multihost nccl", torchrun, f4 + ["--multihost"])):
            prefix = "_" + label.replace(" ", "_")
            runs[label], secs[label] = _dp_run(argv + extra + ["--prefix", prefix], work,
                                               label, launcher)
            epochs = int(extra[1])
            (runs[label]["ckpt"],) = glob.glob(os.path.join(
                work, f"log{prefix}", "*", "model", f"epoch{epochs - 1}.pth.tar"))
        n_grad = sum(v.numel() for v in torch.load(
            runs["f4"]["ckpt"], map_location="cpu", weights_only=True)["state_dict"].values())
        for label, ref in (("eager nccl", "eager"), ("f4 multihost nccl", "f4")):
            got, want = runs[label], runs[ref]
            fused = label.startswith("f4")
            epochs = DP_F4_EPOCHS if fused else DP_EPOCHS
            steps = epochs * 8
            if (got["world"], got["backend"], want["backend"]) != (1, "nccl", None):
                fail(f"dp {label}: world {got['world']} over {got['backend']} "
                     f"(want 1 over nccl, against a run without a group)")
            agree = _ckpt_agreement(got["ckpt"], want["ckpt"])
            if not (agree["bit_equal"] and agree["same_counts"]) or got["losses"] != want["losses"]:
                fail(f"dp {label}: not bit for bit the run without a group: {agree}, losses "
                     f"{got['losses']} / {want['losses']}")
            replays = (steps // GRAPH_N - 1) if fused else 0
            coll = _dp_expect(steps, CLI_VAL_BATCHES * epochs, replays)
            if got["collectives"] != coll or any(want["collectives"].values()):
                fail(f"dp {label}: collectives {got['collectives']} (want {coll}); "
                     f"without a group {want['collectives']}")
            kern = {k: v for k, v in _cli_expect(steps, epochs, 0).items() if v}
            for run, name in ((got, label), (want, ref)):
                if run["launches"] != kern or run["steps"] != steps:
                    fail(f"dp {name}: launches {run['launches']} (want {kern}), "
                         f"{run['steps']} steps")
            if fused and (got["captures"], want["captures"]) != (1, 1):
                fail(f"dp {label}: captures {got['captures']} / {want['captures']} (want 1)")
        # (c) the service at eval_devices=2 clamps to the one card
        model = _front_aligner()
        rng = np.random.RandomState(90)
        req = AlignRequest(video=rng.randn(300, 512).astype(np.float32),
                           text_embeds=rng.randn(24, 512).astype(np.float32))
        answers = []
        for n in (1, 2):
            svc = AlignmentService(model, seq_len=64, eval_devices=n)
            if svc._evaluator.devices != [torch.device("cuda")]:
                fail(f"eval_devices={n}: devices {svc._evaluator.devices} on one card")
            answers.append(svc.align(req))
        if not all(np.array_equal(np.asarray(answers[0][k]), np.asarray(answers[1][k]))
                   for k in answers[0]):
            fail("AlignmentService(eval_devices=2) does not score as at 1 on one card")
        # (d) the step's collectives and the vote, timed apart
        parts = dp_collectives_case(n_grad)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def replayed(run):  # every group after the first (the capture) is a replay
        ms = run["step_ms"][GRAPH_N:]
        return dict(median=statistics.median(ms), replays=len(ms) // GRAPH_N,
                    min=min(ms), max=max(ms))

    rep = {"nccl world 1": replayed(runs["f4 multihost nccl"]), "no group": replayed(runs["f4"])}
    bench = dict(
        card=card, kernels_s=round(t_kernels, 1),
        run_s={k: round(v, 1) for k, v in secs.items()},
        replay_step_ms=dict(rep, **{"phase 5b B64 f32 (4096-d input)":
                                    GRAPH_BENCH.get("B64 f32 auto", {}).get("replay_step_ms")}),
        replay_step_ms_delta=rep["nccl world 1"]["median"] - rep["no group"]["median"],
        collectives_ms=parts,
        eager_step_ms_median={k: round(runs[k]["timing"]["step_ms_median"], 3)
                              for k in ("eager nccl", "eager")},
        collectives={k: r["collectives"] for k, r in runs.items()},
        bit_equal=True, phase_s=round(time.perf_counter() - t_phase, 1))
    print("dp_bench", json.dumps(bench), flush=True)
    return grid_cases, loss_cases, {k: runs[k]["launches"] for k in runs}


# ---------------------------------------------------------------- phase 12
# The end-to-end S3D-G finetune (scripts/train_e2e.sh): 16 frames at 5 fps,
# 224² crops, the 512-d joint embedding, --freezeBN, B16, over seeded
# MIL-NCE-layout weights (tools/synth_htm_aa.py: the trunk with its BN stats,
# fc 1024 -> 512, the text module 66,249 words x 300 -> 2,048 -> 512) read
# through the port's converters. No kernel of the port is on this path
# (cuDNN's 3-D convolutions and PyTorch's pools, BatchNorm and matmuls): the
# nine kernels' counters must read 0 across it.
S3D_FRAMES, S3D_CROP, S3D_BATCH, S3D_DIM, S3D_VOCAB = 16, 224, 16, 512, 66249
S3D_CHECK_B = 4  # the card-vs-CPU step and the replayed group's batch
S3D_TIMED, S3D_PROFILED = 10, 5  # steady steps timed (median) and profiled
S3D_VIDEOS, S3D_ROWS = 20, 3  # the command line's tree: 16 kept videos, 48 rows, 3 steps
S3D_ARGV = ["--dataset", "htm-aa", "--model", "s3d", "--freezeBN", "--batch_size", "16",
            "--num_frames", "16", "--fps", "5", "--lr_backbone", "1e-5", "--num_workers", "8"]


def _s3d_clips(seed, b):
    """(b, 1, 16, 224, 224, 3) uint8 clips of drifting colour gratings and
    moving blobs, smooth in space and time as video is, each its own."""
    rng = np.random.RandomState(seed)
    t = np.arange(S3D_FRAMES, dtype=np.float32)[:, None, None, None]
    y = (np.arange(S3D_CROP, dtype=np.float32) / S3D_CROP)[None, :, None, None]
    x = y.reshape(1, 1, S3D_CROP, 1)
    out = np.empty((b, 1, S3D_FRAMES, S3D_CROP, S3D_CROP, 3), np.uint8)
    for i in range(b):
        img = np.zeros((S3D_FRAMES, S3D_CROP, S3D_CROP, 3), np.float32)
        for _ in range(3):
            fy, fx, v, ph = rng.uniform(-6, 6), rng.uniform(-6, 6), rng.uniform(-0.1, 0.1), \
                rng.uniform(0, 2 * np.pi)
            img += np.sin(2 * np.pi * (fy * y + fx * x + v * t) + ph) * rng.uniform(
                -1, 1, 3).astype(np.float32)
        for _ in range(2):
            cy, cx, vy, vx = rng.uniform(0, 1), rng.uniform(0, 1), *rng.uniform(-0.02, 0.02, 2)
            r2 = np.float32(2 * rng.uniform(0.05, 0.2) ** 2)
            img += np.exp(-((y - cy - vy * t) ** 2 + (x - cx - vx * t) ** 2) / r2) * rng.uniform(
                -2, 2, 3).astype(np.float32)
        lo, hi = img.min(), img.max()
        out[i, 0] = (255 * (0.1 + 0.8 * (img - lo) / (hi - lo))).astype(np.uint8)
    return out


def _s3d_state(conv, text, device, dtype=torch.float32):
    """(model, params ``s3d.*`` / ``text.*``, batch_stats) on ``device``,
    the model and parameters in ``dtype``, the stats in float32 (float64
    with a float64 model), as the step keeps them."""
    from exoground_tpu_torch.models.s3d import S3D

    model = S3D(S3D_DIM, device=device)
    model.load_state_dict(conv["params"])
    model.to(dtype)
    params = {f"s3d.{k}": p.detach() for k, p in model.named_parameters()}
    params.update({f"text.{k}": v.to(device, dtype).clone() for k, v in text.items()})
    sdt = torch.float64 if dtype == torch.float64 else torch.float32
    return model, params, {k: v.to(device, sdt).clone() for k, v in conv["batch_stats"].items()}


def _rel_max(got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max())


# Card-vs-CPU limits of phase 12 (a share of max|CPU|, the same dtype on
# both). float64 holds the semantics: 1e-9, and 1e-7 (a float32 ulp) on the
# step's loss and grads, which leave it as float32 as the JAX step's do.
# float32 and bfloat16 hold the issue's 1e-4 and 2e-2, except where
# train-mode BN over 2-4 clips amplifies either device's rounding through
# the randomly weighted trunk: there a fixed limit about three times the
# card's reading on these clips (PERF.md, PR 20: float32's pooled trunk
# 9.2e-5, bfloat16's 0.154 and its stats 1.9e-2, float32's B 4 step grads
# 1.0e-2), and float64 carries the check.
S3D_LIMITS = {"f64": 1e-9, "f64 step": 1e-7, "f32": 1e-4, "bf16": 2e-2,
              "f32 train_bn pooled": 3e-4, "bf16 train_bn pooled": 0.5,
              "bf16 train_bn stats": 5e-2, "f32 train_bn step grads": 3e-2}


@contextlib.contextmanager
def _torch_train_bn():
    """The control the limits must catch: inside the block the model's
    train-mode BatchNorm is PyTorch's own (``F.batch_norm``, momentum 0.1,
    which is flax's 0.9), whose running variance takes the unbiased batch
    variance where flax keeps the biased one."""
    import torch.nn.functional as F

    from exoground_tpu_torch.models import s3d

    class TorchNorm(s3d._Norm):
        def __call__(self, bn, x, train):
            if not train:
                return super().__call__(bn, x, train)
            mean, var = (self.stats[f"{bn.key}.{s}"].clone() for s in s3d.STATS)
            y = F.batch_norm(x, mean, var, bn.weight, bn.bias, training=True, momentum=0.1,
                             eps=s3d.BN_EPS)
            self.new[f"{bn.key}.running_mean"], self.new[f"{bn.key}.running_var"] = mean, var
            return y

    real, s3d._Norm = s3d._Norm, TorchNorm
    try:
        yield
    finally:
        s3d._Norm = real


@contextlib.contextmanager
def _tf32(allow: bool):
    """cuDNN's TF32 flag set to ``allow`` inside the block."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def _s3d_hold(name, got, want, limit, record) -> float:
    err = _rel_max(got, want)
    record[name] = err
    if not err <= limit:
        fail(f"s3d {name}: card vs CPU {err:.3e} of max|CPU| (> {limit})")
    return err


def _s3d_forwards(conv, text, out) -> None:
    """The forward on 2 clips, the embedding and the pooled trunk, frozen
    and train_bn (its new stats too), card vs CPU in float32 (TF32 off),
    bfloat16 and, under train_bn, float64; then the controls: the card's
    float32 with cuDNN's TF32 must leave the float32 limit, and PyTorch's
    BatchNorm the float64 limit on the stats."""
    x = torch.from_numpy(_s3d_clips(90, 2)[:, 0]).float().div(255).permute(0, 4, 1, 2, 3)
    lim = S3D_LIMITS
    runs, ctrl = {}, {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16"), (torch.float64, "f64")):
        for dev in ("cpu", "cuda"):
            model, _, stats = _s3d_state(conv, text, dev, dtype)
            xs = x.to(dev, dtype)
            frozen = {k: v.to(dtype) for k, v in stats.items()}
            with _tf32(False), torch.no_grad():
                for train_bn in ((True,) if dtype == torch.float64 else (False, True)):
                    for emb in (True, False):
                        runs[dev, tag, train_bn, emb] = model(
                            xs, stats if train_bn else frozen, train_bn=train_bn,
                            return_embedding=emb)
                if dev == "cuda" and dtype == torch.float32:
                    with _tf32(True):
                        ctrl["tf32"] = model(xs, frozen, return_embedding=False)
                if dev == "cuda" and dtype == torch.float64:
                    with _torch_train_bn():
                        ctrl["torch bn"] = model(xs, stats, train_bn=True)
            del model
    for (dev, tag, train_bn, emb), r in runs.items():
        if dev != "cuda":
            continue
        want = runs["cpu", tag, train_bn, emb]
        y, new = r if train_bn else (r, None)
        cpu_y, cpu_new = want if train_bn else (want, None)
        name = f"fwd {'train_bn' if train_bn else 'frozen'} {'emb' if emb else 'pooled'} {tag}"
        _s3d_hold(name, y, cpu_y, lim.get(f"{tag} train_bn pooled", lim[tag]) if (
            train_bn and not emb) else lim[tag], out)
        if new is not None and emb:
            stats = {}
            for k in new:
                _s3d_hold(f"{name} stats {k}", new[k], cpu_new[k],
                          lim.get(f"{tag} train_bn stats", lim[tag]), stats)
            out[f"fwd train_bn stats {tag}"] = max(stats.values())
    y, new = ctrl["torch bn"]
    y64, new64 = runs["cpu", "f64", True, True]
    ctrl = {"tf32 fwd frozen pooled": _rel_max(ctrl["tf32"], runs["cpu", "f32", False, False]),
            "torch bn fwd emb": _rel_max(y, y64),
            "torch bn stats": max(_rel_max(new[k], new64[k]) for k in new)}
    out["controls fwd"] = ctrl
    if not (ctrl["tf32 fwd frozen pooled"] > lim["f32"] and ctrl["torch bn stats"] > lim["f64"]):
        fail(f"s3d controls: TF32 and PyTorch's BatchNorm not told apart by the limits {ctrl}")


def s3d_agreement(conv, text) -> dict:
    """The card against the CPU on the same inputs, the same dtype on both
    (``S3D_LIMITS``): the forwards (``_s3d_forwards``), then one
    ``make_s3d_nce_step`` at B 4, freeze_early, its loss, metrics, grads
    and new stats: float32 under --freezeBN and train_bn, float64 under
    train_bn; the early blocks' grads exactly 0 on both. The steps run under
    PyTorch's default cuDNN flags (TF32 allowed): the step itself keeps its
    float32 convolutions in float32. Controls: PyTorch's BatchNorm in the
    card's train_bn steps must leave the stats limits."""
    from exoground_tpu_torch.models.s3d import EARLY
    from exoground_tpu_torch.parallel import make_s3d_nce_step

    out = {}
    _s3d_forwards(conv, text, out)
    lim = S3D_LIMITS
    batch = {"video": _s3d_clips(91, S3D_CHECK_B),
             "token": np.random.RandomState(91).randint(0, S3D_VOCAB + 1, (S3D_CHECK_B, 16))}
    ctrl = {}
    for dtype, train_bn in ((torch.float32, False), (torch.float32, True), (torch.float64, True)):
        tag = f"{'f32' if dtype == torch.float32 else 'f64'} {'train_bn' if train_bn else 'frozen'}"
        res = {}
        for dev in ("cpu", "cuda"):
            model, params, stats = _s3d_state(conv, text, dev, dtype)
            step = make_s3d_nce_step(model, None, freeze_early=True, train_bn=train_bn,
                                     compute_dtype=str(dtype)[6:])
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            res[dev] = step.loss_and_grads(params, stats, b)
            if dev == "cuda" and train_bn:
                with _torch_train_bn():
                    res["torch bn"] = step.loss_and_grads(params, stats, b)
            del model, params
        (m_cpu, g_cpu, s_cpu), (m_gpu, g_gpu, s_gpu) = res["cpu"], res["cuda"]
        f64 = dtype == torch.float64
        rec = {}
        for k in ("loss", "loss-per-text", "loss-per-video"):
            _s3d_hold(k, m_gpu[k].reshape(1), m_cpu[k].reshape(1),
                      lim["f64 step"] if f64 else lim["f32"], rec)
        names = list(g_cpu)
        flat = (lambda g: torch.cat([g[k].detach().double().cpu().reshape(-1) for k in names]))
        _s3d_hold("grads", flat(g_gpu), flat(g_cpu), lim["f64 step"] if f64 else
                  lim["f32 train_bn step grads"] if train_bn else lim["f32"], rec)
        if train_bn:
            stats = {}
            for k in s_cpu:
                _s3d_hold(f"stats {k}", s_gpu[k], s_cpu[k], lim["f64" if f64 else "f32"], stats)
            rec["stats"] = max(stats.values())
            ctrl[tag] = max(_rel_max(res["torch bn"][2][k], s_cpu[k]) for k in s_cpu)
        early = [k for k in g_cpu if k.split(".")[1] in EARLY or k == "text.word_embd.weight"]
        zero = all(float(g_cpu[k].abs().max()) == 0 and float(g_gpu[k].abs().max()) == 0
                   for k in early)
        out[f"step {tag}"] = dict(cpu_loss=float(m_cpu["loss"]), early_zero=zero, **{
            k: v for k, v in rec.items() if not k.startswith("stats ")})
        if not zero:
            fail(f"s3d step {tag}: the early blocks' grads are not all 0 ({out[f'step {tag}']})")
    out["controls step stats"] = ctrl
    if not (ctrl["f64 train_bn"] > lim["f64"] and ctrl["f32 train_bn"] > lim["f32"]):
        fail(f"s3d controls: PyTorch's BatchNorm within the step's stats limits {ctrl}")
    return out


def s3d_timing(card, conv, text) -> dict:
    """S3DTrainer at B 16 on uint8 clips under --freezeBN, float32 and --amp:
    the steady step (median of S3D_TIMED after 3 warm-up steps), clips/s, the
    device's busy ms a step and idle share over S3D_PROFILED profiled steps,
    the no-grad forward's clips/s (median of 5), the peak memory; the nine
    kernels' counters over the timed steps must read 0. Returns (the
    numbers by dtype, the counters by run)."""
    from torch.profiler import ProfilerActivity, profile

    from exoground_tpu_torch.models.s3d import S3D
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.tools.profile_main_path import _device_rows
    from exoground_tpu_torch.train import ExperimentConfig, S3DTrainer

    out, counts = {}, {}
    g = torch.Generator(device="cuda").manual_seed(92)
    batch = {"video": torch.randint(0, 256, (S3D_BATCH, 1, S3D_FRAMES, S3D_CROP, S3D_CROP, 3),
                                    dtype=torch.uint8, device="cuda", generator=g),
             "token": torch.randint(0, S3D_VOCAB + 1, (S3D_BATCH, 16), dtype=torch.int32,
                                    device="cuda", generator=g)}
    for amp in (False, True):
        cfg = ExperimentConfig(dataset="htm-aa", model="s3d", freezeBN=True, amp=amp,
                               batch_size=S3D_BATCH, lr=1e-4, lr_backbone=1e-5, epochs=1)
        tr = S3DTrainer(S3D(S3D_DIM, device="cuda"), cfg, text, iters_per_epoch=100,
                        device="cuda")
        tr.load_backbone(conv)
        for _ in range(3):
            tr._do_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        times = []
        for _ in range(S3D_TIMED):
            t0 = time.perf_counter()
            m = tr._do_step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts[f"timed steps {'amp' if amp else 'f32'}"] = dict(_kernels.LAUNCHES)
        launched = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        if launched or not np.isfinite(float(m["loss"])):
            fail(f"s3d timed steps: kernel launches {launched}, loss {float(m['loss'])}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(S3D_PROFILED):
                tr._do_step(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(r[0] for r in _device_rows(prof)) / 1e6
        cdt = torch.bfloat16 if amp else torch.float32
        p_c = {k[4:]: v.to(cdt) for k, v in tr.params.items() if k.startswith("s3d.")}
        s_c = {k: v.to(cdt) for k, v in tr.batch_stats.items()}
        x = (batch["video"][:, 0].float() / torch.full((), 255.0, device="cuda")).to(cdt)
        x = x.permute(0, 4, 1, 2, 3)
        fwd = []
        with torch.no_grad(), _tf32(False):
            for i in range(6):
                t0 = time.perf_counter()
                torch.func.functional_call(tr.model, p_c, (x, s_c))
                torch.cuda.synchronize()
                if i:
                    fwd.append(time.perf_counter() - t0)
        step_ms = statistics.median(times) * 1e3
        out["amp" if amp else "f32"] = dict(
            step_ms=round(step_ms, 2), clips_per_s=round(S3D_BATCH / step_ms * 1e3, 1),
            busy_ms=round(busy / S3D_PROFILED * 1e3, 2), idle=round(1 - busy / wall, 4),
            fwd_clips_per_s=round(S3D_BATCH / statistics.median(fwd), 1),
            peak_gb=round(peak, 2))
        print(f"s3d timing {'amp' if amp else 'f32'} ({card}): {out['amp' if amp else 'f32']}, "
              f"step ms {[round(t * 1e3, 2) for t in times]}", flush=True)
        del tr
        torch.cuda.empty_cache()
    return out, counts


def s3d_graph(conv, text) -> dict:
    """make_s3d_nce_step(scan_steps=4) at B 4, float32, train_bn (the stats
    updated inside the graph), with cuDNN deterministic and PyTorch's
    deterministic algorithms (warn only; the pools take their ordered
    backward): two 4-step calls (eager with the capture, then a replay)
    against 8 eager steps of another state, bit for bit: losses,
    parameters, stats, moments; one capture, no kernel launch."""
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.parallel import make_s3d_nce_step
    from exoground_tpu_torch.train import FusedAdamWEMA

    n = 4
    raw = [{"video": _s3d_clips(100 + i, S3D_CHECK_B),
            "token": np.random.RandomState(100 + i).randint(1, S3D_VOCAB + 1, (S3D_CHECK_B, 16))}
           for i in range(2 * n)]
    dev = [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in raw]
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for scan in (None, n):
            model, params, stats = _s3d_state(conv, text, "cuda")
            tx = FusedAdamWEMA(params, lr=1e-4, warmup_iterations=0, backbone_lr=1e-5)
            o = tx.init(params)
            step = make_s3d_nce_step(model, tx, freeze_early=True, train_bn=True, scan_steps=scan)
            _kernels.reset_launches()
            if scan is None:
                ms = [step(params, stats, o, b)[3] for b in dev]
                losses = [float(m["loss"]) for m in ms]
            else:
                losses = []
                for g in range(2):
                    stacked = {k: torch.stack([b[k] for b in dev[g * n:(g + 1) * n]])
                               for k in dev[0]}
                    losses += step(params, stats, o, stacked)[3]["loss"].tolist()
            torch.cuda.synchronize()
            runs.append(dict(losses=losses, params=params, stats=stats, o=o, step=step,
                             counts=dict(_kernels.LAUNCHES),
                             launched={k: v for k, v in _kernels.LAUNCHES.items() if v}))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    eager, replay = runs
    equal = eager["losses"] == replay["losses"] and all(
        torch.equal(eager[t][k], replay[t][k]) for t in ("params", "stats")
        for k in eager[t]) and all(
        torch.equal(getattr(eager["o"], t)[k], getattr(replay["o"], t)[k])
        for t in ("mu", "nu") for k in eager["o"].mu)
    captures = replay["step"].captures
    out = dict(bit_equal=equal, captures=captures, steps=2 * n, losses=replay["losses"],
               counts={"eager": eager["counts"], "scan_steps=4": replay["counts"]})
    print("s3d scan_steps", json.dumps({k: v for k, v in out.items() if k != "counts"}),
          flush=True)
    if not equal or captures != 1 or eager["launched"] or replay["launched"] or (
            replay["o"].count != 2 * n):
        fail(f"s3d scan_steps=4: replay vs eager {out}")
    return out


def s3d_path(card):
    """Phase 12: the S3D finetune on the card (see the section's comment):
    the command line on a synthetic HTM-AA tree (--freezeBN, B 16, 16
    frames at 5 fps, one epoch of 3 steps, then --resume for a second,
    checked bit for bit as load_checkpoint returns; counted), then the card
    against the CPU, the timed trainer and the replayed group. Returns the
    kernel launches of every counted run (all 0)."""
    import glob
    import os
    import shutil
    import tempfile

    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.tools.synth_htm_aa import make_htm_aa_tree
    from exoground_tpu_torch.train import S3DTrainer
    from exoground_tpu_torch.train import main as cli
    from exoground_tpu_torch.train.checkpoint import load_state
    from exoground_tpu_torch.utils.convert import (
        convert_s3d_state_dict,
        convert_sentence_embedding_from_s3d,
        load_torch_checkpoint,
    )

    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="s3d_", dir=build)
    cwd = os.getcwd()
    built, loaded, launches = [], [], {}
    real_build, real_load = cli.build_htm_e2e, S3DTrainer.load_checkpoint

    def build_spy(cfg, device, mesh=None):
        run = real_build(cfg, device, mesh)
        built.append(run)
        return run

    def load_spy(self, path, mode="resume"):
        real_load(self, path, mode)
        loaded.append(({k: v.cpu().clone() for k, v in self.params.items()},
                       {k: v.cpu().clone() for k, v in self.batch_stats.items()},
                       {k: v.cpu().clone() for k, v in self.opt_state.mu.items()},
                       self.opt_state.count))

    cli.build_htm_e2e, S3DTrainer.load_checkpoint = build_spy, load_spy
    try:
        t0 = time.perf_counter()
        root = make_htm_aa_tree(os.path.join(work, "htm_aa"), n_videos=S3D_VIDEOS,
                                rows_per_video=S3D_ROWS, vocab=S3D_VOCAB, embed_dim=300,
                                hidden=2048, out_dim=S3D_DIM, seed=0)
        tree_s = time.perf_counter() - t0
        os.chdir(work)
        runs = {}
        for tag, extra in (("epoch 0", ["--epochs", "1", "--prefix", "_s3d"]),
                           ("--resume", None)):
            if extra is None:  # the resumed run saves epoch 1 beside it and drops it
                (ckpt,) = glob.glob(os.path.join(work, "log_s3d", "*", "model",
                                                 "epoch0.pth.tar"))
                blob, ckpt_mb = load_state(ckpt), os.path.getsize(ckpt) / 2**20
                extra = ["--epochs", "2", "--resume", ckpt]
            _kernels.reset_launches()
            t0 = time.perf_counter()
            last = cli.main(S3D_ARGV + ["--data_root", root] + extra)
            torch.cuda.synchronize()
            launches[f"command line {tag}"] = dict(_kernels.LAUNCHES)
            run = built[-1]
            ds, tr = run.dataset, run.trainer
            runs[tag] = dict(last=last, run_s=time.perf_counter() - t0, decoded=ds.decoded,
                             grey=ds.grey, steps=sum(s["steps"] for s in tr.epoch_stats),
                             reader_ms_a_batch=ds.item_s * 1e3 / max(
                                 sum(s["steps"] for s in tr.epoch_stats), 1),
                             step_ms=[round(t * 1e3, 2) for s in tr.epoch_stats
                                      for t in s["step_s"]])
            if not np.isfinite(last) or any(_kernels.LAUNCHES.values()):
                fail(f"s3d command line {tag}: loss {last}, launches "
                     f"{ {k: v for k, v in _kernels.LAUNCHES.items() if v} }")
        params, stats, mu, count = loaded[-1]
        resumed = (sorted(blob["batch_stats"]) == sorted(stats) and count == blob[
            "optimizer"]["count"] and all(torch.equal(params[k], v) for k, v in
                                          blob["state_dict"].items())
            and all(torch.equal(stats[k], v) for k, v in blob["batch_stats"].items())
            and all(torch.equal(mu[k], v) for k, v in blob["optimizer"]["mu"].items()))
        epochs = [s["epoch"] for s in built[-1].trainer.epoch_stats]
        print("s3d command line", json.dumps(dict(
            card=card, tree_s=round(tree_s, 1), runs=runs, resumed_bit_equal=resumed,
            resumed_epochs=epochs, checkpoint_mb=round(ckpt_mb, 1))),
            flush=True)
        if not resumed or epochs != [1] or runs["epoch 0"]["steps"] != 3:
            fail(f"s3d --resume: restored bit for bit {resumed}, epochs {epochs}, "
                 f"steps {runs['epoch 0']['steps']}")
        ckpt_state = load_torch_checkpoint(os.path.join(root, "s3d_howto100m.pth"))
    finally:
        cli.build_htm_e2e, S3DTrainer.load_checkpoint = real_build, real_load
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    conv = convert_s3d_state_dict(ckpt_state)
    text = convert_sentence_embedding_from_s3d(ckpt_state)
    agreement = s3d_agreement(conv, text)
    print("s3d agreement", json.dumps(agreement), flush=True)
    timing, counts = s3d_timing(card, conv, text)
    graph = s3d_graph(conv, text)
    launches.update(counts)
    launches.update({f"steps {k}": v for k, v in graph["counts"].items()})
    bench = dict(card=card, f32=timing["f32"], amp=timing["amp"],
                 kernel_launches=0,
                 fwd_err_max={f"{mode} {dt}": max(v for k, v in agreement.items()
                                                  if k.startswith(f"fwd {mode}")
                                                  and k.endswith(dt))
                              for mode, dts in (("frozen", ("f32", "bf16")),
                                                ("train_bn", ("f32", "bf16", "f64")))
                              for dt in dts},
                 step_grad_err={k[5:]: v["grads"] for k, v in agreement.items()
                                if k.startswith("step")},
                 controls=dict(tf32=agreement["controls fwd"]["tf32 fwd frozen pooled"],
                               torch_bn_stats=min(agreement["controls step stats"].values())),
                 replay_bit_equal=graph["bit_equal"],
                 cli=dict(steps=runs["epoch 0"]["steps"], decoded=runs["epoch 0"]["decoded"],
                          grey=runs["epoch 0"]["grey"],
                          reader_ms_a_batch=round(runs["epoch 0"]["reader_ms_a_batch"], 1),
                          resumed=resumed),
                 phase_s=round(time.perf_counter() - t_phase, 1))
    print("s3d_bench", json.dumps(bench), flush=True)
    return launches


# ---------------------------------------------------------------- phase 13
# Sequence parallelism on the card: parallel/sequence.py's ring in a world-1
# NCCL group of this process (one H100: one rank, which passes its K/V block
# to itself once a layer), over the three global-mode bench videos at E6D6
# full width, held against the model path's last stage.
SEQ_INTERP = 64  # the global mode's interpolate_from (its seq_len)
SEQ_TOL = 1e-4  # absolute, on both similarities (f32, TF32 off)
SEQ_TIMED = 3  # timed calls a path and video, in turns, after a warm-up


def self_p2p(mesh, frames, model) -> tuple:
    """The ring rotation's NCCL send/recv (``collectives.send_recv``) from
    the rank of a world-1 group to itself, on one layer's block at
    ``frames`` frames (K and V (1, heads, frames, width / heads) float32, the
    mask as bytes): the block received must be the block sent. Returns (the
    median ms of SEQ_TIMED * 2 timed calls after one warm-up, the
    collectives the checked call issued)."""
    from exoground_tpu_torch.parallel import collectives

    gen = torch.Generator(device="cuda").manual_seed(frames)
    attn = model.video_temporal_encoder.resblocks[0].attn
    h = attn.num_heads
    kv = (1, h, frames, attn.in_proj_weight.shape[1] // h)
    block = [torch.randn(kv, device="cuda", generator=gen),
             torch.randn(kv, device="cuda", generator=gen),
             (torch.rand((1, frames), device="cuda", generator=gen) < 0.1).to(torch.uint8)]
    collectives.reset()
    got = collectives.send_recv(block, mesh, mesh.rank, mesh.rank)()
    torch.cuda.synchronize()
    issued = {k: v for k, v in collectives.COLLECTIVES.items() if v}
    if issued != {"ppermute": 1} or not all(torch.equal(a, b) for a, b in zip(got, block)):
        fail(f"sequence parallel: the self send/recv of {frames} frames gave another block "
             f"({issued})")
    times = []
    for _ in range(SEQ_TIMED * 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        collectives.send_recv(block, mesh, mesh.rank, mesh.rank)()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return round(statistics.median(times), 3), issued


def sequence_path(card):
    """Phase 13: ``sequence_parallel_sim`` (dual + joint, 6 + 6 layers) in a
    world-1 NCCL group on each ``GLOBAL_VLENS`` video with its sentences,
    counted (12 fused MLP launches a video and 2 gathers; at world 1 the
    rotation is the identity and sends nothing), against
    ``text_visual_sim``'s last stage under attn_impl='xla' (<= SEQ_TOL
    absolute) and beside 'auto' (flash: the gap printed); the first video
    again on the CPU (``Mesh()``: no group); ms a video of the three. Apart
    from the ring, the rotation's NCCL send/recv (``collectives.send_recv``)
    of one layer's K/V/mask block at the video's length, from the rank to
    itself: the block received must be the block sent, and its ms is
    printed beside the ring's (``self_p2p_ms``), not in it.
    Returns the launches of the ring runs."""
    import copy

    import torch.distributed as dist

    from exoground_tpu_torch.evals.bench_items import make_bench_params, make_global_items
    from exoground_tpu_torch.models import TemporalAligner
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.parallel import Mesh, collectives, sequence_parallel_sim
    from exoground_tpu_torch.parallel.mesh import free_port, make_mesh
    from exoground_tpu_torch.utils.convert import load_tan_params

    t_phase = time.perf_counter()
    model = TemporalAligner(num_encoder_layers=6, num_joint_layers=6, width=512, heads=8,
                            input_dim=4096, device="cpu")
    load_tan_params(model, make_bench_params(0))
    gpu = copy.deepcopy(model).to("cuda")
    items = make_global_items(4096, 4096)
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, device_id=dev)
    launches, rows = {k: 0 for k in _kernels.LAUNCHES}, []
    try:
        mesh = make_mesh(device=dev)
        if (mesh.world, mesh.backend) != (1, "nccl"):
            fail(f"sequence parallel: world {mesh.world} over {mesh.backend}")

        def ring(video, text, on=mesh):
            out = sequence_parallel_sim(gpu, video, text, on, num_joint_layers=6,
                                        interpolate_from=SEQ_INTERP)
            torch.cuda.synchronize()
            return out

        def model_path(video, text, impl):
            gpu.attn_impl = impl
            with torch.inference_mode():
                out = gpu.text_visual_sim(video, text[None], interpolate_from=SEQ_INTERP)
            torch.cuda.synchronize()
            return {k: out[k][:, -1] for k in ("dual-sim", "sim")}

        for i, it in enumerate(items):
            video = torch.tensor(it["video"][None], device="cuda")
            text = torch.tensor(it["text_embed"], device="cuda")
            _kernels.reset_launches()
            collectives.reset()
            got = ring(video, text)
            counts, issued = dict(_kernels.LAUNCHES), dict(collectives.COLLECTIVES)
            want = {k: 0 for k in counts}
            want["fused_mlp"] = 12
            _check_counts(f"sequence parallel video {i}", counts, want)
            if issued != dict(all_reduce=0, all_gather=2, reduce_scatter=0, broadcast=0,
                              ppermute=0):
                fail(f"sequence parallel video {i}: collectives {issued}")
            for k, v in counts.items():
                launches[k] += v
            xla, auto = model_path(video, text, "xla"), model_path(video, text, None)
            err = {k: (got[k] - xla[k]).abs().max().item() for k in xla}
            gap = {k: (got[k] - auto[k]).abs().max().item() for k in auto}
            finite = all(torch.isfinite(v).all().item() for v in got.values())
            shape = (1, len(it["video"]), len(it["text_embed"]))
            if not finite or any(tuple(v.shape) != shape for v in got.values()):
                fail(f"sequence parallel video {i}: shapes "
                     f"{ {k: tuple(v.shape) for k, v in got.items()} } != {shape} or not finite")
            if not max(err.values()) <= SEQ_TOL:
                fail(f"sequence parallel video {i}: ring vs 'xla' model path {err} > {SEQ_TOL}")
            p2p_ms, p2p_issued = self_p2p(mesh, len(it["video"]), gpu)
            times = {"ring": [], "xla": [], "auto": []}
            runs = {"ring": lambda: ring(video, text),
                    "xla": lambda: model_path(video, text, "xla"),
                    "auto": lambda: model_path(video, text, None)}
            for _ in range(SEQ_TIMED):
                for name in ("ring", "xla", "auto", "auto", "xla", "ring"):
                    t0 = time.perf_counter()
                    runs[name]()
                    times[name].append((time.perf_counter() - t0) * 1e3)
            row = dict(card=card, frames=shape[1], texts=shape[2],
                       collectives={k: v for k, v in issued.items() if v},
                       self_p2p_ms=p2p_ms, self_p2p_collectives=p2p_issued,
                       ring_vs_xla_abs={k: float(f"{v:.3g}") for k, v in err.items()},
                       ring_vs_auto_abs={k: float(f"{v:.3g}") for k, v in gap.items()},
                       **{f"{k}_ms": round(statistics.median(v), 3) for k, v in times.items()})
            if i == 0:  # the first video again on the CPU, no group
                t0 = time.perf_counter()
                cpu = sequence_parallel_sim(model, video.cpu(), text.cpu(), Mesh(),
                                            num_joint_layers=6, interpolate_from=SEQ_INTERP)
                row["cpu_s"] = round(time.perf_counter() - t0, 1)
                row["card_vs_cpu_abs"] = {k: float(f"{(got[k].cpu() - cpu[k]).abs().max():.3g}")
                                          for k in cpu}
                if not max(row["card_vs_cpu_abs"].values()) <= SEQ_TOL:
                    fail(f"sequence parallel: card vs CPU {row['card_vs_cpu_abs']}")
            print("seq_bench", json.dumps(row), flush=True)
            rows.append(row)
            gpu.attn_impl = None
            del video, text, got, xla, auto
    finally:
        dist.destroy_process_group()
    del gpu
    torch.cuda.empty_cache()
    print(f"sequence parallel: launches {launches}, {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ---------------------------------------------------------------- phase 14
# The feature-extraction tool (tools/extract_features.py) on the card over
# seeded frames (the card's machine has no ffmpeg), with an image encoder
# built here from port modules: a 32-pixel patch projection, two
# ResidualAttentionBlocks at width 768 / 12 heads (49 patches + a class
# token: 50 tokens, so under 'auto' the bf16 fused MHA and fused MLP
# launch), then LN and a projection to 512.
EXTRACT_FRAMES, EXTRACT_SIZE, EXTRACT_WIDTH = 300, 224, 768


class PatchEncoder(torch.nn.Module):
    """(B, H, W, 3) frames in [0, 1] -> (B, 512)."""

    def __init__(self, width=EXTRACT_WIDTH, heads=12, layers=2, patch=32, out=512):
        from exoground_tpu_torch.ops.blocks import ResidualAttentionBlock

        super().__init__()
        n = (EXTRACT_SIZE // patch) ** 2 + 1
        self.conv1 = torch.nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = torch.nn.Parameter(torch.randn(width) * width ** -0.5)
        self.positional_embedding = torch.nn.Parameter(torch.randn(n, width) * width ** -0.5)
        self.ln_pre = torch.nn.LayerNorm(width)
        self.resblocks = torch.nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers))
        self.ln_post = torch.nn.LayerNorm(width)
        self.proj = torch.nn.Linear(width, out, bias=False)

    def forward(self, frames):
        x = self.conv1(frames.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = self.ln_pre(torch.cat([cls, x], 1) + self.positional_embedding.to(x.dtype))
        for blk in self.resblocks:
            x, _ = blk(x)
        return self.proj(self.ln_post(x[:, 0]))


def extraction_path(card):
    """Phase 14: ``extract_video_features`` over EXTRACT_FRAMES seeded
    frames of EXTRACT_SIZE² at fps 1 (two buckets of 256, the last ragged)
    and fps 8, counted (2 fused MHA + 2 fused MLP a bucket, bf16), the card
    against the CPU (<= 1e-2 of max|CPU|), frames/s (median of 3, a call as
    it casts the module and with the cast module handed in). Returns the
    launches of the two counted runs."""
    from exoground_tpu_torch.ops import _kernels
    from exoground_tpu_torch.tools import ExtractConfig, extract_video_features, half_copy

    t_phase = time.perf_counter()
    torch.manual_seed(0)
    enc = PatchEncoder()
    frames = np.random.RandomState(0).rand(EXTRACT_FRAMES, EXTRACT_SIZE, EXTRACT_SIZE,
                                           3).astype(np.float32)
    buckets = -(-EXTRACT_FRAMES // ExtractConfig.frame_bucket)
    launches, out = {k: 0 for k in _kernels.LAUNCHES}, {}
    for fps in (1, 8):
        cfg = ExtractConfig(fps=fps)
        _kernels.reset_launches()
        out[fps] = extract_video_features(enc, frames, cfg)
        counts = dict(_kernels.LAUNCHES)
        want = {k: 0 for k in counts}
        want.update(fused_mha=2 * buckets, fused_mlp=2 * buckets)
        _check_counts(f"feature extraction fps {fps}", counts, want)
        for k, v in counts.items():
            launches[k] += v
        rows = EXTRACT_FRAMES // fps
        if out[fps].shape != (rows, 512) or out[fps].dtype != np.float16 or not np.isfinite(
                out[fps]).all():
            fail(f"feature extraction fps {fps}: {out[fps].shape} {out[fps].dtype}")
    t0 = time.perf_counter()
    cpu = extract_video_features(enc, frames, ExtractConfig(fps=1), device="cpu")
    cpu_s = time.perf_counter() - t0
    c, g = cpu.astype(np.float32), out[1].astype(np.float32)
    rel = float(np.abs(g - c).max() / np.abs(c).max())
    if not rel <= TOL[torch.bfloat16]:
        fail(f"feature extraction: card vs CPU {rel:.3e} of max|CPU|")
    # a call as a caller pays it (the module cast anew), and with the cast
    # module passed as a plain callable (as extract_corpus runs a corpus)
    prepared = half_copy(enc).to("cuda")
    times = {"call": [], "prepared": []}
    for _ in range(3):
        for name, e in (("call", enc), ("prepared", lambda x: prepared(x))):
            t0 = time.perf_counter()
            extract_video_features(e, frames, ExtractConfig(fps=1))
            times[name].append(time.perf_counter() - t0)
    bench = dict(card=card, frames=EXTRACT_FRAMES, size=EXTRACT_SIZE, width=EXTRACT_WIDTH,
                 buckets=buckets, **{f"{k}_frames_per_s": round(
                     EXTRACT_FRAMES / statistics.median(v), 1) for k, v in times.items()},
                 **{f"{k}_ms": [round(t * 1e3, 2) for t in v] for k, v in times.items()},
                 card_vs_cpu_rel=float(f"{rel:.3g}"),
                 cpu_s=round(cpu_s, 1), launches={k: v for k, v in launches.items() if v},
                 phase_s=round(time.perf_counter() - t_phase, 1))
    print("extract_bench", json.dumps(bench), flush=True)
    return launches


def _grid_part_cases(part, cases):
    """The grid cases with the ``fwd_`` or ``bwd_`` (``part``) numbers as
    the kernels line's, the other part's dropped."""
    out = []
    for c in cases:
        c = {k: v for k, v in c.items() if not k.startswith("bwd" if part == "fwd" else "fwd")}
        for k in ("ms", "plain_ms", "bound_ms", "bound_by", "ms_b2b", "plain_ms_b2b",
                  "bound_cuda_cores_ms", "bound_3xtf32_ms"):
            if f"{part}_{k}" in c:
                c[k] = c.pop(f"{part}_{k}")
        out.append(c)
    return out


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
    mha_cases += wide_mha_family_cases("fused_mha", mha_case, 100, b2b=True)  # the wide body
    gemm_cases = wgmma_linear_cases(torch.bfloat16)
    gemm32_cases = wgmma_linear_cases(torch.float32)
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
    # phase 3c: the flash kernels against their plain version (the wide
    # bodies too)
    flash_cases = flash_kernel_cases() + wide_flash_cases()

    mark("3d")
    # phase 3d: the int8 kernels against their plain versions (row 5's
    # wide-head body too)
    mha8_cases, mlp8_cases = int8_kernel_cases()
    mha8_cases += wide_mha_family_cases("fused_mha_int8", mha_int8_case, 130, timed=True,
                                        b2b=True, library_b2b=True)

    mark("3e")
    # phase 3e: the whole-block kernels against their plain versions (row
    # 7's wide-head bodies too)
    block_cases = block_kernel_cases()
    for int8, name in ((False, "block_attn"), (True, "block_attn_int8")):
        block_cases[name] += wide_mha_family_cases(
            name, lambda *a, **kw: block_attn_case(*a, int8=int8, **kw), 200 + 30 * int8,
            timed=True, b2b=True, library_b2b=True)
    attention_bars(mha_cases, flash_cases, mha8_cases, block_cases)

    mark("3f")
    # phase 3f: the window-attention kernel against its plain version (the
    # wide body too)
    wide_small = wide_small_cases()
    small_cases = small_kernel_cases() + wide_small

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
    train_chain_agreement(model)

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

    mark("7b")
    # phase 7b: keystep grounding at --feature_dim 1024 and 2048, served by
    # the wide-head bodies, counted
    wide_launches = wide_grounding_path(card)

    mark("8")
    # phase 8: the training command line, counted (this slice's main path),
    # at --fused_steps 1 and 4
    cli_launches, cli_fused_launches, cli_chain_launches = cli_path(card)

    mark("8b")
    # phase 8b: the JAX package's checkpoints resumed on the card
    jax_resume_path(card)
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
        return entry(f"milnce_grid_{part}", "exoground_tpu_torch/csrc/milnce_grid.cu",
                     replaces, _grid_part_cases(part, grid_cases))

    def flash_entry(part, replaces, name=None, of=None):
        parts = ("fwd", "dq", "dkv")
        cases = []
        for c in flash_cases if of is None else of:
            c = {k: v for k, v in c.items()
                 if not any(k.startswith(f"{p}_") for p in parts if p != part)}
            for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "ms_b2b",
                      "library_ms_b2b", "bound_cuda_cores_ms", "bound_3xtf32_ms"):
                if f"{part}_{k}" in c:
                    c[k] = c.pop(f"{part}_{k}")
            cases.append(c)
        name = name or f"flash_{part}"
        e = entry(name, "exoground_tpu_torch/csrc/flash_attn.cu", replaces, cases)
        e["launches_by_path"] = dict(flash_launches.get(name, {}))
        return e

    # the bodies behind a wrapper that phase 7b's C 2048 forwards launch: the
    # flash forward's cluster body (D > 128; its cases the wide ones of phase
    # 3c, the timed first) and the wgmma GEMM. The cluster dq and dk/dv run on
    # no path yet (a D 256 training run waits for chip_smoke time): their cases
    # stay in flash_dq's and flash_dkv's lines, held to the plain version there
    for name in ("flash_fwd_cluster", "wgmma_linear", "wgmma_linear_tf32", "wide_window"):
        launches[name] = sum(n.get(name, 0) for n in wide_launches.values())
    wide_flash = sorted((c for c in flash_cases if c.get("head_size", 0) > 128),
                        key=lambda c: "fwd_ms" not in c)

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
        flash_entry("fwd", "exoground_tpu/ops/attention.py:279", "flash_fwd_cluster",
                    wide_flash),
        dict(entry("wgmma_linear", "exoground_tpu_torch/csrc/wgmma_linear.cuh",
                   "exoground_tpu/ops/attention.py:761", gemm_cases),
             launches_by_path={}, part_of="rows 1, 5 and 7's wide bf16 bodies (qkv and "
                                         "out-projection; the TPU kernels' products inside "
                                         "_mha_kernel :658 and _mha_attention_tail :575)"),
        dict(entry("wgmma_linear_tf32", "exoground_tpu_torch/csrc/wgmma_linear.cuh",
                   "exoground_tpu/ops/attention.py:761", gemm32_cases),
             launches_by_path={}, part_of="rows 1, 5 and 7's wide f32 bodies (3xTF32; the qkv "
                                         "of the exact bodies, every out-projection; the TPU "
                                         "kernels' products inside _mha_kernel :658 and "
                                         "_mha_attention_tail :575)"),
        # the window kernel: its cases the window core's wide ones (phase 3f,
        # D >= 128, the timed D 256 first), beside SDPA
        dict(entry("wide_window", "exoground_tpu_torch/csrc/wide_window.cuh",
                   "exoground_tpu/ops/attention.py:514",
                   sorted((c for c in wide_small if c["wide_window"]),
                          key=lambda c: (c.get("ms") is None, "D256 " not in c["shape"]))),
             launches_by_path={}, part_of="row 9 at D >= 128 (small_attn) and the attention "
                                         "core of rows 1, 5 and 7's wide bodies (the TPU "
                                         "kernels' _small_kernel :450 and "
                                         "_mha_attention_tail :575)"),
    ]
    for e in kernels:
        if e["name"] in ("milnce_grid_fwd", "milnce_grid_bwd"):
            e["launches_by_path"] = {"train path (phase 5)": launches[e["name"]]}
        for run, n in wide_launches.items():
            if n.get(e["name"]):
                e["launches_by_path"][f"wide-head grounding served {run} (phase 7b)"] = (
                    n[e["name"]])
        if e["name"] in ("milnce_grid_fwd", "milnce_grid_bwd"):
            e["launches_by_path"].update({
                f"train step, graph replay {case} (phase 5b)": n[e["name"]]
                for case, n in graph_launches.items()})
        if e["name"] in ("milnce_grid_fwd", "milnce_grid_bwd", "fused_mha", "fused_mlp"):
            e["launches_by_path"]["training command line (phase 8)"] = cli_launches[e["name"]]
            e["launches_by_path"][f"training command line --fused_steps {GRAPH_N} (phase 8)"] = (
                cli_fused_launches[e["name"]])
            for flags, n in cli_chain_launches.items():
                e["launches_by_path"][f"training command line {flags} (phase 8)"] = (
                    n[e["name"]])
    mark("9")
    # phase 9: grounding training through the command line, counted
    gnd_launches = grounding_train_path(card)
    for e in kernels:
        for tag, n in gnd_launches.items():
            if n[e["name"]]:
                e["launches_by_path"][f"grounding training command line {tag} (phase 9)"] = (
                    n[e["name"]])
    mark("10")
    # phase 10: the inference front (raw texts, HTTP, YouCook2), counted
    front_launches = inference_front_path(card)
    for e in kernels:
        for path, n in front_launches.items():
            if e["name"] in n:
                e["launches_by_path"][path] = n[e["name"]]
    mark("11")
    # phase 11: data parallelism on the card: the grid at the gathered
    # shapes and column offsets, the command line in a world-1 NCCL group
    dp_grid, dp_loss, dp_launches = dp_path(card)
    for e in kernels:
        if e["name"] in ("milnce_grid_fwd", "milnce_grid_bwd"):
            e["cases"] += _grid_part_cases(e["name"].rsplit("_", 1)[1], dp_grid)
            e["gathered_tan_loss_cases"] = dp_loss
        for label, n in dp_launches.items():
            if n.get(e["name"]):
                e["launches_by_path"][
                    f"training command line --gather_negatives {label} (phase 11)"] = n[e["name"]]
    mark("12")
    # phase 12: the end-to-end S3D finetune; the nine kernels' counters read
    # 0 in every run. It runs under PyTorch's default cuDNN flags (TF32
    # allowed), as a user's run does: the S3D step keeps its float32
    # convolutions in float32 itself
    with _tf32(True):
        s3d_launches = s3d_path(card)
    for path, n in s3d_launches.items():
        for e in kernels:
            e["launches_by_path"][f"S3D finetune {path} (phase 12)"] = n[e["name"]]
            if n[e["name"]]:
                fail(f"S3D finetune {path}: {n[e['name']]} {e['name']} launches (want 0)")
    mark("13")
    # phase 13: sequence parallelism, the ring in a world-1 NCCL group
    seq_launches = sequence_path(card)
    mark("14")
    # phase 14: the feature-extraction tool
    extract_launches = extraction_path(card)
    carry = GRAPH_BENCH["carry_cast"]["tan"]["replay_launches"]
    for e in kernels:
        for path, n in (("sequence parallel ring, world-1 NCCL group (phase 13)", seq_launches),
                        ("feature extraction, fps 1 and 8 (phase 14)", extract_launches),
                        ("train step, graph replay B64 bf16, casts recast (phase 5b A/B)",
                         carry["recast"]),
                        ("train step, graph replay B64 bf16, casts carried (phase 5b A/B)",
                         carry["carried"])):
            if n.get(e["name"]):
                e["launches_by_path"][path] = n[e["name"]]
    mark(None)
    print("phase_s", json.dumps(phase_s), flush=True)
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
