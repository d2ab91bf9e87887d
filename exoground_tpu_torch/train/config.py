"""Experiment configuration: the reference's flag surface as one dataclass,
its command-line parser and the experiment-directory registry.

A copy of ``exoground_tpu/train/config.py`` (``ExperimentConfig``,
``validate``, ``parse_args`` :216, ``set_path`` :271; the port imports
nothing of the JAX package), so the port's trainer and command line take
the same configurations. ``validate`` also checks ``attn_impl``. Comments
that speak of TPU measurements describe the JAX package, not the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from dataclasses import dataclass
from datetime import datetime
from typing import List, Optional, Tuple

# per-dataset annotation/decode frame rates (see ExperimentConfig.fps)
_DEFAULT_FPS = {"lemma": 24, "htm-aa": 5}


@dataclass
class ExperimentConfig:
    # core
    seed: int = 888
    model: str = "joint"  # view_invariant | grounding | joint | init | cotrain
    language_model: str = "word2vec"
    dataset: str = "egoexo4d"  # egoexo4d | lemma | htm-370k | htm-fe
    seq_len: int = 64
    seq_hop: int = 5
    batch_size: int = 64
    loss: str = "iou_l1"
    lr: float = 1e-4
    iou_loss_eps: float = 1e-8
    wd: float = 1e-5
    clip_grad: float = 0.0  # 0.0 or 3.0 (DINO-style per-param clip)
    num_workers: int = 8

    test: str = ""
    resume: str = ""
    pretrain: str = ""
    epochs: int = 10
    start_epoch: int = 0

    name_prefix: str = ""
    prefix: str = ""
    backprop_freq: int = 1
    eval_freq: int = 1
    print_freq: int = 1
    runtime_save_iter: int = 1000
    optim_policy: str = "default"  # default | bce

    # TAN
    sim: str = "cos"
    aux_loss: int = 1
    pos_enc: str = "learned"
    use_text_pos_enc: int = 0
    loss_threshold: float = 0.0
    learn_agreement: int = 0
    temporal_agreement_type: str = "keep"
    use_alignability_head: int = 0
    momentum_m: float = 0.999
    iou_thresholds: Tuple[float, ...] = (0.1, 0.3, 0.5, 0.7)
    minimum_four_exo_takes: bool = False

    # transformer
    hidden_dim: int = 256
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6

    # exo grounding
    use_decoder: bool = True
    use_audio: bool = False
    use_keysteps: bool = False
    use_distill_nce_loss: bool = False
    use_pairwise_distill_nce_loss: bool = False
    pairwise_distill_mode: str = "all"  # all | unmasked
    use_center_duration: bool = True
    views: str = "all"  # exo | ego | all | multi
    num_max_views: int = 4
    multi_view_egoexo: bool = False
    randomize_narration_order: bool = False
    final_phase_prop: float = 0.3
    curriculum_train: bool = False
    sorted_curr_train: str = "phased"  # phased | sorted
    exos: str = "all"
    start_frac: float = 0.50
    end_epoch_frac: float = 0.75
    stitched_best_exo_distill: bool = False
    same_view_negative: bool = False
    only_same_view_negative: bool = False
    reverse_ranking: bool = False
    randomize_ranking: bool = False
    exo_exo_distill: bool = False

    # end-to-end S3D finetune (reference end2end/config.py:6-53)
    num_frames: int = 16  # frames per decoded clip (end2end/config.py:12)
    lr_backbone: float = 0.0  # separate S3D-backbone LR group; 0 = same LR.
    # The reference DECLARES --lr_backbone 1e-7 (end2end/config.py:16) but its
    # optim_policy never builds the group (main_nce.py:252-272 raises for any
    # non-default policy), so the shipped behavior is one LR; we implement the
    # intended two-group form behind a non-zero value.
    freezeBN: bool = False  # frozen BN buffers (end2end/freeze_bn.py:6-37)
    pt_backbone: bool = True  # init S3D from the MIL-NCE checkpoint (:33)
    convert_from_frozen_bn: bool = False  # remap .scale keys on load (:303-310)
    auto_align_tag: str = "htm_aa_v1"  # HTM-AA csv name (end2end/config.py:37)

    # data dimensions.  fps: annotation frame rate; None = per-dataset default
    # (egoexo4d 30, LEMMA 24 per loader_lemma.py, htm-aa clip decode 5 per
    # end2end/config.py:13) resolved by parse_args — an explicit --fps always
    # wins (a 30 sentinel used to be unoverridable for LEMMA).
    fps: Optional[int] = None
    video_feature_dim: int = 4096
    text_feature_dim: int = 4096
    audio_feature_dim: int = 2304
    feature_dim: int = 512
    use_egovlp_features: bool = False
    use_tf_video_features: bool = False
    # zero-shot VI baseline: score RAW video features through the VI eval
    # (reference config_egoexo4d.py:92, loss_egoexo4d.py:152); requires --test
    test_egovlp: bool = False

    # inference / output
    visualize: bool = False
    save_features: bool = False
    vis_freq: int = 1
    visualization_videos_per_epoch: int = 5000
    vi_encoder_path: str = ""

    # TPU-native additions (not in the reference surface)
    gather_negatives: bool = False  # all_gather contrastive negatives over DP
    attn_impl: str = "auto"  # auto | flash | xla
    # bf16 model compute in the train steps — the TPU equivalent of the
    # reference's always-on AMP fp16 autocast (train/main.py:75,514). Loss
    # math, grads and optimizer state stay f32; no GradScaler needed on bf16.
    # Off by default: f32 is bit-stable for checkpoint-parity runs.
    amp: bool = False
    # Use the intended curriculum ramp (linear start_frac -> 1.0 at
    # end_epoch_frac*max_epochs). Default off: the reference's formula
    # algebraically cancels end_epoch_frac (see data/sampling.py) and parity
    # means reproducing what it actually does.
    fixed_curriculum: bool = False
    # Run N optimizer steps a dispatch over N stacked prefetched batches: on
    # the card one replay of a CUDA graph of N whole steps
    # (parallel/train_step.py::TanScanStep), which takes the step's ~1,800
    # eager launches off the host. Logging, runtime snapshots and the LR
    # schedule stay per step (metrics come back stacked); they land every N
    # steps.
    fused_steps: int = 1
    # Stream the TAN MIL-NCE similarity grid from normalized features
    # (losses/milnce.py::_feature_two_way) instead of materializing the
    # per-layer f32 (B,S,T,B,N) volumes (the train-memory knee: OOM at
    # bs256). Identical math up to fp summation order; --no-fused_grid keeps
    # the reference-shaped volume path for bit-level comparisons.
    fused_grid: bool = True
    # Single-pass fused AdamW(+EMA) update (train/optim.py::FusedAdamWEMA):
    # identical math to the optax chain, ~0.5 ms less optimizer-tail HBM
    # traffic per step on a 43M-param model. Auto-falls back to the optax
    # path for configs it cannot fuse (grad accumulation, global-norm clip).
    fused_optimizer: bool = True
    # Adam moment dtype for the fused optimizer: float32 (reference parity)
    # or bfloat16 (halves optimizer state + its HBM traffic; documented
    # accuracy trade for throughput-bound runs).
    opt_moment_dtype: str = "float32"
    dp_devices: int = 0  # 0 = all local devices
    data_root: str = ""  # dataset tree root (replaces hardcoded cluster paths)
    multihost: bool = False  # call jax.distributed.initialize()

    # filled by set_path
    launch_timestamp: str = ""
    log_path: str = ""
    model_path: str = ""
    exp_path: str = ""
    iteration: int = 0

    def __post_init__(self):
        # per-dataset fps default (loader_lemma.py 24; end2end/config.py:13
        # clip decode 5; egoexo4d 30) resolved at construction so programmatic
        # users (ExperimentConfig(...) without parse_args) never see None.
        # parse_args re-resolves after its dataset override; an explicit fps
        # always wins.
        if self.fps is None:
            self.fps = _DEFAULT_FPS.get(self.dataset, 30)

    def validate(self):
        """Mutual-exclusion checks (main_egoexo4d_distributed.py:580-611)."""
        assert self.model in (
            "view_invariant", "grounding", "joint", "init", "cotrain", "s3d"
        )
        if self.dataset == "htm-aa":
            assert self.model == "s3d", "--dataset htm-aa trains the S3D backbone"
        if self.model == "s3d":
            assert self.dataset == "htm-aa", (
                "--model s3d is the end2end HTM-AA pipeline (end2end/main_nce.py)"
            )
        assert not (self.views == "ego" and self.use_distill_nce_loss)
        if self.curriculum_train:
            assert self.exos == "all"
        assert self.sorted_curr_train in ("phased", "sorted")
        assert self.pairwise_distill_mode in ("all", "unmasked")
        assert not (self.use_pairwise_distill_nce_loss and self.use_distill_nce_loss)
        if self.views == "multi":
            assert self.num_max_views >= 1
        assert self.optim_policy in ("default", "bce")
        assert self.opt_moment_dtype in ("float32", "bfloat16")
        assert self.attn_impl in ("auto", "flash", "xla"), self.attn_impl
        if self.test_egovlp:  # main_egoexo4d_distributed.py:606-607
            assert self.test, "--test_egovlp is a test-time baseline"
        return self


def parse_args(argv: Optional[List[str]] = None, dataset: Optional[str] = None) -> ExperimentConfig:
    """CLI with the reference's flag names (config_egoexo4d.py:6-95), as the
    JAX package's ``parse_args``: every dataclass field a flag, booleans
    with ``--no-<flag>``, no prefix abbreviations."""
    defaults = ExperimentConfig()
    # allow_abbrev=False: the explicit --model detection below scans argv for
    # the literal token, so '--mode joint' must be an argparse error
    parser = argparse.ArgumentParser(allow_abbrev=False)
    for f in dataclasses.fields(ExperimentConfig):
        if f.name in ("launch_timestamp", "log_path", "model_path", "exp_path", "iteration"):
            continue
        # the FIELD default: __post_init__ resolves fps=None to a rate, which
        # would defeat the "explicit --fps wins" sentinel
        default = f.default if f.default is not dataclasses.MISSING else getattr(defaults, f.name)
        if f.type in ("bool", bool) or isinstance(default, bool):
            parser.add_argument(f"--{f.name}", action=argparse.BooleanOptionalAction,
                                default=default)
        elif isinstance(default, tuple):
            parser.add_argument(f"--{f.name}", nargs="+", type=float, default=list(default))
        elif default is None:  # Optional[int] sentinel fields (fps)
            parser.add_argument(f"--{f.name}", type=int, default=None)
        else:
            parser.add_argument(f"--{f.name}", type=type(default), default=default)
    kw = vars(parser.parse_args(argv))
    kw["iou_thresholds"] = tuple(kw["iou_thresholds"])
    cfg = ExperimentConfig(**kw)
    if dataset:
        cfg.dataset = dataset
    # the e2e pipeline's only model (end2end/config.py:9), only when --model
    # was not given: an explicit `--model joint` must reach validate()
    raw_argv = sys.argv[1:] if argv is None else argv
    model_given = any(a == "--model" or a.startswith("--model=") for a in raw_argv)
    if cfg.dataset == "htm-aa" and not model_given:
        cfg.model = "s3d"
    if kw["fps"] is None:  # an explicit --fps always wins
        cfg.fps = _DEFAULT_FPS.get(cfg.dataset, 30)
    return cfg.validate()


def set_path(cfg: ExperimentConfig, root: str = ".") -> ExperimentConfig:
    """Experiment registry: the log-dir name encodes the key hyperparameters
    (config_egoexo4d.py:98-135); appends the full config to
    ``log/running_command.txt``. Resume and test write into the
    checkpoint's experiment directory."""
    dt = datetime.now().strftime("%Y_%m_%d_%H_%M")
    cfg.launch_timestamp = dt
    if cfg.resume:
        exp_path = os.path.dirname(os.path.dirname(cfg.resume))
    elif cfg.test:
        d = os.path.dirname(cfg.test)
        exp_path = os.path.dirname(d) if d.endswith("model") else d
    else:
        name_prefix = f"{cfg.name_prefix}_" if cfg.name_prefix else ""
        exp_path = os.path.join(
            root, f"log{cfg.prefix}",
            f"{name_prefix}{dt}_{cfg.model}_{cfg.loss}_{cfg.dataset}_"
            f"len{cfg.seq_len}_e{cfg.num_encoder_layers}d{cfg.num_decoder_layers}_"
            f"bs{cfg.batch_size}_lr{cfg.lr}_view={cfg.views}_"
            f"distill={cfg.use_distill_nce_loss}_"
            f"pair_ds={cfg.use_pairwise_distill_nce_loss}_"
            f"pair_ds_mode={cfg.pairwise_distill_mode}_"
            f"multi_ego={cfg.multi_view_egoexo}_"
            f"narr_rand={cfg.randomize_narration_order}")
    cfg.exp_path = exp_path
    cfg.log_path = os.path.join(exp_path, "log")
    cfg.model_path = os.path.join(exp_path, "model")
    os.makedirs(cfg.log_path, exist_ok=True)
    os.makedirs(cfg.model_path, exist_ok=True)
    with open(os.path.join(cfg.log_path, "running_command.txt"), "a") as f:
        json.dump({"command_time_stamp": dt,
                   **{k: (list(v) if isinstance(v, tuple) else v)
                      for k, v in dataclasses.asdict(cfg).items()}}, f, indent=2)
        f.write("\n")
    return cfg
