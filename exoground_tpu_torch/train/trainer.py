"""TAN train loop (MIL-NCE alignment, init or EMA cotrain) on one device.

Counterpart of ``exoground_tpu/train/trainer.py::TANTrainer`` (reference
train/main.py:36-544) over the port's single-device step
(``parallel/train_step.py``): the online parameters are the model's own,
the EMA twin is a dictionary beside them, ``FusedAdamWEMA`` updates both in
place, and a finite-loss guard keeps non-finite losses out of the meters
(main.py:102-103).

Waits for later slices: checkpoints (save/resume, the JAX package's
msgpack format), ``evaluate``/``make_tan_eval_step`` and the downstream
eval hooks, ``fused_steps``, the word2vec text tower (token batches), the
event writer, data parallelism.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List

import numpy as np
import torch

from exoground_tpu_torch.losses.milnce import TANLossConfig
from exoground_tpu_torch.models.ema import ema_init
from exoground_tpu_torch.parallel.train_step import make_tan_train_step
from exoground_tpu_torch.train.config import ExperimentConfig
from exoground_tpu_torch.train.optim import make_fused_optimizer
from exoground_tpu_torch.utils.device import resolve_device
from exoground_tpu_torch.utils.meters import AverageMeter, ProgressMeter


def _ragged_to_arrays(start: List, end: List, n_bucket: int):
    b = len(start)
    s = np.zeros((b, n_bucket), np.float32)
    e = np.zeros((b, n_bucket), np.float32)
    for i in range(b):
        k = min(len(start[i]), n_bucket)
        s[i, :k] = np.asarray(start[i], np.float32)[:k]
        e[i, :k] = np.asarray(end[i], np.float32)[:k]
    return s, e


class TANTrainer:
    """MIL-NCE alignment training of a port ``TemporalAligner`` (its
    weights as they are: seeded, bridged from JAX or loaded by the caller).

    Batches carry 'text' (or 'narration_features') feature arrays; token
    batches need the text tower, which waits for a later slice."""

    def __init__(self, model, cfg: ExperimentConfig, iters_per_epoch: int = 1000,
                 device="cuda"):
        cfg.validate()
        if cfg.fused_steps > 1:
            raise NotImplementedError("fused_steps waits for a later slice of the port")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if cfg.attn_impl != "auto":  # 'auto' keeps the model's own (train/main.py:124)
            self.model.attn_impl = cfg.attn_impl
        self.iteration = cfg.iteration
        self.start_epoch = cfg.start_epoch
        self.generator = torch.Generator().manual_seed(cfg.seed)  # random pos start
        self.loss_cfg = TANLossConfig(
            model=cfg.model, sim=cfg.sim, learn_agreement=bool(cfg.learn_agreement),
            temporal_agreement_type=cfg.temporal_agreement_type,
            loss_threshold=cfg.loss_threshold,
            use_alignability_head=bool(cfg.use_alignability_head),
            optim_policy=cfg.optim_policy,
        )
        # float32 masters, shared by storage with the module
        self.params = {k: p.detach() for k, p in self.model.named_parameters()}
        self.is_cotrain = cfg.model == "cotrain"
        self.target_params = ema_init(self.params)
        self.tx = make_fused_optimizer(
            self.params, lr=cfg.lr, weight_decay=cfg.wd,
            total_iterations=cfg.epochs * iters_per_epoch, grad_clip=cfg.clip_grad or None,
            accumulate_steps=cfg.backprop_freq, policy=cfg.optim_policy,
            moment_dtype=cfg.opt_moment_dtype)
        if self.tx is None:
            raise NotImplementedError(
                "gradient accumulation and global-norm clipping need the optax-chain "
                "optimizer, which waits for a later slice of the port")
        self.opt_state = self.tx.init(self.params)
        self.step = make_tan_train_step(
            self.model, self.loss_cfg, self.tx,
            ema_momentum=cfg.momentum_m if self.is_cotrain else None,
            gather_negatives=cfg.gather_negatives,
            compute_dtype="bfloat16" if cfg.amp else "float32",
            fused_grid=cfg.fused_grid)

    # ------------------------------------------------------------ batch prep
    def prepare_batch(self, batch: Dict) -> Dict[str, np.ndarray]:
        """Host arrays of one batch (trainer.py:457-488): masks as bool,
        ragged start/end lists padded to the text bucket, abs_text_pos."""
        out = {"video": np.asarray(batch["video"], np.float32)}
        out["video_padding_mask"] = np.asarray(
            batch.get("video_padding_mask", batch.get("padding_mask")), bool)
        if "text" in batch and isinstance(batch["text"], np.ndarray):
            out["text"] = batch["text"]
        elif "narration_features" in batch:
            out["text"] = np.asarray(batch["narration_features"], np.float32)
        elif "token" in batch:
            raise NotImplementedError("token batches need the word2vec text tower, "
                                      "which waits for a later slice of the port")
        else:
            raise ValueError("batch needs 'text' features or narration_features")
        out["text_padding_mask"] = np.asarray(
            batch.get("text_padding_mask", batch.get("narration_padding_mask")), bool)
        n_bucket = out["text_padding_mask"].shape[1]
        if isinstance(batch.get("start"), list):
            s, e = _ragged_to_arrays(batch["start"], batch["end"], n_bucket)
        else:
            s = np.asarray(batch["start"], np.float32)
            e = np.asarray(batch["end"], np.float32)
        out["start"], out["end"] = s, e
        t = out["video"].shape[1]
        if "abs_text_pos" in batch:
            out["abs_text_pos"] = np.asarray(batch["abs_text_pos"], np.float32)
        else:
            out["abs_text_pos"] = np.stack([s / t, e / t], axis=-1)
        return out

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    # ------------------------------------------------------------ train loop
    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step on a device batch; returns its metrics."""
        self.params, self.target_params, self.opt_state, metrics = self.step(
            self.params, self.target_params, self.opt_state, batch, self.generator)
        self.iteration += 1
        return metrics

    def _run_train_epoch(self, loader: Iterable[Dict], epoch: int) -> float:
        """Meters and progress, the finite-loss guard (trainer.py:303-355)."""
        cfg = self.cfg
        meters = {k: AverageMeter(k, ":.4f") for k in ("Time", "Data", "Loss")}
        progress = ProgressMeter(getattr(loader, "__len__", lambda: 0)(),
                                 list(meters.values()), prefix=f"Epoch:[{epoch}]")
        t0 = time.perf_counter()
        for idx, raw in enumerate(loader):
            batch = self.to_device(self.prepare_batch(raw))
            t1 = time.perf_counter()
            meters["Data"].update(t1 - t0)
            metrics = self.train_step(batch)
            loss = float(metrics["loss"])  # waits for the step
            if np.isfinite(loss):
                meters["Loss"].update(loss, batch["video"].shape[0])
            t0 = time.perf_counter()
            meters["Time"].update(t0 - t1)
            if idx % cfg.print_freq == 0:
                progress.display(idx)
        return meters["Loss"].avg

    def train_epoch(self, loader: Iterable[Dict], epoch: int) -> float:
        """One pass over ``loader``; the mean finite loss, weighted by rows."""
        self.model.train()
        return self._run_train_epoch(loader, epoch)

    def fit(self, train_loader) -> float:
        """Train from ``start_epoch`` to ``cfg.epochs``; returns the last
        epoch's mean loss (validation and checkpoints wait)."""
        loss = float("nan")
        for epoch in range(self.start_epoch, self.cfg.epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            loss = self.train_epoch(train_loader, epoch)
        return loss
