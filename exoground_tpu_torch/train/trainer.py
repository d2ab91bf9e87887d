"""TAN train loop (MIL-NCE alignment, init or EMA cotrain) on one device.

Counterpart of ``exoground_tpu/train/trainer.py`` (``BaseTrainer`` and
``TANTrainer``, reference train/main.py:36-544) over the port's
single-device steps (``parallel/train_step.py``): the online parameters are
the model's own, the EMA twin is a dictionary beside them, and
``FusedAdamWEMA`` updates both in place.

``BaseTrainer`` holds what the JAX one does on one device: checkpoints
(``save_epoch``, ``maybe_save_runtime`` on an iteration threshold,
``load_checkpoint`` in resume / pretrain / test mode), batches copied to
the card one ahead of the step through pinned buffers (``_prefetched``,
depth 2 as in the JAX package; ``_prefetched_groups`` stacks
``fused_steps`` of them into one upload), and the shared
epoch loop (meters, the finite-loss guard, every-5 logging, runtime
saves). ``TANTrainer`` adds the step, the frozen word2vec tower for token
batches, ``evaluate`` and ``fit`` with the downstream HTM-Align hook.

With ``fused_steps`` N > 1 each N batches that stack run as one call of
the N-step runner (``make_tan_train_step(scan_steps=N)``: on the card a
replayed CUDA graph); a group whose batches do not stack, and the epoch's
last batches short of a group, run single eager steps, as in the JAX
trainer. Both draw the random pos starts from one generator in step order,
so the parameters follow the same path whatever N is.

The random pos-start generator is not saved in a checkpoint (the JAX
package does not save its key either), so a resumed run is not a
bit-exact continuation: it restarts the generator from ``cfg.seed``.

Still raising, with the ROADMAP item that brings them (queue 1 item 4):
gradient accumulation and global-norm clipping.
"""

from __future__ import annotations

import collections
import os
import statistics
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from exoground_tpu_torch.data.pipeline import device_prefetch
from exoground_tpu_torch.losses.milnce import TANLossConfig
from exoground_tpu_torch.models.ema import ema_init
from exoground_tpu_torch.parallel.train_step import make_tan_eval_step, make_tan_train_step
from exoground_tpu_torch.train.checkpoint import (
    load_state,
    restore_into,
    save_checkpoint,
    save_runtime_checkpoint,
)
from exoground_tpu_torch.train.config import ExperimentConfig
from exoground_tpu_torch.train.logging import AsyncWriter, DeviceMonitor, Timer
from exoground_tpu_torch.train.optim import make_fused_optimizer
from exoground_tpu_torch.utils.device import resolve_device
from exoground_tpu_torch.utils.meters import AverageMeter, ProgressMeter

_LATER = "a later slice of the port (ROADMAP.md, queue 1 item 4)"


def _ragged_to_arrays(start: List, end: List, n_bucket: int):
    b = len(start)
    s = np.zeros((b, n_bucket), np.float32)
    e = np.zeros((b, n_bucket), np.float32)
    for i in range(b):
        k = min(len(start[i]), n_bucket)
        s[i, :k] = np.asarray(start[i], np.float32)[:k]
        e[i, :k] = np.asarray(end[i], np.float32)[:k]
    return s, e


def epoch_summary(stats: List[Dict]) -> Dict[str, float]:
    """Rates over entries of ``epoch_stats``. The window is every step and
    every wait for data, so ``samples_per_s`` is what a user pays per sample.
    ``step_ms_median`` is a step whose batch was already on the device (a
    loader-idle step once the loader has run ahead). ``data_share`` is the
    window's share spent waiting on data, also without each epoch's first
    batch (the loader starting up)."""
    step_s = [t for s in stats for t in s["step_s"]]
    data_s = [t for s in stats for t in s["data_s"]]
    window = sum(step_s) + sum(data_s)
    later = sum(sum(s["step_s"][1:]) + sum(s["data_s"][1:]) for s in stats)
    samples = sum(s["samples"] for s in stats)
    return dict(steps=len(step_s), window_s=window, samples_per_s=samples / window,
                step_ms_median=statistics.median(step_s) * 1e3,
                data_share=sum(data_s) / window,
                data_share_after_first=sum(t for s in stats for t in s["data_s"][1:])
                / max(later, 1e-12))


class BaseTrainer:
    """Checkpoints, prefetch and the epoch loop shared by the trainers;
    a subclass sets ``params``, ``target_params``, ``opt_state``, ``model``
    and ``prepare_batch``."""

    def __init__(self, cfg: ExperimentConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.iteration = cfg.iteration
        self._last_runtime_save = cfg.iteration
        self._last_log = cfg.iteration - 5  # the first step logs
        self.start_epoch = cfg.start_epoch
        self.best_acc = -1e5
        self.writer = AsyncWriter(cfg.log_path) if cfg.log_path else None
        self.monitor = DeviceMonitor(self.device)
        # per-epoch wall times of the loop's phases (also written to the log)
        self.epoch_stats: List[Dict] = []

    # --------------------------------------------------------- checkpointing
    def _ckpt_state(self, epoch: int) -> Dict:
        state = {
            "epoch": epoch,
            "state_dict": self.params,
            "best_acc": self.best_acc,
            "optimizer": {"count": self.opt_state.count, "mu": self.opt_state.mu,
                          "nu": self.opt_state.nu},
            "iteration": self.iteration,
        }
        if getattr(self, "is_cotrain", False):
            state["target_state_dict"] = self.target_params
        return state

    def save_epoch(self, epoch: int, is_best: bool = False, keep_all: bool = False):
        if not self.cfg.model_path:
            return
        save_checkpoint(self._ckpt_state(epoch), is_best=is_best,
                        filename=os.path.join(self.cfg.model_path, f"epoch{epoch}.pth.tar"),
                        keep_all=keep_all)

    def maybe_save_runtime(self, epoch: int):
        # a threshold, not a modulo: a resume offset (or several steps an
        # iteration) can leave `iteration % k == 0` without solutions
        due = self.iteration - self._last_runtime_save >= self.cfg.runtime_save_iter
        if self.cfg.model_path and due:
            self._last_runtime_save = self.iteration
            save_runtime_checkpoint(self._ckpt_state(epoch),
                                    filename=os.path.join(self.cfg.model_path,
                                                          "runtime.pth.tar"))

    def load_checkpoint(self, path: str, mode: str = "resume"):
        """resume: parameters, EMA twin, optimizer state, iteration, epoch
        and best; pretrain / test: parameters (and the twin) only, non-strict
        (reference main.py:452-484)."""
        if mode not in ("resume", "pretrain", "test"):
            raise ValueError(f"checkpoint mode {mode!r}: resume, pretrain or test")
        blob = load_state(path)
        restore_into(self.params, blob["state_dict"])
        if mode == "resume":
            self.iteration = int(blob.get("iteration", 0))
            self._last_runtime_save = self.iteration
            self._last_log = self.iteration - 5
            self.start_epoch = int(blob.get("epoch", 0)) + 1
            self.best_acc = float(blob.get("best_acc", self.best_acc))
            opt = blob.get("optimizer")
            if opt is not None:
                self.opt_state.count = int(opt["count"])
                restore_into(self.opt_state.mu, opt["mu"])
                restore_into(self.opt_state.nu, opt["nu"])
        if getattr(self, "target_params", None) is not None:
            restore_into(self.target_params, blob.get("target_state_dict", blob["state_dict"]))

    # ------------------------------------------------------------- batches
    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def _prefetched(self, loader: Iterable[Dict], depth: int = 2):
        """Prepared batches on the device, copied ``depth`` - 1 ahead of the
        consumer through pinned buffers on a side stream (the JAX
        ``_prefetched``: H2D overlaps the step in flight)."""
        return device_prefetch((self.prepare_batch(raw) for raw in loader), self.device,
                               size=depth)

    def _prefetched_groups(self, loader: Iterable[Dict], n: int, depth: int = 2):
        """('fused', the (n, B, ...) stack of n prepared batches) for each n
        that stack, else ('single', batch) for each batch of the group, and
        for the epoch's last batches short of n; each item uploaded in one
        copy, ``depth`` - 1 ahead (the JAX ``_prefetched_stacked``)."""
        kinds = collections.deque()

        def items():
            group = []
            for raw in loader:
                group.append(self.prepare_batch(raw))
                if len(group) < n:
                    continue
                try:
                    stacked = {k: np.stack([g[k] for g in group]) for k in group[0]}
                except (ValueError, KeyError):  # shapes or keys that do not stack
                    stacked = None
                if stacked is not None:
                    kinds.append("fused")
                    yield stacked
                    group = []
                    continue
                for g in group:
                    kinds.append("single")
                    yield g
                group = []
            for g in group:
                kinds.append("single")
                yield g

        for batch in device_prefetch(items(), self.device, size=depth):
            yield kinds.popleft(), batch

    # ------------------------------------------------------------ the loop
    def _run_train_epoch(self, loader: Iterable[Dict], epoch: int,
                         do_step: Callable[[Dict[str, torch.Tensor]], Dict],
                         do_fused: Optional[Callable[[Dict[str, torch.Tensor]], Dict]] = None
                         ) -> float:
        """Meters and progress, the finite-loss guard (main.py:102-103),
        every-5 logging and the runtime-checkpoint cadence (trainer.py:
        303-355). ``do_step(batch) -> metrics`` advances the state one step;
        ``do_fused(stacked) -> stacked metrics`` (with ``cfg.fused_steps`` >
        1) N steps. A group counts as N steps of its time / N, its wait for
        data on the first."""
        cfg = self.cfg
        meters = {k: AverageMeter(k, ":.4f") for k in ("Time", "Data", "Loss")}
        progress = ProgressMeter(getattr(loader, "__len__", lambda: 0)(),
                                 list(meters.values()), prefix=f"Epoch:[{epoch}]")
        step_s, data_s, samples = [], [], 0
        timer = Timer()
        source = (self._prefetched_groups(loader, cfg.fused_steps) if do_fused is not None
                  else (("single", b) for b in self._prefetched(loader)))
        for idx, (kind, batch) in enumerate(source):
            wait = timer.lap()
            meters["Data"].update(wait)
            if kind == "fused":
                metrics = do_fused(batch)
                losses = metrics["loss"].tolist()  # waits for the group
                last = {k: v[-1] for k, v in metrics.items()}  # the group's last step logs
            else:
                metrics = do_step(batch)
                losses = [float(metrics["loss"])]  # waits for the step
                last = metrics
            rows = batch["video"].shape[-3]
            for loss in losses:
                samples += rows
                if np.isfinite(loss):
                    meters["Loss"].update(loss, rows)
            self._log(last, "train/")  # reads the other scalars only when it logs
            self.iteration += len(losses)
            per_step = timer.lap() / len(losses)
            step_s += [per_step] * len(losses)
            data_s += [wait] + [0.0] * (len(losses) - 1)
            meters["Time"].update(per_step, len(losses))
            if idx % cfg.print_freq == 0:
                progress.display(idx)
            self.maybe_save_runtime(epoch)
        self.epoch_stats.append(dict(epoch=epoch, steps=len(step_s), samples=samples,
                                     step_s=step_s, data_s=data_s))
        if self.writer:
            self.writer.add_data("train/total_epoch_loss", meters["Loss"].avg, epoch)
            if step_s:
                summary = epoch_summary(self.epoch_stats[-1:])
                self.writer.add_data("time/step_ms", summary["step_ms_median"], epoch)
                self.writer.add_data("time/data_share", summary["data_share"], epoch)
                self.writer.add_data("time/samples_per_s", summary["samples_per_s"], epoch)
        return meters["Loss"].avg

    def _log(self, metrics: Dict, prefix: str):
        if self.writer is None:
            return
        if self.iteration - self._last_log >= 5:  # every-5 cadence (main.py:119)
            self._last_log = self.iteration
            self.writer.add_dict(metrics, self.iteration, prefix=prefix)
            self.monitor.log_to(self.writer, self.iteration)

    def close(self):
        if self.writer is not None:
            self.writer.close()


class TANTrainer(BaseTrainer):
    """MIL-NCE alignment training of a port ``TemporalAligner`` (its
    weights as they are: seeded, bridged from JAX or loaded by the caller).

    ``text_tower``: the frozen word2vec tower (a ``Word2VecModel`` or its
    tensors). With it, batches may carry 'token' (B, N, L) ids, embedded
    inside the train and eval steps on the device (the reference's in-model
    text tower, train/main.py:166-184); without it they carry 'text' (or
    'narration_features') feature arrays."""

    def __init__(self, model, cfg: ExperimentConfig, iters_per_epoch: int = 1000,
                 device="cuda", text_tower=None):
        cfg.validate()
        super().__init__(cfg, device)
        self.model = model.to(self.device)
        if cfg.attn_impl != "auto":  # 'auto' keeps the model's own (train/main.py:124)
            self.model.attn_impl = cfg.attn_impl
        tower = getattr(text_tower, "params", text_tower)
        self._tower_params = (None if tower is None else
                              {k: v.to(self.device) for k, v in tower.items()})
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
                f"optimizer, which waits for {_LATER}")
        self.opt_state = self.tx.init(self.params)
        step = make_tan_train_step(
            self.model, self.loss_cfg, self.tx,
            ema_momentum=cfg.momentum_m if self.is_cotrain else None,
            gather_negatives=cfg.gather_negatives, text_tower_params=self._tower_params,
            compute_dtype="bfloat16" if cfg.amp else "float32",
            fused_grid=cfg.fused_grid,
            scan_steps=cfg.fused_steps if cfg.fused_steps > 1 else None)
        # the N-step runner (fused_steps > 1) and the one step it repeats
        self.fused_step = step if cfg.fused_steps > 1 else None
        self.step = step.single if cfg.fused_steps > 1 else step
        self._eval_step = None

    # ------------------------------------------------------------ batch prep
    def prepare_batch(self, batch: Dict) -> Dict[str, np.ndarray]:
        """Host arrays of one batch (trainer.py:457-488): masks as bool,
        token ids as int32 (with the tower), ragged start/end lists padded to
        the text bucket, abs_text_pos."""
        out = {"video": np.asarray(batch["video"], np.float32)}
        out["video_padding_mask"] = np.asarray(
            batch.get("video_padding_mask", batch.get("padding_mask")), bool)
        if "text" in batch and isinstance(batch["text"], np.ndarray):
            out["text"] = batch["text"]
        elif "narration_features" in batch:
            out["text"] = np.asarray(batch["narration_features"], np.float32)
        elif self._tower_params is not None:
            out["token"] = np.asarray(batch["token"], np.int32)
        else:
            raise ValueError("batch needs 'text' features, narration_features, "
                             "or tokens and a text_tower")
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

    # ------------------------------------------------------------ train loop
    def _do_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.params, self.target_params, self.opt_state, metrics = self.step(
            self.params, self.target_params, self.opt_state, batch, self.generator)
        return metrics

    def _do_fused(self, batches: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.params, self.target_params, self.opt_state, metrics = self.fused_step(
            self.params, self.target_params, self.opt_state, batches, self.generator)
        return metrics

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step on a device batch; returns its metrics."""
        metrics = self._do_step(batch)
        self.iteration += 1
        return metrics

    def train_epoch(self, loader: Iterable[Dict], epoch: int) -> float:
        """One pass over ``loader``; the mean finite loss, weighted by rows."""
        self.model.train()
        return self._run_train_epoch(loader, epoch, self._do_step,
                                     self._do_fused if self.fused_step is not None else None)

    def evaluate(self, loader: Iterable[Dict], epoch: int) -> float:
        """Validation loss of the train protocol (trainer.py:511-541): the
        eval step over every batch of ``loader``, averaged by rows."""
        if self._eval_step is None:
            self._eval_step = make_tan_eval_step(
                self.model, self.loss_cfg, is_cotrain=self.is_cotrain,
                text_tower_params=self._tower_params, fused_grid=self.cfg.fused_grid)
        meter = AverageMeter("Loss", ":.4f")
        for batch in self._prefetched(loader):
            ld = self._eval_step(self.params, self.target_params, batch)
            loss = float(ld["loss"])
            if np.isfinite(loss):
                meter.update(loss, int(ld["_rows"]))
        if self.writer:
            self.writer.add_data("val/loss", meter.avg, epoch)
        return meter.avg

    def fit(self, train_loader, val_loader=None,
            downstream_eval: Optional[Callable] = None) -> float:
        """Train from ``start_epoch`` to ``cfg.epochs`` (trainer.py:543-563):
        each ``eval_freq``-th epoch the validation loss and, when given,
        ``downstream_eval(self)`` (e.g. HTM-Align, whose 'Recall' then ranks
        the epochs); a checkpoint every epoch (all kept for cotrain). Returns
        the best score."""
        cfg = self.cfg
        best = self.best_acc  # survives resume (the checkpoint's best_acc)
        for epoch in range(self.start_epoch, cfg.epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            self.train_epoch(train_loader, epoch)
            stats = self.epoch_stats[-1]
            is_best = False
            if val_loader is not None and epoch % cfg.eval_freq == 0:
                t0 = time.perf_counter()
                val_loss = self.evaluate(val_loader, epoch)
                stats["val_s"] = time.perf_counter() - t0
                score = -val_loss
                if downstream_eval is not None:
                    t0 = time.perf_counter()
                    ds = downstream_eval(self)  # e.g. HTM-Align R@1
                    stats["downstream_s"] = time.perf_counter() - t0
                    if self.writer:
                        self.writer.add_dict(ds, epoch, prefix="val/")
                    score = ds.get("Recall", score)
                is_best = score > best
                best = max(score, best)
                self.best_acc = best
            t0 = time.perf_counter()
            self.save_epoch(epoch, is_best=is_best, keep_all=self.is_cotrain)
            stats["save_s"] = time.perf_counter() - t0
            if self.writer:
                self.writer.add_dict({k: v for k, v in stats.items()
                                      if k in ("val_s", "downstream_s", "save_s")},
                                     epoch, prefix="time/")
        return best
