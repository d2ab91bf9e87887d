"""Train loops: TAN (MIL-NCE alignment, init or EMA cotrain) and EgoExo4D /
LEMMA (view-invariant, grounding, joint), data parallel over a ``Mesh``.

Counterpart of ``exoground_tpu/train/trainer.py`` (``BaseTrainer`` and
``TANTrainer``, reference train/main.py:36-544) over the port's
steps (``parallel/train_step.py``): the online parameters are
the model's own, the EMA twin is a dictionary beside them, and the optimizer
updates both in place: ``FusedAdamWEMA`` under ``--fused_optimizer`` (the
default) when it can serve the configuration, else the optax chain
(``make_optimizer``: ``--backprop_freq`` accumulation, global-norm
clipping, ``--no-fused_optimizer``), chosen as the JAX ``_build_optimizer``
chooses (trainer.py:56-71).

``BaseTrainer`` holds what the JAX one does: checkpoints
(``save_epoch``, ``maybe_save_runtime`` on an iteration threshold,
``load_checkpoint`` in resume / pretrain / test mode, from the port's
files or the JAX package's msgpack files and orbax directories), batches
copied to the card one ahead of the step through pinned buffers (``_prefetched``,
depth 2 as in the JAX package; ``_prefetched_groups`` stacks
``fused_steps`` of them into one upload), and the shared
epoch loop (meters, the finite-loss guard, every-5 logging, runtime
saves). ``TANTrainer`` adds the step, the frozen word2vec tower for token
batches, ``evaluate`` and ``fit`` with the downstream HTM-Align hook.
``EgoExoTrainer`` (the JAX ``EgoExoTrainer``, trainer.py:566-807) adds the
grounding-family step, ``prepare_batch`` (the (B, V) view mask, the
positive view's ego features, the same-view negatives gathered from the
model's input), ``evaluate`` with exact meters and, at ``--test``, the IoU
binned by camera rank and ``test_results_epoch_{epoch}.json``, and ``fit``
with the curriculum phases. ``S3DTrainer`` (the JAX ``S3DTrainer``,
trainer.py:810-924) finetunes S3D-G end to end on HTM-AA clips; its BN
running stats (``batch_stats``) are checkpointed and restored with the
parameters, as the JAX ``_ckpt_state`` / ``load_checkpoint`` do.

With ``fused_steps`` N > 1 each N batches that stack run as one call of
the N-step runner (``make_tan_train_step(scan_steps=N)``: on the card a
replayed CUDA graph); a group whose batches do not stack, and the epoch's
last batches short of a group, run single eager steps, as in the JAX
trainer. Both draw the random pos starts from one generator in step order,
so the parameters follow the same path whatever N is.

Data parallel (``parallel/mesh.py``): one trainer a rank, the mesh's (the
process group's; world 1 without one). Each rank holds the whole state,
broadcast from rank 0 after it is built or loaded (``_replicate``), takes
its block of each host batch (``shard_batch``) and uploads that alone; the
steps reduce over the ranks. Only the chief (rank 0) writes: checkpoints,
the metrics log and the test results. Validation pads a host batch's
ragged tail to the mesh's multiple (``_pad_rows``: by repeating rows for
TAN, whose grid couples a rank's rows, and with masked rows and
'row_valid' for grounding), and the test's IoU binning reads the host's
rows, gathered from its ranks (``_host_rows``). Each rank draws its own pos
starts from a generator of its own (``rank_seed``).

The random pos-start generator is not saved in a checkpoint (the JAX
package does not save its key either), so a resumed run is not a
bit-exact continuation: it restarts the generator from ``cfg.seed``.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from exoground_tpu_torch.data.pipeline import device_prefetch
from exoground_tpu_torch.losses.grounding import GroundingLossConfig
from exoground_tpu_torch.losses.milnce import TANLossConfig
from exoground_tpu_torch.models.ema import ema_init
from exoground_tpu_torch.parallel import collectives
from exoground_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
from exoground_tpu_torch.parallel.train_step import (
    make_grounding_eval_step,
    make_grounding_train_step,
    make_s3d_nce_step,
    make_tan_eval_step,
    make_tan_train_step,
)
from exoground_tpu_torch.train.checkpoint import (
    checkpoint_format,
    jax_layout,
    load_state,
    restore_into,
    save_checkpoint,
    save_runtime_checkpoint,
)
from exoground_tpu_torch.train.config import ExperimentConfig
from exoground_tpu_torch.train.logging import AsyncWriter, DeviceMonitor, Timer
from exoground_tpu_torch.train.optim import (
    adapt_optimizer_state,
    make_fused_optimizer,
    make_optimizer,
    optimizer_state_dict,
)
from exoground_tpu_torch.utils.convert import (
    grounding_checkpoint_from_jax,
    s3d_checkpoint_from_jax,
    tan_checkpoint_from_jax,
)
from exoground_tpu_torch.utils.device import resolve_device
from exoground_tpu_torch.utils.meters import AverageMeter, ProgressMeter


def _build_optimizer(cfg: ExperimentConfig, params, total_iterations: int, **kw):
    """The fused single-pass AdamW when ``cfg.fused_optimizer`` is set and it
    can serve the configuration, else the optax chain (the JAX
    ``_build_optimizer``, trainer.py:56-71). Both share the step protocol
    and the checkpoint layout (``optimizer_state_dict``)."""
    opt_kw = dict(lr=cfg.lr, weight_decay=cfg.wd, total_iterations=total_iterations,
                  grad_clip=cfg.clip_grad or None, accumulate_steps=cfg.backprop_freq, **kw)
    if cfg.fused_optimizer:
        fused = make_fused_optimizer(params, moment_dtype=cfg.opt_moment_dtype, **opt_kw)
        if fused is not None:
            return fused
    return make_optimizer(params, **opt_kw)


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


def rank_seed(seed: int, rank: int) -> int:
    """Rank ``rank``'s pos-start seed: ``seed`` itself on rank 0, the others
    spread apart by the 32-bit golden ratio (the generator keeps 32 bits)."""
    return (seed + rank * 0x9E3779B9) % 2**32


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


class BaseTrainer:
    """Checkpoints, prefetch and the epoch loop shared by the trainers;
    a subclass sets ``params``, ``target_params``, ``opt_state``, ``model``
    and ``prepare_batch``, the batch entry whose rows it counts
    (``batch_key``, rows on axis ``rows_axis``) and the bridge of the JAX
    package's checkpoints (``from_jax``); ``batch_stats`` when it has BN
    running stats. ``mesh``: the data-parallel group (``make_mesh()``'s when
    None)."""

    batch_key = "video"
    rows_axis = -3  # (B, T, D), stacked (N, B, T, D)
    from_jax = staticmethod(tan_checkpoint_from_jax)

    def __init__(self, cfg: ExperimentConfig, device="cuda", mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = make_mesh(device=self.device) if mesh is None else mesh
        self.iteration = cfg.iteration
        self._last_runtime_save = cfg.iteration
        self._last_log = cfg.iteration - 5  # the first step logs
        self.start_epoch = cfg.start_epoch
        self.best_acc = -1e5
        # rank 0 alone writes checkpoints, the log and the test results
        # (the reference's rank == 0 guards, main.py:137,119)
        self.is_chief = self.mesh.rank == 0
        self.writer = AsyncWriter(cfg.log_path) if cfg.log_path and self.is_chief else None
        self.monitor = DeviceMonitor(self.device)
        # the random pos starts: one generator a rank, rank 0's cfg.seed's
        self.generator = torch.Generator().manual_seed(rank_seed(cfg.seed, self.mesh.rank))
        # per-epoch wall times of the loop's phases (also written to the log)
        self.epoch_stats: List[Dict] = []

    # --------------------------------------------------------- checkpointing
    def _ckpt_state(self, epoch: int) -> Dict:
        state = {
            "epoch": epoch,
            "state_dict": self.params,
            "best_acc": self.best_acc,
            "optimizer": optimizer_state_dict(self.opt_state),
            "iteration": self.iteration,
        }
        if getattr(self, "is_cotrain", False):
            state["target_state_dict"] = self.target_params
        if getattr(self, "batch_stats", None) is not None:
            state["batch_stats"] = self.batch_stats  # learned state under train_bn
        return state

    def save_epoch(self, epoch: int, is_best: bool = False, keep_all: bool = False):
        if not self.cfg.model_path or not self.is_chief:
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
            if not self.is_chief:
                return
            save_runtime_checkpoint(self._ckpt_state(epoch),
                                    filename=os.path.join(self.cfg.model_path,
                                                          "runtime.pth.tar"))

    def load_checkpoint(self, path: str, mode: str = "resume"):
        """resume: parameters, EMA twin, optimizer state, iteration, epoch
        and best; pretrain / test: parameters (and the twin) only, non-strict
        (reference main.py:452-484). ``path`` is the port's checkpoint or the
        JAX package's msgpack file or orbax directory (``checkpoint_format``,
        ``jax_layout``), bridged by ``from_jax``; the optimizer state of either layout is
        adapted to this trainer's optimizer (``adapt_optimizer_state``).
        Every rank reads the file; rank 0's state is then broadcast."""
        if mode not in ("resume", "pretrain", "test"):
            raise ValueError(f"checkpoint mode {mode!r}: resume, pretrain or test")
        blob = load_state(path)
        if jax_layout(checkpoint_format(path)):
            blob = self.from_jax(blob)
        restore_into(self.params, blob["state_dict"])
        if mode == "resume":
            self.iteration = int(blob.get("iteration", 0))
            self._last_runtime_save = self.iteration
            self._last_log = self.iteration - 5
            self.start_epoch = int(blob.get("epoch", 0)) + 1
            self.best_acc = float(blob.get("best_acc", self.best_acc))
            opt = blob.get("optimizer")
            if opt is not None and adapt_optimizer_state(self.opt_state, opt) is None:
                print("[checkpoint] optimizer state not restored: no count / mu / nu")
        if getattr(self, "target_params", None) is not None:
            restore_into(self.target_params, blob.get("target_state_dict", blob["state_dict"]))
        if getattr(self, "batch_stats", None) is not None and "batch_stats" in blob:
            restore_into(self.batch_stats, blob["batch_stats"])
        self._replicate()

    def _replicate(self):
        """Rank 0's parameters, EMA twin, BN stats and optimizer moments (and
        the accumulator) on every rank (the JAX ``_replicate``, trainer.py:
        198-204); nothing without a group."""
        trees = [self.params, getattr(self, "target_params", None) or {},
                 self.opt_state.mu, self.opt_state.nu, getattr(self.opt_state, "acc_grads", {}),
                 getattr(self, "batch_stats", None) or {}]
        replicate({f"{i}.{k}": v for i, d in enumerate(trees) for k, v in d.items()},
                  self.mesh)

    # ------------------------------------------------------------- batches
    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def _prefetched(self, loader: Iterable[Dict], depth: int = 2, pad: Optional[str] = None):
        """Prepared batches on the device, this rank's block of each
        (``shard_batch``; with ``pad`` the host batch first padded by
        ``_pad_rows``), copied ``depth`` - 1 ahead of the consumer through
        pinned buffers on a side stream (the JAX ``_prefetched``: H2D
        overlaps the step in flight)."""
        def blocks():
            for raw in loader:
                batch = self.prepare_batch(raw)
                if pad is not None:
                    batch = self._pad_rows(batch, pad)
                yield shard_batch(batch, self.mesh)

        return device_prefetch(blocks(), self.device, size=depth)

    def _pad_rows(self, batch: Dict[str, np.ndarray], mode: str = "zeros") -> Dict:
        """A host batch padded to the mesh's multiple of rows for the sharded
        eval steps (the JAX ``_pad_rows``, trainer.py:255-285). 'zeros':
        zero rows whose narrations are all padding, and 'row_valid' (B,)
        marking the real rows; 'wrap': the first rows repeated (the
        reference DistributedSampler's pad by repeat; TAN's grid couples a
        rank's rows, so masked rows would not do)."""
        b = next(iter(batch.values())).shape[0]
        b_pad = _round_up(b, self.mesh.world)  # the JAX mesh.devices.size
        out = dict(batch)
        if b_pad != b:
            for k, v in batch.items():
                v = np.asarray(v)
                if mode == "wrap":
                    out[k] = np.concatenate([v] * -(-b_pad // b), axis=0)[:b_pad]
                else:
                    pad = (np.ones if k == "narration_padding_mask" else np.zeros)(
                        (b_pad - b,) + v.shape[1:], v.dtype)
                    out[k] = np.concatenate([v, pad], axis=0)
        if mode == "zeros":
            out["row_valid"] = (np.arange(b_pad) < b).astype(np.float32)
        return out

    def _host_rows(self, rows: torch.Tensor) -> np.ndarray:
        """The rows of this rank's host, in row order, from each rank's
        block of an eval output (the JAX ``_local_eval_rows``, trainer.py:
        287-301): every rank's block is gathered, and the host's ranks'
        taken."""
        every = collectives.all_gather_rows(rows.contiguous(), self.mesh)
        per_host = every.shape[0] // self.mesh.hosts
        host = every[self.mesh.host * per_host:(self.mesh.host + 1) * per_host]
        return host.float().cpu().numpy()

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
                    yield shard_batch(stacked, self.mesh, dim=1)
                    group = []
                    continue
                for g in group:
                    kinds.append("single")
                    yield shard_batch(g, self.mesh)
                group = []
            for g in group:
                kinds.append("single")
                yield shard_batch(g, self.mesh)

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
        data on the first. A step's rows are the global batch's (this rank's
        block times the world), as the JAX loop weighs its meters."""
        cfg = self.cfg
        meters = {k: AverageMeter(k, ":.4f") for k in ("Time", "Data", "Loss")}
        progress = ProgressMeter(getattr(loader, "__len__", lambda: 0)(),
                                 list(meters.values()), prefix=f"Epoch:[{epoch}]")
        step_s, data_s, samples, step_losses = [], [], 0, []
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
            rows = batch[self.batch_key].shape[self.rows_axis] * self.mesh.world
            step_losses += losses
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
            if idx % cfg.print_freq == 0 and self.is_chief:
                progress.display(idx)
            self.maybe_save_runtime(epoch)
        self.epoch_stats.append(dict(epoch=epoch, steps=len(step_s), samples=samples,
                                     step_s=step_s, data_s=data_s, losses=step_losses))
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
                 device="cuda", text_tower=None, mesh=None):
        cfg.validate()
        super().__init__(cfg, device, mesh)
        self.model = model.to(self.device)
        if cfg.attn_impl != "auto":  # 'auto' keeps the model's own (train/main.py:124)
            self.model.attn_impl = cfg.attn_impl
        tower = getattr(text_tower, "params", text_tower)
        self._tower_params = (None if tower is None else
                              {k: v.to(self.device) for k, v in tower.items()})
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
        self.tx = _build_optimizer(cfg, self.params, cfg.epochs * iters_per_epoch,
                                   policy=cfg.optim_policy)
        self.opt_state = self.tx.init(self.params)
        self._replicate()
        step = make_tan_train_step(
            self.model, self.loss_cfg, self.tx,
            ema_momentum=cfg.momentum_m if self.is_cotrain else None,
            gather_negatives=cfg.gather_negatives, text_tower_params=self._tower_params,
            compute_dtype="bfloat16" if cfg.amp else "float32",
            fused_grid=cfg.fused_grid,
            scan_steps=cfg.fused_steps if cfg.fused_steps > 1 else None, mesh=self.mesh)
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
        eval step over every batch of ``loader``, sharded over the mesh
        (each ragged tail padded by repeating rows: the repeats count in
        '_rows', and one can sit in its original's grid, as in the JAX
        trainer), averaged by rows."""
        if self._eval_step is None:
            self._eval_step = make_tan_eval_step(
                self.model, self.loss_cfg, is_cotrain=self.is_cotrain,
                text_tower_params=self._tower_params, fused_grid=self.cfg.fused_grid,
                mesh=self.mesh)
        meter = AverageMeter("Loss", ":.4f")
        for batch in self._prefetched(loader, pad="wrap"):
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


class EgoExoTrainer(BaseTrainer):
    """View-invariant, grounding and joint training on EgoExo4D or LEMMA
    (the JAX ``EgoExoTrainer``; reference main_egoexo4d_distributed.py:
    573-883) of a port model: ``ViewInvariantMLP``, ``GroundingModel`` or
    ``ExoGroundingTransformer``, its weights as they are. No EMA twin."""

    batch_key = "video_features"
    from_jax = staticmethod(grounding_checkpoint_from_jax)
    _VI_KEYS = ("L1 loss", "Pos cosine sim", "Avg neg cosine sim", "InfoNCE loss")

    def __init__(self, model, cfg: ExperimentConfig, iters_per_epoch: int = 1000,
                 device="cuda", mesh=None):
        cfg.validate()
        super().__init__(cfg, device, mesh)
        self.model = model.to(self.device)
        self.loss_cfg = GroundingLossConfig(
            use_center_duration=cfg.use_center_duration, iou_loss_eps=cfg.iou_loss_eps,
            iou_thresholds=tuple(cfg.iou_thresholds), model=cfg.model,
            use_distill_nce_loss=cfg.use_distill_nce_loss,
            same_view_negative=cfg.same_view_negative,
            only_same_view_negative=cfg.only_same_view_negative,
            test_egovlp=cfg.test_egovlp)
        self.params = {k: p.detach() for k, p in self.model.named_parameters()}
        self.target_params = None
        self.tx = _build_optimizer(cfg, self.params, cfg.epochs * iters_per_epoch,
                                   policy=cfg.optim_policy)
        self.opt_state = self.tx.init(self.params)
        self._replicate()
        step = make_grounding_train_step(
            self.model, self.loss_cfg, self.tx,
            compute_dtype="bfloat16" if cfg.amp else "float32",
            scan_steps=cfg.fused_steps if cfg.fused_steps > 1 else None, mesh=self.mesh)
        self.fused_step = step if cfg.fused_steps > 1 else None
        self.step = step.single if cfg.fused_steps > 1 else step
        self._eval_step = None

    # ------------------------------------------------------------ batch prep
    def prepare_batch(self, batch: Dict) -> Dict[str, np.ndarray]:
        """Host arrays of one batch (trainer.py:629-673): the model's inputs
        and the loss targets; under ``views == 'multi'`` the (B, V) view
        mask; with a view bank the positive view's features per step
        (``ego_video_features_flat``, the model's distillation target) and,
        under ``same_view_negative``, the same-view negatives gathered from
        the model's input video features."""
        out = {
            "video_features": np.asarray(batch["video_features"], np.float32),
            "narration_features": np.asarray(batch["narration_features"], np.float32),
            "video_padding_mask": np.asarray(batch["video_padding_mask"], bool),
            "narration_padding_mask": np.asarray(batch["narration_padding_mask"], bool),
        }
        for k in ("starts", "ends", "mean", "duration"):
            if k in batch:
                out[k] = np.asarray(batch[k], np.float32)
        if "audio_features" in batch:
            out["audio_features"] = np.asarray(batch["audio_features"], np.float32)
            out["audio_padding_mask"] = np.asarray(batch["audio_padding_mask"], bool)
        if "view_available_mask" in batch and self.cfg.views == "multi":
            b = out["video_features"].shape[0]
            out["view_mask"] = np.asarray(batch["view_available_mask"], bool).reshape(
                b, self.cfg.num_max_views, -1).any(axis=-1)
        if "ego_video_features" in batch:
            bank = np.asarray(batch["ego_video_features"], np.float32)  # (B, V, T, C)
            out["ego_video_features"] = bank
            out["view_rank_label"] = np.asarray(batch["view_rank_label"], np.int32)
            out["view_rank_neg_label"] = np.asarray(batch["view_rank_neg_label"], np.int32)
            v = bank.shape[1]
            pos = np.clip(out["view_rank_label"][..., None, None], 0, v - 1)  # (B, T, 1, 1)
            out["ego_video_features_flat"] = np.take_along_axis(
                bank.transpose(0, 2, 1, 3), pos, axis=2)[:, :, 0]
            if "same_view_neg_idxs" in batch and self.cfg.same_view_negative:
                idxs = np.asarray(batch["same_view_neg_idxs"], np.int64)  # (B, T)
                out["same_view_neg_feats"] = np.take_along_axis(
                    out["video_features"], idxs[..., None], axis=1)
        return out

    # ------------------------------------------------------------ train loop
    def _do_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.params, _, self.opt_state, metrics = self.step(
            self.params, None, self.opt_state, batch, self.generator)
        return metrics

    def _do_fused(self, batches: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.params, _, self.opt_state, metrics = self.fused_step(
            self.params, None, self.opt_state, batches, self.generator)
        return metrics

    def train_epoch(self, loader: Iterable[Dict], epoch: int) -> float:
        """One pass over ``loader``; the mean finite loss, weighted by rows."""
        self.model.train()
        return self._run_train_epoch(loader, epoch, self._do_step,
                                     self._do_fused if self.fused_step is not None else None)

    def evaluate(self, loader: Iterable[Dict], epoch: int, test: bool = False):
        """(loss, results): the eval step over every batch of ``loader`` (the
        last partial one too), each metric averaged with the weight of its
        exact in-step mean (narrations for the grounding scalars, rows for
        the view-invariant ones; trainer.py:702-777). At ``test`` for
        grounding / joint: 'Rank r mean IoU' / 'Rank r count' over the
        valid narrations by camera rank, and ``test_results_epoch_{epoch}
        .json`` under ``log_path``. Sharded over the mesh: a ragged tail is
        padded with masked rows ('row_valid'), and the binning reads the
        host's rows, gathered from its ranks; the chief writes the file."""
        if self._eval_step is None:
            self._eval_step = make_grounding_eval_step(self.model, self.loss_cfg,
                                                       mesh=self.mesh)
        binned = test and self.cfg.model in ("grounding", "joint")
        vi_mode = self.cfg.model == "view_invariant"
        meters: Dict[str, AverageMeter] = {}
        loss_meter = AverageMeter("Loss", ":.4f")
        rank_iou: Dict[str, List[float]] = {}
        save_list = []
        metas = collections.deque()

        def prepared():
            for raw in loader:
                batch = self.prepare_batch(raw)
                metas.append((raw.get("metadata", {}), batch["narration_padding_mask"]))
                yield shard_batch(self._pad_rows(batch, "zeros"), self.mesh)

        for batch in device_prefetch(prepared(), self.device, size=2):
            meta, narr_pad = metas.popleft()
            b = narr_pad.shape[0]
            scalars, ious = self._eval_step(self.params, batch)
            keys = list(scalars)
            values = dict(zip(keys, torch.stack([scalars[k] for k in keys]).tolist()))
            n_valid = int(values.pop("_n_valid"))
            values.pop("_rows")
            for k, v in values.items():
                per_row = k in self._VI_KEYS or (vi_mode and k == "loss")
                meters.setdefault(k, AverageMeter(k, ":.4f")).update(v, b if per_row else n_valid)
            loss_meter.update(values["loss"], b if vi_mode else n_valid)
            if not binned:
                continue
            ious_np = self._host_rows(ious)[:b]
            save_list.append({
                "loss_dict": ious_np.tolist(),
                "metadata": {"narration": meta.get("narrations"),
                             "video_id": meta.get("video_id"),
                             "cam_id": meta.get("exo_camera"),
                             "narr_ranks": meta.get("narr_ranks")},
            })
            # per-camera-rank IoU binning (reference loss_egoexo4d.py:126-137)
            valid = ~narr_pad
            for i, ranks in enumerate(meta.get("narr_ranks") or []):
                for j, r in enumerate(ranks):
                    if j < ious_np.shape[1] and valid[i, j]:
                        rank_iou.setdefault(str(r), []).append(float(ious_np[i, j]))
        if self.writer:
            for k, m in meters.items():
                self.writer.add_data(f"val/{k}", m.avg, epoch)
        results = {k: m.avg for k, m in meters.items()}
        for r, vals in sorted(rank_iou.items()):
            results[f"Rank {r} mean IoU"] = float(np.mean(vals))
            results[f"Rank {r} count"] = len(vals)
        if test and save_list and self.cfg.log_path and self.is_chief:
            with open(os.path.join(self.cfg.log_path, f"test_results_epoch_{epoch}.json"),
                      "w") as f:
                json.dump(save_list, f)
        return loss_meter.avg, results

    def fit(self, train_loader, val_loader=None, dataset=None) -> float:
        """Train from ``start_epoch`` to ``cfg.epochs`` with the curriculum
        (trainer.py:779-807): each epoch the loader's and the dataset's epoch,
        then under ``curriculum_train`` with 'phased' the dataset's phase;
        each ``eval_freq``-th epoch the validation, whose 'mean IoU' (else
        the negated loss) ranks the epochs; a checkpoint every epoch.
        Returns the best score."""
        from exoground_tpu_torch.data.sampling import get_phase

        cfg = self.cfg
        best = self.best_acc
        for epoch in range(self.start_epoch, cfg.epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            if dataset is not None and hasattr(dataset, "set_epoch"):
                dataset.set_epoch(epoch)
            if dataset is not None and cfg.curriculum_train and cfg.sorted_curr_train == "phased":
                dataset.set_phase(get_phase(epoch, cfg.epochs, 4, cfg.final_phase_prop))
            self.train_epoch(train_loader, epoch)
            stats = self.epoch_stats[-1]
            is_best = False
            if val_loader is not None and epoch % cfg.eval_freq == 0:
                t0 = time.perf_counter()
                val_loss, results = self.evaluate(val_loader, epoch)
                stats["val_s"] = time.perf_counter() - t0
                score = results.get("mean IoU", -val_loss)
                is_best = score > best
                best = max(score, best)
                self.best_acc = best
            t0 = time.perf_counter()
            self.save_epoch(epoch, is_best=is_best)
            stats["save_s"] = time.perf_counter() - t0
            if self.writer:
                self.writer.add_dict({k: v for k, v in stats.items()
                                      if k in ("val_s", "save_s")}, epoch, prefix="time/")
        return best


class S3DTrainer(BaseTrainer):
    """End-to-end S3D finetune on HTM-AA clips (the JAX ``S3DTrainer``;
    reference end2end/main_nce.py:60-137, 275-403): the symmetric InfoNCE
    between the S3D-G video embeddings and the MIL-NCE sentence embedding,
    the early blocks frozen (``freeze_early``).

    ``model``: a port ``S3D`` (its initial weights as they are; the MIL-NCE
    trunk through ``load_backbone``); ``text_params``: the text module's
    tensors (``convert_sentence_embedding_from_s3d``). Parameters are
    ``s3d.<name>`` (shared by storage with the model) and ``text.<key>``;
    ``batch_stats`` are the S3D's BN running stats, flax's initial ones until
    loaded, trained unless ``cfg.freezeBN`` (the reference's default mode;
    --freezeBN keeps them frozen, end2end/freeze_bn.py) and checkpointed.
    ``--lr_backbone`` puts the ``s3d.*`` parameters on a second LR. The best
    epoch is the one of lowest train loss (main_nce.py:293, 385-387), and
    every epoch is saved. As in the JAX trainer, ``--fused_steps`` and
    ``--sim`` are ignored: every step runs eagerly, and the InfoNCE takes
    the embeddings' dot products as they are."""

    rows_axis = -6  # video (B, n_clips, T, H, W, 3)
    from_jax = staticmethod(s3d_checkpoint_from_jax)

    def __init__(self, model, cfg: ExperimentConfig, text_params: Dict[str, torch.Tensor],
                 iters_per_epoch: int = 1000, freeze_early: bool = True, device="cuda",
                 mesh=None):
        cfg.validate()
        super().__init__(cfg, device, mesh)
        self.model = model.to(self.device)
        self.best_acc = 1e5  # the lowest train loss
        self.params = {**{f"s3d.{k}": p.detach() for k, p in self.model.named_parameters()},
                       **{f"text.{k}": torch.as_tensor(v, dtype=torch.float32,
                                                       device=self.device).clone()
                          for k, v in text_params.items()}}  # owned: trained in place
        self.batch_stats = self.model.init_batch_stats()
        self.target_params = None
        self.tx = _build_optimizer(cfg, self.params, cfg.epochs * iters_per_epoch,
                                   backbone_lr=cfg.lr_backbone or None)
        self.opt_state = self.tx.init(self.params)
        self._replicate()
        self.train_bn = not cfg.freezeBN
        self.step = make_s3d_nce_step(
            self.model, self.tx, mesh=self.mesh, freeze_early=freeze_early,
            gather_negatives=cfg.gather_negatives,
            compute_dtype="bfloat16" if cfg.amp else "float32", train_bn=self.train_bn)

    def load_backbone(self, s3d_state: Dict):
        """The trunk from a MIL-NCE checkpoint (``convert_s3d_state_dict``'s
        ``{'params', 'batch_stats'}``), non-strict: a parameter the
        checkpoint lacks (an ``fc`` of another width) keeps its value."""
        restore_into({k[4:]: v for k, v in self.params.items() if k.startswith("s3d.")},
                     s3d_state["params"])
        restore_into(self.batch_stats, s3d_state["batch_stats"])
        self._replicate()

    def prepare_batch(self, batch: Dict) -> Dict[str, np.ndarray]:
        """uint8 clips as they are (the step divides by 255 on the card),
        other clips as float32; tokens as int32."""
        video = np.asarray(batch["video"])
        if video.dtype != np.uint8:
            video = video.astype(np.float32)
        return {"video": video, "token": np.asarray(batch["token"], np.int32)}

    def _do_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.params, self.batch_stats, self.opt_state, metrics = self.step(
            self.params, self.batch_stats, self.opt_state, batch, self.generator)
        return metrics

    def train_epoch(self, loader: Iterable[Dict], epoch: int) -> float:
        """One pass over ``loader``; the mean finite loss, weighted by rows."""
        self.model.train()
        return self._run_train_epoch(loader, epoch, self._do_step)

    def fit(self, train_loader, epochs: Optional[int] = None) -> float:
        """Train from ``start_epoch`` to ``epochs`` (``cfg.epochs``), saving
        every epoch; the best is the lowest train loss. Returns the last
        epoch's loss."""
        last = float("nan")
        best = self.best_acc
        for epoch in range(self.start_epoch, epochs or self.cfg.epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            last = self.train_epoch(train_loader, epoch)
            is_best = last < best
            best = min(last, best)
            self.best_acc = best
            self.save_epoch(epoch, is_best=is_best)
        return last
