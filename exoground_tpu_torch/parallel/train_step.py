"""The TAN and grounding train and eval steps, data parallel over a ``Mesh``.

Counterpart of ``exoground_tpu/parallel/train_step.py::make_tan_train_step``
(:129-379): one call runs the online forward
(random pos start from a ``torch.Generator``), the EMA teacher forward under
``torch.no_grad()`` with ``deterministic=True``, ``tan_loss``, backward, and
the optimizer's update with the EMA twin's: ``FusedAdamWEMA`` or the optax
chain (``OptaxChain``: gradient accumulation, global-norm clipping), both
behind one protocol, so the step has no branch on the optimizer. The whole
step runs inside ``disable_fused_kernels()``, as the JAX step traces under
it, so the model takes its plain compositions; on the card the MIL-NCE grid
kernel carries the loss's denominators (2 forward and 2 backward launches
per step, dual and joint).

With ``text_tower_params`` (the frozen word2vec tower's tensors) a batch
may carry 'token' (B, N, L) ids in place of 'text' features: the tower
embeds them inside the step (``_batch_text``, its pooled output only), its
weights cast once to the compute dtype, as the JAX step casts them.

A step has a host half and a device half. The host half (``draw``) takes
the random pos starts from the ``torch.Generator`` and the optimizer's
scalars for the step's count (lr, bc1, bc2, and under accumulation emit and
the mini step + 1); the device half (``device_step``)
reads them as small tensors on the card and does everything else: no host
read, no host-to-device copy of a pageable buffer, nothing that a CUDA
graph capture forbids.

``make_tan_train_step(scan_steps=N)`` returns ``ScanStep``, the JAX
``scan_steps`` runner: one call runs N optimizer steps over a batch with a
leading (N, ...) axis. On the CPU it loops over the eager step (the plain
version). On a card its first call for a shape runs the N steps eagerly and
then captures them as one ``torch.cuda.CUDAGraph`` over static input
buffers; every later call copies its batches, starts and scalars into those
buffers and replays the graph (the grid kernel's launches, and flash's under
``attn_impl='flash'``, are inside it). Parameters, the EMA twin and the
moments (and the accumulator of gradient accumulation) are updated in
place, so the graph's addresses stay theirs; a tensor that moved (replaced,
not updated in place) makes the runner capture anew before it replays. Under
accumulation over k mini-batches the graph updates on the k-th of each, as
the eager step does: the emit flag is a replayed scalar, not a branch. In a
compute dtype other than float32 a group casts the masters once and carries
the casts from step to step (``_CarriedCasts``).

``TanEvalStep`` is the JAX ``make_tan_eval_step`` (:607-676) on one device:
inference-shaped, under ``torch.no_grad()`` with the kernels on (fused MHA
and MLP in both towers, the grid's forward), the cotrain targets from the
EMA teacher, returning the loss scalars and ``_rows``.

``GroundingTrainStep`` is the JAX ``make_grounding_train_step``
(:679-785) on one device, for the view-invariant, grounding and joint
models: the forward under ``disable_fused_kernels()`` with its random pos
starts from the host half, ``egoexo_loss`` plus the model's
``distill_infonce_loss`` where it returns one, backward and the optimizer
(no EMA twin), split into the same host and device halves, so
``make_grounding_train_step(scan_steps=N)`` replays it through the same
``ScanStep``. ``GroundingEvalStep`` is ``make_grounding_eval_step``
(:523-604): the exact weighted sums per metric (narrations for the
grounding scalars, rows x steps for the view-invariant ones), the joint
loss reassembled from its two halves, and the (B, N) IoU map, under
``torch.no_grad()`` with the inference kernels on.

``S3DNceStep`` is the JAX ``make_s3d_nce_step`` (:381-509), the end-to-end
S3D finetune on HTM-AA clips: uint8 clips divided by 255 in float32 on the
device, then cast to the compute dtype; the (B, n) clips flattened through
the S3D trunk (``models/s3d.py``, parameters ``s3d.*``) and the text module
(``text.*``) over the tokens, each text repeated for its n clips; the
symmetric InfoNCE and its five metrics. Its BN running stats ride in the
``target`` slot of the protocol: frozen (--freezeBN) they are cast with the
parameters; under ``train_bn`` they stay float32 and the step writes the new
ones into them in place (averaged over the ranks: each rank normalizes with
its own batch's moments, and only the stats are averaged, as the JAX step's
``pmean``). It draws no pos start, so ``make_s3d_nce_step(scan_steps=N)``
replays it through the same ``ScanStep``. No kernel of the port is on this
path: cuDNN's 3-D convolutions stand where XLA's convolutions stand.

Data parallel (``mesh``, ``parallel/mesh.py``; the group's, world 1 without
one): each rank runs the step on its block of the batch and reduces where
the JAX step reduces over its 'data' axis. The float32 grads (zeros where the
loss does not reach a parameter) and the metrics go through one all-reduce
of a flat buffer laid out alike on every rank and come back as their
unweighted mean (:275-280, :728-730); each rank draws its own pos starts
from its own generator (the JAX step folds ``axis_index`` into its key).
``gather_negatives`` gathers the text features over the ranks
(``collectives.all_gather_tiled``; the gradient comes back as the transpose)
so the MIL-NCE denominators see the global batch: the normalized text
features under the fused grid, the EMA features staying local (:230-251),
or the joint and dual text features from which the volumes are rebuilt
(``_gathered_logits``, :305-330); the text padding mask is gathered too and
the rank's rows sit at column offset ``rank * b_local`` (:261-266). The eval
steps sum their weighted metrics over the ranks (:562-594, :660-666). Under
``ScanStep`` the collectives are inside the captured graph.

Parameters are a dictionary of float32 master tensors (the model's own
parameters, shared by storage, so the optimizer's in-place update keeps the
module current). ``compute_dtype="bfloat16"`` casts them for the forward
through ``torch.func.functional_call``, as the JAX step's ``_cast_floats``
does: the grads come back to the float32 masters through the cast, and the
loss math stays float32.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from exoground_tpu_torch.losses.grounding import GroundingLossConfig, egoexo_loss
from exoground_tpu_torch.losses.infonce import symmetric_info_nce
from exoground_tpu_torch.losses.milnce import TANLossConfig, tan_loss
from exoground_tpu_torch.models.s3d import sentence_embedding_forward
from exoground_tpu_torch.models.word2vec import word2vec_forward
from exoground_tpu_torch.ops import _kernels
from exoground_tpu_torch.ops.fused_mlp import disable_fused_kernels
from exoground_tpu_torch.parallel import collectives
from exoground_tpu_torch.parallel.mesh import make_mesh
from exoground_tpu_torch.utils.device import to_device

# normalized-feature outputs of TemporalAligner: they stay in the compute
# dtype under the fused grid (the grid and the diagonal accumulate in
# float32); every other output is upcast for the loss math
_FEATURE_KEYS = (
    "dual_feature_video", "dual_feature_text",
    "joint_feature_video", "joint_feature_text",
)


class _CarriedCasts:
    """The compute-dtype casts of the parameters (and of the EMA twin) that
    a group of steps (``ScanStep``) carries from step to step when the
    compute dtype is not float32: persistent buffers (their addresses stay a
    captured graph's), filled from the float32 masters when the group
    begins, then written by the optimizer's pass (``apply(casts=)``), so no
    step of the group casts the masters again. The results are the same bit
    for bit: the gradient through a cast is the upcast of the gradient of
    the cast. (The JAX package's ``CARRY_CAST``, train_step.py:47-57, a
    switch there, off after a TPU measurement; the port always carries: on
    an H100 the carried group was as exact and faster, PERF.md §5.)"""

    _casts = None

    def begin_group(self, params, target=None) -> Dict:
        """{'params'[, 'target']: casts by name} of the masters a group
        starts from."""
        trees = {"params": params}
        if target is not None:
            trees["target"] = target
        if self._casts is None or any(set(self._casts.get(n, ())) != set(t)
                                      for n, t in trees.items()):
            self._casts = {n: {k: torch.empty_like(v, dtype=self.cdt) for k, v in t.items()}
                           for n, t in trees.items()}
        with torch.no_grad():
            for n, t in trees.items():
                torch._foreach_copy_([self._casts[n][k] for k in t], list(t.values()))
        return self._casts


@contextlib.contextmanager
def _ieee_float32():
    """cuDNN's and cuBLAS's float32 work inside the block in float32, not
    TF32 (PyTorch lets cuDNN's convolutions take TF32 by default); the flags
    as they were after it."""
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    old = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, allow in zip(flags, old):
            f.allow_tf32 = allow


def _cast_floats(tree: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    """Floating tensors to ``dtype``; masks and integers pass through."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}


def _f32_except_features(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v if k in _FEATURE_KEYS else v.float() for k, v in out.items()}


def _lengths(batch: Dict[str, torch.Tensor]) -> tuple:
    """(T, N) of a batch, stacked or not: video (..., T, Dv), text
    (..., N, Dt) or token (..., N, L)."""
    return batch["video"].shape[-2], batch["text" if "text" in batch else "token"].shape[-2]


def _pmean_grads(mesh, metrics: Dict[str, torch.Tensor], grads: Dict, params: Dict):
    """(metrics, grads) as their mean over the ranks: one all-reduce of the
    float32 grads in ``params``' order, zeros where a grad is None (the
    buffer's layout the same on every rank), then the metrics (the JAX
    steps' two ``pmean``). Without a group the values pass as they are, the
    None grads filled with zeros all the same."""
    names, keys = list(params), list(metrics)
    parts = [grads[k].float() if grads[k] is not None
             else torch.zeros_like(params[k], dtype=torch.float32) for k in names]
    out = collectives.pmean(parts + [metrics[k].float() for k in keys], mesh)
    return dict(zip(keys, out[len(names):])), dict(zip(names, out[:len(names)]))


def _batch_text(batch: Dict[str, torch.Tensor], tower) -> torch.Tensor:
    """Text features for the TAN steps (the JAX ``_batch_text``, :111-127):
    'text' passes through; 'token' (B, N, L) ids go through the frozen
    tower, pad ids (0) masked, and come back (B, N, D) in its dtype."""
    if "text" in batch:
        return batch["text"]
    if tower is None:
        raise ValueError("a token batch needs the step's text_tower_params")
    tok = batch["token"]
    b, n, l = tok.shape
    tok2 = tok.reshape(b * n, l)
    with torch.no_grad():
        emb = word2vec_forward(tower, tok2, tok2 != 0)["pooler_output"]
    return emb.reshape(b, n, -1)


class TanTrainStep(_CarriedCasts):
    """``step(params, target, opt_state, batch, generator) -> (params,
    target, opt_state, metrics)``; ``loss_and_grads`` is its first half.

    batch: video (B, T, Dv), text (B, N, Dt) or token (B, N, L) with
    ``text_tower_params``, video_padding_mask (B, T), text_padding_mask
    (B, N), start, end [, abs_text_pos], on the device of the parameters.
    ``target`` is the EMA twin (pass ``params`` when not cotraining); with
    ``ema_momentum`` set the optimizer updates it in the same pass. Metrics
    are the loss dict's 0-d tensors, detached, averaged over the ranks of
    ``mesh``; ``batch`` is this rank's block."""

    def __init__(self, model, loss_cfg: TANLossConfig, optimizer,
                 ema_momentum: Optional[float] = None, compute_dtype: str = "float32",
                 fused_grid: bool = True, text_tower_params=None,
                 gather_negatives: bool = False, mesh=None):
        self.model = model
        self.loss_cfg = loss_cfg
        self.optimizer = optimizer
        self.ema_momentum = ema_momentum
        self.cdt = getattr(torch, compute_dtype)
        self.fused_grid = fused_grid
        self.cotrain = loss_cfg.model == "cotrain"
        self.gather = gather_negatives
        self.mesh = make_mesh() if mesh is None else mesh
        # frozen tower: cast once at build time, not once per step
        self.tower = None if text_tower_params is None else _cast_floats(
            text_tower_params, self.cdt)

    def _forward(self, params, batch_c, batch, deterministic, generator=None,
                 pos_starts=None):
        kw = dict(deterministic=deterministic, return_sim_volumes=not self.fused_grid,
                  generator=generator)
        if pos_starts is not None:
            kw["pos_starts"] = pos_starts
        return functional_call(
            self.model, params,
            (batch_c["video"], batch_c["text"], batch["video_padding_mask"],
             batch["text_padding_mask"]), kw)

    batch_key = "video"

    def n_pos_starts(self, batch: Dict[str, torch.Tensor]) -> int:
        """How many pos starts a step over ``batch`` (stacked or not) draws."""
        return len(self.model.pos_start_lengths(*_lengths(batch)))

    def draw(self, batch: Dict[str, torch.Tensor], generator, count: int):
        """The host half of the step that reads optimizer count ``count``:
        (its pos starts, (k,) int64, ``TemporalAligner.draw_pos_starts``;
        the optimizer's float32 scalars, ``optimizer.scalars(count)``).
        ``batch`` may be stacked."""
        return (self.model.draw_pos_starts(generator, *_lengths(batch)).numpy(),
                self.optimizer.scalars(count))

    def loss_and_grads(self, params: Dict[str, torch.Tensor], target: Dict[str, torch.Tensor],
                       batch: Dict[str, torch.Tensor], generator=None, pos_starts=None,
                       casts=None):
        """(metrics, grads): the loss dict's scalars and float32 grads by
        parameter name (zeros where the loss does not reach a parameter),
        averaged over the ranks under a group. The
        random pos starts come from ``pos_starts`` (on the device) or else
        from ``generator``. ``casts`` (``begin_group``) stand for the
        compute-dtype casts of the parameters and the twin."""
        with disable_fused_kernels():
            if casts is None:
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                p_c = _cast_floats(leaves, self.cdt)
            else:  # the grads of the casts, upcast below: the masters' grads
                leaves = {k: v.detach().requires_grad_(True)
                          for k, v in casts["params"].items()}
                p_c = leaves
            batch_c = _cast_floats({"video": batch["video"],
                                    "text": _batch_text(batch, self.tower)}, self.cdt)
            out = self._forward(p_c, batch_c, batch, False, generator, pos_starts)
            if self.fused_grid:
                missing = [k for k in _FEATURE_KEYS if k not in out]
                if missing:
                    raise ValueError(f"fused_grid=True needs the model to return the "
                                     f"normalized features {missing}")
                logits = {k: v for k, v in _f32_except_features(out).items()
                          if k not in ("logits_dual", "logits_joint")}
                if self.gather:
                    # only the text features cross ranks; the grid streams
                    # them as they are (no gathered volume)
                    for k in ("dual_feature_text", "joint_feature_text"):
                        logits[k] = collectives.all_gather_tiled(out[k], self.mesh)
            else:
                logits = {k: v.float() for k, v in out.items()}
                if self.gather:
                    logits = self._gathered_logits(logits)
            if self.cotrain:
                with torch.no_grad():
                    t_c = _cast_floats(target, self.cdt) if casts is None else casts["target"]
                    ema_out = self._forward(t_c, batch_c, batch, True)
                if self.fused_grid:
                    # the agreement reads the diagonal block alone: local
                    # EMA features suffice
                    for k in _FEATURE_KEYS:
                        logits[f"ema-{k}"] = ema_out[k]
                else:
                    ema_out = {k: v.float() for k, v in ema_out.items()}
                    if self.gather:
                        ema_out = self._gathered_logits(ema_out)
                    logits["ema-logits_dual"] = ema_out["logits_dual"]
                    logits["ema-logits_joint"] = ema_out["logits_joint"]
            kw = {}
            if self.gather:
                kw["col_text_padding_mask"] = collectives.all_gather_rows(
                    batch["text_padding_mask"], self.mesh)
                kw["col_offset"] = self.mesh.rank * batch["video"].shape[0]
            ld = tan_loss(batch["start"], batch["end"], logits, batch["video_padding_mask"],
                          batch["text_padding_mask"], self.loss_cfg,
                          abs_text_pos=batch.get("abs_text_pos"), **kw)
            names = list(leaves)
            grads = torch.autograd.grad(ld["loss"], [leaves[k] for k in names],
                                        allow_unused=True)
        metrics = {k: v.detach() for k, v in ld.items() if v.dim() == 0}
        return _pmean_grads(self.mesh, metrics, dict(zip(names, grads)), params)

    def _gathered_logits(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The volumes rebuilt against the gathered text features (the JAX
        ``_gathered_logits``): both grids are indexed with the global column
        offset, so the joint text features must be gathered too."""
        if "joint_feature_text" not in out:
            raise ValueError("gather_negatives=True needs the model to return "
                             "joint_feature_text; a local-batch logits_joint cannot be "
                             "indexed with global column offsets")
        text_n = collectives.all_gather_tiled(out["dual_feature_text"], self.mesh)
        text_nj = collectives.all_gather_tiled(out["joint_feature_text"], self.mesh)
        return {**out,
                "logits_dual": torch.einsum("astc,bkc->astbk", out["dual_feature_video"], text_n),
                "logits_joint": torch.einsum("astc,bskc->astbk", out["joint_feature_video"],
                                             text_nj)}

    def device_step(self, params, target, opt_state, batch, pos_starts: torch.Tensor,
                    scalars: torch.Tensor, casts=None) -> Dict[str, torch.Tensor]:
        """The device half of one step, from ``draw``'s starts and scalars on
        the device; updates the parameters, moments and twin in place (and
        ``casts``, the carried casts, with them) and leaves
        ``opt_state.count`` to the caller. Returns the metrics."""
        metrics, grads = self.loss_and_grads(params, target, batch, pos_starts=pos_starts,
                                             casts=casts)
        kw = {} if casts is None else {"casts": casts}
        self.optimizer.apply(params, opt_state, grads, scalars, target, self.ema_momentum, **kw)
        return metrics

    def begin_group(self, params, target=None):
        return super().begin_group(params, target if self.cotrain else None)

    def __call__(self, params, target, opt_state, batch, generator=None, casts=None):
        dev = batch[self.batch_key].device
        starts, scalars = self.draw(batch, generator, opt_state.count)
        metrics = self.device_step(params, target, opt_state, batch, to_device(starts, dev),
                                   to_device(scalars, dev), casts)
        opt_state.count += 1
        return params, target, opt_state, metrics


def _addresses(params, target, opt_state) -> tuple:
    """Every tensor a step updates in place, the accumulator too."""
    trees = (params, target or {}, opt_state.mu, opt_state.nu,
             getattr(opt_state, "acc_grads", {}))
    return tuple(t.data_ptr() for d in trees for t in d.values())


class _Graph:
    """N captured steps: the graph, its static inputs and stacked metrics,
    the launches its capture recorded and the addresses it was captured on."""

    def __init__(self, graph, batch, starts, scalars, metrics, launches, addresses,
                 capture_s, pool_bytes, issued=None):
        self.graph, self.batch, self.starts, self.scalars = graph, batch, starts, scalars
        self.metrics, self.launches, self.addresses = metrics, launches, addresses
        self.capture_s, self.pool_bytes = capture_s, pool_bytes
        self.issued = issued or {}  # the collectives the capture recorded

    def replay(self, batches, starts: np.ndarray, scalars: np.ndarray) -> None:
        for k, buf in self.batch.items():
            buf.copy_(batches[k])
        self.starts.copy_(torch.from_numpy(starts).pin_memory(), non_blocking=True)
        self.scalars.copy_(torch.from_numpy(scalars).pin_memory(), non_blocking=True)
        self.graph.replay()
        _kernels.add_launches(self.launches)
        collectives.add(self.issued)


class ScanStep:
    """``step(params, target, opt_state, batches, generator) -> (params,
    target, opt_state, metrics)``: N optimizer steps a call (the JAX
    ``scan_steps`` contract). ``batches`` carries a leading (N, ...) axis;
    each metric comes back stacked (N,); ``opt_state.count`` advances by N.
    ``single`` is the one-step ``TanTrainStep``, ``GroundingTrainStep`` or
    ``S3DNceStep`` it repeats (``target`` is None for the second, the BN
    stats for the third).

    On a card: one graph per batch shapes and dtypes, compute dtype,
    ``attn_impl`` and train mode (``graphs``); each records its capture
    seconds and the bytes its memory pool reserved. A capture that fails
    raises: it never falls back to the eager loop on the card. Under a
    process group the step's collectives are captured with it (each rank
    captures the same steps in the same order), and the ranks decide
    together whether a tensor moved and the graph must be captured anew:
    a rank that captured alone would wait on the others for ever."""

    def __init__(self, single: TanTrainStep, n: int):
        if n < 1:
            raise ValueError(f"scan_steps must be at least 1, got {n}")
        self.single, self.n = single, n
        # carried casts (``_CarriedCasts``) where the step has them and casts
        self.carry_casts = isinstance(single, _CarriedCasts) and single.cdt != torch.float32
        self.graphs: Dict[tuple, _Graph] = {}
        self.captures = 0
        self._stream = None

    def _key(self, batches) -> tuple:
        return (tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batches.items())),
                self.single.cdt, getattr(self.single.model, "attn_impl", None),
                self.single.model.training)

    def _group_casts(self, params, target):
        """The carried casts a group starts from, or None (``carry_casts``)."""
        return self.single.begin_group(params, target) if self.carry_casts else None

    def _loop(self, params, target, opt_state, batches, generator):
        ms = []
        casts = self._group_casts(params, target)
        kw = {} if casts is None else {"casts": casts}
        for i in range(self.n):
            params, target, opt_state, m = self.single(
                params, target, opt_state, {k: v[i] for k, v in batches.items()}, generator,
                **kw)
            ms.append(m)
        return params, target, opt_state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    def __call__(self, params, target, opt_state, batches, generator=None):
        bad = {k: tuple(v.shape) for k, v in batches.items() if v.shape[0] != self.n}
        if bad:
            raise ValueError(f"scan_steps={self.n} needs a leading axis of {self.n}: {bad}")
        dev = batches[self.single.batch_key].device
        if dev.type != "cuda":
            return self._loop(params, target, opt_state, batches, generator)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        key = self._key(batches)
        g = self.graphs.get(key)
        if g is None:
            # real steps, and the capture's warm-up on the stream it captures on
            cur = torch.cuda.current_stream(dev)
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                out = self._loop(params, target, opt_state, batches, generator)
            cur.wait_stream(self._stream)
            for m in out[3].values():
                m.record_stream(cur)
            self.graphs[key] = self._capture(params, target, opt_state, batches)
            return out
        moved = g.addresses != _addresses(params, target, opt_state)
        if collectives.any_rank(moved, self.single.mesh):
            del self.graphs[key], g
            g = self.graphs[key] = self._capture(params, target, opt_state, batches)
        draws = [self.single.draw(batches, generator, opt_state.count + i)
                 for i in range(self.n)]
        g.replay(batches, np.stack([d[0] for d in draws]), np.stack([d[1] for d in draws]))
        opt_state.count += self.n
        return params, target, opt_state, {k: v.clone() for k, v in g.metrics.items()}

    def _capture(self, params, target, opt_state, batches) -> _Graph:
        dev = batches[self.single.batch_key].device
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # as the capture does: the pool's bytes are what it adds
        reserved0 = torch.cuda.memory_reserved(dev)
        static = {k: torch.empty_like(v) for k, v in batches.items()}
        k = self.single.n_pos_starts(batches)
        starts = torch.zeros((self.n, k), dtype=torch.int64, device=dev)
        width = len(self.single.optimizer.scalars(0))
        scalars = torch.ones((self.n, width), dtype=torch.float32, device=dev)
        graph = torch.cuda.CUDAGraph()
        with _kernels.captured_launches() as launches, collectives.captured() as issued, \
                torch.cuda.graph(graph, stream=self._stream,
                                 capture_error_mode="thread_local"):
            casts = self._group_casts(params, target)
            kw = {} if casts is None else {"casts": casts}
            ms = [self.single.device_step(params, target, opt_state,
                                          {key: v[i] for key, v in static.items()},
                                          starts[i], scalars[i], **kw) for i in range(self.n)]
            metrics = {key: torch.stack([m[key] for m in ms]) for key in ms[0]}
        torch.cuda.synchronize(dev)
        self.captures += 1
        return _Graph(graph, static, starts, scalars, metrics, launches,
                      _addresses(params, target, opt_state), time.perf_counter() - t0,
                      torch.cuda.memory_reserved(dev) - reserved0, issued)


def make_tan_train_step(model, loss_cfg: TANLossConfig, optimizer,
                        ema_momentum: Optional[float] = None, gather_negatives: bool = False,
                        text_tower_params=None, compute_dtype: str = "float32",
                        scan_steps: Optional[int] = None, fused_grid: bool = True,
                        mesh=None):
    """The TAN train step (``TanTrainStep``) over ``mesh`` (the process
    group's; world 1 without one), or with ``scan_steps=N`` the N-step
    runner (``ScanStep``). ``fused_grid=False`` keeps the reference-shaped
    volume path; ``gather_negatives`` puts every rank's text in each rank's
    MIL-NCE denominators."""
    step = TanTrainStep(model, loss_cfg, optimizer, ema_momentum=ema_momentum,
                        compute_dtype=compute_dtype, fused_grid=fused_grid,
                        text_tower_params=text_tower_params,
                        gather_negatives=gather_negatives, mesh=mesh)
    return step if scan_steps is None else ScanStep(step, scan_steps)


class TanEvalStep:
    """``eval_step(params, target, batch) -> scalars``: the validation loss
    of the train protocol (the JAX ``make_tan_eval_step``, :607-676).

    float32, deterministic, under ``torch.no_grad()`` with the model in eval
    mode and the inference kernels available; for cotrain the agreement
    targets come from the EMA teacher (deriving them from the online
    outputs would bias the loss low). Each rank scores its block of rows on
    its own grid (negatives never cross ranks in validation); the scalars
    come back as their row-weighted mean over the ranks (the JAX step's
    psum, :660-666), with ``_rows``, the rows of every rank, by which
    callers average."""

    def __init__(self, model, loss_cfg: TANLossConfig, is_cotrain: bool = False,
                 text_tower_params=None, fused_grid: bool = True, mesh=None):
        self.model = model
        self.loss_cfg = loss_cfg
        self.is_cotrain = is_cotrain
        self.tower = text_tower_params
        self.fused_grid = fused_grid
        self.mesh = make_mesh() if mesh is None else mesh

    def _forward(self, params, text, batch):
        return functional_call(
            self.model, params,
            (batch["video"], text, batch["video_padding_mask"], batch["text_padding_mask"]),
            dict(deterministic=True, return_sim_volumes=not self.fused_grid))

    @torch.no_grad()
    def __call__(self, params, target, batch) -> Dict[str, torch.Tensor]:
        self.model.eval()
        text = _batch_text(batch, self.tower)
        out = self._forward(params, text, batch)
        if self.fused_grid:
            out = {k: v for k, v in out.items() if k not in ("logits_dual", "logits_joint")}
        if self.is_cotrain:
            ema_out = self._forward(target, text, batch)
            keys = _FEATURE_KEYS if self.fused_grid else ("logits_dual", "logits_joint")
            out.update({f"ema-{k}": ema_out[k] for k in keys})
        ld = tan_loss(batch["start"], batch["end"], out, batch["video_padding_mask"],
                      batch["text_padding_mask"], self.loss_cfg,
                      abs_text_pos=batch.get("abs_text_pos"))
        keys = [k for k, v in ld.items() if v.dim() == 0]
        rows = torch.tensor(float(batch["video"].shape[0]), device=batch["video"].device)
        sums = collectives.psum([ld[k] * rows for k in keys] + [rows], self.mesh)
        agg = {k: v / torch.clamp(sums[-1], min=1e-6) for k, v in zip(keys, sums)}
        agg["_rows"] = sums[-1]
        return agg


def make_tan_eval_step(model, loss_cfg: TANLossConfig, is_cotrain: bool = False,
                       text_tower_params=None, fused_grid: bool = True,
                       mesh=None) -> TanEvalStep:
    """The TAN validation step over ``mesh`` (see ``TanEvalStep``)."""
    return TanEvalStep(model, loss_cfg, is_cotrain=is_cotrain,
                       text_tower_params=text_tower_params, fused_grid=fused_grid, mesh=mesh)


# grounding-family batch entries the model takes, by its keyword
_GROUNDING_INPUTS = (("audio_features", "audio_embed"),
                     ("audio_padding_mask", "audio_padding_mask"),
                     ("ego_video_features_flat", "egocentric_video_embed"),
                     ("view_mask", "view_mask"))


def _grounding_forward(model, params, batch, batch_c, **kw):
    """``model`` with ``params`` on a grounding batch: the features from
    ``batch_c`` (the compute dtype), the masks from ``batch``."""
    for key, name in _GROUNDING_INPUTS:
        if key in batch:
            kw[name] = (batch_c if key in batch_c else batch)[key]
    return functional_call(
        model, params, (batch_c["video_features"], batch_c["narration_features"],
                        batch["video_padding_mask"], batch["narration_padding_mask"]), kw)


def _grounding_lengths(batch: Dict[str, torch.Tensor]) -> tuple:
    """(T, N, audio) of a grounding batch, stacked or not."""
    return (batch["video_features"].shape[-2], batch["narration_features"].shape[-2],
            "audio_features" in batch)


class GroundingTrainStep(_CarriedCasts):
    """``step(params, None, opt_state, batch, generator) -> (params, None,
    opt_state, metrics)`` for the view-invariant, grounding and joint models
    (the TAN step's protocol, with no EMA twin).

    batch: video_features (B, T, Dv), narration_features (B, N, Dt), their
    padding masks, the loss targets (mean / duration or starts / ends;
    ego_video_features (B, V, T, Dv), view_rank_label, view_rank_neg_label
    and same_view_neg_feats for the VI loss) and the model's optional inputs
    (audio_features / audio_padding_mask, ego_video_features_flat,
    view_mask), on the device of the parameters. The features reach the
    model in the compute dtype; the loss reads the batch as it is, its
    math in float32. Metrics are the loss dict's 0-d tensors, detached;
    metrics and grads are averaged over the ranks of ``mesh``."""

    batch_key = "video_features"

    def __init__(self, model, loss_cfg: GroundingLossConfig, optimizer,
                 compute_dtype: str = "float32", mesh=None):
        self.model = model
        self.loss_cfg = loss_cfg
        self.optimizer = optimizer
        self.cdt = getattr(torch, compute_dtype)
        self.mesh = make_mesh() if mesh is None else mesh

    def n_pos_starts(self, batch: Dict[str, torch.Tensor]) -> int:
        return len(self.model.pos_start_lengths(*_grounding_lengths(batch)))

    def draw(self, batch: Dict[str, torch.Tensor], generator, count: int):
        """(the step's pos starts, (k,) int64, ``draw_pos_starts``; the
        optimizer's scalars for ``count``); ``batch`` may be stacked."""
        return (self.model.draw_pos_starts(generator, *_grounding_lengths(batch)).numpy(),
                self.optimizer.scalars(count))

    def loss_and_grads(self, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                       generator=None, pos_starts=None, casts=None):
        """(metrics, float32 grads by name; zeros where the loss does not
        reach a parameter, as for the frozen VI pre-pass), averaged over the
        ranks under a group. ``casts`` stand for the parameters' casts."""
        with disable_fused_kernels():
            if casts is None:
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                p_c = _cast_floats(leaves, self.cdt)
            else:
                leaves = {k: v.detach().requires_grad_(True)
                          for k, v in casts["params"].items()}
                p_c = leaves
            batch_c = _cast_floats({k: v for k, v in batch.items()
                                    if k in ("video_features", "narration_features",
                                             "audio_features", "ego_video_features_flat")},
                                   self.cdt)
            out = _grounding_forward(self.model, p_c, batch, batch_c, deterministic=False,
                                     generator=generator, pos_starts=pos_starts)
            out = {k: v.float() for k, v in out.items()}
            ld, _ = egoexo_loss(out, batch, batch["narration_padding_mask"], self.loss_cfg)
            loss = ld["loss"]
            if "distill_infonce_loss" in out:
                loss = loss + out["distill_infonce_loss"]
            names = list(leaves)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        metrics = {k: v.detach() for k, v in ld.items() if v.dim() == 0}
        return _pmean_grads(self.mesh, metrics, dict(zip(names, grads)), params)

    def device_step(self, params, target, opt_state, batch, pos_starts: torch.Tensor,
                    scalars: torch.Tensor, casts=None) -> Dict[str, torch.Tensor]:
        """The device half of one step (see ``TanTrainStep.device_step``)."""
        metrics, grads = self.loss_and_grads(params, batch, pos_starts=pos_starts, casts=casts)
        kw = {} if casts is None else {"casts": casts}
        self.optimizer.apply(params, opt_state, grads, scalars, **kw)
        return metrics

    def __call__(self, params, target, opt_state, batch, generator=None, casts=None):
        dev = batch[self.batch_key].device
        starts, scalars = self.draw(batch, generator, opt_state.count)
        metrics = self.device_step(params, None, opt_state, batch, to_device(starts, dev),
                                   to_device(scalars, dev), casts)
        opt_state.count += 1
        return params, target, opt_state, metrics


def make_grounding_train_step(model, loss_cfg: GroundingLossConfig, optimizer,
                              compute_dtype: str = "float32",
                              scan_steps: Optional[int] = None, mesh=None):
    """The grounding-family train step (``GroundingTrainStep``) over
    ``mesh``, or with ``scan_steps=N`` the N-step runner (``ScanStep``: on
    the card a replayed CUDA graph)."""
    step = GroundingTrainStep(model, loss_cfg, optimizer, compute_dtype=compute_dtype,
                              mesh=mesh)
    return step if scan_steps is None else ScanStep(step, scan_steps)


def _subtree(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


class S3DNceStep:
    """``step(params, batch_stats, opt_state, batch, generator) -> (params,
    batch_stats, opt_state, metrics)``: the end-to-end S3D finetune (the JAX
    ``make_s3d_nce_step``; reference end2end/main_nce.py:30-47, 60-137).

    params: ``s3d.<S3D name>`` and ``text.<tower key>`` float32 masters;
    ``batch_stats`` the S3D's running stats by name (updated in place under
    ``train_bn``, passed through as they are otherwise); batch: video (B,
    n_clips, T, H, W, 3) uint8 or float, token (B, L) int. Metrics: loss,
    loss-per-text, loss-per-video, top1-per-text, top1-per-video, averaged
    over the ranks of ``mesh``. ``gather_negatives`` gathers the video and
    text embeddings over the ranks so the InfoNCE batch is global."""

    batch_key = "video"

    def __init__(self, model, optimizer, temperature: float = 0.07, freeze_early: bool = True,
                 gather_negatives: bool = False, compute_dtype: str = "float32",
                 train_bn: bool = False, mesh=None):
        self.model = model
        self.optimizer = optimizer
        self.temperature = temperature
        self.freeze_early = freeze_early
        self.gather = gather_negatives
        self.cdt = getattr(torch, compute_dtype)
        self.train_bn = train_bn
        self.mesh = make_mesh() if mesh is None else mesh

    def n_pos_starts(self, batch: Dict[str, torch.Tensor]) -> int:
        return 0

    def draw(self, batch: Dict[str, torch.Tensor], generator, count: int):
        """(no pos start, the optimizer's scalars for ``count``)."""
        return np.zeros(0, np.int64), self.optimizer.scalars(count)

    def loss_and_grads(self, params: Dict[str, torch.Tensor],
                       batch_stats: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
        """(metrics, grads by name, the new stats: None when frozen), the
        metrics, grads and stats averaged over the ranks under a group. The
        frozen early blocks' and the word embedding's grads are zeros. The
        float32 route's convolutions and matmuls, forward and backward, run
        in float32 (``_ieee_float32``)."""
        with _ieee_float32():
            return self._loss_and_grads(params, batch_stats, batch)

    def _loss_and_grads(self, params, batch_stats, batch):
        video = batch["video"]
        if video.dtype == torch.uint8:
            # exact in float32, and a true division by a tensor (a CUDA
            # division by a Python scalar multiplies by its reciprocal): the
            # host's / 255 bit for bit
            video = video.float() / torch.full((), 255.0, device=video.device)
        video = video.to(self.cdt)
        b, n = video.shape[:2]
        # (B n, T, H, W, 3) -> NCDHW
        flat = video.reshape((b * n,) + tuple(video.shape[2:])).permute(0, 4, 1, 2, 3)
        # updated stats accumulate in float32; frozen ones are constants in
        # the compute dtype
        stats = batch_stats if self.train_bn else _cast_floats(batch_stats, self.cdt)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        p_c = _cast_floats(leaves, self.cdt)
        out = functional_call(self.model, _subtree(p_c, "s3d."), (flat, stats),
                              dict(train_bn=self.train_bn, freeze_early=self.freeze_early))
        v, new_stats = out if self.train_bn else (out, None)
        # the loss in float32 (float64 when the step computes in float64)
        ldt = torch.promote_types(self.cdt, torch.float32)
        v = v.to(ldt)
        t = sentence_embedding_forward(_subtree(p_c, "text."), batch["token"])[
            "text_embedding"].to(ldt)
        t = t.repeat_interleave(n, dim=0)
        if self.gather:
            v = collectives.all_gather_tiled(v, self.mesh)
            t = collectives.all_gather_tiled(t, self.mesh)
        loss, parts = symmetric_info_nce(v, t, self.temperature)
        sim = parts["sim"].detach()
        labels = torch.arange(sim.shape[0], device=sim.device)
        metrics = {"loss": loss.detach(), "loss-per-text": parts["loss-per-text"].detach(),
                   "loss-per-video": parts["loss-per-video"].detach(),
                   "top1-per-text": (sim.argmax(-1) == labels).float().mean(),
                   "top1-per-video": (sim.argmax(0) == labels).float().mean()}
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        metrics, grads = _pmean_grads(self.mesh, metrics, dict(zip(names, grads)), params)
        if new_stats is not None:  # each rank saw its own batch
            keys = list(new_stats)
            new_stats = dict(zip(keys, collectives.pmean([new_stats[k] for k in keys],
                                                         self.mesh)))
        return metrics, grads, new_stats

    def device_step(self, params, batch_stats, opt_state, batch, pos_starts: torch.Tensor,
                    scalars: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The device half of one step: the parameters, moments and (under
        ``train_bn``) the stats updated in place; ``opt_state.count`` is the
        caller's to advance. Returns the metrics."""
        metrics, grads, new_stats = self.loss_and_grads(params, batch_stats, batch)
        if new_stats is not None:
            with torch.no_grad():
                for k, t in batch_stats.items():
                    t.copy_(new_stats[k])
        self.optimizer.apply(params, opt_state, grads, scalars)
        return metrics

    def __call__(self, params, batch_stats, opt_state, batch, generator=None):
        dev = batch[self.batch_key].device
        _, scalars = self.draw(batch, generator, opt_state.count)
        metrics = self.device_step(params, batch_stats, opt_state, batch, None,
                                   to_device(scalars, dev))
        opt_state.count += 1
        return params, batch_stats, opt_state, metrics


def make_s3d_nce_step(model, optimizer, mesh=None, temperature: float = 0.07,
                      freeze_early: bool = True, gather_negatives: bool = False,
                      compute_dtype: str = "float32", scan_steps: Optional[int] = None,
                      train_bn: bool = False):
    """The end-to-end S3D finetune step (``S3DNceStep``) over ``mesh``, or
    with ``scan_steps=N`` the N-step runner (``ScanStep``: on the card a
    replayed CUDA graph, the stats updated inside it)."""
    step = S3DNceStep(model, optimizer, temperature=temperature, freeze_early=freeze_early,
                      gather_negatives=gather_negatives, compute_dtype=compute_dtype,
                      train_bn=train_bn, mesh=mesh)
    return step if scan_steps is None else ScanStep(step, scan_steps)


# view-invariant scalars are means over (B, T) steps, recomputed from these
# maps by rows (the JAX _VI_SCALAR_MAPS, train_step.py:515)
_VI_SCALAR_MAPS = {
    "L1 loss": "per_step_l1",
    "Pos cosine sim": "per_step_pos_cos",
    "Avg neg cosine sim": "per_step_neg_cos",
    "InfoNCE loss": "per_step_nce",
}


class GroundingEvalStep:
    """``eval_step(params, batch) -> (scalars, ious)``: the validation and
    test step of the grounding family (the JAX ``make_grounding_eval_step``
    on one device).

    Deterministic, under ``torch.no_grad()`` with the model in eval mode
    and the inference kernels available. An optional 'row_valid' (B,) marks
    padding rows, which must carry an all-true narration mask. Each scalar
    is its exact weighted mean over the batch: the grounding scalars over
    the valid narrations ('_n_valid'), the view-invariant ones over rows x
    steps ('_rows' rows); the joint loss is the grounding loss plus the
    InfoNCE loss, each over its own weights. Each weighted sum and weight is
    summed over the ranks of ``mesh`` first (the JAX step's psum), so the
    scalars are the global batch's and '_n_valid' / '_rows' count every
    rank's. ``ious`` is the (B, N) IoU map of this rank's rows."""

    def __init__(self, model, loss_cfg: GroundingLossConfig, mesh=None):
        self.model = model
        self.loss_cfg = loss_cfg
        self.mesh = make_mesh() if mesh is None else mesh
        self.vi_mode = loss_cfg.model == "view_invariant"
        self.joint = loss_cfg.model == "joint" and loss_cfg.use_distill_nce_loss

    @torch.no_grad()
    def __call__(self, params, batch):
        self.model.eval()
        video = batch["video_features"]
        rv = batch.get("row_valid")
        rv = (torch.ones(video.shape[0], device=video.device) if rv is None
              else rv.to(torch.float32))
        out = _grounding_forward(self.model, params, batch, batch, deterministic=True)
        ld, ious = egoexo_loss(out, batch, batch["narration_padding_mask"], self.loss_cfg)
        nvalid = ((~batch["narration_padding_mask"]).to(torch.float32) * rv[:, None]).sum()
        rows = rv.sum()
        pairs = {}
        for k, mapk in _VI_SCALAR_MAPS.items():
            if mapk in ld and (self.vi_mode or self.joint):
                m = ld[mapk]
                pairs[k] = ((m * rv[:, None]).sum(), rows * m.shape[1])
        if self.vi_mode:
            m = ld["per_step_nce"]
            pairs["loss"] = ((m * rv[:, None]).sum(), rows * m.shape[1])
        else:
            for k, v in ld.items():
                if v.dim() == 0 and k not in _VI_SCALAR_MAPS and k != "loss":
                    pairs[k] = (v * nvalid, nvalid)
            if self.joint:
                pairs["_gnd_loss"] = ((ld["loss"] - ld["InfoNCE loss"]) * nvalid, nvalid)
            else:
                pairs["loss"] = (ld["loss"] * nvalid, nvalid)
        keys = list(pairs)
        sums = collectives.psum([pairs[k][0] for k in keys] + [pairs[k][1] for k in keys]
                                + [nvalid, rows], self.mesh)
        n = len(keys)
        agg = {k: sums[i] / torch.clamp(sums[n + i], min=1e-6) for i, k in enumerate(keys)}
        if self.joint:
            agg["loss"] = agg.pop("_gnd_loss") + agg["InfoNCE loss"]
        agg["_n_valid"] = sums[-2]
        agg["_rows"] = sums[-1]
        return agg, ious


def make_grounding_eval_step(model, loss_cfg: GroundingLossConfig,
                             mesh=None) -> GroundingEvalStep:
    """The grounding-family validation / test step over ``mesh``."""
    return GroundingEvalStep(model, loss_cfg, mesh=mesh)
