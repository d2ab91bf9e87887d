"""The TAN train step on one device.

Counterpart of ``exoground_tpu/parallel/train_step.py::make_tan_train_step``
(:129-303) without the data-parallel axis: one call runs the online forward
(random pos start from a ``torch.Generator``), the EMA teacher forward under
``torch.no_grad()`` with ``deterministic=True``, ``tan_loss``, backward, and
``FusedAdamWEMA.step`` with the EMA update. The whole step runs inside
``disable_fused_kernels()``, as the JAX step traces under it, so the model
takes its plain compositions; on the card the MIL-NCE grid kernel carries
the loss's denominators (2 forward and 2 backward launches per step, dual
and joint).

With ``text_tower_params`` (the frozen word2vec tower's tensors) a batch
may carry 'token' (B, N, L) ids in place of 'text' features: the tower
embeds them inside the step (``_batch_text``, its pooled output only), its
weights cast once to the compute dtype, as the JAX step casts them.

A step has a host half and a device half. The host half (``draw``) takes
the random pos starts from the ``torch.Generator`` and the optimizer's
(lr, bc1, bc2) for the step's count; the device half (``device_step``)
reads them as small tensors on the card and does everything else: no host
read, no host-to-device copy of a pageable buffer, nothing that a CUDA
graph capture forbids.

``make_tan_train_step(scan_steps=N)`` returns ``TanScanStep``, the JAX
``scan_steps`` runner: one call runs N optimizer steps over a batch with a
leading (N, ...) axis. On the CPU it loops over the eager step (the plain
version). On a card its first call for a shape runs the N steps eagerly and
then captures them as one ``torch.cuda.CUDAGraph`` over static input
buffers; every later call copies its batches, starts and scalars into those
buffers and replays the graph (the grid kernel's launches, and flash's under
``attn_impl='flash'``, are inside it). Parameters, the EMA twin and the
moments are updated in place, so the graph's addresses stay theirs; a
tensor that moved (replaced, not updated in place) makes the runner capture
anew before it replays.

``TanEvalStep`` is the JAX ``make_tan_eval_step`` (:607-676) on one device:
inference-shaped, under ``torch.no_grad()`` with the kernels on (fused MHA
and MLP in both towers, the grid's forward), the cotrain targets from the
EMA teacher, returning the loss scalars and ``_rows``.

Parameters are a dictionary of float32 master tensors (the model's own
parameters, shared by storage, so the optimizer's in-place update keeps the
module current). ``compute_dtype="bfloat16"`` casts them for the forward
through ``torch.func.functional_call``, as the JAX step's ``_cast_floats``
does: the grads come back to the float32 masters through the cast, and the
loss math stays float32.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from exoground_tpu_torch.losses.milnce import TANLossConfig, tan_loss
from exoground_tpu_torch.models.word2vec import word2vec_forward
from exoground_tpu_torch.ops import _kernels
from exoground_tpu_torch.ops.fused_mlp import disable_fused_kernels
from exoground_tpu_torch.utils.device import to_device

# normalized-feature outputs of TemporalAligner: they stay in the compute
# dtype under the fused grid (the grid and the diagonal accumulate in
# float32); every other output is upcast for the loss math
_FEATURE_KEYS = (
    "dual_feature_video", "dual_feature_text",
    "joint_feature_video", "joint_feature_text",
)
_LATER = "a later slice of the port (ROADMAP.md, queue 1 item 4)"


def _cast_floats(tree: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    """Floating tensors to ``dtype``; masks and integers pass through."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}


def _f32_except_features(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v if k in _FEATURE_KEYS else v.float() for k, v in out.items()}


def _lengths(batch: Dict[str, torch.Tensor]) -> tuple:
    """(T, N) of a batch, stacked or not: video (..., T, Dv), text
    (..., N, Dt) or token (..., N, L)."""
    return batch["video"].shape[-2], batch["text" if "text" in batch else "token"].shape[-2]


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


class TanTrainStep:
    """``step(params, target, opt_state, batch, generator) -> (params,
    target, opt_state, metrics)``; ``loss_and_grads`` is its first half.

    batch: video (B, T, Dv), text (B, N, Dt) or token (B, N, L) with
    ``text_tower_params``, video_padding_mask (B, T), text_padding_mask
    (B, N), start, end [, abs_text_pos], on the device of the parameters.
    ``target`` is the EMA twin (pass ``params`` when not cotraining); with
    ``ema_momentum`` set the optimizer updates it in the same pass. Metrics
    are the loss dict's 0-d tensors, detached."""

    def __init__(self, model, loss_cfg: TANLossConfig, optimizer,
                 ema_momentum: Optional[float] = None, compute_dtype: str = "float32",
                 fused_grid: bool = True, text_tower_params=None):
        self.model = model
        self.loss_cfg = loss_cfg
        self.optimizer = optimizer
        self.ema_momentum = ema_momentum
        self.cdt = getattr(torch, compute_dtype)
        self.fused_grid = fused_grid
        self.cotrain = loss_cfg.model == "cotrain"
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

    def draw(self, batch: Dict[str, torch.Tensor], generator, count: int):
        """The host half of the step that reads optimizer count ``count``:
        (its pos starts, (k,) int64, ``TemporalAligner.draw_pos_starts``;
        the optimizer's (3,) float32 scalars). ``batch`` may be stacked."""
        return (self.model.draw_pos_starts(generator, *_lengths(batch)).numpy(),
                self.optimizer.scalars(count))

    def loss_and_grads(self, params: Dict[str, torch.Tensor], target: Dict[str, torch.Tensor],
                       batch: Dict[str, torch.Tensor], generator=None, pos_starts=None):
        """(metrics, grads): the loss dict's scalars and float32 grads by
        parameter name (None where the loss does not reach a parameter).
        The random pos starts come from ``pos_starts`` (on the device) or
        else from ``generator``."""
        with disable_fused_kernels():
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            p_c = _cast_floats(leaves, self.cdt)
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
            else:
                logits = {k: v.float() for k, v in out.items()}
            if self.cotrain:
                with torch.no_grad():
                    ema_out = self._forward(_cast_floats(target, self.cdt), batch_c, batch, True)
                if self.fused_grid:
                    for k in _FEATURE_KEYS:
                        logits[f"ema-{k}"] = ema_out[k]
                else:
                    logits["ema-logits_dual"] = ema_out["logits_dual"].float()
                    logits["ema-logits_joint"] = ema_out["logits_joint"].float()
            ld = tan_loss(batch["start"], batch["end"], logits, batch["video_padding_mask"],
                          batch["text_padding_mask"], self.loss_cfg,
                          abs_text_pos=batch.get("abs_text_pos"))
            names = list(leaves)
            grads = torch.autograd.grad(ld["loss"], [leaves[k] for k in names],
                                        allow_unused=True)
        metrics = {k: v.detach() for k, v in ld.items() if v.dim() == 0}
        return metrics, dict(zip(names, grads))

    def device_step(self, params, target, opt_state, batch, pos_starts: torch.Tensor,
                    scalars: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The device half of one step, from ``draw``'s starts and scalars on
        the device; updates the parameters, moments and twin in place and
        leaves ``opt_state.count`` to the caller. Returns the metrics."""
        metrics, grads = self.loss_and_grads(params, target, batch, pos_starts=pos_starts)
        self.optimizer.apply(params, opt_state, grads, scalars, target, self.ema_momentum)
        return metrics

    def __call__(self, params, target, opt_state, batch, generator=None):
        dev = batch["video"].device
        starts, scalars = self.draw(batch, generator, opt_state.count)
        metrics = self.device_step(params, target, opt_state, batch, to_device(starts, dev),
                                   to_device(scalars, dev))
        opt_state.count += 1
        return params, target, opt_state, metrics


def _addresses(params, target, opt_state) -> tuple:
    return tuple(t.data_ptr() for d in (params, target, opt_state.mu, opt_state.nu)
                 for t in d.values())


class _Graph:
    """N captured steps: the graph, its static inputs and stacked metrics,
    the launches its capture recorded and the addresses it was captured on."""

    def __init__(self, graph, batch, starts, scalars, metrics, launches, addresses,
                 capture_s, pool_bytes):
        self.graph, self.batch, self.starts, self.scalars = graph, batch, starts, scalars
        self.metrics, self.launches, self.addresses = metrics, launches, addresses
        self.capture_s, self.pool_bytes = capture_s, pool_bytes

    def replay(self, batches, starts: np.ndarray, scalars: np.ndarray) -> None:
        for k, buf in self.batch.items():
            buf.copy_(batches[k])
        self.starts.copy_(torch.from_numpy(starts).pin_memory(), non_blocking=True)
        self.scalars.copy_(torch.from_numpy(scalars).pin_memory(), non_blocking=True)
        self.graph.replay()
        _kernels.add_launches(self.launches)


class TanScanStep:
    """``step(params, target, opt_state, batches, generator) -> (params,
    target, opt_state, metrics)``: N optimizer steps a call (the JAX
    ``scan_steps`` contract). ``batches`` carries a leading (N, ...) axis;
    each metric comes back stacked (N,); ``opt_state.count`` advances by N.
    ``single`` is the one-step ``TanTrainStep`` it repeats.

    On a card: one graph per batch shapes and dtypes, compute dtype,
    ``attn_impl`` and train mode (``graphs``); each records its capture
    seconds and the bytes its memory pool reserved. A capture that fails
    raises: it never falls back to the eager loop on the card."""

    def __init__(self, single: TanTrainStep, n: int):
        if n < 1:
            raise ValueError(f"scan_steps must be at least 1, got {n}")
        self.single, self.n = single, n
        self.graphs: Dict[tuple, _Graph] = {}
        self.captures = 0
        self._stream = None

    def _key(self, batches) -> tuple:
        return (tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batches.items())),
                self.single.cdt, self.single.model.attn_impl, self.single.model.training)

    def _loop(self, params, target, opt_state, batches, generator):
        ms = []
        for i in range(self.n):
            params, target, opt_state, m = self.single(
                params, target, opt_state, {k: v[i] for k, v in batches.items()}, generator)
            ms.append(m)
        return params, target, opt_state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    def __call__(self, params, target, opt_state, batches, generator=None):
        bad = {k: tuple(v.shape) for k, v in batches.items() if v.shape[0] != self.n}
        if bad:
            raise ValueError(f"scan_steps={self.n} needs a leading axis of {self.n}: {bad}")
        dev = batches["video"].device
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
        if g.addresses != _addresses(params, target, opt_state):
            del self.graphs[key], g
            g = self.graphs[key] = self._capture(params, target, opt_state, batches)
        draws = [self.single.draw(batches, generator, opt_state.count + i)
                 for i in range(self.n)]
        g.replay(batches, np.stack([d[0] for d in draws]), np.stack([d[1] for d in draws]))
        opt_state.count += self.n
        return params, target, opt_state, {k: v.clone() for k, v in g.metrics.items()}

    def _capture(self, params, target, opt_state, batches) -> _Graph:
        dev = batches["video"].device
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # as the capture does: the pool's bytes are what it adds
        reserved0 = torch.cuda.memory_reserved(dev)
        static = {k: torch.empty_like(v) for k, v in batches.items()}
        k = len(self.single.model.pos_start_lengths(*_lengths(batches)))
        starts = torch.zeros((self.n, k), dtype=torch.int64, device=dev)
        scalars = torch.ones((self.n, 3), dtype=torch.float32, device=dev)
        graph = torch.cuda.CUDAGraph()
        with _kernels.captured_launches() as launches, torch.cuda.graph(
                graph, stream=self._stream, capture_error_mode="thread_local"):
            ms = [self.single.device_step(params, target, opt_state,
                                          {key: v[i] for key, v in static.items()},
                                          starts[i], scalars[i]) for i in range(self.n)]
            metrics = {key: torch.stack([m[key] for m in ms]) for key in ms[0]}
        torch.cuda.synchronize(dev)
        self.captures += 1
        return _Graph(graph, static, starts, scalars, metrics, launches,
                      _addresses(params, target, opt_state), time.perf_counter() - t0,
                      torch.cuda.memory_reserved(dev) - reserved0)


def make_tan_train_step(model, loss_cfg: TANLossConfig, optimizer,
                        ema_momentum: Optional[float] = None, gather_negatives: bool = False,
                        text_tower_params=None, compute_dtype: str = "float32",
                        scan_steps: Optional[int] = None, fused_grid: bool = True):
    """The TAN train step (``TanTrainStep``), or with ``scan_steps=N`` the
    N-step runner (``TanScanStep``). ``fused_grid=False`` keeps the
    reference-shaped volume path. ``gather_negatives`` (data parallel)
    raises: it comes with a later slice."""
    if gather_negatives:
        raise NotImplementedError(f"gather_negatives (all_gather over NCCL) waits for {_LATER}")
    step = TanTrainStep(model, loss_cfg, optimizer, ema_momentum=ema_momentum,
                        compute_dtype=compute_dtype, fused_grid=fused_grid,
                        text_tower_params=text_tower_params)
    return step if scan_steps is None else TanScanStep(step, scan_steps)


class TanEvalStep:
    """``eval_step(params, target, batch) -> scalars``: the validation loss
    of the train protocol (the JAX ``make_tan_eval_step``, :607-676).

    float32, deterministic, under ``torch.no_grad()`` with the model in eval
    mode and the inference kernels available; for cotrain the agreement
    targets come from the EMA teacher (deriving them from the online
    outputs would bias the loss low). Returns the loss dict's scalars (on
    one device the JAX step's row-weighted psum mean is the batch's own
    value) and ``_rows``, the batch's rows, by which callers average."""

    def __init__(self, model, loss_cfg: TANLossConfig, is_cotrain: bool = False,
                 text_tower_params=None, fused_grid: bool = True):
        self.model = model
        self.loss_cfg = loss_cfg
        self.is_cotrain = is_cotrain
        self.tower = text_tower_params
        self.fused_grid = fused_grid

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
        agg = {k: v for k, v in ld.items() if v.dim() == 0}
        agg["_rows"] = torch.tensor(float(batch["video"].shape[0]), device=batch["video"].device)
        return agg


def make_tan_eval_step(model, loss_cfg: TANLossConfig, is_cotrain: bool = False,
                       text_tower_params=None, fused_grid: bool = True) -> TanEvalStep:
    """The TAN validation step on one device (see ``TanEvalStep``)."""
    return TanEvalStep(model, loss_cfg, is_cotrain=is_cotrain,
                       text_tower_params=text_tower_params, fused_grid=fused_grid)
