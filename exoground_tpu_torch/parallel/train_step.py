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

from typing import Dict, Optional

import torch
from torch.func import functional_call

from exoground_tpu_torch.losses.milnce import TANLossConfig, tan_loss
from exoground_tpu_torch.models.word2vec import word2vec_forward
from exoground_tpu_torch.ops.fused_mlp import disable_fused_kernels

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

    def _forward(self, params, batch_c, batch, deterministic, generator=None):
        kw = dict(deterministic=deterministic, return_sim_volumes=not self.fused_grid,
                  generator=generator)
        return functional_call(
            self.model, params,
            (batch_c["video"], batch_c["text"], batch["video_padding_mask"],
             batch["text_padding_mask"]), kw)

    def loss_and_grads(self, params: Dict[str, torch.Tensor], target: Dict[str, torch.Tensor],
                       batch: Dict[str, torch.Tensor], generator=None):
        """(metrics, grads): the loss dict's scalars and float32 grads by
        parameter name (None where the loss does not reach a parameter)."""
        with disable_fused_kernels():
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            p_c = _cast_floats(leaves, self.cdt)
            batch_c = _cast_floats({"video": batch["video"],
                                    "text": _batch_text(batch, self.tower)}, self.cdt)
            out = self._forward(p_c, batch_c, batch, False, generator)
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

    def __call__(self, params, target, opt_state, batch, generator=None):
        metrics, grads = self.loss_and_grads(params, target, batch, generator)
        params, opt_state, target = self.optimizer.step(
            params, opt_state, grads, target, self.ema_momentum)
        return params, target, opt_state, metrics


def make_tan_train_step(model, loss_cfg: TANLossConfig, optimizer,
                        ema_momentum: Optional[float] = None, gather_negatives: bool = False,
                        text_tower_params=None, compute_dtype: str = "float32",
                        scan_steps: Optional[int] = None,
                        fused_grid: bool = True) -> TanTrainStep:
    """The TAN train step (see ``TanTrainStep``). ``fused_grid=False`` keeps
    the reference-shaped volume path. The data-parallel and multi-step
    options of the JAX step raise: they come with a later slice."""
    if gather_negatives:
        raise NotImplementedError(f"gather_negatives (all_gather over NCCL) waits for {_LATER}")
    if scan_steps is not None:
        raise NotImplementedError(f"scan_steps (fused multi-step dispatch) waits for {_LATER}")
    return TanTrainStep(model, loss_cfg, optimizer, ema_momentum=ema_momentum,
                        compute_dtype=compute_dtype, fused_grid=fused_grid,
                        text_tower_params=text_tower_params)


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
