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
from exoground_tpu_torch.ops.fused_mlp import disable_fused_kernels

# normalized-feature outputs of TemporalAligner: they stay in the compute
# dtype under the fused grid (the grid and the diagonal accumulate in
# float32); every other output is upcast for the loss math
_FEATURE_KEYS = (
    "dual_feature_video", "dual_feature_text",
    "joint_feature_video", "joint_feature_text",
)
_LATER = "a later slice of the port (ROADMAP.md, queue 1 item 8)"


def _cast_floats(tree: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    """Floating tensors to ``dtype``; masks and integers pass through."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}


def _f32_except_features(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v if k in _FEATURE_KEYS else v.float() for k, v in out.items()}


class TanTrainStep:
    """``step(params, target, opt_state, batch, generator) -> (params,
    target, opt_state, metrics)``; ``loss_and_grads`` is its first half.

    batch: video (B, T, Dv), text (B, N, Dt), video_padding_mask (B, T),
    text_padding_mask (B, N), start, end [, abs_text_pos], on the device of
    the parameters. ``target`` is the EMA twin (pass ``params`` when not
    cotraining); with ``ema_momentum`` set the optimizer updates it in the
    same pass. Metrics are the loss dict's 0-d tensors, detached."""

    def __init__(self, model, loss_cfg: TANLossConfig, optimizer,
                 ema_momentum: Optional[float] = None, compute_dtype: str = "float32",
                 fused_grid: bool = True):
        self.model = model
        self.loss_cfg = loss_cfg
        self.optimizer = optimizer
        self.ema_momentum = ema_momentum
        self.cdt = getattr(torch, compute_dtype)
        self.fused_grid = fused_grid
        self.cotrain = loss_cfg.model == "cotrain"

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
            batch_c = _cast_floats({"video": batch["video"], "text": batch["text"]}, self.cdt)
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
    if text_tower_params is not None:
        raise NotImplementedError(f"the word2vec text tower in the step waits for {_LATER}")
    return TanTrainStep(model, loss_cfg, optimizer, ema_momentum=ema_momentum,
                        compute_dtype=compute_dtype, fused_grid=fused_grid)
