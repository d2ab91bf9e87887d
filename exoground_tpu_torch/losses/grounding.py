"""EgoExo4D / LEMMA grounding and view-invariant losses.

Counterpart of ``exoground_tpu/losses/grounding.py`` (reference
train/loss_egoexo4d.py:73-363): static-shape functions on masks that return
the loss dictionary and a per-element map, so the caller bins by camera rank
on the host.

  * ``grounding_loss`` — IoU + L1 interval regression, in (center,
    duration) or (start, end) form; the per-narration IoU map (pads 0);
  * ``view_invariant_loss`` — the cross-view InfoNCE (with same-view
    negatives when the batch carries them) and its monitoring metrics,
    with the per-timestep maps the eval step reduces by rows;
  * ``egoexo_loss`` — the dispatcher: 'view_invariant', 'grounding', or
    'joint' (the sum of both under ``use_distill_nce_loss``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from exoground_tpu_torch.losses.infonce import cross_view_info_nce, l1_cosine_metrics
from exoground_tpu_torch.ops.masks import masked_mean


@dataclasses.dataclass(frozen=True)
class GroundingLossConfig:
    use_center_duration: bool = True
    iou_loss_eps: float = 1e-6
    iou_thresholds: Tuple[float, ...] = (0.1, 0.3, 0.5, 0.7)
    model: str = "grounding"  # 'grounding' | 'view_invariant' | 'joint'
    use_distill_nce_loss: bool = False
    # mirrors of the train flags, as in the JAX config: the loss keys off the
    # batch (same-view negatives apply iff 'same_view_neg_feats' is present)
    same_view_negative: bool = False
    only_same_view_negative: bool = False
    # the zero-shot baseline: the raw input video features through the VI
    # loss instead of the model's (reference loss_egoexo4d.py:152)
    test_egovlp: bool = False


def grounding_loss(interval_preds: torch.Tensor, targets: Dict[str, torch.Tensor],
                   text_padding_mask: torch.Tensor, cfg: GroundingLossConfig):
    """IoU + L1 regression (JAX grounding.py:42): (loss dict, the (B, N)
    IoU map with 0 at pads). ``targets`` holds 'mean' / 'duration' or
    'starts' / 'ends' (B, N); ``interval_preds`` is (B, N, 2)."""
    valid = (~text_padding_mask).to(torch.float32)
    ld: Dict[str, torch.Tensor] = {}
    p0, p1 = interval_preds[..., 0], interval_preds[..., 1]
    if cfg.use_center_duration:
        c_gt, d_gt = targets["mean"], targets["duration"]
        ld["Center L1 loss"] = masked_mean((p0 - c_gt).abs(), valid)
        ld["Duration L1 loss"] = masked_mean((p1 - d_gt).abs(), valid)
        s_pred, e_pred = p0 - p1 / 2, p0 + p1 / 2
        s_gt, e_gt = c_gt - d_gt / 2, c_gt + d_gt / 2
    else:
        s_pred, e_pred = p0, p1
        s_gt, e_gt = targets["starts"], targets["ends"]
        ld["Timestamp L1 loss"] = (masked_mean((s_pred - s_gt).abs(), valid)
                                   + masked_mean((e_pred - e_gt).abs(), valid)) / 2
    inter = (torch.minimum(e_pred, e_gt) - torch.maximum(s_pred, s_gt)).clamp(min=0.0)
    union = torch.maximum(e_pred, e_gt) - torch.minimum(s_pred, s_gt)
    iou = inter / (union + cfg.iou_loss_eps)
    mean_iou = masked_mean(iou, valid)
    ld["IoU loss"] = 1.0 - mean_iou
    ld["mean IoU"] = mean_iou
    for theta in cfg.iou_thresholds:
        ld[f"IoU>={theta}"] = ((iou > theta) * valid).sum() / valid.sum().clamp(min=1e-6)
    loss = ld["IoU loss"]
    if cfg.use_center_duration:
        loss = loss + ld["Duration L1 loss"] + ld["Center L1 loss"]
    else:
        loss = loss + ld["Timestamp L1 loss"]
    ld["loss"] = loss
    return ld, iou * valid


def view_invariant_loss(features: torch.Tensor, ego_features: torch.Tensor,
                        positive_indices: torch.Tensor, negative_indices: torch.Tensor,
                        cfg: GroundingLossConfig,
                        same_view_neg_feats: Optional[torch.Tensor] = None):
    """The cross-view distillation loss (JAX grounding.py:94): (loss dict,
    the (B, T) InfoNCE map). 'loss' is the mean InfoNCE, always trained (the
    flag only emits the 'InfoNCE loss' key); the 'per_step_*' maps let the
    eval step reduce by rows."""
    nce = cross_view_info_nce(features, ego_features, positive_indices, negative_indices,
                              same_view_neg_feats=same_view_neg_feats,
                              only_same_view_negative=cfg.only_same_view_negative)
    l1, pos_cos, neg_cos = l1_cosine_metrics(features, ego_features, positive_indices,
                                             negative_indices)
    ld = {"L1 loss": l1.mean(), "Pos cosine sim": pos_cos.mean(),
          "Avg neg cosine sim": neg_cos.mean(), "per_step_l1": l1,
          "per_step_pos_cos": pos_cos, "per_step_neg_cos": neg_cos, "per_step_nce": nce,
          "loss": nce.mean()}
    if cfg.use_distill_nce_loss:
        ld["InfoNCE loss"] = ld["loss"]
    return ld, nce


def _vi(features, batch, cfg):
    return view_invariant_loss(features, batch["ego_video_features"], batch["view_rank_label"],
                               batch["view_rank_neg_label"], cfg,
                               same_view_neg_feats=batch.get("same_view_neg_feats"))


def egoexo_loss(model_out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                text_padding_mask: torch.Tensor, cfg: GroundingLossConfig):
    """The dispatcher (JAX grounding.py:135): view_invariant -> the VI loss
    (of the raw video features under ``test_egovlp``); grounding, or joint
    without distillation -> the regression; joint -> the sum of both, the
    IoU map returned."""
    if cfg.model == "view_invariant":
        return _vi(batch["video_features"] if cfg.test_egovlp
                   else model_out["high_dim_features"], batch, cfg)
    targets = {k: batch[k] for k in ("mean", "duration", "starts", "ends") if k in batch}
    gnd, iou = grounding_loss(model_out["interval_preds"], targets, text_padding_mask, cfg)
    if cfg.model == "grounding" or not cfg.use_distill_nce_loss:
        return gnd, iou
    vi, _ = _vi(model_out["high_dim_features"], batch, cfg)
    combined = {**vi, **gnd}
    combined["loss"] = vi["loss"] + gnd["loss"]
    return combined, iou
