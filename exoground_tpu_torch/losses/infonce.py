"""InfoNCE-family losses.

Counterpart of ``exoground_tpu/losses/infonce.py`` (reference
model/exo_ground_model.py:206-292, train/loss_egoexo4d.py:201-323,
end2end/main_nce.py:30-47), mask-based and static-shape:

  * ``info_nce_diag`` — per-timestep InfoNCE whose positives are the
    diagonal (the same timestep of the positive sequence);
  * ``pairwise_view_info_nce`` — the same between every ordered pair of
    views of a stitched multi-view sequence, over the batch rows where both
    views exist, averaged over the pairs that have such a row;
  * ``cross_view_info_nce`` — per-timestep InfoNCE against an explicit
    positive and negative view of a multi-view bank (and optionally a
    same-view temporal negative), the view-invariant loss;
  * ``l1_cosine_metrics`` — its monitoring metrics;
  * ``symmetric_info_nce`` — the plain batch InfoNCE of the S3D stage.

``GroundingModel.forward`` computes the first two under its distillation
options; ``losses/grounding.py`` the next two.
"""

from __future__ import annotations

import torch


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def _diag_log_softmax(f: torch.Tensor, p: torch.Tensor, temperature: float) -> torch.Tensor:
    """log-softmax over s of (f_t . p_s) / temperature at s = t: (B, T)."""
    sim = torch.einsum("btc,bsc->bts", f, p) / temperature
    return torch.diagonal(torch.log_softmax(sim, dim=2), dim1=1, dim2=2)


def info_nce_diag(features, positive_features, temperature: float = 0.1):
    """Mean InfoNCE with per-timestep diagonal positives; features and
    positive_features (B, T, C); the negatives are the other timesteps of
    the same pair (JAX infonce.py:29)."""
    return -_diag_log_softmax(_l2norm(features), _l2norm(positive_features),
                              temperature).mean()


def pairwise_view_info_nce(features, view_mask, num_views: int, temperature: float = 0.1):
    """All-pair cross-view InfoNCE over a stitched (B, V*Tv, C) sequence
    (JAX infonce.py:43): for each pair i < j of views, the diagonal InfoNCE
    between the two view chunks over the batch rows where ``view_mask`` (B,
    V) holds both, then the mean over the pairs with such a row (0 if
    none)."""
    b, vt, c = features.shape
    f = _l2norm(features.reshape(b, num_views, vt // num_views, c))
    zero = features.new_zeros(())
    total, pair_w = zero, zero
    for i in range(num_views):
        for j in range(i + 1, num_views):
            valid = (view_mask[:, i] & view_mask[:, j]).to(features.dtype)
            diag = _diag_log_softmax(f[:, i], f[:, j], temperature).mean(dim=1)
            n = valid.sum()
            pair_loss = -(diag * valid).sum() / n.clamp(min=1e-6)
            total = total + torch.where(n > 0, pair_loss, zero)
            pair_w = pair_w + (n > 0).to(features.dtype)
    return torch.where(pair_w > 0, total / pair_w.clamp(min=1e-6), zero)


def _gather_views(video_features, indices):
    """(B, T, C) rows ``video_features[b, indices[b, t], t]`` of a (B, V, T,
    C) bank."""
    b, _, t, _ = video_features.shape
    bt = torch.arange(b, device=indices.device)[:, None]
    tt = torch.arange(t, device=indices.device)[None, :]
    return video_features[bt, indices.long(), tt]


def cross_view_info_nce(output_features, video_features, positive_indices, negative_indices,
                        same_view_neg_feats=None, only_same_view_negative: bool = False,
                        temperature: float = 0.1):
    """Per-timestep cross-view InfoNCE map (B, T) (JAX infonce.py:78):
    output (B, T, C) against the positive and negative views of the (B, V,
    T, C) bank picked per timestep by the (B, T) indices, and the (B, T, C)
    same-view negatives when given (alone under
    ``only_same_view_negative``); the caller reduces it."""
    f = _l2norm(output_features)
    pos = _l2norm(_gather_views(video_features, positive_indices))
    neg = _l2norm(_gather_views(video_features, negative_indices))
    sims = [(f * pos).sum(-1) / temperature]
    neg_sim = (f * neg).sum(-1) / temperature
    if same_view_neg_feats is not None:
        sv = (f * _l2norm(same_view_neg_feats)).sum(-1) / temperature
        sims += [sv] if only_same_view_negative else [neg_sim, sv]
    else:
        sims.append(neg_sim)
    return -torch.log_softmax(torch.stack(sims, dim=-1), dim=-1)[..., 0]


def l1_cosine_metrics(output_features, video_features, positive_indices, negative_indices):
    """Monitoring metrics (JAX infonce.py:113): per-timestep L1 to the
    positive view and cosine similarity to the positive and negative views,
    each (B, T)."""
    f = _l2norm(output_features)
    pos = _l2norm(_gather_views(video_features, positive_indices))
    neg = _l2norm(_gather_views(video_features, negative_indices))
    return (f - pos).abs().mean(-1), (f * pos).sum(-1), (f * neg).sum(-1)


def symmetric_info_nce(video_embed, text_embed, temperature: float = 0.07):
    """The batch InfoNCE over (B, C) video and text embeddings, the SUM of
    both directions (JAX infonce.py:127): (loss, {'loss-per-video',
    'loss-per-text', 'sim'}); the rows of sim are videos, so the softmax
    over texts is 'loss-per-text'."""
    sim = torch.einsum("bc,kc->bk", video_embed, text_embed) / temperature
    loss_t = -torch.diagonal(torch.log_softmax(sim, dim=1)).mean()
    loss_v = -torch.diagonal(torch.log_softmax(sim, dim=0)).mean()
    return loss_v + loss_t, {"loss-per-video": loss_v, "loss-per-text": loss_t, "sim": sim}
