"""InfoNCE losses of the grounding model's distillation options.

Counterpart of the first two functions of ``exoground_tpu/losses/infonce.py``
(reference model/exo_ground_model.py:206-292), mask-based and static-shape:

  * ``info_nce_diag`` — per-timestep InfoNCE whose positives are the
    diagonal (the same timestep of the positive sequence);
  * ``pairwise_view_info_nce`` — the same between every ordered pair of
    views of a stitched multi-view sequence, over the batch rows where both
    views exist, averaged over the pairs that have such a row.

``GroundingModel.forward`` computes them under its distillation options.
The rest of the JAX module (cross-view InfoNCE, the monitoring metrics, the
symmetric InfoNCE of the S3D stage) belongs to the train slices.
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
