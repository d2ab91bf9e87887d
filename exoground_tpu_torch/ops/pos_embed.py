"""Temporal positional embeddings.

Counterpart of ``exoground_tpu/ops/pos_embed.py`` (reference:
model/tfm_model.py:106-148, model/tan_model.py:146-173): a static sine table,
the mask-driven DETR-style sine embedding,
linear interpolation of a table to a longer sequence (the "global" mode,
``F.interpolate(..., mode='linear', align_corners=False)`` semantics), and a
slice from a start index (0, or a random start drawn from a
``torch.Generator`` for the length-generalization augmentation).

A start given as a tensor selects its rows on the device
(``pos_rows``), the JAX ``dynamic_slice_in_dim``: the train step hands the
model its starts that way, so a captured CUDA graph reads each replay's
starts from memory instead of freezing a Python ``int``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def get_position_embedding_sine(
    feature_dim: int = 512, num_features: int = 1024, temperature: float = 10000.0
) -> torch.Tensor:
    """Static (num_features, feature_dim) float32 sine table: positions
    normalised to [0, 2*pi] over the table length, interleaved sin/cos over
    channel pairs (reference model/tfm_model.py:137-148)."""
    scale = 2 * math.pi
    eps = 1e-6
    pos = torch.arange(num_features, dtype=torch.float32)
    pos = pos / (pos[-1] + eps) * scale
    dim_t = torch.arange(feature_dim, dtype=torch.float32)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / feature_dim)
    angles = pos[:, None] / dim_t
    emb = torch.stack(
        (torch.sin(angles[:, 0::2]), torch.cos(angles[:, 1::2])), dim=2
    ).reshape(num_features, feature_dim)
    return emb


def position_embedding_sine_from_mask(padding_mask: torch.Tensor, num_pos_feats: int = 64,
                                      temperature: float = 10000.0, normalize: bool = True,
                                      scale: Optional[float] = None) -> torch.Tensor:
    """DETR-style 1-D sine embedding from a (B, T) padding mask (True at
    PAD): positions count the real steps, normalised to [0, scale] by each
    row's count; returns (B, num_pos_feats, T), the reference's permuted
    output (model/tfm_model.py:120-134)."""
    if scale is None:
        scale = 2 * math.pi
    y_embed = torch.cumsum((~padding_mask).to(torch.float32), dim=1)
    if normalize:
        y_embed = y_embed / (y_embed[:, -1:] + 1e-6) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=padding_mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    pos_y = y_embed[:, :, None] / dim_t
    pos = torch.stack((torch.sin(pos_y[:, :, 0::2]), torch.cos(pos_y[:, :, 1::2])), dim=3)
    return pos.reshape(pos_y.shape[0], pos_y.shape[1], num_pos_feats).permute(0, 2, 1)


def interpolate_pos_embed(
    table: torch.Tensor, source_len: int, target_len: int, true_len=None
) -> torch.Tensor:
    """Linearly resample ``table[:source_len]`` to ``target_len`` positions
    with half-pixel centres (reference model/tan_model.py:151-154).

    ``true_len`` resamples as if the output grid had ``true_len`` entries
    (the real video length inside a padded bucket); rows beyond it clamp to
    the table end and are key-masked away by the caller."""
    src = table[:source_len]
    s = src.shape[0]
    denom = float(target_len) if true_len is None else float(true_len)
    pos = (torch.arange(target_len, dtype=torch.float32, device=table.device)
           + 0.5) * (s / denom) - 0.5
    pos = pos.clamp(0.0, s - 1.0)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=s - 1)
    w = (pos - lo.to(torch.float32))[:, None].to(table.dtype)
    return src[lo] * (1.0 - w) + src[hi] * w


def slice_or_interpolate_pos_embed(
    table: torch.Tensor,
    seq_len: int,
    interpolate_from: Optional[int] = None,
    start_idx: int = 0,
    true_len=None,
) -> torch.Tensor:
    """The (seq_len, C) positional embedding of one forward pass: resampled
    from ``table[:interpolate_from]`` when that is given, else the slice
    starting at ``start_idx`` (reference model/tan_model.py:146-160): an
    ``int``, or a 0-d integer tensor (see ``pos_rows``)."""
    if interpolate_from:
        return interpolate_pos_embed(table, interpolate_from, seq_len, true_len)
    if isinstance(start_idx, torch.Tensor):
        return pos_rows(table, start_idx, seq_len)
    start_idx = int(start_idx)
    return table[start_idx:start_idx + seq_len]


def pos_rows(table: torch.Tensor, start: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Rows [start, start + seq_len) of ``table`` for a 0-d integer tensor
    ``start`` on the table's device, clamped into the table as
    ``jax.lax.dynamic_slice_in_dim`` clamps it. Nothing is read back to the
    host (a captured graph allows no ``.item()``); each row is picked, and
    takes a gradient, exactly once, so the values and the table's gradient
    equal the slice's."""
    start = torch.clamp(start, 0, table.shape[0] - seq_len)
    idx = start + torch.arange(seq_len, device=table.device)
    return torch.index_select(table, 0, idx)


def random_pos_start(generator: Optional[torch.Generator], seq_len: int) -> int:
    """Random start index in [0, seq_len//2) (model/tan_model.py:157)."""
    hi = max(int(seq_len) // 2, 1)
    return int(torch.randint(0, hi, (1,), generator=generator).item())
