"""View-invariant (exo -> ego) encoders.

Counterpart of ``exoground_tpu/models/vi_encoder.py`` (reference
model/vi_encoder.py):

  * ``ViewInvariantEncoder`` — the transformer variant (vi_encoder.py:8-163):
    a video-only ``TemporalEncoder`` over the projected features, the mean
    of its stages, and ``exo_feature_proj`` back up to the input width;
  * ``ViewInvariantMLP`` — the variant the reference pipeline trains and
    loads (vi_encoder.py:166-256): a no-bias Linear, LayerNorm, then a
    two-layer ReLU MLP, input width in and out.

Both return {'low_dim_features', 'high_dim_features'}. Attribute names
follow the reference's state dict (``mlp.0`` / ``mlp.2`` for the MLP's
Linears). Their projections are exact under ``quant.matmul_impl('int8')``,
as the JAX modules' plain Denses are; the transformer's blocks take the
context as every block does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from exoground_tpu_torch.ops.attention import check_impl
from exoground_tpu_torch.ops.blocks import LN_EPS, TemporalEncoder, post_ln_last
from exoground_tpu_torch.ops.pos_embed import (
    get_position_embedding_sine,
    random_pos_start,
    slice_or_interpolate_pos_embed,
)
from exoground_tpu_torch.utils.device import resolve_device


class ViewInvariantEncoder(nn.Module):
    def __init__(self, num_encoder_layers: int = 2, pos_enc: str = "learned",
                 random_pos_start: int = 1, video_embed_dim: int = 4096,
                 feature_dim: int = 512, use_distill_nce_loss: bool = True,
                 num_max_views: int = 1, heads: int = 8, max_pos: int = 1024,
                 attn_impl: Optional[str] = None, device="cuda"):
        super().__init__()
        check_impl(attn_impl)
        self.random_pos_start = random_pos_start
        self.use_distill_nce_loss = use_distill_nce_loss
        self.num_max_views = num_max_views
        self.attn_impl = attn_impl
        w = feature_dim
        self.video_unimodal_encoder = TemporalEncoder(w, num_encoder_layers, heads)
        self.video_pre_proj = nn.Linear(video_embed_dim, w, bias=False)
        self.ln_video_init = nn.LayerNorm(w, eps=LN_EPS)
        self.ln_position_init = nn.LayerNorm(w, eps=LN_EPS)
        self.ln_video_post_enc = nn.LayerNorm(w, eps=LN_EPS)
        if use_distill_nce_loss:
            self.exo_feature_proj = nn.Linear(w, video_embed_dim)
        if pos_enc == "learned":
            self.temporal_pos_embed = nn.Parameter(torch.randn(max_pos, w) * 0.01)
        else:
            self.register_buffer("temporal_pos_embed", get_position_embedding_sine(w, max_pos))
        self.to(resolve_device(device))

    def pos_start_lengths(self, t: int, interpolate_from=None,
                          deterministic: bool = False) -> tuple:
        """The length of the one random pos start a training forward over T
        steps draws (none when it draws none)."""
        if deterministic or interpolate_from is not None or not self.random_pos_start:
            return ()
        return (t // self.num_max_views,)

    def forward(self, video_embed, lang_embed=None, video_padding_mask=None,
                lang_padding_mask=None, audio_embed=None, audio_padding_mask=None,
                egocentric_video_embed=None, view_mask=None, interpolate_from=None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None,
                pos_starts: Optional[torch.Tensor] = None):
        """(B, T, D_video) -> features (vi_encoder.py:67-99); the pos table
        slice of T // num_max_views rows is tiled per view. When
        ``deterministic=False`` the random pos start is ``pos_starts``'s one
        entry or else a draw from ``generator``."""
        b, t, _ = video_embed.shape
        if video_padding_mask is None:
            video_padding_mask = torch.zeros((b, t), dtype=torch.bool, device=video_embed.device)
        x = self.ln_video_init(self.video_pre_proj(video_embed))
        seq_len = t // self.num_max_views
        start = 0
        if self.pos_start_lengths(t, interpolate_from, deterministic):
            start = (random_pos_start(generator, seq_len) if pos_starts is None
                     else pos_starts.reshape(-1)[0])
        pos = slice_or_interpolate_pos_embed(self.temporal_pos_embed, seq_len,
                                             interpolate_from, start)
        x = x + self.ln_position_init(pos.to(x.dtype).repeat(self.num_max_views, 1))[None]
        stages = self.video_unimodal_encoder(x, video_padding_mask, impl=self.attn_impl)
        feats = post_ln_last(stages, self.ln_video_post_enc).mean(dim=1)
        high = self.exo_feature_proj(feats) if self.use_distill_nce_loss else feats
        return {"low_dim_features": feats, "high_dim_features": high}


class ViewInvariantMLP(nn.Module):
    def __init__(self, video_embed_dim: int = 4096, device="cuda"):
        super().__init__()
        d = video_embed_dim
        self.video_pre_proj = nn.Linear(d, d, bias=False)
        self.ln_video_init = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp = nn.Sequential(nn.Linear(d, d), nn.ReLU(), nn.Linear(d, d))
        self.to(resolve_device(device))

    def pos_start_lengths(self, *args, **kwargs) -> tuple:
        """No pos table, so no start."""
        return ()

    def draw_pos_starts(self, *args, **kwargs) -> torch.Tensor:
        return torch.zeros((0,), dtype=torch.int64)

    def forward(self, video_embed, *args, **kwargs):
        """(B, T, D_video) -> the same width (vi_encoder.py:112-127); the
        other arguments of the VI interface are accepted and unused."""
        x = self.mlp(self.ln_video_init(self.video_pre_proj(video_embed)))
        return {"low_dim_features": x, "high_dim_features": x}
