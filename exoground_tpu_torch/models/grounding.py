"""ExoGround keystep-grounding models, inference forward.

Counterpart of ``exoground_tpu/models/grounding.py``:

  * ``ExoGroundingTransformer`` (reference model/exo_ground_model.py:12-393):
    uni-modal video and text encoders, the mean of their collected stages,
    a joint encoder over [video (, audio), text], a ``TemporalDecoder`` with
    the narrations as queries and the video (+ audio) as memory, and a
    Linear head emitting (center, duration) or (start, end) per narration.
    Options: the audio branch, multi-view stitched sequences with the pos
    table tiled per view, text pos-enc, ``use_decoder=False`` (the head on
    every stage of the joint text part), the exo->ego distillation
    projection, ``interpolate_from``.
  * ``GroundingModel`` (reference model/keystep_ground_model.py:13-408): the
    same trunk behind a frozen view-invariant pre-pass (``vi_encoder``,
    'mlp', 'transformer' or 'none') whose high-dim output replaces the video
    features, and the distillation InfoNCE computed in forward.

Attribute names follow the reference's state dicts: the reference's
grounding model inlines the trunk, so ``GroundingModel`` subclasses it and
adds ``vi_encoder.*``; the reference's unused ``mlp`` Linear(width, width) is
held too, so a reference checkpoint loads with ``load_state_dict(strict=
True)``. ``attn_impl`` (None or 'auto', 'xla', 'flash', 'small', 'fused')
reaches every encoder and decoder attention, as the JAX fields do: under
'small' each square window of S <= 128 (all of them when served through
``GroundingService``) runs the window-attention kernel. The pre-projections
go through ``quant.linear``, as the JAX model's ``_quant_dot_general``
Denses; the grounding head and the distillation projection stay exact.
``random_pos_start`` draws from the ``torch.Generator`` given to forward,
or the starts come from ``pos_starts``, a small integer tensor on the
device that ``draw_pos_starts`` drew up front in the same order (text,
video, audio; the VI encoder's first): the train step hands them in that
way, so a captured CUDA graph reads each replay's starts from memory instead
of freezing the ones drawn at capture.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from exoground_tpu_torch.losses.infonce import info_nce_diag, pairwise_view_info_nce
from exoground_tpu_torch.models.vi_encoder import ViewInvariantEncoder, ViewInvariantMLP
from exoground_tpu_torch.ops import quant
from exoground_tpu_torch.ops.attention import check_impl
from exoground_tpu_torch.ops.blocks import (
    LN_EPS,
    TemporalDecoder,
    TemporalEncoder,
    post_ln_last,
)
from exoground_tpu_torch.ops.pos_embed import (
    get_position_embedding_sine,
    random_pos_start,
    slice_or_interpolate_pos_embed,
)
from exoground_tpu_torch.utils.device import resolve_device


class ExoGroundingTransformer(nn.Module):
    def __init__(self, num_encoder_layers: int = 2, num_decoder_layers: int = 2,
                 use_decoder: bool = True, sim: str = "cos", pos_enc: str = "learned",
                 use_text_pos_enc: int = 0, random_pos_start: int = 1,
                 use_audio: bool = False, video_embed_dim: int = 4096,
                 text_embed_dim: int = 4096, audio_embed_dim: int = 2304,
                 feature_dim: int = 512, use_distill_nce_loss: bool = False,
                 multi_view: bool = False, num_max_views: int = 1,
                 use_pairwise_distill_nce_loss: bool = False,
                 pairwise_distill_mode: str = "all", heads: int = 8, max_pos: int = 1024,
                 attn_impl: Optional[str] = None, device="cuda"):
        super().__init__()
        check_impl(attn_impl)
        self.use_decoder = use_decoder
        self.sim = sim
        self.use_text_pos_enc = use_text_pos_enc
        self.random_pos_start = random_pos_start
        self.use_distill_nce_loss = use_distill_nce_loss
        self.multi_view = multi_view
        self.num_max_views = num_max_views
        self.use_pairwise_distill_nce_loss = use_pairwise_distill_nce_loss
        self.pairwise_distill_mode = pairwise_distill_mode
        self.attn_impl = attn_impl
        w = feature_dim
        self.multi_modal_encoder = TemporalEncoder(w, num_encoder_layers, heads)
        if use_decoder:
            self.decoder = TemporalDecoder(w, num_decoder_layers, heads)
        self.video_unimodal_encoder = TemporalEncoder(w, num_encoder_layers, heads)
        self.text_unimodal_encoder = TemporalEncoder(w, num_encoder_layers, heads)
        self.grounding_head = nn.Linear(w, 2)
        self.video_pre_proj = nn.Linear(video_embed_dim, w, bias=False)
        self.text_pre_proj = nn.Linear(text_embed_dim, w, bias=False)
        self.ln_text_init = nn.LayerNorm(w, eps=LN_EPS)
        self.ln_video_init = nn.LayerNorm(w, eps=LN_EPS)
        self.ln_position_init = nn.LayerNorm(w, eps=LN_EPS)
        self.ln_joint_post_enc = nn.LayerNorm(w, eps=LN_EPS)
        self.ln_video_post_enc = nn.LayerNorm(w, eps=LN_EPS)
        self.ln_text_post_enc = nn.LayerNorm(w, eps=LN_EPS)
        self.mlp = nn.Linear(w, w)  # in the reference's state dict; unused
        if use_distill_nce_loss or use_pairwise_distill_nce_loss:
            self.exo_feature_proj = nn.Linear(w, video_embed_dim)
        if use_audio:
            self.ln_audio_init = nn.LayerNorm(w, eps=LN_EPS)
            self.audio_pre_proj = nn.Linear(audio_embed_dim, w, bias=False)
        if pos_enc == "learned":
            self.temporal_pos_embed = nn.Parameter(torch.randn(max_pos, w) * 0.01)
        else:
            self.register_buffer("temporal_pos_embed", get_position_embedding_sine(w, max_pos))
        # the reference sizes the text table by the text width (exo_ground_model.py:98)
        self.text_temporal_pos_embed = nn.Parameter(torch.randn(text_embed_dim, w) * 0.01)
        self.to(resolve_device(device))

    # ------------------------------------------------------------------

    def pos_start_lengths(self, t: int, n: int, audio: bool = False, interpolate_from=None,
                          deterministic: bool = False) -> tuple:
        """The sequence lengths of the random pos starts a forward over T
        video steps and N narrations draws, in draw order: the text's (with
        text pos-enc), the video's, the audio's (none when it draws none)."""
        if deterministic or interpolate_from is not None or not self.random_pos_start:
            return ()
        tv = t // self.num_max_views
        return (((n,) if self.use_text_pos_enc else ()) + (tv,)
                + ((tv,) if audio else ()))

    def draw_pos_starts(self, generator: Optional[torch.Generator], t: int, n: int,
                        audio: bool = False) -> torch.Tensor:
        """The (k,) int64 CPU tensor of the starts a training forward draws
        from ``generator``, in its order."""
        return torch.tensor([random_pos_start(generator, s)
                             for s in self.pos_start_lengths(t, n, audio)], dtype=torch.int64)

    def _starts(self, lens: tuple, generator, pos_starts) -> list:
        """One start a length of ``lens``: the entries of ``pos_starts`` (0-d
        tensors) or, without it, draws from ``generator``."""
        if pos_starts is None:
            return [random_pos_start(generator, s) for s in lens]
        if tuple(pos_starts.shape) != (len(lens),):
            raise ValueError(f"pos_starts {tuple(pos_starts.shape)}: this forward draws "
                             f"{len(lens)} starts")
        return list(pos_starts.unbind(0))

    def _pos_with(self, table, n, interpolate_from, deterministic, start=None, views=1):
        """ln_position_init of the (n // views)-row pos slice tiled per view
        (grounding.py:127-137, :142-151), from ``start`` when training."""
        seq_len = n // views
        if interpolate_from is not None or not self.random_pos_start or deterministic:
            start = 0
        pos = slice_or_interpolate_pos_embed(table, seq_len, interpolate_from, start)
        return self.ln_position_init(pos.repeat(views, 1))[None]

    def get_textual_feature(self, lang_embed):
        return self.ln_text_init(quant.linear(lang_embed, self.text_pre_proj.weight))

    def get_textual_feature_with_time(self, lang_embed, interpolate_from=None,
                                      deterministic=True, pos_start=None):
        x = self.get_textual_feature(lang_embed)
        return x + self._pos_with(self.text_temporal_pos_embed, x.shape[1], interpolate_from,
                                  deterministic, pos_start).to(x.dtype)

    def get_audio_feature(self, audio_embed):
        return self.ln_audio_init(quant.linear(audio_embed, self.audio_pre_proj.weight))

    def get_unimodal_features(self, mode, feat_embed, padding_mask, interpolate_from=None,
                              deterministic=True, pos_start=None):
        """Uni-modal encoder pass -> (B, Stage, X, C) (grounding.py:156-172):
        the video is projected, normed and given the tiled pos-emb here; the
        text arrives projected."""
        if mode == "video":
            x = self.ln_video_init(quant.linear(feat_embed, self.video_pre_proj.weight))
            x = x + self._pos_with(self.temporal_pos_embed, x.shape[1], interpolate_from,
                                   deterministic, pos_start, self.num_max_views).to(x.dtype)
            stages = self.video_unimodal_encoder(x, padding_mask, impl=self.attn_impl)
            return post_ln_last(stages, self.ln_video_post_enc)
        stages = self.text_unimodal_encoder(feat_embed, padding_mask, impl=self.attn_impl)
        return post_ln_last(stages, self.ln_text_post_enc)

    def get_joint_feature(self, video_feats, video_padding_mask, text_feats, lang_padding_mask,
                          audio_feats=None, audio_padding_mask=None, interpolate_from=None,
                          deterministic=True, pos_start=None):
        """Joint encoder over [video (, audio), text] (grounding.py:174-202);
        only the audio receives a pos-emb here."""
        parts, masks = [video_feats], [video_padding_mask]
        if audio_feats is not None:
            parts.append(audio_feats + self._pos_with(
                self.temporal_pos_embed, video_feats.shape[1], interpolate_from, deterministic,
                pos_start, self.num_max_views).to(audio_feats.dtype))
            masks.append(audio_padding_mask)
        stages = self.multi_modal_encoder(torch.cat(parts + [text_feats], dim=1),
                                          torch.cat(masks + [lang_padding_mask], dim=1),
                                          impl=self.attn_impl)
        return post_ln_last(stages, self.ln_joint_post_enc)

    def forward(self, video_embed, lang_embed, video_padding_mask, lang_padding_mask,
                audio_embed=None, audio_padding_mask=None, egocentric_video_embed=None,
                view_mask=None, interpolate_from=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                pos_starts: Optional[torch.Tensor] = None):
        """{'low_dim_features' (B, T, C), 'interval_preds' (B, N, 2), or (B,
        Stage, N, 2) without the decoder[, 'high_dim_features']}
        (grounding.py:206-266). A training forward's pos starts come from
        ``pos_starts`` (``draw_pos_starts``'s tensor) or else from
        ``generator``."""
        n = lang_embed.shape[1]
        # the trunk's own starts (a subclass's override adds its pre-pass's)
        lens = ExoGroundingTransformer.pos_start_lengths(
            self, video_embed.shape[1], n, audio_embed is not None, interpolate_from,
            deterministic)
        starts = self._starts(lens, generator, pos_starts)
        text_start = starts.pop(0) if lens and self.use_text_pos_enc else None
        video_start = starts.pop(0) if starts else None
        audio_start = starts.pop(0) if starts else None
        lang_raw = self.get_textual_feature(lang_embed)
        if self.use_text_pos_enc:
            lang_with_time = self.get_textual_feature_with_time(
                lang_embed, interpolate_from, deterministic, text_start)
        else:
            lang_with_time = lang_raw
        audio_feats = self.get_audio_feature(audio_embed) if audio_embed is not None else None
        video_feats = self.get_unimodal_features(
            "video", video_embed, video_padding_mask, interpolate_from, deterministic,
            video_start).mean(dim=1)
        text_feats = self.get_unimodal_features(
            "text", lang_with_time, lang_padding_mask, interpolate_from,
            deterministic).mean(dim=1)

        out = {"low_dim_features": video_feats}
        if ((self.use_distill_nce_loss and egocentric_video_embed is not None)
                or (self.multi_view and self.use_pairwise_distill_nce_loss)):
            out["high_dim_features"] = self.exo_feature_proj(video_feats)

        all_stages = self.get_joint_feature(
            video_feats, video_padding_mask, text_feats, lang_padding_mask, audio_feats,
            audio_padding_mask, interpolate_from, deterministic, audio_start)
        if self.use_decoder:
            memory_mask = video_padding_mask
            if audio_feats is not None:
                memory_mask = torch.cat([video_padding_mask, audio_padding_mask], dim=1)
            dec_stages = self.decoder(all_stages[:, -1, -n:], all_stages[:, -1, :-n],
                                      tgt_key_padding_mask=lang_padding_mask,
                                      memory_key_padding_mask=memory_mask,
                                      impl=self.attn_impl)
            out["interval_preds"] = self.grounding_head(dec_stages[:, -1])
        else:
            out["interval_preds"] = self.grounding_head(all_stages[:, :, -n:])
        return out


class GroundingModel(ExoGroundingTransformer):
    """The grounding trunk behind a frozen view-invariant pre-pass, run
    under ``torch.no_grad()`` as the reference runs it (keystep_ground_model.
    py:158-169; the JAX model's stop_gradient); its high-dim output replaces
    the video features. The distillation InfoNCE is computed in forward under
    ``use_distill_nce_loss`` (with an egocentric target) or, multi-view,
    ``use_pairwise_distill_nce_loss`` (grounding.py:382-400)."""

    def __init__(self, vi_encoder_type: str = "mlp", num_encoder_layers: int = 2,
                 num_decoder_layers: int = 2, use_decoder: bool = True,
                 pos_enc: str = "learned", use_text_pos_enc: int = 0,
                 random_pos_start: int = 1, use_audio: bool = False,
                 video_embed_dim: int = 4096, text_embed_dim: int = 4096,
                 audio_embed_dim: int = 2304, feature_dim: int = 512,
                 use_distill_nce_loss: bool = False, multi_view: bool = False,
                 num_max_views: int = 1, use_pairwise_distill_nce_loss: bool = False,
                 pairwise_distill_mode: str = "all", attn_impl: Optional[str] = None,
                 device="cuda"):
        super().__init__(
            num_encoder_layers=num_encoder_layers, num_decoder_layers=num_decoder_layers,
            use_decoder=use_decoder, pos_enc=pos_enc, use_text_pos_enc=use_text_pos_enc,
            random_pos_start=random_pos_start, use_audio=use_audio,
            video_embed_dim=video_embed_dim, text_embed_dim=text_embed_dim,
            audio_embed_dim=audio_embed_dim, feature_dim=feature_dim,
            use_distill_nce_loss=use_distill_nce_loss, multi_view=multi_view,
            num_max_views=num_max_views,
            use_pairwise_distill_nce_loss=use_pairwise_distill_nce_loss,
            pairwise_distill_mode=pairwise_distill_mode, attn_impl=attn_impl, device="cpu")
        if vi_encoder_type == "mlp":
            self.vi_encoder = ViewInvariantMLP(video_embed_dim, device="cpu")
        elif vi_encoder_type == "transformer":
            # the trunk's pos-enc flavour, random start and view tiling, as
            # the JAX model forwards them (grounding.py:327-347)
            self.vi_encoder = ViewInvariantEncoder(
                num_encoder_layers=num_encoder_layers, pos_enc=pos_enc,
                random_pos_start=random_pos_start, video_embed_dim=video_embed_dim,
                feature_dim=feature_dim, use_distill_nce_loss=True,
                num_max_views=num_max_views, attn_impl=attn_impl, device="cpu")
        elif vi_encoder_type == "none":
            self.vi_encoder = None
        else:
            raise ValueError(f"vi_encoder_type {vi_encoder_type!r} is not one of "
                             "('mlp', 'transformer', 'none')")
        self.to(resolve_device(device))

    def _vi_lengths(self, t: int, interpolate_from=None, deterministic: bool = False) -> tuple:
        if isinstance(self.vi_encoder, ViewInvariantEncoder):
            return self.vi_encoder.pos_start_lengths(t, interpolate_from, deterministic)
        return ()

    def pos_start_lengths(self, t: int, n: int, audio: bool = False, interpolate_from=None,
                          deterministic: bool = False) -> tuple:
        """The VI encoder's starts (the transformer's), then the trunk's."""
        return (self._vi_lengths(t, interpolate_from, deterministic)
                + super().pos_start_lengths(t, n, audio, interpolate_from, deterministic))

    def forward(self, video_embed, lang_embed, video_padding_mask, lang_padding_mask,
                audio_embed=None, audio_padding_mask=None, egocentric_video_embed=None,
                view_mask=None, interpolate_from=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                pos_starts: Optional[torch.Tensor] = None):
        video = video_embed
        k = len(self._vi_lengths(video_embed.shape[1], interpolate_from, deterministic))
        vi_starts = None if pos_starts is None else pos_starts[:k]
        if pos_starts is not None:
            pos_starts = pos_starts[k:]
        if self.vi_encoder is not None:
            with torch.no_grad():
                video = self.vi_encoder(
                    video_embed, lang_embed, video_padding_mask, lang_padding_mask,
                    egocentric_video_embed=egocentric_video_embed,
                    deterministic=deterministic, generator=generator,
                    pos_starts=vi_starts)["high_dim_features"]
        out = super().forward(video, lang_embed, video_padding_mask, lang_padding_mask,
                              audio_embed, audio_padding_mask, egocentric_video_embed,
                              view_mask, interpolate_from, deterministic, generator,
                              pos_starts)
        if self.use_distill_nce_loss and egocentric_video_embed is not None:
            out["distill_infonce_loss"] = info_nce_diag(out["high_dim_features"],
                                                        egocentric_video_embed)
        elif self.multi_view and self.use_pairwise_distill_nce_loss:
            vm = view_mask
            if self.pairwise_distill_mode != "all":
                # 'unmasked': view v exists iff any of its Tv slots is real
                b = video_padding_mask.shape[0]
                vm = (~video_padding_mask).reshape(b, self.num_max_views, -1).any(dim=-1)
            out["distill_infonce_loss"] = pairwise_view_info_nce(
                out["high_dim_features"], vm, self.num_max_views)
        return out
