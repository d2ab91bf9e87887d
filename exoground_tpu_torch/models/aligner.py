"""TemporalAligner — the TAN dual + joint encoder model.

Counterpart of ``exoground_tpu/models/aligner.py`` (reference
model/tan_model.py:13-306) as an ``nn.Module`` in (B, T, C) layout: a
video-only "dual" encoder and a video+text "joint" encoder, 4096->width
pre-projections (``video_dim`` / ``text_dim`` set the two input widths apart,
each defaulting to ``input_dim``), a learned or sine temporal pos-embedding with optional
random start (drawn from a ``torch.Generator``) and linear interpolation for
longer sequences, optional text pos-embedding, and an optional binary
alignability head.

Attribute names follow the reference's state dict, so a reference
checkpoint (and ``tests/golden_common.py::synth_state`` of a golden
manifest) loads with ``load_state_dict(strict=True)``. That includes the
reference's ``mlp`` Linear(width, width), which its forward never uses.

``attn_impl`` (None or 'auto', 'xla', 'flash' or 'fused') and ``mlp_impl``
(None or 'auto', 'xla' or 'fused') reach every encoder block of both towers,
as the JAX model's fields of the same names: under 'auto' a long sequence on
the card (sq * sk >= 2048^2, the global mode) takes the flash kernel; with
``attn_impl="fused", mlp_impl="fused"`` every block whose window the
fused-MHA test admits runs the whole-block path (two kernel launches a
layer, ``ops/blocks.py``).

The two pre-projections go through ``quant.linear`` (exactly ``F.linear``
outside ``quant.matmul_impl('int8')``), as the JAX model's Dense hooks.

A training forward draws its random pos starts on the host, in the order
video (dual), text (with ``use_text_pos_enc``), video (joint).
``draw_pos_starts`` makes the same draws up front; the train step passes
them back as ``pos_starts``, a small integer tensor on the device, and the
model selects the pos rows on the device (``ops/pos_embed.py::pos_rows``),
so the step can be captured in a CUDA graph and replayed with new starts.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from exoground_tpu_torch.ops import quant
from exoground_tpu_torch.ops.attention import check_impl
from exoground_tpu_torch.ops.blocks import LN_EPS, TemporalEncoder, post_ln_last
from exoground_tpu_torch.ops.fused_mlp import MLP_IMPLS
from exoground_tpu_torch.ops.pos_embed import (
    get_position_embedding_sine,
    random_pos_start,
    slice_or_interpolate_pos_embed,
)
from exoground_tpu_torch.utils.device import resolve_device


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    # eps guards all-pad rows (exactly-zero embeddings) from 0/0 -> NaN
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


class TemporalAligner(nn.Module):
    def __init__(
        self,
        num_encoder_layers: int = 6,
        num_joint_layers: int = 6,
        pos_enc: str = "learned",
        use_text_pos_enc: int = 0,
        return_dual_feature: int = 1,
        random_pos_start: int = 1,
        use_alignability_head: int = 0,
        width: int = 512,
        heads: int = 8,
        input_dim: int = 4096,
        max_pos: int = 4096,
        video_dim: Optional[int] = None,
        text_dim: Optional[int] = None,
        attn_impl: Optional[str] = None,
        mlp_impl: Optional[str] = None,
        device="cuda",
    ):
        super().__init__()
        check_impl(attn_impl)
        if mlp_impl is not None and mlp_impl not in MLP_IMPLS:
            raise ValueError(f"mlp_impl {mlp_impl!r} is not one of {MLP_IMPLS}")
        self.attn_impl = attn_impl
        self.mlp_impl = mlp_impl
        self.num_encoder_layers = num_encoder_layers
        self.pos_enc = pos_enc
        self.use_text_pos_enc = use_text_pos_enc
        self.return_dual_feature = return_dual_feature
        self.random_pos_start = random_pos_start
        self.use_alignability_head = use_alignability_head
        w = width
        self.video_temporal_encoder = TemporalEncoder(w, num_encoder_layers, heads)
        self.joint_temporal_encoder = TemporalEncoder(w, num_joint_layers, heads)
        # the JAX Dense layers take each input's width from the input itself
        self.video_pre_proj = nn.Linear(video_dim or input_dim, w, bias=False)
        self.text_pre_proj = nn.Linear(text_dim or input_dim, w, bias=False)
        self.ln_text_init = nn.LayerNorm(w, eps=LN_EPS)
        self.ln_video_init = nn.LayerNorm(w, eps=LN_EPS)
        self.ln_position_init = nn.LayerNorm(w, eps=LN_EPS)
        self.ln_video_post_enc = nn.LayerNorm(w, eps=LN_EPS)
        self.ln_joint_post_enc = nn.LayerNorm(w, eps=LN_EPS)
        self.mlp = nn.Linear(w, w)  # in the reference's state dict; unused
        if pos_enc == "learned":
            self.temporal_pos_embed = nn.Parameter(torch.randn(max_pos, w) * 0.01)
        else:
            self.register_buffer("temporal_pos_embed",
                                 get_position_embedding_sine(w, max_pos))
        self.text_temporal_pos_embed = nn.Parameter(torch.randn(max_pos, w) * 0.01)
        if use_alignability_head:
            self.binary_head = nn.Linear(w, 1)
        self.to(resolve_device(device))

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def pos_start_lengths(self, t: int, n: int, interpolate_from=None,
                          deterministic: bool = False) -> tuple:
        """The sequence lengths of the random pos starts a forward over T
        frames and N texts draws, in draw order (none when it draws none)."""
        if deterministic or interpolate_from is not None or not self.random_pos_start:
            return ()
        return (t, n, t) if self.use_text_pos_enc else (t, t)

    def draw_pos_starts(self, generator: Optional[torch.Generator], t: int, n: int
                        ) -> torch.Tensor:
        """The (k,) int64 CPU tensor of the starts a training forward over T
        frames and N texts draws from ``generator``, in its order."""
        return torch.tensor([random_pos_start(generator, s)
                             for s in self.pos_start_lengths(t, n)], dtype=torch.int64)

    def _pos_slice(self, table, seq_len, interpolate_from, deterministic,
                   true_len=None, generator=None, start=None):
        if interpolate_from is None and self.random_pos_start and not deterministic:
            if start is None:
                start = random_pos_start(generator, seq_len)
        else:
            start = 0
        return slice_or_interpolate_pos_embed(
            table, seq_len, interpolate_from, start, true_len=true_len
        )

    def _video_with_time(self, video_embed, interpolate_from, deterministic,
                         pos_interp_len=None, preprojected=False, generator=None,
                         pos_start=None):
        x = video_embed if preprojected else self.preproject_video(video_embed)
        pos = self._pos_slice(self.temporal_pos_embed, x.shape[1], interpolate_from,
                              deterministic, pos_interp_len, generator, pos_start)
        return x + self.ln_position_init(pos.to(x.dtype))[None]

    def preproject_video(self, video_embed):
        """Position-independent half of the video input stage:
        ``ln_video_init(video_pre_proj(x))``."""
        return self.ln_video_init(quant.linear(video_embed, self.video_pre_proj.weight))

    def preproject_text(self, lang_embed):
        """Position-independent text input stage (== get_textual_feature)."""
        return self.get_textual_feature(lang_embed)

    # ------------------------------------------------------------------
    # feature extractors (reference tan_model.py:146-228)
    # ------------------------------------------------------------------

    def get_visual_feature(self, video_embed, video_padding_mask, interpolate_from=None,
                           deterministic=True, pos_interp_len=None, preprojected=False,
                           generator=None, pos_start=None):
        """Dual-encoder video tower -> per-stage features (B, Stage, T, C).
        A training pass draws its pos start from ``generator`` unless
        ``pos_start`` (a 0-d integer tensor) gives it."""
        x = self._video_with_time(video_embed, interpolate_from, deterministic,
                                  pos_interp_len, preprojected, generator, pos_start)
        if self.num_encoder_layers == 0:
            return x[:, None]
        stages = self.video_temporal_encoder(x, video_padding_mask, impl=self.attn_impl,
                                             mlp_impl=self.mlp_impl)
        return post_ln_last(stages, self.ln_video_post_enc)

    def get_textual_feature(self, lang_embed):
        return self.ln_text_init(quant.linear(lang_embed, self.text_pre_proj.weight))

    def get_textual_feature_with_time(self, lang_embed, interpolate_from=None,
                                      deterministic=True, preprojected=False,
                                      generator=None, pos_start=None):
        """Text features + temporal pos-emb (tan_model.py:206-222)."""
        x = lang_embed if preprojected else self.get_textual_feature(lang_embed)
        pos = self._pos_slice(self.text_temporal_pos_embed, x.shape[1],
                              interpolate_from, deterministic, generator=generator,
                              start=pos_start)
        return x + self.ln_position_init(pos.to(x.dtype))[None]

    def get_joint_feature(self, video_embed, video_padding_mask, lang_embed_with_time,
                          lang_padding_mask, interpolate_from=None, deterministic=True,
                          pos_interp_len=None, preprojected=False, generator=None,
                          pos_start=None):
        """Joint encoder over [video, text]; returns (video, text) stage stacks.
        Like the reference (tan_model.py:181-192) the joint pass draws its
        own random pos start."""
        x = self._video_with_time(video_embed, interpolate_from, deterministic,
                                  pos_interp_len, preprojected, generator, pos_start)
        t = x.shape[1]
        joint = torch.cat([x, lang_embed_with_time], dim=1)
        joint_mask = torch.cat([video_padding_mask, lang_padding_mask], dim=1)
        stages = self.joint_temporal_encoder(joint, joint_mask, impl=self.attn_impl,
                                             mlp_impl=self.mlp_impl)
        stages = post_ln_last(stages, self.ln_joint_post_enc)
        return stages[:, :, :t], stages[:, :, t:]

    # ------------------------------------------------------------------
    # training-shaped forward (tan_model.py:94-143)
    # ------------------------------------------------------------------

    def forward(self, video_embed, lang_embed, video_padding_mask, lang_padding_mask,
                text_timestamp=None, interpolate_from: Optional[int] = None,
                deterministic: bool = True, return_sim_volumes: bool = True,
                generator: Optional[torch.Generator] = None,
                pos_starts: Optional[torch.Tensor] = None):
        """Similarity volumes logits_dual / logits_joint (B, S, T, B, N) and
        the normalized features; ``return_sim_volumes=False`` returns only the
        features. When ``deterministic=False`` the random pos starts come
        from ``pos_starts`` (``draw_pos_starts``'s (k,) tensor, on the
        device) or else are drawn from ``generator``."""
        lens = self.pos_start_lengths(video_embed.shape[1], lang_embed.shape[1],
                                      interpolate_from, deterministic)
        starts = [None, None, None]  # video (dual), text, video (joint)
        if pos_starts is not None and lens:
            if tuple(pos_starts.shape) != (len(lens),):
                raise ValueError(f"pos_starts {tuple(pos_starts.shape)}: this forward "
                                 f"draws {len(lens)} starts")
            drawn = list(pos_starts.unbind(0))
            starts = drawn if len(drawn) == 3 else [drawn[0], None, drawn[1]]
        video_out = self.get_visual_feature(video_embed, video_padding_mask,
                                            interpolate_from, deterministic,
                                            generator=generator, pos_start=starts[0])
        lang_raw = self.get_textual_feature(lang_embed)
        video_n = _l2norm(video_out)
        text_n = _l2norm(lang_raw)
        if self.use_text_pos_enc:
            lang_with_time = self.get_textual_feature_with_time(
                lang_embed, interpolate_from, deterministic, generator=generator,
                pos_start=starts[1])
        else:
            lang_with_time = lang_raw
        joint_video, joint_text = self.get_joint_feature(
            video_embed, video_padding_mask, lang_with_time, lang_padding_mask,
            interpolate_from, deterministic, generator=generator, pos_start=starts[2])
        video_nj = _l2norm(joint_video)
        text_nj = _l2norm(joint_text)

        out = {}
        if return_sim_volumes:
            out["logits_dual"] = torch.einsum("astc,bkc->astbk", video_n, text_n)
            out["logits_joint"] = torch.einsum("astc,bskc->astbk", video_nj, text_nj)
        if self.return_dual_feature or not return_sim_volumes:
            out["dual_feature_video"] = video_n
            out["dual_feature_text"] = text_n
            out["joint_feature_video"] = video_nj
            out["joint_feature_text"] = text_nj
        if self.use_alignability_head:
            out["dual_logits_alignability"] = self.binary_head(lang_raw)
            out["joint_logits_alignability"] = self.binary_head(joint_text)
        return out

    # ------------------------------------------------------------------
    # HTM-Align inference entry point (tan_model.py:231-306)
    # ------------------------------------------------------------------

    def text_visual_sim(self, video_embed, lang_embed, interpolate_from=None,
                        video_padding_mask=None, lang_padding_mask=None,
                        pos_interp_len=None, preprojected=False):
        """Per-window similarity dict used by the overlap-seq/global stitchers:
        {'sim': (B,S,T,K) joint, 'dual-sim': (B,S,T,K) dual
         [, 'alignability-dual' (B,K,1), 'alignability-joint' (B,S,K,1)]}.

        ``interpolate_from`` may be an int (video only) or a (video, text)
        tuple; ``pos_interp_len`` is the real video length when the video
        axis is a padded bucket. The padding masks key-pad tail frames and
        inactive texts, so batched windows equal per-window calls."""
        if isinstance(interpolate_from, (tuple, list)):
            video_if, text_if = interpolate_from
        else:
            video_if, text_if = interpolate_from, None
        b, t = video_embed.shape[:2]
        n = lang_embed.shape[1]
        dev = video_embed.device
        vmask = (torch.zeros((b, t), dtype=torch.bool, device=dev)
                 if video_padding_mask is None else video_padding_mask)
        lmask = (torch.zeros((b, n), dtype=torch.bool, device=dev)
                 if lang_padding_mask is None else lang_padding_mask)

        if self.use_text_pos_enc:
            lang_with_time = self.get_textual_feature_with_time(
                lang_embed, text_if, preprojected=preprojected)
        elif preprojected:
            lang_with_time = lang_embed
        else:
            lang_with_time = self.get_textual_feature(lang_embed)

        joint_video, joint_text = self.get_joint_feature(
            video_embed, vmask, lang_with_time, lmask, video_if,
            pos_interp_len=pos_interp_len, preprojected=preprojected)
        sim_joint = torch.einsum("bstc,bskc->bstk", _l2norm(joint_video),
                                 _l2norm(joint_text))

        video_out = self.get_visual_feature(video_embed, vmask, video_if,
                                            pos_interp_len=pos_interp_len,
                                            preprojected=preprojected)
        lang_raw = lang_embed if preprojected else self.get_textual_feature(lang_embed)
        sim_dual = torch.einsum("bstc,bkc->bstk", _l2norm(video_out), _l2norm(lang_raw))

        out = {"sim": sim_joint, "dual-sim": sim_dual}
        if self.use_alignability_head:
            out["alignability-dual"] = self.binary_head(lang_raw)
            out["alignability-joint"] = self.binary_head(joint_text)
        return out
