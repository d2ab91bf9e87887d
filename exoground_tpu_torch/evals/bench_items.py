"""Shared synthetic HTM-Align-like items for benchmarking.

A copy of ``exoground_tpu/evals/bench_items.py`` (the port imports nothing
of the JAX package): the same seeds give the same items, so the port's
``chip_smoke.py`` and tests run the JAX package's bench protocol: same video
lengths, text counts, aligned/non-aligned split and GT spans. The reference
model's projections expect 4096-d inputs (reference model/tan_model.py:42-43).
"""

import numpy as np

# HTM-Align's real set is 80 videos of mean ~370 s; 8 x ~600 s gives a stable
# per-chip measurement without multi-minute bench runs
BENCH_VLENS = [520, 640, 580, 700, 610, 560, 660, 590]
# global mode over long videos. These lengths are chosen to cross the 'auto'
# gate (every padded length, a multiple of 128, is >= 2048, so both towers
# take the flash kernel on the card), not taken from user traffic: at a mean
# of ~370 s most HTM-Align videos stay below it, and the share at or above
# 2048 frames is not known here (PERF.md section 4)
GLOBAL_VLENS = [2048, 2400, 3000]
# the JAX bench's int8 serving row (bench.py:458-464, :640-643) as
# AlignEvalConfig fields: at width 512, int8_min_cols 1024 quantizes the
# fused qkv (N = 1536) and c_fc (N = 2048) products and keeps the rest exact
INT8_SERVING = dict(compute_dtype="bfloat16", transfer_dtype="float16", matmul_dtype="int8",
                    int8_min_cols=1024)


def make_item(seed, vlen, video_dim=1024, text_dim=512):
    r = np.random.RandomState(seed)
    num_text = max(8, int(vlen / 12))
    aligned = (r.rand(num_text) > 0.5).astype(np.int64)
    aligned[0], aligned[1] = 1, 0
    centers = np.sort(r.rand(num_text)) * (vlen - 10) + 5
    start = np.maximum(centers - r.randint(2, 8, num_text), 0.0)
    end = np.minimum(centers + r.randint(2, 8, num_text), vlen)
    return {
        "video": r.randn(vlen, video_dim).astype(np.float32),
        "start": start,
        "end": end,
        "aligned": aligned,
        "text_embed": r.randn(num_text, text_dim).astype(np.float32),
        "vid": f"bench{seed}",
    }


def make_bench_items(video_dim=1024, text_dim=512, vlens=None):
    vlens = BENCH_VLENS if vlens is None else vlens
    return [
        make_item(s, vlen, video_dim=video_dim, text_dim=text_dim)
        for s, vlen in enumerate(vlens)
    ]


def make_global_items(video_dim=4096, text_dim=4096, vlens=None):
    """Long HTM-Align-like items for the global mode (``make_item`` at
    ``GLOBAL_VLENS``, seeds 100, 101, ...)."""
    vlens = GLOBAL_VLENS if vlens is None else vlens
    return [
        make_item(100 + s, vlen, video_dim=video_dim, text_dim=text_dim)
        for s, vlen in enumerate(vlens)
    ]


def make_global_bench_inputs(seed=0):
    """The JAX package's global-mode bench inputs (bench.py:1133-1135): one
    (1, 2048, 4096) video and (1, 48, 4096) texts, float32, no padding; the
    bench calls ``text_visual_sim(video, text, interpolate_from=max_pos)``."""
    rng = np.random.RandomState(seed)
    video = rng.randn(1, 2048, 4096).astype(np.float32)
    text = rng.randn(1, 48, 4096).astype(np.float32)
    return {"video": video, "text": text}


class _Draw:
    """Seeded numpy draws at the JAX models' init scales (the CLIP-style
    stds of ``_init_scales``, blocks.py:127-132), in the JAX param layout:
    Dense kernels (in, out), in_proj_kernel (C, 3C), LayerNorm
    scale/bias."""

    def __init__(self, seed, width, layers):
        self.rng, self.w = np.random.RandomState(seed), width
        self.attn_std = width ** -0.5
        self.proj_std = width ** -0.5 * (2 * layers) ** -0.5
        self.fc_std = (2 * width) ** -0.5

    def n(self, *shape, std):
        return (self.rng.standard_normal(shape) * std).astype(np.float32)

    def ln(self):
        return {"scale": 1.0 + self.n(self.w, std=0.05), "bias": self.n(self.w, std=0.02)}

    def attn(self):
        w = self.w
        return {"in_proj_kernel": self.n(w, 3 * w, std=self.attn_std),
                "in_proj_bias": self.n(3 * w, std=0.02),
                "out_proj_kernel": self.n(w, w, std=self.proj_std),
                "out_proj_bias": self.n(w, std=0.02)}

    def mlp(self):
        w = self.w
        return {"c_fc": {"kernel": self.n(w, 4 * w, std=self.fc_std),
                         "bias": self.n(4 * w, std=0.02)},
                "c_proj": {"kernel": self.n(4 * w, w, std=self.proj_std),
                           "bias": self.n(w, std=0.02)}}

    def stack(self, layers, decoder=False):
        """A TemporalEncoder's blocks, or a TemporalDecoder's (a self-
        attention and a third LayerNorm each)."""
        out = {}
        for i in range(layers):
            blk = {"attn": self.attn(), "ln_1": self.ln(), "ln_2": self.ln(), "mlp": self.mlp()}
            if decoder:
                blk.update(self_attn=self.attn(), ln_3=self.ln())
            out[f"resblocks_{i}"] = blk
        return out


def make_bench_params(seed, layers=6, width=512, input_dim=4096, max_pos=4096,
                      binary_head=False):
    """Seeded random weights for a TemporalAligner (E6D6, width 512, 4096-d
    inputs by default) as a param tree in the JAX package's layout (Dense
    kernels (in, out), in_proj_kernel (C, 3C), LayerNorm scale/bias), drawn
    with numpy at the model's init scales; ``utils/convert.py::
    load_tan_params`` loads it into the port's model. ``binary_head`` adds
    the alignability head (drawn last, so the other weights stay the same)."""
    d = _Draw(seed, width, layers)
    n, ln, w = d.n, d.ln, width

    tree = {
        "video_temporal_encoder": d.stack(layers), "joint_temporal_encoder": d.stack(layers),
        "video_pre_proj": {"kernel": n(input_dim, w, std=0.01)},
        "text_pre_proj": {"kernel": n(input_dim, w, std=0.01)},
        "ln_text_init": ln(), "ln_video_init": ln(), "ln_position_init": ln(),
        "ln_video_post_enc": ln(), "ln_joint_post_enc": ln(),
        "temporal_pos_embed": n(max_pos, w, std=0.01),
        "text_temporal_pos_embed": n(max_pos, w, std=0.01),
    }
    if binary_head:
        tree["binary_head"] = {"kernel": n(w, 1, std=0.01), "bias": np.zeros(1, np.float32)}
    return {"params": tree}


def make_train_batch(b, t=64, n=12, seed=0, video_dim=4096, text_dim=4096):
    """The JAX package's train-bench batch (bench.py:933-945) as numpy:
    (B, T, 4096) video and (B, N, 4096) text features, no padding, 6-second
    text spans starting in [0, T-8), and their normalized positions."""
    rng = np.random.RandomState(seed)
    video = rng.randn(b, t, video_dim).astype(np.float32)
    text = rng.randn(b, n, text_dim).astype(np.float32)
    start = rng.randint(0, t - 8, (b, n)).astype(np.float32)
    end = start + 6.0
    return {
        "video": video, "text": text,
        "video_padding_mask": np.zeros((b, t), bool),
        "text_padding_mask": np.zeros((b, n), bool),
        "start": start, "end": end,
        "abs_text_pos": np.stack([start / t, end / t], axis=-1),
    }


# the configuration scripts/train_grounding.sh trains (--model grounding
# --views all; exoground_tpu/train/main.py:136-155 with the ExperimentConfig
# defaults): GroundingModel(vi_encoder_type="mlp") over the trunk E6D6,
# width 512, 8 heads, 4096-d video and text, single view, learned
# positions, the decoder, (center, duration) outputs
GROUNDING = dict(vi_encoder_type="mlp", num_encoder_layers=6, num_decoder_layers=6,
                 feature_dim=512, video_embed_dim=4096, text_embed_dim=4096)


def make_grounding_params(seed, layers=6, width=512, input_dim=4096, max_pos=1024):
    """Seeded random weights for ``GroundingModel(**GROUNDING)`` (the repo
    has no grounding checkpoint) in the JAX package's layout, {'trunk',
    'vi_encoder'}; ``utils/convert.py::load_grounding_params`` loads it."""
    d = _Draw(seed, width, layers)
    n, ln = d.n, d.ln
    trunk = {
        "multi_modal_encoder": d.stack(layers), "video_unimodal_encoder": d.stack(layers),
        "text_unimodal_encoder": d.stack(layers), "decoder": d.stack(layers, decoder=True),
        "grounding_head": {"kernel": n(width, 2, std=0.01), "bias": n(2, std=0.02)},
        "video_pre_proj": {"kernel": n(input_dim, width, std=0.01)},
        "text_pre_proj": {"kernel": n(input_dim, width, std=0.01)},
        "ln_text_init": ln(), "ln_video_init": ln(), "ln_position_init": ln(),
        "ln_joint_post_enc": ln(), "ln_video_post_enc": ln(), "ln_text_post_enc": ln(),
        "temporal_pos_embed": n(max_pos, width, std=0.01),
        "text_temporal_pos_embed": n(input_dim, width, std=0.01),
    }
    vi = {"video_pre_proj": {"kernel": n(input_dim, input_dim, std=0.01)},
          "ln_video_init": {"scale": 1.0 + n(input_dim, std=0.05),
                            "bias": n(input_dim, std=0.02)},
          "mlp_fc1": {"kernel": n(input_dim, input_dim, std=0.01),
                      "bias": n(input_dim, std=0.02)},
          "mlp_fc2": {"kernel": n(input_dim, input_dim, std=0.01),
                      "bias": n(input_dim, std=0.02)}}
    return {"params": {"trunk": trunk, "vi_encoder": vi}}


def make_grounding_requests(seed, n, video_dim=4096, text_dim=4096, max_t=64, max_k=64):
    """``n`` seeded grounding requests ({'video' (T, video_dim),
    'narration_embeds' (K, text_dim)}, float32) with T in [16, max_t] frames
    and K in [4, max_k] narrations, as ``GroundingService.ground_batch``
    takes them: at the service's defaults (seq_len 64, text_bucket 64) all
    fall in one bucket."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t, k = int(rng.randint(16, max_t + 1)), int(rng.randint(4, max_k + 1))
        out.append({"video": rng.randn(t, video_dim).astype(np.float32),
                    "narration_embeds": rng.randn(k, text_dim).astype(np.float32)})
    return out
