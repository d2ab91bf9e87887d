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


def make_bench_params(seed, layers=6, width=512, input_dim=4096, max_pos=4096,
                      binary_head=False):
    """Seeded random weights for a TemporalAligner (E6D6, width 512, 4096-d
    inputs by default) as a param tree in the JAX package's layout (Dense
    kernels (in, out), in_proj_kernel (C, 3C), LayerNorm scale/bias), drawn
    with numpy at the model's init scales; ``utils/convert.py::
    load_tan_params`` loads it into the port's model. ``binary_head`` adds
    the alignability head (drawn last, so the other weights stay the same)."""
    rng = np.random.RandomState(seed)
    w = width

    def n(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def ln():
        return {"scale": 1.0 + n(w, std=0.05), "bias": n(w, std=0.02)}

    attn_std, proj_std, fc_std = w ** -0.5, w ** -0.5 * (2 * layers) ** -0.5, (2 * w) ** -0.5

    def stack():
        return {f"resblocks_{i}": {
            "attn": {"in_proj_kernel": n(w, 3 * w, std=attn_std),
                     "in_proj_bias": n(3 * w, std=0.02),
                     "out_proj_kernel": n(w, w, std=proj_std),
                     "out_proj_bias": n(w, std=0.02)},
            "ln_1": ln(), "ln_2": ln(),
            "mlp": {"c_fc": {"kernel": n(w, 4 * w, std=fc_std), "bias": n(4 * w, std=0.02)},
                    "c_proj": {"kernel": n(4 * w, w, std=proj_std), "bias": n(w, std=0.02)}},
        } for i in range(layers)}

    tree = {
        "video_temporal_encoder": stack(), "joint_temporal_encoder": stack(),
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
