"""Command-line tools of the port, and the feature-extraction harness."""

from exoground_tpu_torch.tools.extract_features import (  # noqa: F401
    ExtractConfig,
    bf16_params_keep_layernorm,
    decode_frames,
    extract_corpus,
    extract_video_features,
    half_copy,
    probe_duration,
)
