"""Ops of the port: plain PyTorch versions and the CUDA kernel wrappers.

Kernel libraries build at first use (``ops/_kernels.py``), never at import.
``quant`` is the int8 serving mode's context and quantizers.
"""

from exoground_tpu_torch.ops import quant
from exoground_tpu_torch.ops.attention import (
    FlashAttention,
    block_fusion_mode,
    check_impl,
    flash_attention,
    flash_attention_plain,
    fused_block_attn,
    fused_mha_int8,
    mha_int8_plain,
    resolve_impl,
    scaled_dot_attention,
    small_attention,
    small_attention_plain,
)
from exoground_tpu_torch.ops.fused_mlp import (
    fused_block_mlp,
    fused_mlp_int8,
    mlp_int8_plain,
    resolve_mlp_impl,
)

__all__ = [
    "FlashAttention",
    "block_fusion_mode",
    "check_impl",
    "flash_attention",
    "flash_attention_plain",
    "fused_block_attn",
    "fused_block_mlp",
    "fused_mha_int8",
    "fused_mlp_int8",
    "mha_int8_plain",
    "mlp_int8_plain",
    "quant",
    "resolve_impl",
    "resolve_mlp_impl",
    "scaled_dot_attention",
    "small_attention",
    "small_attention_plain",
]
