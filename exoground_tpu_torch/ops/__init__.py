"""Ops of the port: plain PyTorch versions and the CUDA kernel wrappers.

Kernel libraries build at first use (``ops/_kernels.py``), never at import.
"""

from exoground_tpu_torch.ops.attention import (
    FlashAttention,
    check_impl,
    flash_attention,
    flash_attention_plain,
    resolve_impl,
    scaled_dot_attention,
)

__all__ = [
    "FlashAttention",
    "check_impl",
    "flash_attention",
    "flash_attention_plain",
    "resolve_impl",
    "scaled_dot_attention",
]
