"""Transformer encoder blocks.

Counterpart of ``exoground_tpu/ops/blocks.py`` (reference
model/tfm_model.py:17-55), in (B, T, C) layout, with the two quirks the TAN
loss and checkpoint parity depend on:

  1. each block returns both its output and the pre-attention LayerNormed
     input ``x_norm`` (tfm_model.py:34-38);
  2. the stack collects ``x_norm`` of layers 2..N plus the final output —
     the ``intermediate.pop(0); intermediate.append(x)`` protocol
     (tfm_model.py:48-55) — stacked as (B, Stage, T, C).

Parameter names follow the reference's state dict
(``resblocks.{i}.attn.in_proj_weight``, ``ln_1``, ``mlp.c_fc`` ...).
"""

from __future__ import annotations

import torch
from torch import nn

from exoground_tpu_torch.ops import quant
from exoground_tpu_torch.ops.attention import MultiHeadAttention
from exoground_tpu_torch.ops.fused_mlp import (
    fused_kernels_disabled,
    fused_mlp,
    fused_mlp_int8,
    kernel_eligible,
    mlp_plain,
)

LN_EPS = 1e-5  # torch LayerNorm default


class MLP(nn.Module):
    """4x-expansion MLP with QuickGELU (reference tfm_model.py:23-27).
    Widths that are multiples of 128 go through ``fused_mlp`` (the JAX
    package's test), or under ``quant.matmul_impl('int8')`` through
    ``fused_mlp_int8`` when the policy quantizes c_fc (4C >= min_cols) but
    not c_proj (C < min_cols) (blocks.py:86-111); others, any other int8
    policy, and every width inside ``disable_fused_kernels()``, take the
    plain composition with ``quant.linear`` projections."""

    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x):
        args = (x, self.c_fc.weight, self.c_fc.bias, self.c_proj.weight,
                self.c_proj.bias)
        c = x.shape[-1]
        if kernel_eligible(c) and not fused_kernels_disabled():
            if quant.current_impl() == "default":
                return fused_mlp(*args)
            if quant.kernel_gate(4 * c, c):
                return fused_mlp_int8(*args)
        return mlp_plain(*args, linear=quant.linear)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN self-attention block returning (output, x_norm)
    (reference model/tfm_model.py:17-38). ``impl`` reaches the attention
    (None or 'auto', 'xla', 'flash'); the JAX block's 'fused' (whole-block
    kernels) and 'small' raise ``NotImplementedError`` there until their
    kernels are ported."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = MultiHeadAttention(width, heads)
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = MLP(width)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)

    def forward(self, x, key_padding_mask=None, impl=None):
        x_norm = self.ln_1(x)
        x = x + self.attn(x_norm, x_norm, x_norm, key_padding_mask, impl=impl)
        x = x + self.mlp(self.ln_2(x))
        return x, x_norm


class TemporalEncoder(nn.Module):
    """Stack of N blocks returning the collected stages (B, Stage, T, C):
    x_norm of layers 2..N followed by the final un-normed output; the caller
    applies its post-LN to the last stage (reference model/tan_model.py:168)."""

    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers)
        )

    def forward(self, x, key_padding_mask=None, impl=None):
        intermediate = []
        for block in self.resblocks:
            x, x_norm = block(x, key_padding_mask, impl=impl)
            intermediate.append(x_norm)
        intermediate.pop(0)
        intermediate.append(x)
        return torch.stack(intermediate, dim=1)
