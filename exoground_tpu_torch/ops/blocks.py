"""Transformer encoder blocks.

Counterpart of ``exoground_tpu/ops/blocks.py`` (reference
model/tfm_model.py:17-55), in (B, T, C) layout, with the two quirks the TAN
loss and checkpoint parity depend on:

  1. each block returns both its output and the pre-attention LayerNormed
     input ``x_norm`` (tfm_model.py:34-38);
  2. the stack collects ``x_norm`` of layers 2..N plus the final output —
     the ``intermediate.pop(0); intermediate.append(x)`` protocol
     (tfm_model.py:48-55) — stacked as (B, Stage, T, C).

A block takes the whole-block path (two kernel launches, ``fused_block_attn``
then ``fused_block_mlp``) exactly when ``block_fusion_mode`` admits its
attention impl and window and ``resolve_mlp_impl`` gives 'fused' for its
MLP impl (the JAX block, blocks.py:197-205); otherwise the per-module path.
Both read the same ``ln_1``, ``attn``, ``ln_2`` and ``mlp`` parameters.

Parameter names follow the reference's state dict
(``resblocks.{i}.attn.in_proj_weight``, ``ln_1``, ``mlp.c_fc`` ...).
"""

from __future__ import annotations

import torch
from torch import nn

from exoground_tpu_torch.ops import quant
from exoground_tpu_torch.ops.attention import (
    MultiHeadAttention,
    block_fusion_mode,
    fused_block_attn,
)
from exoground_tpu_torch.ops.fused_mlp import (
    LN_EPS,
    fused_block_mlp,
    fused_mlp,
    fused_mlp_int8,
    mlp_plain,
    resolve_mlp_impl,
)


class MLP(nn.Module):
    """4x-expansion MLP with QuickGELU (reference tfm_model.py:23-27).
    ``impl`` (None or 'auto', 'xla', 'fused') resolves through
    ``resolve_mlp_impl`` as on the card on every device, since the kernel
    wrappers take their plain versions for CPU tensors: widths that are
    multiples of 128 go through ``fused_mlp`` (under 'auto' outside
    ``disable_fused_kernels()``, under 'fused' even inside it), or under
    ``quant.matmul_impl('int8')`` through ``fused_mlp_int8`` when the
    policy quantizes c_fc (4C >= min_cols) but not c_proj (C < min_cols)
    (blocks.py:86-111); 'xla', other widths and any other int8 policy take
    the plain composition with ``quant.linear`` projections."""

    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x, impl=None):
        args = (x, self.c_fc.weight, self.c_fc.bias, self.c_proj.weight,
                self.c_proj.bias)
        c = x.shape[-1]
        if resolve_mlp_impl(impl, c, "cuda") == "fused":
            if quant.current_impl() == "default":
                return fused_mlp(*args)
            if quant.kernel_gate(4 * c, c):
                return fused_mlp_int8(*args)
        return mlp_plain(*args, linear=quant.linear)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN self-attention block returning (output, x_norm)
    (reference model/tfm_model.py:17-38). ``impl`` reaches the attention
    (None or 'auto', 'xla', 'flash', 'fused'; the JAX block's 'small'
    raises ``NotImplementedError`` until its kernel is ported), ``mlp_impl``
    the MLP."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = MultiHeadAttention(width, heads)
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = MLP(width)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)

    def forward(self, x, key_padding_mask=None, impl=None, mlp_impl=None):
        _, s, c = x.shape
        mode = block_fusion_mode(impl, s, c, self.attn.num_heads)
        if mode is not None and resolve_mlp_impl(mlp_impl, c, x.device) == "fused":
            return self._fused_block(x, key_padding_mask, mode == "int8")
        x_norm = self.ln_1(x)
        x = x + self.attn(x_norm, x_norm, x_norm, key_padding_mask, impl=impl)
        x = x + self.mlp(self.ln_2(x), impl=mlp_impl)
        return x, x_norm

    def _fused_block(self, x, key_padding_mask, int8: bool):
        """The whole-block path (blocks.py:147-184): two launches, the
        LayerNorms, qkv, attention output, 4C hidden and both residual adds
        staying in the kernels."""
        attn, mlp = self.attn, self.mlp
        x, x_norm = fused_block_attn(
            x, key_padding_mask, self.ln_1.weight, self.ln_1.bias, attn.in_proj_weight,
            attn.in_proj_bias, attn.out_proj.weight, attn.out_proj.bias, attn.num_heads,
            int8_qkv=int8)
        x = fused_block_mlp(x, self.ln_2.weight, self.ln_2.bias, mlp.c_fc.weight,
                            mlp.c_fc.bias, mlp.c_proj.weight, mlp.c_proj.bias, int8_cfc=int8)
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

    def forward(self, x, key_padding_mask=None, impl=None, mlp_impl=None):
        intermediate = []
        for block in self.resblocks:
            x, x_norm = block(x, key_padding_mask, impl=impl, mlp_impl=mlp_impl)
            intermediate.append(x_norm)
        intermediate.pop(0)
        intermediate.append(x)
        return torch.stack(intermediate, dim=1)
