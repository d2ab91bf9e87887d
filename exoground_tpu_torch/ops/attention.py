"""Multi-head attention: the plain composition and the fused-MHA kernel.

Counterpart of ``exoground_tpu/ops/attention.py`` for the serving path:

  * ``attention_plain`` — scaled dot-product attention over (B, H, S, D)
    with a torch ``key_padding_mask`` (True/nonzero at PAD) and the finite
    ``NEG_INF`` fill, so a fully-masked row averages its keys uniformly
    (counterpart of ``attention_xla``).
  * ``mha_plain`` — the whole self-attention MHA the kernel fuses
    (counterpart of ``_mha_xla``).
  * ``fused_mha`` — the wrapper of the hand-written kernel in
    ``csrc/fused_mha.cu``: a CUDA tensor launches it, a CPU tensor takes
    ``mha_plain``. Inference-only, as the TPU kernel is.
  * ``MultiHeadAttention`` — the ``nn.MultiheadAttention`` parameter layout
    (packed ``in_proj_weight`` (3C, C), ``out_proj``) with the JAX module's
    dispatch: qualifying self-attention takes ``fused_mha``, everything else
    (and everything inside ``disable_fused_kernels()``) the unfused
    composition with the q/kv alias split.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from exoground_tpu_torch.ops import _kernels
from exoground_tpu_torch.ops.fused_mlp import fused_kernels_disabled

NEG_INF = -1e30  # finite "minus infinity": avoids NaN on fully-masked rows
MAX_FUSED_S = 128  # windows the fused kernel serves (the TPU kernel's tile)
MAX_KERNEL_HEAD_DIM = 64  # largest head size the CUDA kernel serves


def attention_plain(q, k, v, key_padding_mask=None, scale: Optional[float] = None):
    """Scaled dot-product attention over (B, H, S, D); key_padding_mask
    (B, Sk) True/nonzero at PAD keys. Scores and softmax in float32."""
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if key_padding_mask is not None:
        pad = key_padding_mask.to(torch.bool)[:, None, None, :]
        s = s.masked_fill(pad, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    return o.to(q.dtype)


def _split_heads(t, num_heads):
    b, s, c = t.shape
    return t.reshape(b, s, num_heads, c // num_heads).transpose(1, 2)


def _merge_heads(o):
    b, h, s, d = o.shape
    return o.transpose(1, 2).reshape(b, s, h * d)


def mha_plain(x, kpad, w_in, b_in, w_out, b_out, num_heads):
    """The composition the kernel fuses: qkv = x W_in^T + b_in, per-head
    attention under the key padding, o W_out^T + b_out (torch layout)."""
    q, k, v = F.linear(x, w_in, b_in).chunk(3, dim=-1)
    o = attention_plain(_split_heads(q, num_heads), _split_heads(k, num_heads),
                        _split_heads(v, num_heads), kpad)
    return F.linear(_merge_heads(o), w_out, b_out)


def fused_mha(x, key_padding_mask, w_in, b_in, w_out, b_out, num_heads):
    """Whole-MHA window self-attention, S <= 128: x (B, S, C), weights in
    torch layout. CPU tensors take ``mha_plain``; CUDA tensors launch the
    kernel or raise."""
    b, s, c = x.shape
    if x.device.type == "cpu":
        return mha_plain(x, key_padding_mask, w_in, b_in, w_out, b_out, num_heads)
    name = "fused_mha"
    if not kernel_eligible(s, c, num_heads):
        raise ValueError(f"{name}: S={s}, C={c}, H={num_heads} outside the fused test "
                         f"S <= {MAX_FUSED_S}, C % 128 == 0, (C/H) % 8 == 0")
    if c // num_heads > MAX_KERNEL_HEAD_DIM:
        raise NotImplementedError(
            f"{name}: head size {c // num_heads} > {MAX_KERNEL_HEAD_DIM}; the CUDA "
            "kernel does not serve it yet (ROADMAP.md, queue 2)")
    if w_in.shape != (3 * c, c) or w_out.shape != (c, c):
        raise ValueError(f"{name}: weights {tuple(w_in.shape)}, {tuple(w_out.shape)} "
                         f"do not fit width {c}")
    if b_in.shape != (3 * c,) or b_out.shape != (c,):
        raise ValueError(f"{name}: biases {tuple(b_in.shape)}, {tuple(b_out.shape)} "
                         f"do not fit width {c}")
    _kernels.check_inference(name, x, w_in, b_in, w_out, b_out)
    _kernels.check_cuda_inputs(name, x.device, x.dtype, x=x, w_in=w_in, b_in=b_in,
                               w_out=w_out, b_out=b_out)
    code = _kernels.dtype_code(x)
    if key_padding_mask is None:
        kpad = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    else:
        if key_padding_mask.shape != (b, s):
            raise ValueError(f"{name}: key_padding_mask {tuple(key_padding_mask.shape)} "
                             f"!= {(b, s)}")
        kpad = key_padding_mask.to(device=x.device, dtype=torch.int32).contiguous()
    attn = torch.empty((b * s, c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    rc = _kernels.library(name).fused_mha_forward(
        x.data_ptr(), kpad.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
        w_out.data_ptr(), b_out.data_ptr(), attn.data_ptr(), out.data_ptr(),
        b, s, c, num_heads, code, _kernels.stream_of(x))
    _kernels.check(name, rc)
    _kernels.LAUNCHES[name] += 1
    return out


def kernel_eligible(s: int, c: int, num_heads: int) -> bool:
    """The JAX module's fused-MHA test (attention.py:1082-1085: S <= 128,
    C % 128 == 0, Dh % 8 == 0). No row-count gate: the TPU's was a TPU
    measurement."""
    if c % num_heads:
        return False
    return 1 <= s <= MAX_FUSED_S and c % 128 == 0 and (c // num_heads) % 8 == 0


class MultiHeadAttention(nn.Module):
    """MHA with the packed in-projection layout of ``nn.MultiheadAttention``
    (reference model/tfm_model.py:21): ``in_proj_weight`` (3C, C) packed
    [q | k | v], ``in_proj_bias`` (3C,), ``out_proj`` Linear(C, C).
    ``key_padding_mask`` is (B, Sk) with True at PAD."""

    def __init__(self, width: int, num_heads: int):
        super().__init__()
        assert width % num_heads == 0
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.normal_(self.in_proj_weight, std=0.02)
        nn.init.normal_(self.out_proj.weight, std=0.02)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, query, key, value, key_padding_mask=None):
        c = query.shape[-1]
        w_in, b_in = self.in_proj_weight, self.in_proj_bias
        w_out, b_out = self.out_proj.weight, self.out_proj.bias
        self_attn = query is key and key is value
        if (self_attn and kernel_eligible(query.shape[1], c, self.num_heads)
                and not fused_kernels_disabled()):
            return fused_mha(query, key_padding_mask, w_in, b_in, w_out, b_out,
                             self.num_heads)
        # unfused composition (the XLA branch of the JAX module): one packed
        # projection when the inputs alias, else q and kv (or q, k, v) apart
        h = self.num_heads
        if self_attn:
            return mha_plain(query, key_padding_mask, w_in, b_in, w_out, b_out, h)
        if key is value:
            q = F.linear(query, w_in[:c], b_in[:c])
            k, v = F.linear(key, w_in[c:], b_in[c:]).chunk(2, dim=-1)
        else:
            q = F.linear(query, w_in[:c], b_in[:c])
            k = F.linear(key, w_in[c:2 * c], b_in[c:2 * c])
            v = F.linear(value, w_in[2 * c:], b_in[2 * c:])
        o = attention_plain(_split_heads(q, h), _split_heads(k, h),
                            _split_heads(v, h), key_padding_mask)
        return F.linear(_merge_heads(o), w_out, b_out)
