"""Multi-head attention: the plain composition, the fused-MHA kernel and
the flash-attention kernel with its backward.

Counterpart of ``exoground_tpu/ops/attention.py``:

  * ``attention_plain`` — scaled dot-product attention over (B, H, S, D)
    with a torch ``key_padding_mask`` (True/nonzero at PAD) and the finite
    ``NEG_INF`` fill, so a fully-masked row averages its keys uniformly
    (counterpart of ``attention_xla``).
  * ``mha_plain`` — the whole self-attention MHA the kernel fuses
    (counterpart of ``_mha_xla``).
  * ``fused_mha`` — the wrapper of the hand-written kernel in
    ``csrc/fused_mha.cu``: a CUDA tensor launches it, a CPU tensor takes
    ``mha_plain``. Inference-only, as the TPU kernel is.
  * ``flash_attention`` — blockwise attention with online softmax (the
    counterpart of ``flash_attention``/``_flash``): on a CUDA tensor the
    forward, dq and dk/dv kernels of ``csrc/flash_attn.cu`` (behind the
    autograd Function ``FlashAttention``), on a CPU tensor
    ``flash_attention_plain``. A row with no valid key gives 0 here, not
    the uniform average of ``attention_plain``.
  * ``resolve_impl`` / ``scaled_dot_attention`` — the JAX package's
    dispatch between the two cores ('auto' | 'xla' | 'flash', None meaning
    'auto'), with ``check_impl`` its one test of an impl string.
  * ``MultiHeadAttention`` — the ``nn.MultiheadAttention`` parameter layout
    (packed ``in_proj_weight`` (3C, C), ``out_proj``) with the JAX module's
    dispatch: under 'auto' qualifying self-attention takes ``fused_mha``,
    other self-attention (and all of it inside ``disable_fused_kernels()``)
    ``mha_plain`` with the impl's core, cross-attention the q/kv alias
    split, then ``scaled_dot_attention``.
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
MAX_KERNEL_HEAD_DIM = 64  # largest head size the fused-MHA CUDA kernel serves
MAX_FLASH_HEAD_DIM = 128  # largest head size the flash CUDA kernels serve
# 'auto' takes flash from this many scores per (batch, head) on: the JAX
# package's gate (attention.py:77) as it stands, with "on the TPU" read as
# "on the card". No H100 measurement has moved it yet (PERF.md §7).
FLASH_MIN_SCORES = 2048 * 2048

IMPLS = ("auto", "xla", "flash")  # None means 'auto'
# values of the JAX package whose kernels wait for a later slice
_LATER_IMPLS = {
    "small": "the window-attention kernel _small (ROADMAP.md queue 2, row 9)",
    "fused": "the whole-block kernels (ROADMAP.md queue 2, rows 7-8)",
}


def check_impl(impl: Optional[str]) -> None:
    """The one test of an attention impl: None (= 'auto'), 'auto', 'xla' or
    'flash' pass; the JAX package's 'small' and whole-block 'fused' raise
    ``NotImplementedError`` until their kernels are ported."""
    if impl in _LATER_IMPLS:
        raise NotImplementedError(f"attention impl {impl!r} needs {_LATER_IMPLS[impl]}, "
                                  "which a later slice of the port brings")
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r} is not one of {IMPLS}")


def resolve_impl(impl: Optional[str], sq: int, sk: int, device) -> str:
    """'xla' (``attention_plain``) or 'flash' for an attention over sq x sk
    scores on ``device`` (the counterpart of ``_resolve_impl``)."""
    check_impl(impl)
    if impl not in (None, "auto"):
        return impl
    if torch.device(device).type == "cuda" and sq * sk >= FLASH_MIN_SCORES:
        return "flash"
    return "xla"


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


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def flash_attention_plain(q, k, v, kpad):
    """The flash kernels' function, written plainly: q (BH, Sq, D) already
    scaled by 1/sqrt(D), k and v (BH, Sk, D), kpad (B, Sk) nonzero at PAD
    (b = bh // (BH / B)). Returns (o (BH, Sq, D) in q's type, lse (BH, Sq)
    float32); a row with no valid key gives o = 0 and lse = -NEG_INF, as
    the TPU kernel (attention.py:163-171). p is rounded to v's type before
    p . v, as there (:157). Autograd gives its backward."""
    bh, sq, _ = q.shape
    b, sk = kpad.shape
    valid = (kpad == 0).repeat_interleave(bh // b, dim=0)[:, None, :]  # (BH, 1, Sk)
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    s = torch.where(valid, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros((), dtype=s.dtype, device=s.device))
    l = p.sum(dim=-1, keepdim=True)
    lm = torch.clamp(l, min=1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / lm
    lse = torch.where(l > 0, m + torch.log(lm), torch.full_like(m, -NEG_INF))
    return o.to(q.dtype), lse[..., 0]


def _flash_check(name, q, k, v, kpad):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name}: q, k, v must be (BH, S, D)")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != (bh, sk, d):
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if kpad.dim() != 2 or kpad.shape[1] != sk or bh % kpad.shape[0]:
        raise ValueError(f"{name}: kpad {tuple(kpad.shape)} does not fit BH={bh}, Sk={sk}")
    if d % 8 or d > MAX_FLASH_HEAD_DIM:
        raise NotImplementedError(
            f"{name}: head size {d}; the CUDA kernels serve multiples of 8 up to "
            f"{MAX_FLASH_HEAD_DIM}")
    if sq == 0 or sk == 0:
        raise ValueError(f"{name}: empty sequence (Sq={sq}, Sk={sk})")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernels take CUDA tensors, got {q.device}")
    _kernels.check_cuda_inputs(name, q.device, q.dtype, q=q, k=k, v=v)
    _kernels.check_cuda_inputs(name, q.device, torch.int32, kpad=kpad)
    return bh, bh // kpad.shape[0], sq, sk, d


def flash_forward(q, k, v, kpad):
    """Launch the forward kernel: (o, lse) as ``flash_attention_plain``,
    from contiguous CUDA tensors (kpad int32)."""
    name = "flash_fwd"
    bh, h, sq, sk, d = _flash_check(name, q, k, v, kpad)
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    rc = _kernels.library("flash_attn").flash_attn_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpad.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, h, sq, sk, d, _kernels.dtype_code(q), _kernels.stream_of(q))
    _kernels.check(name, rc)
    _kernels.LAUNCHES[name] += 1
    return o, lse


def _flash_bwd_check(name, q, k, v, kpad, do, lse, delta):
    bh, h, sq, sk, d = _flash_check(name, q, k, v, kpad)
    _kernels.check_cuda_inputs(name, q.device, q.dtype, do=do)
    _kernels.check_cuda_inputs(name, q.device, torch.float32, lse=lse, delta=delta)
    if do.shape != q.shape or lse.shape != (bh, sq) or delta.shape != (bh, sq):
        raise ValueError(f"{name}: do {tuple(do.shape)}, lse {tuple(lse.shape)} or delta "
                         f"{tuple(delta.shape)} does not fit q {tuple(q.shape)}")
    return bh, h, sq, sk, d


def flash_dq(q, k, v, kpad, do, lse, delta):
    """Launch the dq kernel: dq in q's type from the forward's inputs, the
    upstream grad do, the forward's lse and delta = sum(do * o, -1)."""
    name = "flash_dq"
    bh, h, sq, sk, d = _flash_bwd_check(name, q, k, v, kpad, do, lse, delta)
    dq = torch.empty_like(q)
    rc = _kernels.library("flash_attn").flash_attn_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpad.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, h, sq, sk, d,
        _kernels.dtype_code(q), _kernels.stream_of(q))
    _kernels.check(name, rc)
    _kernels.LAUNCHES[name] += 1
    return dq


def flash_dkv(q, k, v, kpad, do, lse, delta):
    """Launch the dk/dv kernel: (dk, dv) in k's and v's type, from the
    arguments of ``flash_dq``."""
    name = "flash_dkv"
    bh, h, sq, sk, d = _flash_bwd_check(name, q, k, v, kpad, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _kernels.library("flash_attn").flash_attn_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpad.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, h, sq, sk, d,
        _kernels.dtype_code(q), _kernels.stream_of(q))
    _kernels.check(name, rc)
    _kernels.LAUNCHES[name] += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """o of the forward kernel; the backward kernels recompute the scores
    from the saved inputs and the forward's lse (the residuals of the TPU
    kernel's custom VJP, attention.py:313). kpad gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kpad):
        o, lse = flash_forward(q, k, v, kpad)
        ctx.save_for_backward(q, k, v, kpad, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kpad, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # a plain float32 reduction, as the JAX package computes it outside
        # Pallas (attention.py:322)
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = flash_dq(q, k, v, kpad, do, lse, delta)
        dk, dv = flash_dkv(q, k, v, kpad, do, lse, delta)
        return dq, dk, dv, None


def flash_attention(q, k, v, key_padding_mask=None):
    """Blockwise attention over (B, H, S, D) with key padding ((B, Sk)
    True/nonzero at PAD), differentiable in q, k and v. The 1/sqrt(D) scale
    is folded into q here, outside the autograd Function, so autograd
    chains it into dq (attention.py:410-413). CPU tensors take
    ``flash_attention_plain``; CUDA tensors launch the kernels or raise."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if key_padding_mask is None:
        kpad = torch.zeros((b, sk), dtype=torch.int32, device=q.device)
    else:
        kpad = key_padding_mask.to(device=q.device, dtype=torch.int32).contiguous()
    q = q * (1.0 / math.sqrt(d))
    qf = q.reshape(b * h, sq, d)
    kf = k.reshape(b * h, sk, d)
    vf = v.reshape(b * h, sk, d)
    if q.device.type == "cpu":
        o, _ = flash_attention_plain(qf, kf, vf, kpad)
    elif torch.is_grad_enabled() and (qf.requires_grad or kf.requires_grad
                                      or vf.requires_grad):
        o = FlashAttention.apply(qf.contiguous(), kf.contiguous(), vf.contiguous(), kpad)
    else:
        o, _ = flash_forward(qf.contiguous(), kf.contiguous(), vf.contiguous(), kpad)
    return o.reshape(b, h, sq, d)


def scaled_dot_attention(q, k, v, key_padding_mask=None, impl: Optional[str] = None):
    """The attention core over (B, H, S, D) under ``resolve_impl``."""
    if resolve_impl(impl, q.shape[2], k.shape[2], q.device) == "flash":
        return flash_attention(q, k, v, key_padding_mask)
    return attention_plain(q, k, v, key_padding_mask)


# ---------------------------------------------------------------------------
# whole-MHA window kernel
# ---------------------------------------------------------------------------


def _split_heads(t, num_heads):
    b, s, c = t.shape
    return t.reshape(b, s, num_heads, c // num_heads).transpose(1, 2)


def _merge_heads(o):
    b, h, s, d = o.shape
    return o.transpose(1, 2).reshape(b, s, h * d)


def mha_plain(x, kpad, w_in, b_in, w_out, b_out, num_heads, impl: Optional[str] = "xla"):
    """The composition the kernel fuses: qkv = x W_in^T + b_in, per-head
    attention under the key padding, o W_out^T + b_out (torch layout). The
    core is ``scaled_dot_attention``'s under ``impl``: ``attention_plain``
    by default, as the kernel computes it."""
    q, k, v = F.linear(x, w_in, b_in).chunk(3, dim=-1)
    o = scaled_dot_attention(_split_heads(q, num_heads), _split_heads(k, num_heads),
                             _split_heads(v, num_heads), kpad, impl=impl)
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

    def forward(self, query, key, value, key_padding_mask=None, impl: Optional[str] = None):
        """``impl``: None or 'auto', 'xla' or 'flash'. The fused-MHA kernel
        runs only under 'auto' (attention.py:1079-1085); 'xla' and 'flash'
        take the unfused projections and that attention core."""
        c = query.shape[-1]
        h = self.num_heads
        w_in, b_in = self.in_proj_weight, self.in_proj_bias
        w_out, b_out = self.out_proj.weight, self.out_proj.bias
        if query is key and key is value:
            if (impl in (None, "auto") and kernel_eligible(query.shape[1], c, h)
                    and not fused_kernels_disabled()):
                return fused_mha(query, key_padding_mask, w_in, b_in, w_out, b_out, h)
            return mha_plain(query, key_padding_mask, w_in, b_in, w_out, b_out, h, impl=impl)
        # cross-attention (the XLA branch of the JAX module): q and kv (or q,
        # k, v) projected apart
        if key is value:
            q = F.linear(query, w_in[:c], b_in[:c])
            k, v = F.linear(key, w_in[c:], b_in[c:]).chunk(2, dim=-1)
        else:
            q = F.linear(query, w_in[:c], b_in[:c])
            k = F.linear(key, w_in[c:2 * c], b_in[c:2 * c])
            v = F.linear(value, w_in[2 * c:], b_in[2 * c:])
        o = scaled_dot_attention(_split_heads(q, h), _split_heads(k, h),
                                 _split_heads(v, h), key_padding_mask, impl=impl)
        return F.linear(_merge_heads(o), w_out, b_out)
