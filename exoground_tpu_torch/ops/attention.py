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
  Both kernels run every product on the tensor cores, bfloat16 as
  ``mma.sync`` bf16 and float32 in 3xTF32 (float32 accuracy); their bodies
  stage their operands by 16-byte ``cp.async`` and the wrappers raise on a
  misaligned one (``_kernels.check_aligned``).
  * ``small_attention`` — the window-attention core of an explicit
    'small' (counterpart of ``small_attention``/``_small``): on a CUDA
    tensor the kernel of ``csrc/small_attn.cu``, on a CPU tensor
    ``small_attention_plain``, the kernel body written plainly.
    Inference-only on the card.
  * ``resolve_impl`` / ``scaled_dot_attention`` — the JAX package's
    dispatch between the cores ('auto' | 'xla' | 'flash' | 'small', None
    meaning 'auto'; 'fused' resolves as 'auto' there; 'small' takes the
    window core on square windows of S <= 128 only), with ``check_impl``
    its one test of an impl string.
  * ``fused_mha_int8`` — the int8 serving mode's route (counterpart of
    ``_fused_mha_int8``): W_in quantized per output row once per weight
    version (``quant.quantized_weight``), then ``csrc/fused_mha_int8.cu``
    quantizes x once per row into the wrapper's scratch (``mha_scratch``)
    and runs the qkv projection as int8 x int8 -> int32 (attention and
    out-projection exact); a CPU tensor takes ``mha_int8_plain``, the
    kernel body written plainly. Inference-only.
  * ``fused_block_attn`` — the whole-block path's first half (counterpart
    of ``fused_block_attn``/``_block_attn``): (x + MHA(LN_1(x)), LN_1(x)) in
    one call of ``csrc/block_attn.cu`` (the int8-qkv body:
    ``csrc/block_attn_int8.cu``): the LayerNorm once per row in float32,
    written as x_norm, then fused MHA's body on it (the int8 fused MHA's on
    its quantized float32 form) and the residual summed in float32 and
    rounded once; a CPU tensor takes ``block_attn_plain`` /
    ``block_attn_int8_plain``.
    ``block_fusion_mode`` says when a block takes it: an explicit 'fused'
    on a kernel-eligible window, in the default context ('exact') or in an
    int8 one whose policy quantizes 3C but not C ('int8').
  The four kernels share ``csrc/mha_tile.cuh``: tiles of packed windows
  per head on the tensor cores, bfloat16 (the int8 qkv as ``mma.sync`` .s8)
  and float32 exact in 3xTF32, and the int8 float32 body per (window,
  head) on the CUDA cores, for heads up to ``MAX_TILE_HEAD_DIM``; a wider
  head (any multiple of 8) runs the wide-head body, whose qkv goes through
  a scratch (``mha_scratch``) into attention in head slabs
  (``csrc/wide_window.cuh``); every launch goes through ``_launch_mha``.
  The flash and window cores take any head size: above 128 their kernels
  work in head slabs too, and a D that is not a multiple of 8 is padded
  with zero columns (``_pad_head``).
  * ``MultiHeadAttention`` — the ``nn.MultiheadAttention`` parameter layout
    (packed ``in_proj_weight`` (3C, C), ``out_proj``) with the JAX module's
    dispatch: under 'auto' (outside ``disable_fused_kernels()``) or an
    explicit 'fused' (even inside it), qualifying self-attention takes
    ``fused_mha``, or under ``quant.matmul_impl('int8')`` ``fused_mha_int8``
    when the policy quantizes the qkv product (3C >= min_cols) but not the
    out-projection (C < min_cols); other self-attention ('xla', 'flash',
    'small' among them) ``mha_plain`` with the impl's core, cross-attention
    the q/kv alias split, then ``scaled_dot_attention``. Every unfused projection goes through
    ``quant.linear``, exactly ``F.linear`` outside an int8 context.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from exoground_tpu_torch.ops import _kernels, quant
from exoground_tpu_torch.ops.fused_mlp import fused_kernels_disabled, layernorm_f32

NEG_INF = -1e30  # finite "minus infinity": avoids NaN on fully-masked rows
MAX_FUSED_S = 128  # windows the fused kernel serves (the TPU kernel's tile)
# the largest head the MHA family's fixed head tiles hold (csrc/mha_tile.cuh
# kMaxTileDh); a wider one runs the wide-head body (2d), which takes a
# (B*S, 3C) qkv scratch of its own
MAX_TILE_HEAD_DIM = 64
# the flash kernels' head sizes: up to 128 in a fixed head tile, above in
# the cluster bodies (csrc/flash_attn.cu, namespace cl: up to 8 CTAs, each
# owning one or more pairs of 64-column slabs), any multiple of 8
MAX_FLASH_TILE_D = 128
# 'auto' takes flash from this many scores per (batch, head) on: the JAX
# package's gate (attention.py:77) as it stands, with "on the TPU" read as
# "on the card". No H100 measurement has moved it yet (PERF.md §7).
FLASH_MIN_SCORES = 2048 * 2048

MAX_SMALL_S = 128  # windows the window-attention kernel serves (S == Sk)
# the largest head the window core's fixed tiles serve (csrc/small_attn.cu:
# below kMaxTileD = 128); 128 and wider run the wide window kernel
# (csrc/wide_window.cuh), faster on an H100 at 128 too
MAX_SMALL_TILE_D = 120

IMPLS = ("auto", "xla", "flash", "small", "fused")  # None means 'auto'


def check_impl(impl: Optional[str]) -> None:
    """The one test of an attention impl: None (= 'auto'), 'auto', 'xla',
    'flash', 'small' (the window-attention kernel, explicit only) or 'fused'
    (the whole-block path, explicit only) pass."""
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r} is not one of {IMPLS}")


def resolve_impl(impl: Optional[str], sq: int, sk: int, device) -> str:
    """'xla' (``attention_plain``), 'flash' or 'small' for an attention over
    sq x sk scores on ``device`` (the counterpart of ``_resolve_impl``); an
    explicit impl is returned as it is. 'fused' is
    consumed by the blocks and ``MultiHeadAttention``; an attention core
    that reaches this dispatcher under it resolves as 'auto'
    (attention.py:60-65)."""
    check_impl(impl)
    if impl not in (None, "auto", "fused"):
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


def _pad_head(t, d8):
    """t with zero columns appended to its last dimension up to ``d8``: the
    kernels take head sizes that are multiples of 8, and zero columns add
    nothing to q . k^T and give zero columns of o (and of dq, dk, dv), which
    the caller slices off. Differentiable."""
    d = t.shape[-1]
    return t if d == d8 else F.pad(t, (0, d8 - d))


def _flash_check(name, q, k, v, kpad):
    """The flash wrappers' checks. Every body stages q, k and v by 16-byte
    cp.async, so each must be 16-byte aligned, and the head size a multiple
    of 8 (``flash_attention`` pads any other)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name}: q, k, v must be (BH, S, D)")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != (bh, sk, d):
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if kpad.dim() != 2 or kpad.shape[1] != sk or bh % kpad.shape[0]:
        raise ValueError(f"{name}: kpad {tuple(kpad.shape)} does not fit BH={bh}, Sk={sk}")
    if d % 8:
        raise ValueError(f"{name}: head size {d} is not a multiple of 8 (flash_attention "
                         "pads it with zero columns)")
    if sq == 0 or sk == 0:
        raise ValueError(f"{name}: empty sequence (Sq={sq}, Sk={sk})")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernels take CUDA tensors, got {q.device}")
    _kernels.check_cuda_inputs(name, q.device, q.dtype, q=q, k=k, v=v)
    _kernels.check_cuda_inputs(name, q.device, torch.int32, kpad=kpad)
    _kernels.check_aligned(name, q=q, k=k, v=v)
    return bh, bh // kpad.shape[0], sq, sk, d


def _check_flash(name, rc, d):
    """After a flash launch: raise on its error (a head above 128 runs a
    cluster body, whose launch the card refuses where no GPC holds the
    cluster: cudaOccupancyMaxActiveClusters tells), then count it, and a
    cluster body under its own name too."""
    wide = d > MAX_FLASH_TILE_D
    if rc != 0 and wide:
        raise RuntimeError(f"{name}: the cluster body (head size {d}) failed to launch with "
                           f"cudaError {rc}")
    _kernels.check(name, rc)
    _kernels.count_launch(name)
    if wide:
        _kernels.count_launch(f"{name}_cluster")


def flash_forward(q, k, v, kpad):
    """Launch the forward kernel: (o, lse) as ``flash_attention_plain``,
    from contiguous CUDA tensors (kpad int32)."""
    name = "flash_fwd"
    bh, h, sq, sk, d = _flash_check(name, q, k, v, kpad)
    o = torch.empty_like(q)
    lse = q.new_empty((bh, sq), dtype=torch.float32)
    rc = _kernels.library("flash_attn").flash_attn_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpad.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, h, sq, sk, d, _kernels.dtype_code(q), _kernels.stream_of(q))
    _check_flash(name, rc, d)
    return o, lse


def _flash_bwd_check(name, q, k, v, kpad, do, lse, delta):
    bh, h, sq, sk, d = _flash_check(name, q, k, v, kpad)
    _kernels.check_cuda_inputs(name, q.device, q.dtype, do=do)
    _kernels.check_cuda_inputs(name, q.device, torch.float32, lse=lse, delta=delta)
    _kernels.check_aligned(name, do=do)
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
    _check_flash(name, rc, d)
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
    _check_flash(name, rc, d)
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
        if do.data_ptr() % 16:
            # the kernels stage do by 16-byte copies; a contiguous view at an
            # odd offset (a slice of a larger grad) gets a fresh copy
            do = do.clone()
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
    ``flash_attention_plain``; CUDA tensors launch the kernels or raise, at
    any head size: one that is not a multiple of 8 gets zero columns up to
    the next (``_pad_head``), the scale staying 1/sqrt(D) of the true D."""
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
        return o.reshape(b, h, sq, d)
    d8 = -(-d // 8) * 8
    qf, kf, vf = (_pad_head(t, d8).contiguous() for t in (qf, kf, vf))
    if torch.is_grad_enabled() and (qf.requires_grad or kf.requires_grad or vf.requires_grad):
        o = FlashAttention.apply(qf, kf, vf, kpad)
    else:
        o, _ = flash_forward(qf, kf, vf, kpad)
    return o[..., :d].reshape(b, h, sq, d)


# ---------------------------------------------------------------------------
# window attention (the 'small' core)
# ---------------------------------------------------------------------------


def small_attention_plain(q, k, v, kpad):
    """The window kernel's function written plainly (``_small_kernel``, per
    window): q (B, H, S, D) already scaled by 1/sqrt(D), k and v (B, H, S,
    D), kpad (B, S) nonzero at PAD. s = q k^T in float32 with masked keys at
    NEG_INF, p = exp(s - max) in float32, l = sum of the unrounded p, o =
    (p rounded to v's type) . v in float32, then o / l in q's type: the
    normalisation after the product, as the TPU body (attention.py:469-479).
    A fully-masked window averages its own S values (the TPU kernel averages
    its packed 128-column tile). Differentiable."""
    valid = (kpad == 0)[:, None, None, :]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = torch.where(valid, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype)


def small_attention(q, k, v, key_padding_mask=None):
    """Window attention over (B, H, S, D) with S == Sk <= 128 (the
    counterpart of ``small_attention``/``_small``): the key padding as the
    JAX function builds it (attention.py:999-1002; bool on the card), q scaled by
    1/sqrt(D) in q's type (:540), then ``small_attention_plain`` on a CPU
    tensor. A CUDA tensor launches the kernel of ``csrc/small_attn.cu`` or
    raises: it reads q, k and v where they lie (``_window_strides``: the
    strided views of a packed qkv need no copy) and scales q as it loads it,
    to the same q * scale in q's type; o comes back as a (B, H, S, D) view
    of (B, S, H, D) memory. Any head size, as the JAX function: on the card
    one that is not a multiple of 8 gets zero columns up to the next
    (``_pad_head``: a copy, sliced off o), the scale staying 1/sqrt(D) of
    the true D. Inference-only on the card."""
    b, h, s, d = q.shape
    name = "small_attn"
    if k.shape != (b, h, s, d) or v.shape != (b, h, s, d) or s > MAX_SMALL_S:
        raise ValueError(f"{name}: serves self-attention windows of S <= {MAX_SMALL_S}; got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if key_padding_mask is not None and key_padding_mask.shape != (b, s):
        raise ValueError(f"{name}: key_padding_mask {tuple(key_padding_mask.shape)} "
                         f"!= {(b, s)}")
    scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        if key_padding_mask is None:
            kpad = torch.zeros((b, s), dtype=torch.int32, device=q.device)
        else:
            kpad = key_padding_mask.to(device=q.device, dtype=torch.int32).contiguous()
        return small_attention_plain(q * scale, k, v, kpad)
    _kernels.check_inference(name, q, k, v)
    dev = q.get_device()
    for arg, t in (("k", k), ("v", v)):
        if t.get_device() != dev or t.dtype != q.dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype} on {t.device}, q {q.dtype} on "
                             f"{q.device}")
    # the kernel reads the mask as bool (a contiguous bool mask as it is) or none
    kpad = key_padding_mask
    if kpad is not None and not (kpad.dtype == torch.bool and kpad.get_device() == dev
                                 and kpad.is_contiguous()):
        kpad = kpad.to(device=q.device, dtype=torch.bool).contiguous()
    d8 = -(-d // 8) * 8
    q, k, v = (_pad_head(t, d8) for t in (q, k, v))
    # o in (B, S, H, D) memory, so that merging the heads back is a view; its
    # strides are known and aligned (D % 8 == 0)
    o = torch.empty_strided((b, h, s, d8), (s * h * d8, d8, h * d8, 1), dtype=q.dtype,
                            device=q.device)
    strides = (_window_strides(q, name) + _window_strides(k, name) + _window_strides(v, name)
               + (s * h * d8, d8, h * d8))
    lib = _kernels.library(name)
    rc = lib.small_attn_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if kpad is None else kpad.data_ptr(),
        o.data_ptr(), b, h, s, d8,
        *strides, scale, _kernels.dtype_code(q), _kernels.stream_of(q))
    # the wide-head window kernel's launches (the heads past the fixed
    # tiles), as the library counted them where it launched them
    launched = _kernels.body_launches(lib, ("wide_window",))
    _kernels.check(name, rc)
    _kernels.count_launch(name)
    for body, n in launched.items():
        _kernels.count_launch(body, n)
    return o if d8 == d else o[..., :d]


def _window_strides(t, name="small_attn"):
    """The (batch, head, row) element strides under which the window kernel
    reads or writes the (B, H, S, D) tensor ``t`` where it lies: the views
    of ``mha_plain``'s head split, strides (S*3C, D, 3C, 1), as well as
    contiguous tensors. The last dimension must be contiguous and the base
    and every stride 16-byte aligned (the kernel's 16-byte copies); anything
    else raises ``ValueError``, with no hidden copy. The stride of a
    dimension of size 1 is never used and is given as 0."""
    shape, st = t.shape, t.stride()
    if len(shape) != 4:
        raise ValueError(f"{name}: expected a (B, H, S, D) tensor, got {tuple(shape)}")
    if shape[3] > 1 and st[3] != 1:
        raise ValueError(f"{name}: the head dimension must be contiguous (stride "
                         f"{st[3]}); pass a view whose last dimension is dense")
    out = (st[0] if shape[0] > 1 else 0, st[1] if shape[1] > 1 else 0,
           st[2] if shape[2] > 1 else 0)
    size = t.element_size()
    if (t.data_ptr() | out[0] * size | out[1] * size | out[2] * size) % 16:
        raise ValueError(f"{name}: base or batch/head/row pitch of a {tuple(shape)} view "
                         f"with strides {st} is not 16-byte aligned")
    return out


def scaled_dot_attention(q, k, v, key_padding_mask=None, impl: Optional[str] = None):
    """The attention core over (B, H, S, D) under ``resolve_impl``. 'small'
    takes ``small_attention`` for a square window of S <= 128 and
    ``attention_plain`` otherwise (decoder cross-attention of another
    length, long sequences): the JAX dispatcher's rule
    (attention.py:1016-1017)."""
    sq, sk = q.shape[2], k.shape[2]
    impl = resolve_impl(impl, sq, sk, q.device)
    if impl == "flash":
        return flash_attention(q, k, v, key_padding_mask)
    if impl == "small" and sq == sk <= MAX_SMALL_S:
        return small_attention(q, k, v, key_padding_mask)
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


def mha_plain(x, kpad, w_in, b_in, w_out, b_out, num_heads, impl: Optional[str] = "xla",
              linear=F.linear):
    """The composition the kernel fuses: qkv = x W_in^T + b_in, per-head
    attention under the key padding, o W_out^T + b_out (torch layout). The
    core is ``scaled_dot_attention``'s under ``impl``: ``attention_plain``
    by default, as the kernel computes it. ``MultiHeadAttention`` passes
    ``quant.linear`` for its unfused path (the JAX ``quant.matmul`` hooks)."""
    q, k, v = linear(x, w_in, b_in).chunk(3, dim=-1)
    o = scaled_dot_attention(_split_heads(q, num_heads), _split_heads(k, num_heads),
                             _split_heads(v, num_heads), kpad, impl=impl)
    return linear(_merge_heads(o), w_out, b_out)


def mha_int8_plain(x, kpad, w_in, b_in, w_out, b_out, num_heads):
    """The int8 kernel's function written plainly (``_mha_kernel_int8``):
    qkv as the int8 product of the per-row quantized x and the per-row
    quantized w_in, ``float(acc) * xs * ws + b_in`` in float32; attention in
    float32 under the key padding (per window: a fully-masked window
    averages its own values); o cast to w_out's type; the out-projection
    exact. Reads no context."""
    acc, xs, ws = quant.int8_product(x, w_in)
    q, k, v = (acc.float() * xs * ws + b_in.float()).chunk(3, dim=-1)
    o = attention_plain(_split_heads(q, num_heads), _split_heads(k, num_heads),
                        _split_heads(v, num_heads), kpad)
    return F.linear(_merge_heads(o).to(w_out.dtype), w_out, b_out).to(x.dtype)


def _check_mha(name, x, key_padding_mask, w_in, b_in, w_out, b_out, num_heads, staged=(),
               **ln):
    """The wrappers' checks before a launch (``ln``: the block kernels'
    LayerNorm weight and bias); returns the int32 key padding. The
    out-projection stages W_out by cp.async, and the attention body the
    operands named in ``staged`` ('x', 'w_in'): each must be 16-byte
    aligned, in both types."""
    b, s, c = x.shape
    if not kernel_eligible(s, c, num_heads):
        raise ValueError(f"{name}: S={s}, C={c}, H={num_heads} outside the fused test "
                         f"S <= {MAX_FUSED_S}, C % 128 == 0, (C/H) % 8 == 0")
    if w_in.shape != (3 * c, c) or w_out.shape != (c, c):
        raise ValueError(f"{name}: weights {tuple(w_in.shape)}, {tuple(w_out.shape)} "
                         f"do not fit width {c}")
    if b_in.shape != (3 * c,) or b_out.shape != (c,):
        raise ValueError(f"{name}: biases {tuple(b_in.shape)}, {tuple(b_out.shape)} "
                         f"do not fit width {c}")
    if any(t.shape != (c,) for t in ln.values()):
        raise ValueError(f"{name}: LayerNorm parameters do not fit width {c}")
    _kernels.check_inference(name, x, w_in, b_in, w_out, b_out, *ln.values())
    _kernels.check_cuda_inputs(name, x.device, x.dtype, x=x, w_in=w_in, b_in=b_in,
                               w_out=w_out, b_out=b_out, **ln)
    operands = dict(x=x, w_in=w_in)
    _kernels.check_aligned(name, w_out=w_out, **{k: operands[k] for k in staged})
    if key_padding_mask is None:
        return torch.zeros((b, s), dtype=torch.int32, device=x.device)
    if key_padding_mask.shape != (b, s):
        raise ValueError(f"{name}: key_padding_mask {tuple(key_padding_mask.shape)} "
                         f"!= {(b, s)}")
    return key_padding_mask.to(device=x.device, dtype=torch.int32).contiguous()


def mha_scratch(x, int8: bool, num_heads: int):
    """The device scratch of one launch of the MHA family, for x (B, S, C):
    with ``int8`` the row prologue's output, xq (B*S, C) int8 and its
    scales xs (B*S,) float32; then the (B*S, C) o scratch in x's type that
    the out-projection reads, and the wide-head body's (B*S, 3C) qkv in x's
    type at a head size above ``MAX_TILE_HEAD_DIM``, else None (a null
    pointer: the library refuses a wide head without one). Fresh
    allocations: 16-byte aligned."""
    b, s, c = x.shape
    attn = torch.empty((b * s, c), dtype=x.dtype, device=x.device)
    qkv = (torch.empty((b * s, 3 * c), dtype=x.dtype, device=x.device)
           if c // num_heads > MAX_TILE_HEAD_DIM else None)
    if not int8:
        return attn, qkv
    return (torch.empty((b * s, c), dtype=torch.int8, device=x.device),
            torch.empty((b * s,), dtype=torch.float32, device=x.device), attn, qkv)


def wide_linear_plain(a, w, bias, res=None):
    """The wide-head bodies' GEMM written plainly: a . w^T + bias (+ res)
    summed in float32 and rounded once to a's type (bf16), the kernels'
    order."""
    y = torch.matmul(a.float(), w.float().t()) + bias.float()
    if res is not None:
        y = y + res.float()
    return y.to(a.dtype)


def wide_linear(a, w, bias, res=None):
    """y (M, N) = a (M, K) . w (N, K)^T + bias (+ res) in bfloat16 or
    float32: the GEMM that the MHA family's wide-head bodies run for their
    projections (``csrc/wgmma_linear.cuh``: wgmma fed by TMA; float32 in
    3xTF32, counted as ``wgmma_linear_tf32``), alone. CPU tensors take
    ``wide_linear_plain``; CUDA tensors launch the kernel of a's type or
    raise (an encode or launch error included)."""
    name = "wgmma_linear_tf32" if a.dtype == torch.float32 else "wgmma_linear"
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1] or bias.shape != (w.shape[0],):
        raise ValueError(f"{name}: a {tuple(a.shape)}, w {tuple(w.shape)}, bias "
                         f"{tuple(bias.shape)} do not fit")
    m, n = a.shape[0], w.shape[0]
    if res is not None and res.shape != (m, n):
        raise ValueError(f"{name}: res {tuple(res.shape)} != {(m, n)}")
    if a.device.type == "cpu":
        return wide_linear_plain(a, w, bias, res)
    if n % 8 or a.shape[1] % 8:
        raise ValueError(f"{name}: N {n} and K {a.shape[1]} must be multiples of 8")
    _kernels.check_inference(name, a, w, bias, *(() if res is None else (res,)))
    extra = {} if res is None else {"res": res}
    dtype = torch.float32 if name == "wgmma_linear_tf32" else torch.bfloat16
    _kernels.check_cuda_inputs(name, a.device, dtype, a=a, w=w, bias=bias, **extra)
    _kernels.check_aligned(name, a=a, w=w)
    y = a.new_empty((m, n))
    lib = _kernels.library("fused_mha")
    rc = getattr(lib, f"{name}_forward")(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), None if res is None else res.data_ptr(),
        y.data_ptr(), m, n, a.shape[1], _kernels.stream_of(a))
    launched = _kernels.body_launches(lib, (name,))[name]  # as the library counted them
    _kernels.check(name, rc)
    _kernels.count_launch(name, launched)
    return y


def _launch_mha(name, x, key_padding_mask, w_in, b_in, w_out, b_out, num_heads, *, ln=None,
                int8=False):
    """One call of the MHA family: the checks, W_in (quantized and cached
    with ``int8``), the scratch, then the C function ``<name>_forward`` of
    library ``name`` (built at first use, after the checks) and the count. Its
    pointers: x, the key padding, the LayerNorm (``ln``, by name: the block
    bodies), W_in or its int8 values and scales, b_in, W_out, b_out, the
    scratch, out (and x_norm with ``ln``). In both types the exact bodies'
    tile copies W_in by cp.async (the int8 bodies' bf16 tile the fresh int8
    W_in and xq; their f32 body reads plainly), fused MHA's tile x (the
    block bodies' tile the fresh x_norm), and the block bodies'
    out-projection reads x, its residual, as pairs: those operands are
    checked for alignment. Returns out, or (out, x_norm)."""
    ln = ln or {}
    staged = tuple(k for k, on in (("x", bool(ln) or not int8), ("w_in", not int8)) if on)
    kpad = _check_mha(name, x, key_padding_mask, w_in, b_in, w_out, b_out, num_heads,
                      staged=staged, **ln)
    b, s, c = x.shape
    w = quant.quantized_weight(w_in) if int8 else (w_in,)
    outs = (torch.empty_like(x), torch.empty_like(x)) if ln else (torch.empty_like(x),)
    lib = _kernels.library(name)
    ptrs = [None if t is None else t.data_ptr()
            for t in (x, kpad, *ln.values(), *w, b_in, w_out, b_out,
                      *mha_scratch(x, int8, num_heads), *outs)]
    rc = getattr(lib, f"{name}_forward")(*ptrs, b, s, c, num_heads, _kernels.dtype_code(x),
                                         _kernels.stream_of(x))
    # the wide bodies' launches in this call (the wgmma GEMMs of the
    # projections, the window kernel), as the library counted them where it
    # launched them
    launched = _kernels.body_launches(lib, _kernels.BODY_COUNTERS)
    _kernels.check(name, rc)
    _kernels.count_launch(name)
    for body, n in launched.items():
        _kernels.count_launch(body, n)
    return outs if ln else outs[0]


def fused_mha(x, key_padding_mask, w_in, b_in, w_out, b_out, num_heads):
    """Whole-MHA window self-attention, S <= 128: x (B, S, C), weights in
    torch layout. CPU tensors take ``mha_plain``; CUDA tensors launch the
    kernel or raise."""
    if x.device.type == "cpu":
        return mha_plain(x, key_padding_mask, w_in, b_in, w_out, b_out, num_heads)
    return _launch_mha("fused_mha", x, key_padding_mask, w_in, b_in, w_out, b_out, num_heads)


def fused_mha_int8(x, key_padding_mask, w_in, b_in, w_out, b_out, num_heads):
    """The int8-qkv whole MHA over windows of S <= 128, inference only. CPU
    tensors take ``mha_int8_plain``; CUDA tensors launch the kernel or
    raise, with w_in quantized once per weight version. An input that
    requires grad raises on either device: the int8 product has no
    gradient."""
    name = "fused_mha_int8"
    _kernels.check_inference(name, x, w_in, b_in, w_out, b_out)
    if x.device.type == "cpu":
        return mha_int8_plain(x, key_padding_mask, w_in, b_in, w_out, b_out, num_heads)
    return _launch_mha(name, x, key_padding_mask, w_in, b_in, w_out, b_out, num_heads,
                       int8=True)


def kernel_eligible(s: int, c: int, num_heads: int) -> bool:
    """The JAX module's fused-MHA test (attention.py:1082-1085: S <= 128,
    C % 128 == 0, Dh % 8 == 0). No row-count gate: the TPU's was a TPU
    measurement."""
    if c % num_heads:
        return False
    return 1 <= s <= MAX_FUSED_S and c % 128 == 0 and (c // num_heads) % 8 == 0


# ---------------------------------------------------------------------------
# whole-block first half: (x + MHA(LN_1(x)), LN_1(x))
# ---------------------------------------------------------------------------


def block_fusion_mode(impl: Optional[str], s: int, c: int, num_heads: int) -> Optional[str]:
    """The whole-block test (the counterpart of ``block_fusion_mode``,
    attention.py:860-887): None, 'exact' or 'int8'. Only an explicit
    'fused' on a window the fused-MHA test admits; 'exact' in the default
    matmul context, 'int8' in an int8 one whose policy quantizes the qkv
    product (3C >= min_cols) but not the N = C ones (C < min_cols), which
    also selects c_fc (4C >= min_cols); any other int8 policy gives None."""
    check_impl(impl)
    if impl != "fused" or not kernel_eligible(s, c, num_heads):
        return None
    if quant.current_impl() == "default":
        return "exact"
    return "int8" if quant.kernel_gate(3 * c, c) else None


def _block_attn_tail(x, xn, qkv, kpad, w_out, b_out, num_heads):
    """Per-window attention of the float32 qkv, o rounded to W_out's type,
    then o . W_out^T + b_out + x summed in float32 and rounded once
    (attention.py:604-613); returns (out, xn) in x's type."""
    q, k, v = qkv.chunk(3, dim=-1)
    o = attention_plain(_split_heads(q, num_heads), _split_heads(k, num_heads),
                        _split_heads(v, num_heads), kpad)
    o = _merge_heads(o).to(w_out.dtype).float()
    out = F.linear(o, w_out.float(), b_out.float()) + x.float()
    return out.to(x.dtype), xn.to(x.dtype)


def block_attn_plain(x, kpad, ln_w, ln_b, w_in, b_in, w_out, b_out, num_heads):
    """The block kernel's function written plainly (``_block_attn_kernel``):
    xn = LN_1(x) in float32, rounded to x's type for the qkv product, which
    accumulates in float32; per-window attention in float32 (a fully-masked
    window averages its own values); then ``_block_attn_tail``.
    Differentiable."""
    xn = layernorm_f32(x, ln_w, ln_b).to(x.dtype)
    qkv = F.linear(xn.float(), w_in.float(), b_in.float())
    return _block_attn_tail(x, xn, qkv, kpad, w_out, b_out, num_heads)


def block_attn_int8_plain(x, kpad, ln_w, ln_b, w_in, b_in, w_out, b_out, num_heads):
    """The int8 block kernel's function written plainly
    (``_block_attn_kernel_int8``): the float32 xn = LN_1(x), unrounded,
    quantized per row, qkv = float(acc) * xs * ws + b_in; the rest as
    ``block_attn_plain``. Reads no context."""
    xn = layernorm_f32(x, ln_w, ln_b)
    acc, xs, ws = quant.int8_product(xn, w_in)
    qkv = acc.float() * xs * ws + b_in.float()
    return _block_attn_tail(x, xn, qkv, kpad, w_out, b_out, num_heads)


def fused_block_attn(x, key_padding_mask, ln_w, ln_b, w_in, b_in, w_out, b_out, num_heads,
                     int8_qkv: bool = False):
    """(x + MHA(LN_1(x)), LN_1(x)) over windows of S <= 128 in one call
    (the counterpart of ``fused_block_attn``, attention.py:927), torch
    weight layout, both outputs in x's type. CPU tensors take
    ``block_attn_plain`` (``block_attn_int8_plain`` with ``int8_qkv``);
    CUDA tensors call ``csrc/block_attn.cu`` (``block_attn_int8.cu``): the
    row prologue, the attention body and the out-projection with the
    residual, or raise. Inference-only on the card; the int8 body raises
    under grad on either device."""
    name = "block_attn_int8" if int8_qkv else "block_attn"
    weights = (ln_w, ln_b, w_in, b_in, w_out, b_out)
    if int8_qkv:
        _kernels.check_inference(name, x, *weights)
    if x.device.type == "cpu":
        plain = block_attn_int8_plain if int8_qkv else block_attn_plain
        return plain(x, key_padding_mask, *weights, num_heads)
    return _launch_mha(name, x, key_padding_mask, w_in, b_in, w_out, b_out, num_heads,
                       ln=dict(ln_w=ln_w, ln_b=ln_b), int8=int8_qkv)


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
        """``impl``: None or 'auto', 'xla', 'flash', 'small' or 'fused'. The fused-MHA
        kernels run under 'auto' outside ``disable_fused_kernels()`` and
        under an explicit 'fused' even inside it (attention.py:1079-1106):
        ``fused_mha`` in the default matmul context, ``fused_mha_int8`` in
        an int8 one that quantizes the qkv product but not the
        out-projection; 'xla', 'flash', 'small' and any other int8 policy
        take the unfused projections (``quant.linear``) and that attention core
        ('fused' resolving as 'auto' there)."""
        c = query.shape[-1]
        h = self.num_heads
        w_in, b_in = self.in_proj_weight, self.in_proj_bias
        w_out, b_out = self.out_proj.weight, self.out_proj.bias
        if query is key and key is value:
            wanted = impl == "fused" or (impl in (None, "auto") and not fused_kernels_disabled())
            if wanted and kernel_eligible(query.shape[1], c, h):
                if quant.current_impl() == "default":
                    return fused_mha(query, key_padding_mask, w_in, b_in, w_out, b_out, h)
                if quant.kernel_gate(3 * c, c):
                    return fused_mha_int8(query, key_padding_mask, w_in, b_in, w_out, b_out,
                                          h)
            return mha_plain(query, key_padding_mask, w_in, b_in, w_out, b_out, h, impl=impl,
                             linear=quant.linear)
        # cross-attention (the XLA branch of the JAX module): q and kv (or q,
        # k, v) projected apart
        if key is value:
            q = quant.linear(query, w_in[:c], b_in[:c])
            k, v = quant.linear(key, w_in[c:], b_in[c:]).chunk(2, dim=-1)
        else:
            q = quant.linear(query, w_in[:c], b_in[:c])
            k = quant.linear(key, w_in[c:2 * c], b_in[c:2 * c])
            v = quant.linear(value, w_in[2 * c:], b_in[2 * c:])
        o = scaled_dot_attention(_split_heads(q, h), _split_heads(k, h),
                                 _split_heads(v, h), key_padding_mask, impl=impl)
        return quant.linear(_merge_heads(o), w_out, b_out)
