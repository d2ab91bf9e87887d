"""The int8 serving mode: dynamic int8 projections behind a thread-local
context.

Counterpart of ``exoground_tpu/ops/quant.py``. Every projection of the
transformer core that the JAX package routes through ``quant.matmul`` /
``dense_dot_general`` goes through :func:`linear` here (the unfused
self-attention, cross-attention and out-projections of
``MultiHeadAttention``, the plain ``MLP``, the two 4096-d pre-projections).
By default :func:`linear` is exactly ``F.linear``. Inside
``with matmul_impl("int8"):`` a product with at least ``min_cols`` output
columns instead

  * quantizes the activations per row (absmax / 127 over the contracted
    axis),
  * quantizes the weight per output channel,
  * multiplies int8 x int8 with int32 accumulation (exact in any order),
  * rescales in float32 and casts back to the activation's type, before
    the bias is added (``exoground_tpu/ops/quant.py:117``).

The fused int8 kernels (``attention.fused_mha_int8``,
``fused_mlp.fused_mlp_int8``) engage where the policy quantizes their wide
product but not their width-C one (:func:`kernel_gate`); they share these
quantizers. The MLP family's int8 kernels take their c_fc through
:func:`quantized_weight`, which quantizes a weight once per version.

The scales are IEEE quotients ``absmax / 127``, computed against a tensor
divisor: PyTorch's CUDA division by a Python scalar multiplies by the
reciprocal instead, which differs in the last bit for ~5% of values and
would let the kernels' quantization drift from this one.

The mode serves inference only: a product under the int8 context whose
inputs require grad raises.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Optional

import torch
import torch.nn.functional as F

# thread-local: the serving front runs a batch on whichever thread leads,
# and another thread's context must never leak into it
_STATE = threading.local()

VALID_IMPLS = ("default", "int8")

# 0 quantizes every projection (the JAX package's default); the serving
# configurations pass 1024, which at width 512 selects the fused qkv
# (N = 1536) and c_fc (N = 2048) products and keeps the N = 512 ones exact
INT8_MIN_COLS_DEFAULT = 0


@contextlib.contextmanager
def matmul_impl(name: str, min_cols: Optional[int] = None):
    """Select the projection lowering on this thread inside the block.
    ``min_cols``: under 'int8', products with fewer output columns stay
    exact."""
    if name not in VALID_IMPLS:
        raise ValueError(f"matmul impl must be one of {VALID_IMPLS}, got {name!r}")
    prev, prev_cols = current_impl(), current_min_cols()
    _STATE.impl = name
    _STATE.min_cols = INT8_MIN_COLS_DEFAULT if min_cols is None else min_cols
    try:
        yield
    finally:
        _STATE.impl = prev
        _STATE.min_cols = prev_cols


def current_impl() -> str:
    return getattr(_STATE, "impl", "default")


def current_min_cols() -> int:
    return getattr(_STATE, "min_cols", INT8_MIN_COLS_DEFAULT)


def kernel_gate(wide: int, width: int) -> bool:
    """True under an int8 context whose policy quantizes a kernel's wide
    product (``wide`` = 3C or 4C output columns) but not its width-C one:
    the JAX gates ``3C >= min_cols > C`` (attention.py:1098-1099) and
    ``4C >= min_cols > C`` (blocks.py:86-90)."""
    return current_impl() == "int8" and wide >= current_min_cols() > width


def _check_no_grad(*tensors: Optional[torch.Tensor]) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "the int8 serving mode is not differentiable: run it under "
            "torch.no_grad()/torch.inference_mode(), or leave matmul_impl('int8')")


def _absmax_scale(a: torch.Tensor, dim: int) -> torch.Tensor:
    absmax = a.abs().amax(dim=dim, keepdim=True)
    # an IEEE quotient: a tensor divisor, never a Python scalar (module doc)
    scale = absmax / absmax.new_full((), 127.0)
    return torch.where(absmax > 0, scale, torch.ones_like(scale))


def _quantize(a: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round and the kernels' rintf
    return torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)


def _quant_last_axis(x: torch.Tensor):
    """Symmetric int8 quantization of each row over the last axis: (int8
    values, float32 scales of shape (..., 1))."""
    xf = x.float()
    scale = _absmax_scale(xf, -1)
    return _quantize(xf, scale), scale


def _quant_first_axis(w: torch.Tensor):
    """Symmetric int8 quantization per output channel of a weight in torch
    layout (N, K): the reduction runs over dim 1, which is the JAX
    function's axis 0 of the (K, N) kernel. Returns (int8 (N, K), float32
    scales (N,))."""
    wf = w.float()
    scale = _absmax_scale(wf, 1)
    return _quantize(wf, scale), scale[:, 0]


# id(weight) -> (weakref to it, its stamp, its quantization); see quantized_weight
_WEIGHT_CACHE: dict = {}
# reentrant: a weakref callback may run inside a locked section (a collection
# triggered there) on the same thread
_WEIGHT_LOCK = threading.RLock()


def quantized_weight(w: torch.Tensor):
    """``_quant_first_axis(w)``, computed once per weight and version.

    The entry is keyed on ``id(w)`` and holds a weakref to w. It is used
    only while that weakref still gives w and w's ``_version`` (bumped by
    every in-place update), ``data_ptr``, shape, dtype and device are those
    it was made from; it is dropped when w dies. An inference tensor has no
    version counter, so it is quantized on every call and never cached."""
    if w.is_inference():
        return _quant_first_axis(w)
    key = id(w)
    stamp = (w._version, w.data_ptr(), tuple(w.shape), w.dtype, w.device)
    with _WEIGHT_LOCK:
        entry = _WEIGHT_CACHE.get(key)
    if entry is not None and entry[0]() is w and entry[1] == stamp:
        return entry[2]
    quantized = _quant_first_axis(w)

    def drop(ref, key=key):
        with _WEIGHT_LOCK:
            if _WEIGHT_CACHE.get(key, (None,))[0] is ref:
                del _WEIGHT_CACHE[key]

    with _WEIGHT_LOCK:
        _WEIGHT_CACHE[key] = (weakref.ref(w, drop), stamp, quantized)
    return quantized


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product a (M, K) . b (N, K)^T of int8 operands through
    ``torch._int_mm``. Its CUDA path wants M > 16 and K, N multiples of 8:
    zero rows and columns are padded in (exact) and cut off again."""
    m, k = a.shape
    n = b.shape[0]
    pm, pk, pn = max(m, 17) - m, -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pk, 0, pn))
    out = torch._int_mm(a.contiguous(), b.contiguous().t())
    return out[:m, :n] if pm or pn else out


def int8_product(x: torch.Tensor, w: torch.Tensor):
    """The quantized product both int8 routes share: x (..., K) and w (N, K)
    quantized, multiplied in int32; returns (int32 (..., N), x scales
    (..., 1), w scales (N,))."""
    xq, xs = _quant_last_axis(x)
    wq, ws = _quant_first_axis(w)
    acc = _int_mm(xq.reshape(-1, xq.shape[-1]), wq)
    return acc.reshape(*x.shape[:-1], w.shape[0]), xs, ws


def _int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) . w (N, K)^T with dynamic int8 quantization of both
    sides, rescaled in float32 and cast to x's type."""
    acc, xs, ws = int8_product(x, w)
    return (acc.float() * xs * ws).to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
    """Drop-in for ``F.linear`` honouring the thread's matmul impl: the
    int8 product (bias added after the cast, as the JAX Dense adds it) when
    the context is 'int8' and N >= min_cols, else exactly ``F.linear``."""
    if (current_impl() == "int8" and w.dim() == 2 and x.shape[-1] == w.shape[1]
            and w.shape[0] >= current_min_cols()):
        _check_no_grad(x, w, b)
        out = _int8_matmul(x, w)
        return out if b is None else out + b
    return F.linear(x, w, b)
