"""Fused transformer MLP: c_fc -> QuickGELU -> c_proj without the hidden
activation reaching device memory.

Counterpart of ``exoground_tpu/ops/fused_mlp.py`` (reference
model/tfm_model.py:23-27). ``fused_mlp`` launches the hand-written kernel in
``csrc/fused_mlp.cu`` on CUDA tensors and takes ``mlp_plain``, the
composition it fuses, only for tensors on the CPU. Inference-only, as the
TPU kernel is (its custom VJP recomputes the XLA path): a CUDA input that
requires grad raises. The train step differentiates inside
``disable_fused_kernels()``, where ``MLP`` and ``MultiHeadAttention`` take
their plain compositions, as the JAX package's train steps trace under its
context of the same name (exoground_tpu/ops/fused_mlp.py:37-58).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from exoground_tpu_torch.ops import _kernels
from exoground_tpu_torch.ops.activations import quick_gelu


_CTX = threading.local()


def fused_kernels_disabled() -> bool:
    """True inside ``disable_fused_kernels()`` on this thread."""
    return getattr(_CTX, "disabled", False)


@contextlib.contextmanager
def disable_fused_kernels():
    """Thread-local off-switch for the inference kernels' dispatch: inside
    it ``MLP`` and ``MultiHeadAttention`` take their plain compositions on
    every device. The train step runs its forwards (the no-grad EMA teacher
    included) inside it, as the JAX package does."""
    prev = fused_kernels_disabled()
    _CTX.disabled = True
    try:
        yield
    finally:
        _CTX.disabled = prev


def mlp_plain(x, fc_w, fc_b, pr_w, pr_b) -> torch.Tensor:
    """The straight-line composition (counterpart of ``_mlp_xla``); torch
    weight layout: fc_w (4C, C), pr_w (C, 4C)."""
    h = quick_gelu(F.linear(x, fc_w, fc_b))
    return F.linear(h.to(pr_w.dtype), pr_w, pr_b).to(x.dtype)


def kernel_eligible(width: int) -> bool:
    """The JAX ``MLP``'s fused test (fused_mlp.py:83: width % 128 == 0);
    other widths take the plain composition on every device, as they stay
    on XLA there."""
    return width % 128 == 0


def fused_mlp(x, fc_w, fc_b, pr_w, pr_b) -> torch.Tensor:
    """QuickGELU MLP over (..., C) with the (rows, 4C) hidden kept on chip."""
    if x.device.type == "cpu":
        return mlp_plain(x, fc_w, fc_b, pr_w, pr_b)
    name = "fused_mlp"
    c = x.shape[-1]
    if not kernel_eligible(c):
        raise ValueError(f"{name}: width {c} is not a multiple of 128")
    if fc_w.shape != (4 * c, c) or pr_w.shape != (c, 4 * c):
        raise ValueError(f"{name}: weights {tuple(fc_w.shape)}, {tuple(pr_w.shape)} "
                         f"do not fit width {c}")
    if fc_b.shape != (4 * c,) or pr_b.shape != (c,):
        raise ValueError(f"{name}: biases {tuple(fc_b.shape)}, {tuple(pr_b.shape)} "
                         f"do not fit width {c}")
    _kernels.check_inference(name, x, fc_w, fc_b, pr_w, pr_b)
    x2d = x.reshape(-1, c)
    _kernels.check_cuda_inputs(name, x.device, x.dtype, x=x2d, fc_w=fc_w,
                               fc_b=fc_b, pr_w=pr_w, pr_b=pr_b)
    code = _kernels.dtype_code(x2d)
    out = torch.empty_like(x2d)
    rc = _kernels.library(name).fused_mlp_forward(
        x2d.data_ptr(), fc_w.data_ptr(), fc_b.data_ptr(), pr_w.data_ptr(),
        pr_b.data_ptr(), out.data_ptr(), x2d.shape[0], c, code,
        _kernels.stream_of(x2d))
    _kernels.check(name, rc)
    _kernels.LAUNCHES[name] += 1
    return out.reshape(x.shape)
