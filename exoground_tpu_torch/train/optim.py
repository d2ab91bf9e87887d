"""Optimizer policies, the LR schedule and the fused AdamW(+EMA) step.

Counterpart of ``exoground_tpu/train/optim.py`` (reference train/main.py:
350-376, 500-513), on dictionaries of named tensors:

  * AdamW with two groups: no weight decay for LayerNorm parameters,
    biases, logit/entropy scales; decay for the rest;
  * the 'bce' policy trains only the binary alignability head;
  * LR: linear warmup, then cosine to 0 over the total iterations.

``FusedAdamWEMA`` is the JAX package's single-pass update. XLA fuses it
elementwise there, with no Pallas kernel; here its counterpart is
PyTorch's multi-tensor ``torch._foreach_*`` ops, one pass per group of
parameters that share their decay and train flags. It updates the
parameters, the moments and the EMA twin in place. The schedule and the
bias corrections are computed in float32, as the JAX step computes them.

The optax chain ``make_optimizer`` (gradient accumulation, global-norm
clipping) waits for a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional

import numpy as np
import torch

NO_DECAY = ("ln_", "bias", "logit_scale", "entropy_scale")


def _has(name: str, substrings: Iterable[str]) -> bool:
    return any(s in name for s in substrings)


def weight_decay_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """True where weight decay applies (reference no_decay list main.py:352)."""
    return {k: not _has(k, NO_DECAY) for k in params}


def trainable_mask(params: Dict[str, torch.Tensor], policy: str = "default") -> Dict[str, bool]:
    """'bce' freezes everything except the binary head (main.py:360-372)."""
    if policy == "default":
        return {k: True for k in params}
    if policy == "bce":
        return {k: _has(k, ("binary_head",)) for k in params}
    raise ValueError(policy)


def warmup_cosine_schedule(base_lr: float, total_iterations: int,
                           warmup_iterations: int = 1000):
    """lr(step): base * step/warmup, then base * 0.5 * (1 + cos(pi *
    (step - warmup) / (total - warmup))) (reference main.py:502-509), in
    float32."""
    f32 = np.float32

    def fn(step: int) -> float:
        step = f32(step)
        if step < warmup_iterations:
            return float(f32(base_lr) * (step / f32(max(warmup_iterations, 1))))
        denom = f32(max(total_iterations - warmup_iterations, 1))
        cos = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * (step - f32(warmup_iterations))
                                             / denom))
        return float(f32(base_lr) * cos)

    return fn


@dataclasses.dataclass
class FusedAdamWState:
    count: int  # shared by the Adam bias correction and the LR schedule
    mu: Dict[str, torch.Tensor]  # first moment (moment dtype)
    nu: Dict[str, torch.Tensor]  # second moment (moment dtype)


class FusedAdamWEMA:
    """AdamW (+ optional EMA twin) in one multi-tensor pass per group.

    Same update as the JAX package's ``FusedAdamWEMA``: per-parameter clip,
    AdamW with the two-group decay mask and the warmup-cosine schedule (lr
    read before the count increments, so step 0 has lr 0 under warmup),
    policy freeze (the update is zeroed, not the moments), then the EMA
    teacher from the new parameters. Moments are float32 or bfloat16; the
    update math runs in float32. The S3D backbone's second LR group waits
    for the S3D slice.

    API: ``init(params) -> state``; ``step(params, state, grads, target,
    ema_momentum) -> (params, state, target)``, with every tensor updated
    in place and returned.
    """

    def __init__(self, params: Dict[str, torch.Tensor], lr: float = 1e-4,
                 weight_decay: float = 1e-5, total_iterations: int = 100_000,
                 warmup_iterations: int = 1000, policy: str = "default", betas=(0.9, 0.999),
                 eps: float = 1e-8, grad_clip: Optional[float] = None,
                 moment_dtype: str = "float32"):
        self.schedule = warmup_cosine_schedule(lr, total_iterations, warmup_iterations)
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.moment_dtype = getattr(torch, moment_dtype)
        wd = weight_decay_mask(params)
        train = trainable_mask(params, policy)
        groups: Dict[tuple, list] = {}
        for k in params:
            groups.setdefault((wd[k], train[k]), []).append(k)
        self._groups = [(names, *flags) for flags, names in groups.items()]

    def init(self, params: Dict[str, torch.Tensor]) -> FusedAdamWState:
        def zeros():
            return {k: torch.zeros_like(v, dtype=self.moment_dtype) for k, v in params.items()}

        return FusedAdamWState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], state: FusedAdamWState,
             grads: Dict[str, torch.Tensor], target: Optional[Dict[str, torch.Tensor]] = None,
             ema_momentum: Optional[float] = None):
        """One optimizer (+EMA) step, in place. A missing or None grad counts
        as zero, as JAX differentiates a parameter the loss does not reach."""
        f32 = np.float32
        lr = self.schedule(state.count)
        count = state.count + 1
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        do_ema = target is not None and ema_momentum is not None
        f32_moments = self.moment_dtype == torch.float32
        for names, wd_on, trainable in self._groups:
            p = [params[k] for k in names]
            g = [grads[k].float() if grads.get(k) is not None else torch.zeros_like(params[k])
                 for k in names]
            if self.grad_clip:  # per-parameter DINO clip (train_utils.py:3-13)
                norms = torch._foreach_norm(g)
                coef = [torch.clamp(self.grad_clip / (n + 1e-6), max=1.0) for n in norms]
                g = torch._foreach_mul(g, coef)
            m = [state.mu[k] if f32_moments else state.mu[k].float() for k in names]
            v = [state.nu[k] if f32_moments else state.nu[k].float() for k in names]
            torch._foreach_mul_(m, self.b1)
            torch._foreach_add_(m, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(v, self.b2)
            torch._foreach_addcmul_(v, g, g, value=1.0 - self.b2)
            denom = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(m, bc1)
            torch._foreach_div_(upd, denom)
            if wd_on and self.weight_decay:
                torch._foreach_add_(upd, p, alpha=self.weight_decay)
            if trainable:
                torch._foreach_add_(p, upd, alpha=-lr)
            if not f32_moments:
                for k, mk, vk in zip(names, m, v):
                    state.mu[k].copy_(mk)
                    state.nu[k].copy_(vk)
            if do_ema:
                t = [target[k] for k in names]
                torch._foreach_mul_(t, ema_momentum)
                torch._foreach_add_(t, p, alpha=1.0 - ema_momentum)
        state.count = count
        return params, state, target


def make_fused_optimizer(params: Dict[str, torch.Tensor], lr: float = 1e-4,
                         weight_decay: float = 1e-5, total_iterations: int = 100_000,
                         warmup_iterations: int = 1000, policy: str = "default",
                         betas=(0.9, 0.999), grad_clip: Optional[float] = None,
                         grad_clip_mode: str = "per_param", accumulate_steps: int = 1,
                         moment_dtype: str = "float32") -> Optional[FusedAdamWEMA]:
    """FusedAdamWEMA with the JAX ``make_optimizer`` signature (less the S3D
    backbone LR), or None when the configuration needs the optax chain
    (gradient accumulation, global-norm clipping), which the port does not
    have yet."""
    if accumulate_steps > 1:
        return None
    if grad_clip and grad_clip_mode != "per_param":
        return None
    return FusedAdamWEMA(
        params, lr=lr, weight_decay=weight_decay, total_iterations=total_iterations,
        warmup_iterations=warmup_iterations, policy=policy, betas=betas,
        grad_clip=grad_clip, moment_dtype=moment_dtype)
