"""Optimizer policies, the LR schedule, the fused AdamW(+EMA) step and the
optax chain.

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
bias corrections are computed on the host in float32, as the JAX step
computes them, and reach the update as one small float32 tensor on the
parameters' device (``scalars`` / ``apply``): a captured CUDA graph reads
each replay's values from it, and the eager step divides by the same tensor
(a CUDA division by a Python scalar multiplies by its reciprocal instead).

``make_optimizer`` is the JAX package's optax chain (per-parameter or
global-norm clip, AdamW, policy freeze, and ``optax.MultiSteps`` gradient
accumulation for ``--backprop_freq``), reproduced operation by operation
on the same ``torch._foreach_*`` ops behind the same protocol, so the train
steps drive either optimizer without a branch (``OptaxChain``).
``optimizer_state_dict`` / ``adapt_optimizer_state`` write either state to
a checkpoint and carry count / mu / nu across the two layouts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from exoground_tpu_torch.train.checkpoint import restore_into
from exoground_tpu_torch.utils.device import to_device

NO_DECAY = ("ln_", "bias", "logit_scale", "entropy_scale")
# the parameters that ``backbone_lr`` puts on the second LR: the S3D trunk
BACKBONE_KEYS = ("s3d",)


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
    update math runs in float32. ``backbone_lr`` (the S3D finetune's
    --lr_backbone) puts every parameter whose name holds one of
    ``BACKBONE_KEYS`` on a second LR: its step, decay included, is scaled by
    ``backbone_lr / lr`` (the JAX ``_lr_scale``, optim.py:163-170).

    API: ``init(params) -> state``; ``step(params, state, grads, target,
    ema_momentum) -> (params, state, target)``, with every tensor updated
    in place and returned. ``apply(..., casts=)`` also writes the new
    parameters (and the new EMA twin) into the compute-dtype copies of
    ``casts`` in the same pass: the carried casts of a group of steps
    (``parallel/train_step.py::_CarriedCasts``; the JAX ``step(...,
    cast_dtype=)``, optim.py:181-239).
    """

    def __init__(self, params: Dict[str, torch.Tensor], lr: float = 1e-4,
                 weight_decay: float = 1e-5, total_iterations: int = 100_000,
                 warmup_iterations: int = 1000, policy: str = "default", betas=(0.9, 0.999),
                 eps: float = 1e-8, grad_clip: Optional[float] = None,
                 backbone_lr: Optional[float] = None, moment_dtype: str = "float32"):
        self.schedule = warmup_cosine_schedule(lr, total_iterations, warmup_iterations)
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.moment_dtype = getattr(torch, moment_dtype)
        wd = weight_decay_mask(params)
        train = trainable_mask(params, policy)
        factor = backbone_lr / lr if backbone_lr is not None and backbone_lr != lr else None
        groups: Dict[tuple, list] = {}
        for k in params:
            scale = factor if factor is not None and _has(k, BACKBONE_KEYS) else None
            groups.setdefault((wd[k], train[k], scale), []).append(k)
        self._groups = [(names, *flags) for flags, names in groups.items()]
        self._names = [k for names, *_ in self._groups for k in names]

    def init(self, params: Dict[str, torch.Tensor]) -> FusedAdamWState:
        def zeros():
            return {k: torch.zeros_like(v, dtype=self.moment_dtype) for k, v in params.items()}

        return FusedAdamWState(count=0, mu=zeros(), nu=zeros())

    def scalars(self, count: int) -> np.ndarray:
        """(lr, bc1, bc2) of the step that reads ``count`` (lr before the
        count increments, the bias corrections after), float32."""
        f32 = np.float32
        return np.array([self.schedule(count), f32(1.0) - f32(self.b1) ** f32(count + 1),
                         f32(1.0) - f32(self.b2) ** f32(count + 1)], np.float32)

    def _dense_grads(self, params, grads) -> list:
        """Float32 grads in ``_names`` order; a missing or None grad counts
        as zero, as JAX differentiates a parameter the loss does not reach."""
        return [grads[k].float() if grads.get(k) is not None else torch.zeros_like(params[k])
                for k in self._names]

    def _clip(self, g: list) -> list:
        if not self.grad_clip:
            return g
        norms = torch._foreach_norm(g)  # per-parameter DINO clip (train_utils.py:3-13)
        return torch._foreach_mul(g, [torch.clamp(self.grad_clip / (n + 1e-6), max=1.0)
                                      for n in norms])

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], state: FusedAdamWState,
             grads: Dict[str, torch.Tensor], target: Optional[Dict[str, torch.Tensor]] = None,
             ema_momentum: Optional[float] = None):
        """One optimizer (+EMA) step, in place."""
        dev = next(iter(params.values())).device
        self.apply(params, state, grads, to_device(self.scalars(state.count), dev), target,
                   ema_momentum)
        state.count += 1
        return params, state, target

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor], state: FusedAdamWState,
              grads: Dict[str, torch.Tensor], scalars: torch.Tensor,
              target: Optional[Dict[str, torch.Tensor]] = None,
              ema_momentum: Optional[float] = None, casts: Optional[Dict] = None) -> None:
        """The update of ``step`` from ``scalars`` (``scalars(state.count)``
        on the parameters' device), with no host work and no host read:
        ``state.count`` is the caller's to advance. ``casts`` ({'params':
        ..., 'target': ...}, compute-dtype tensors by name) receive the new
        parameters and, when the twin moves, the new twin."""
        lr, bc1, bc2 = scalars.unbind(0)[:3]
        self._update(params, state, self._clip(self._dense_grads(params, grads)), lr, bc1, bc2,
                     target, ema_momentum, casts=casts)

    @staticmethod
    def _scale_by_lr(upd: list, lr: torch.Tensor, scale: Optional[float]) -> None:
        """``upd *= lr * scale`` as the fused JAX step multiplies: the
        learning rate of the parameter's group first."""
        torch._foreach_mul_(upd, lr if scale is None else lr * scale)

    def _update(self, params, state, g: list, lr, bc1, bc2, target, ema_momentum,
                emit=None, casts=None) -> None:
        """AdamW from the float32 grads ``g`` (``_names`` order), group by
        group, then the EMA twin. With ``emit`` (a 0-d 0/1 tensor, the optax
        chain's accumulation) the new moments are kept where it is 1, through
        ``torch.where`` as optax selects, and the step is scaled by it. With
        ``casts`` each group's new parameters (and twin) are copied into
        their compute-dtype casts."""
        g = dict(zip(self._names, g))
        do_ema = target is not None and ema_momentum is not None
        f32_moments = self.moment_dtype == torch.float32
        for names, wd_on, trainable, scale in self._groups:
            p = [params[k] for k in names]
            gg = [g[k] for k in names]
            m = [state.mu[k] if f32_moments else state.mu[k].float() for k in names]
            v = [state.nu[k] if f32_moments else state.nu[k].float() for k in names]
            if emit is None:
                torch._foreach_mul_(m, self.b1)
                torch._foreach_mul_(v, self.b2)
                m_new, v_new = m, v
            else:  # computed aside, then selected
                m_new, v_new = torch._foreach_mul(m, self.b1), torch._foreach_mul(v, self.b2)
            torch._foreach_add_(m_new, gg, alpha=1.0 - self.b1)
            torch._foreach_addcmul_(v_new, gg, gg, value=1.0 - self.b2)
            denom = torch._foreach_div(v_new, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(m_new, bc1)
            torch._foreach_div_(upd, denom)
            if wd_on and self.weight_decay:
                torch._foreach_add_(upd, p, alpha=self.weight_decay)
            if trainable:  # the policy freeze: a frozen parameter's update is zero
                self._scale_by_lr(upd, lr, scale)
                if emit is not None:
                    torch._foreach_mul_(upd, emit)
                torch._foreach_sub_(p, upd)
            if emit is not None:
                keep = emit > 0
                torch._foreach_copy_(m, [torch.where(keep, a, b) for a, b in zip(m_new, m)])
                torch._foreach_copy_(v, [torch.where(keep, a, b) for a, b in zip(v_new, v)])
            if not f32_moments:
                for k, mk, vk in zip(names, m, v):
                    state.mu[k].copy_(mk)
                    state.nu[k].copy_(vk)
            if do_ema:
                t = [target[k] for k in names]
                torch._foreach_mul_(t, ema_momentum)
                torch._foreach_add_(t, p, alpha=1.0 - ema_momentum)
            if casts is not None:
                torch._foreach_copy_([casts["params"][k] for k in names], p)
                if do_ema and "target" in casts:
                    torch._foreach_copy_([casts["target"][k] for k in names], t)


def make_fused_optimizer(params: Dict[str, torch.Tensor], lr: float = 1e-4,
                         weight_decay: float = 1e-5, total_iterations: int = 100_000,
                         warmup_iterations: int = 1000, policy: str = "default",
                         betas=(0.9, 0.999), grad_clip: Optional[float] = None,
                         grad_clip_mode: str = "per_param", accumulate_steps: int = 1,
                         backbone_lr: Optional[float] = None,
                         moment_dtype: str = "float32") -> Optional[FusedAdamWEMA]:
    """FusedAdamWEMA with the JAX ``make_fused_optimizer`` signature, or None
    when the configuration needs the optax chain (gradient accumulation,
    global-norm clipping): callers then take ``make_optimizer`` with the
    same arguments."""
    if accumulate_steps > 1:
        return None
    if grad_clip and grad_clip_mode != "per_param":
        return None
    return FusedAdamWEMA(
        params, lr=lr, weight_decay=weight_decay, total_iterations=total_iterations,
        warmup_iterations=warmup_iterations, policy=policy, betas=betas,
        grad_clip=grad_clip, backbone_lr=backbone_lr, moment_dtype=moment_dtype)


@dataclasses.dataclass
class ChainState:
    """The optax chain's state (``make_optimizer``).

    ``count`` is the mini-batches taken, one an ``apply``: the counter the
    train steps advance and hand to ``scalars``. Under accumulation over k
    mini-batches (``optax.MultiSteps``) the inner count, Adam's and the
    schedule's, is ``count // k`` and optax's ``mini_step`` ``count % k``
    (its ``gradient_step`` equals the inner count: k is constant).
    ``acc_grads`` is MultiSteps' running mean of the mini-batch grads, empty
    when k = 1. Moments and accumulator are float32."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    acc_grads: Dict[str, torch.Tensor]
    every_k: int = 1


class OptaxChain(FusedAdamWEMA):
    """The JAX ``make_optimizer`` chain (optax 0.2.6), operation by
    operation, behind ``FusedAdamWEMA``'s protocol (``init``,
    ``scalars(count)``, ``apply``, ``step``).

    Per mini-batch, with k = ``every_k``:

      * k > 1 (``optax.MultiSteps``): ``acc = acc + (g - acc) / (mini_step
        + 1)``, divided by a tensor as optax divides; the inner chain runs
        on this running mean on every mini-batch, branch-free, and its
        results are kept where ``emit = (mini_step == k - 1)``: the moments
        through ``torch.where``, the parameters move by ``emit * update``,
        then ``acc = (1 - emit) * acc``;
      * the clip, on the accumulated mean: per parameter (the DINO clip) or
        ``optax.clip_by_global_norm`` (``g`` where ``||g|| < max_norm``,
        else ``(g / ||g||) * max_norm``, the norm from ``torch._foreach_norm``
        and the select on the device, with no host read);
      * AdamW: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``,
        ``u = mu_hat / (sqrt(nu_hat) + eps)``, ``+ wd p`` under the decay
        mask, ``x -lr``; then ``x backbone_lr / lr`` for the backbone group
        (``scale_selected``, optim.py:83-101); the policy freeze zeroes the
        update of frozen parameters while their moments move.

    The host scalars (``scalars``) are (lr, bc1, bc2) of the inner count,
    and under k > 1 also emit and ``mini_step + 1``. The EMA twin follows
    the current parameters on every mini-batch, as the JAX step's optax
    branch updates it."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float = 1e-4,
                 weight_decay: float = 1e-5, total_iterations: int = 100_000,
                 warmup_iterations: int = 1000, policy: str = "default", betas=(0.9, 0.999),
                 grad_clip: Optional[float] = None, grad_clip_mode: str = "per_param",
                 every_k: int = 1, backbone_lr: Optional[float] = None):
        if grad_clip_mode not in ("per_param", "global"):
            raise ValueError(f"grad_clip_mode {grad_clip_mode!r}: per_param or global")
        super().__init__(params, lr=lr, weight_decay=weight_decay,
                         total_iterations=total_iterations,
                         warmup_iterations=warmup_iterations, policy=policy, betas=betas,
                         grad_clip=grad_clip, backbone_lr=backbone_lr,
                         moment_dtype="float32")
        self.grad_clip_mode = grad_clip_mode
        self.every_k = every_k

    def init(self, params: Dict[str, torch.Tensor]) -> ChainState:
        def zeros():
            return {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}

        return ChainState(count=0, mu=zeros(), nu=zeros(),
                          acc_grads=zeros() if self.every_k > 1 else {}, every_k=self.every_k)

    @staticmethod
    def _scale_by_lr(upd: list, lr: torch.Tensor, scale: Optional[float]) -> None:
        """``upd *= lr``, then the backbone group's ``*= scale``, as the
        chain's ``scale_by_learning_rate`` and ``scale_selected`` do."""
        torch._foreach_mul_(upd, lr)
        if scale is not None:
            torch._foreach_mul_(upd, scale)

    def scalars(self, count: int) -> np.ndarray:
        """(lr, bc1, bc2) of the inner count of mini-batch ``count``, and
        under accumulation (emit, mini_step + 1), float32."""
        inner, mini = divmod(count, self.every_k)
        adam = super().scalars(inner)
        if self.every_k == 1:
            return adam
        return np.concatenate([adam, np.array([mini == self.every_k - 1, mini + 1],
                                              np.float32)])

    def _clip(self, g: list) -> list:
        if self.grad_clip_mode != "global" or not self.grad_clip:
            return super()._clip(g)
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        trigger = g_norm < self.grad_clip
        clipped = torch._foreach_div(g, g_norm)
        torch._foreach_mul_(clipped, self.grad_clip)
        return [torch.where(trigger, a, b) for a, b in zip(g, clipped)]

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor], state: ChainState,
              grads: Dict[str, torch.Tensor], scalars: torch.Tensor,
              target: Optional[Dict[str, torch.Tensor]] = None,
              ema_momentum: Optional[float] = None, casts: Optional[Dict] = None) -> None:
        """The update of ``step`` from ``scalars`` (``scalars(state.count)``
        on the parameters' device), with no host work and no host read:
        ``state.count`` is the caller's to advance. ``casts`` as
        ``FusedAdamWEMA.apply``'s."""
        parts = scalars.unbind(0)
        g = self._dense_grads(params, grads)
        if self.every_k == 1:
            self._update(params, state, self._clip(g), *parts[:3], target, ema_momentum,
                         casts=casts)
            return
        emit, n = parts[3:]
        acc = [state.acc_grads[k] for k in self._names]
        step = torch._foreach_sub(g, acc)
        torch._foreach_div_(step, n)
        torch._foreach_add_(acc, step)  # the running mean
        self._update(params, state, self._clip(acc), *parts[:3], target, ema_momentum, emit,
                     casts)
        torch._foreach_mul_(acc, 1.0 - emit)


def make_optimizer(params: Dict[str, torch.Tensor], lr: float = 1e-4,
                   weight_decay: float = 1e-5, total_iterations: int = 100_000,
                   warmup_iterations: int = 1000, policy: str = "default",
                   betas=(0.9, 0.999), grad_clip: Optional[float] = None,
                   grad_clip_mode: str = "per_param", accumulate_steps: int = 1,
                   backbone_lr: Optional[float] = None) -> OptaxChain:
    """The JAX ``make_optimizer`` (``OptaxChain``): AdamW with the two-group
    decay and the warmup-cosine schedule, an optional per-parameter or
    global-norm clip, the policy freeze, and ``accumulate_steps`` k > 1 as
    ``optax.MultiSteps``, whose inner schedule counts real optimizer steps:
    its total and warmup are divided by k (at least 1 each), so warmup still
    spans the same mini-batches of data. ``backbone_lr`` (the S3D finetune's
    --lr_backbone) scales the step of the ``BACKBONE_KEYS`` parameters by
    ``backbone_lr / lr`` after AdamW, decay included."""
    if accumulate_steps > 1:
        total_iterations = max(1, total_iterations // accumulate_steps)
        warmup_iterations = max(1, warmup_iterations // accumulate_steps)
    return OptaxChain(params, lr=lr, weight_decay=weight_decay,
                      total_iterations=total_iterations, warmup_iterations=warmup_iterations,
                      policy=policy, betas=betas, grad_clip=grad_clip,
                      grad_clip_mode=grad_clip_mode, every_k=max(1, accumulate_steps),
                      backbone_lr=backbone_lr)


def optimizer_state_dict(state) -> Dict:
    """A ``FusedAdamWState`` or ``ChainState`` as a checkpoint holds it:
    ``count`` (Adam's and the schedule's, the inner count under
    accumulation), ``mu`` and ``nu``, and under accumulation ``mini_step``
    and ``acc_grads``, as the JAX chain's ``MultiStepsState`` holds them."""
    k = getattr(state, "every_k", 1)
    out = {"count": state.count // k, "mu": state.mu, "nu": state.nu}
    if k > 1:
        out.update(mini_step=state.count % k, acc_grads=state.acc_grads)
    return out


def adapt_optimizer_state(template, blob):
    """Restore a checkpoint's optimizer state (``optimizer_state_dict``'s
    layout, either optimizer's) into ``template``, a fresh state of the
    current optimizer, in place; the JAX ``adapt_optimizer_state``
    (:276-323) carries count / mu / nu across the fused and chain layouts in
    the same way. The count is carried as it is: a k = 1 count resumed under
    k > 1 becomes the inner count, in units of k mini-batches (and back),
    as in the JAX package. The accumulator and mini step are restored when
    both sides accumulate; otherwise accumulation starts afresh. Moments and
    accumulator load non-strictly (``restore_into``). Returns the template,
    or None when ``blob`` holds no Adam state."""
    if not isinstance(blob, dict) or not {"count", "mu", "nu"} <= set(blob):
        return None
    k = getattr(template, "every_k", 1)
    restore_into(template.mu, blob["mu"])
    restore_into(template.nu, blob["nu"])
    mini = 0
    if k > 1 and "acc_grads" in blob:
        restore_into(template.acc_grads, blob["acc_grads"])
        mini = int(blob.get("mini_step", 0))
    template.count = int(blob["count"]) * k + mini
    return template
