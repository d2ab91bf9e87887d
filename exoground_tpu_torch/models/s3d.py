"""S3D-G (MIL-NCE) video backbone and the Sentence_Embedding text module.

Counterpart of ``exoground_tpu/models/s3d.py`` (reference
model/s3d_milnce/s3dg.py:27-379 and the end2end wrappers), over NCDHW
tensors, the reference's own layout:

  * ``space_to_depth_3d`` folds 2x2x2 blocks into channels in the
    reference's order (s3dg.py:312-319), so ``conv1`` runs stride 1 on 24
    channels, then the TF-SAME crop ``[:, :, 1:, 1:, 1:]`` (:327-329);
  * ``same_maxpool`` is TF's SAME max-pool: the input padded with -inf,
    the smaller half of the padding on the left (flax ``padding='SAME'``),
    since ``F.max_pool3d``'s ``padding`` is symmetric;
  * BatchNorm has flax's semantics, not torch's: the running stats are an
    explicit ``batch_stats`` dictionary, never module buffers. Frozen
    (``train_bn=False``, the --freezeBN finetune) normalizes with them;
    under ``train_bn`` the layer normalizes with the batch's moments and
    returns new stats ``0.9 * old + 0.1 * batch`` (flax momentum 0.9), the
    batch variance biased, ``mean(x^2) - mean(x)^2`` in float32 (flax's
    fast variance), where ``F.batch_norm`` would store the unbiased one;
  * ``freeze_early`` detaches the trunk after ``mixed_3c`` (freeze_forward,
    s3dg.py:351-379), and those blocks keep their running stats even under
    ``train_bn`` (JAX :159): their grads come back zero, not missing.

Submodule names are the reference's (``conv1``, ``conv_2b``, ``conv_2c``,
``gating``, ``mixed_3b`` ... ``mixed_5c`` with ``conv_b0`` ... ``conv_b3_b``
and ``gating_b0-3``, ``fc``), so a MIL-NCE state dict maps one to one
(``utils/convert.py::convert_s3d_state_dict``); a BatchNorm's stats are
``<its name>.running_mean`` / ``.running_var``. The trunk is the MIL-NCE
one, gated and with space-to-depth: the JAX module's ``gating`` and
``space_to_depth`` fields, which no caller of either package turns off, are
not carried.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from exoground_tpu_torch.models.word2vec import word2vec_forward
from exoground_tpu_torch.utils.device import resolve_device

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's: new = 0.9 * old + 0.1 * batch (torch momentum 0.1)
STATS = ("running_mean", "running_var")


def _triple(v) -> Tuple[int, int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


class BatchNorm(nn.Module):
    """A BatchNorm's scale and bias; its stats live in ``batch_stats`` under
    ``key`` (the module's name in the trunk, set by ``S3D``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.key = ""


class _Norm:
    """The BatchNorms of one forward over ``stats``; under training the new
    running stats are collected in ``new``."""

    def __init__(self, stats: Dict[str, torch.Tensor]):
        self.stats = stats
        self.new: Dict[str, torch.Tensor] = {}

    def __call__(self, bn: BatchNorm, x: torch.Tensor, train: bool) -> torch.Tensor:
        mean_k, var_k = (f"{bn.key}.{s}" for s in STATS)
        dt = torch.promote_types(x.dtype, torch.float32)
        if not train:  # statistics and affine in float32 at least, the output in x's dtype
            return F.batch_norm(x, self.stats[mean_k].to(dt), self.stats[var_k].to(dt),
                                bn.weight.to(dt), bn.bias.to(dt), training=False, eps=BN_EPS)
        # flax's batch moments in float32, the fast variance: its rounding
        # (E[x^2] - E[x]^2 cancels where the variance is small) is the one
        # the reference's stats and outputs carry
        xf = x.to(dt)
        dims = (0, 2, 3, 4)
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        with torch.no_grad():
            for k, batch in ((mean_k, mean), (var_k, var)):
                old = self.stats[k]
                self.new[k] = (BN_MOMENTUM * old.to(xf.dtype) + (1.0 - BN_MOMENTUM) * batch).to(
                    old.dtype)
        shape = (1, -1, 1, 1, 1)
        mul = torch.rsqrt(var + BN_EPS) * bn.weight.to(xf.dtype)
        y = (xf - mean.view(shape)) * mul.view(shape) + bn.bias.to(xf.dtype).view(shape)
        return y.to(x.dtype)


class STConv3D(nn.Module):
    """Conv3d + BN + ReLU, or separated into a spatial (1, k, k) and a
    temporal (k, 1, 1) convolution, each with BN + ReLU (s3dg.py:93-150)."""

    def __init__(self, input_dim: int, output_dim: int, kernel_size: Sequence[int],
                 stride=1, padding=0, separable: bool = False):
        super().__init__()
        kt, kh, kw = kernel_size
        st, pd = _triple(stride), _triple(padding)
        self.separable = separable and kt != 1
        if self.separable:
            self.conv1 = nn.Conv3d(input_dim, output_dim, (1, kh, kw), stride=(1, st[1], st[2]),
                                   padding=(0, pd[1], pd[2]), bias=False)
            self.bn1 = BatchNorm(output_dim)
            self.conv2 = nn.Conv3d(output_dim, output_dim, (kt, 1, 1), stride=(st[0], 1, 1),
                                   padding=(pd[0], 0, 0), bias=False)
            self.bn2 = BatchNorm(output_dim)
        else:
            self.conv1 = nn.Conv3d(input_dim, output_dim, tuple(kernel_size), stride=st,
                                   padding=pd, bias=False)
            self.bn1 = BatchNorm(output_dim)

    def forward(self, x, norm: _Norm, train: bool):
        x = torch.relu(norm(self.bn1, self.conv1(x), train))
        if self.separable:
            x = torch.relu(norm(self.bn2, self.conv2(x), train))
        return x


class SelfGating(nn.Module):
    """sigmoid(fc(mean over T, H, W)) * x (s3dg.py:79-90)."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc = nn.Linear(dim, dim)

    def forward(self, x):
        w = torch.sigmoid(self.fc(x.mean(dim=(2, 3, 4))))
        return w[:, :, None, None, None] * x


class _OrderedMaxPool(torch.autograd.Function):
    """``F.max_pool3d`` whose backward adds in a fixed order. PyTorch's CUDA
    backward adds each window's gradient into its argmax with atomics, so
    where windows overlap and share an argmax the sum's order, and its last
    bits, change from run to run. Here the gradient is gathered offset by
    offset of the window: for each (dt, dh, dw), every window whose argmax
    sits at that offset adds into a strided view of the input's gradient."""

    @staticmethod
    def forward(ctx, x, kernel, stride):
        out, idx = F.max_pool3d(x, kernel, stride, return_indices=True)
        ctx.save_for_backward(idx)
        ctx.shape, ctx.kernel, ctx.stride = x.shape, kernel, stride
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        _, _, _, h, w = ctx.shape
        (kt, kh, kw), (st, sh, sw) = ctx.kernel, ctx.stride
        do, ho, wo = g.shape[2:]
        dev = g.device
        # flat index (within a channel) of each window's first element
        base = (torch.arange(do, device=dev).view(-1, 1, 1) * (st * h * w)
                + torch.arange(ho, device=dev).view(1, -1, 1) * (sh * w)
                + torch.arange(wo, device=dev).view(1, 1, -1) * sw)
        grad = g.new_zeros(ctx.shape)
        for dt in range(kt):
            for dh in range(kh):
                for dw in range(kw):
                    hit = idx == base + (dt * h * w + dh * w + dw)
                    grad[:, :, dt: dt + (do - 1) * st + 1: st, dh: dh + (ho - 1) * sh + 1: sh,
                         dw: dw + (wo - 1) * sw + 1: sw].add_(g * hit)
        return grad, None, None


def same_maxpool(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int]) -> torch.Tensor:
    """TF-SAME 3-D max-pool (reference MaxPool3dTFPadding, s3dg.py:153-183;
    flax ``nn.max_pool(padding='SAME')``): each of T, H, W padded with -inf
    by ``max((ceil(n / s) - 1) * s + k - n, 0)``, the smaller half first.
    Under ``torch.use_deterministic_algorithms(True)`` (where PyTorch's own
    CUDA backward, which adds with atomics, refuses to run) the backward
    adds in a fixed order (``_OrderedMaxPool``)."""
    pads = []
    for n, k, s in reversed(list(zip(x.shape[2:], kernel, stride))):  # F.pad: last dim first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, pads, value=float("-inf"))
    kernel, stride = tuple(kernel), tuple(stride)
    if torch.are_deterministic_algorithms_enabled() and torch.is_grad_enabled() and (
            x.requires_grad):
        return _OrderedMaxPool.apply(x, kernel, stride)
    return F.max_pool3d(x, kernel, stride)


class InceptionBlock(nn.Module):
    """The 4-branch S3D inception block with per-branch gating (s3dg.py:27-76)."""

    def __init__(self, input_dim: int, n0: int, n1a: int, n1b: int, n2a: int, n2b: int,
                 n3b: int):
        super().__init__()
        self.conv_b0 = STConv3D(input_dim, n0, (1, 1, 1))
        self.conv_b1_a = STConv3D(input_dim, n1a, (1, 1, 1))
        self.conv_b1_b = STConv3D(n1a, n1b, (3, 3, 3), padding=1, separable=True)
        self.conv_b2_a = STConv3D(input_dim, n2a, (1, 1, 1))
        self.conv_b2_b = STConv3D(n2a, n2b, (3, 3, 3), padding=1, separable=True)
        self.conv_b3_b = STConv3D(input_dim, n3b, (1, 1, 1))
        self.gating_b0 = SelfGating(n0)
        self.gating_b1 = SelfGating(n1b)
        self.gating_b2 = SelfGating(n2b)
        self.gating_b3 = SelfGating(n3b)
        self.output_dim = n0 + n1b + n2b + n3b

    def forward(self, x, norm: _Norm, train: bool):
        b0 = self.conv_b0(x, norm, train)
        b1 = self.conv_b1_b(self.conv_b1_a(x, norm, train), norm, train)
        b2 = self.conv_b2_b(self.conv_b2_a(x, norm, train), norm, train)
        b3 = self.conv_b3_b(same_maxpool(x, (3, 3, 3), (1, 1, 1)), norm, train)
        return torch.cat([self.gating_b0(b0), self.gating_b1(b1), self.gating_b2(b2),
                          self.gating_b3(b3)], dim=1)


def space_to_depth_3d(x: torch.Tensor) -> torch.Tensor:
    """2x2x2 space-to-depth of (B, C, T, H, W) -> (B, 8C, T/2, H/2, W/2),
    output channel ((t2 * 2 + h2) * 2 + w2) * C + c (s3dg.py:312-319)."""
    b, c, t, h, w = x.shape
    x = x.reshape(b, c, t // 2, 2, h // 2, 2, w // 2, 2).permute(0, 3, 5, 7, 1, 2, 4, 6)
    return x.reshape(b, 8 * c, t // 2, h // 2, w // 2)


# (name, n0, n1a, n1b, n2a, n2b, n3b) of the nine blocks (s3dg.py:280-310)
_BLOCKS = (
    ("mixed_3b", 64, 96, 128, 16, 32, 32),
    ("mixed_3c", 128, 128, 192, 32, 96, 64),
    ("mixed_4b", 192, 96, 208, 16, 48, 64),
    ("mixed_4c", 160, 112, 224, 24, 64, 64),
    ("mixed_4d", 128, 128, 256, 24, 64, 64),
    ("mixed_4e", 112, 144, 288, 32, 64, 64),
    ("mixed_4f", 256, 160, 320, 32, 128, 128),
    ("mixed_5b", 256, 160, 320, 32, 128, 128),
    ("mixed_5c", 384, 192, 384, 48, 128, 128),
)
EARLY = ("conv1", "conv_2b", "conv_2c", "gating", "mixed_3b", "mixed_3c")  # freeze_early's


class S3D(nn.Module):
    """The S3D-G trunk (s3dg.py:250-349). ``forward(x, batch_stats)`` takes
    (B, 3, T, H, W) in [0, 1] and returns the 512-d joint embedding (``fc``
    over the mixed_5c average), or with ``return_embedding=False`` the
    (B, 1024) average itself; with ``train_bn=True`` it returns (output, the
    new stats: every key of ``batch_stats``, those of the frozen early
    blocks as they were)."""

    def __init__(self, num_classes: int = 512, device="cuda"):
        super().__init__()
        self.conv1 = STConv3D(24, 64, (2, 4, 4), stride=1, padding=(1, 2, 2))
        self.conv_2b = STConv3D(64, 64, (1, 1, 1))
        self.conv_2c = STConv3D(64, 192, (3, 3, 3), padding=1, separable=True)
        self.gating = SelfGating(192)
        dim = 192
        for name, *widths in _BLOCKS:
            blk = InceptionBlock(dim, *widths)
            setattr(self, name, blk)
            dim = blk.output_dim
        self.fc = nn.Linear(dim, num_classes)
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm):
                m.key = name
        self.to(resolve_device(device))

    def init_batch_stats(self) -> Dict[str, torch.Tensor]:
        """flax's initial stats: means 0, variances 1, float32."""
        out = {}
        for m in self.modules():
            if isinstance(m, BatchNorm):
                out[f"{m.key}.running_mean"] = torch.zeros_like(m.weight.detach())
                out[f"{m.key}.running_var"] = torch.ones_like(m.weight.detach())
        return out

    def forward(self, x: torch.Tensor, batch_stats: Dict[str, torch.Tensor],
                train_bn: bool = False, freeze_early: bool = False,
                return_embedding: bool = True):
        norm = _Norm(batch_stats)
        train_early = train_bn and not freeze_early
        net = self.conv1(space_to_depth_3d(x), norm, train_early)
        net = net[:, :, 1:, 1:, 1:]  # TF-SAME crop (s3dg.py:327-329)
        net = same_maxpool(net, (1, 3, 3), (1, 2, 2))
        net = self.conv_2b(net, norm, train_early)
        net = self.gating(self.conv_2c(net, norm, train_early))
        net = same_maxpool(net, (1, 3, 3), (1, 2, 2))
        net = self.mixed_3b(net, norm, train_early)
        net = self.mixed_3c(net, norm, train_early)
        if freeze_early:  # freeze_forward (s3dg.py:351-379)
            net = net.detach()
        net = same_maxpool(net, (3, 3, 3), (2, 2, 2))
        for name in ("mixed_4b", "mixed_4c", "mixed_4d", "mixed_4e", "mixed_4f"):
            net = getattr(self, name)(net, norm, train_bn)
        net = same_maxpool(net, (2, 2, 2), (2, 2, 2))
        net = self.mixed_5c(self.mixed_5b(net, norm, train_bn), norm, train_bn)
        out = net.mean(dim=(2, 3, 4))  # (B, 1024)
        if return_embedding:
            out = self.fc(out)
        if not train_bn:
            return out
        return out, {k: norm.new.get(k, v) for k, v in batch_stats.items()}


def sentence_embedding_forward(params: Dict[str, torch.Tensor],
                               input_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The MIL-NCE text tower (reference Sentence_Embedding.forward,
    s3dg.py:231-239): the word embedding detached (frozen: its grad is
    zero), fc1, ReLU, the max over every word, padding included (no mask),
    fc2. ``params`` keyed as the word2vec tower's (``word_embd.weight``,
    ``fc1.weight``, ...)."""
    frozen = {**params, "word_embd.weight": params["word_embd.weight"].detach()}
    return {"text_embedding": word2vec_forward(frozen, input_ids)["pooler_output"]}

