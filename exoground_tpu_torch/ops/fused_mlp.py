"""Fused transformer MLP: c_fc -> QuickGELU -> c_proj without the hidden
activation reaching device memory.

Counterpart of ``exoground_tpu/ops/fused_mlp.py`` (reference
model/tfm_model.py:23-27). ``fused_mlp`` launches the hand-written kernel in
``csrc/fused_mlp.cu`` on CUDA tensors and takes ``mlp_plain``, the
composition it fuses, only for tensors on the CPU. Inference-only, as the
TPU kernel is (its custom VJP recomputes the XLA path): a CUDA input that
requires grad raises.

The int8 serving mode's route: ``fused_mlp_int8`` launches
``csrc/fused_mlp_int8.cu``, which quantizes x per row inside and runs c_fc
as int8 x int8 -> int32 (c_proj exact), with c_fc quantized per output row
once per weight version (``quant.quantized_weight``); on the CPU it takes
``mlp_int8_plain``, the kernel body written plainly. ``MLP`` takes it under
``quant.matmul_impl('int8')`` when the policy quantizes c_fc (4C >=
min_cols) but not c_proj (C < min_cols). The train step differentiates
inside ``disable_fused_kernels()``, where ``MLP`` and ``MultiHeadAttention``
take their plain compositions, as the JAX package's train steps trace under
its context of the same name (exoground_tpu/ops/fused_mlp.py:37-58).

The whole-block path's second half: ``fused_block_mlp`` computes
x + MLP(LN_2(x)) in one launch of ``csrc/block_mlp.cu`` (the LayerNorm in
float32, the residual summed in float32 and rounded once), with an int8
c_fc body; on the CPU it takes ``block_mlp_plain`` /
``block_mlp_int8_plain``, the kernel bodies written plainly. The blocks
take it when ``resolve_mlp_impl`` gives 'fused' and the attention impl is
an explicit 'fused' (``attention.block_fusion_mode``).

All four kernel bodies are one tile (``csrc/mlp_tile.cuh``) on the tensor
cores, launched by ``_launch`` with the plan of ``mlp_launch_plan``, a pure
function of (rows, C): row tiles, column slabs and the split of the hidden
over CTAs at few rows, whose float32 partials go to ``mlp_workspace``.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from exoground_tpu_torch.ops import _kernels, quant
from exoground_tpu_torch.ops.activations import quick_gelu

LN_EPS = 1e-5  # torch LayerNorm default
MLP_IMPLS = ("auto", "xla", "fused")  # None means 'auto'

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


def mlp_plain(x, fc_w, fc_b, pr_w, pr_b, linear=F.linear) -> torch.Tensor:
    """The straight-line composition (counterpart of ``_mlp_xla``); torch
    weight layout: fc_w (4C, C), pr_w (C, 4C). ``MLP`` passes
    ``quant.linear`` for its unfused path (the JAX Dense hooks)."""
    h = quick_gelu(linear(x, fc_w, fc_b))
    return linear(h.to(pr_w.dtype), pr_w, pr_b).to(x.dtype)


def mlp_int8_plain(x, fc_w, fc_b, pr_w, pr_b) -> torch.Tensor:
    """The int8 kernel's function written plainly (``_mlp_kernel_int8``):
    c_fc as the int8 product of the per-row quantized x and the per-row
    quantized fc_w, ``float(acc) * xs * ws + fc_b`` in float32, QuickGELU in
    float32, h cast to c_proj's type, c_proj exact. Reads no context."""
    acc, xs, ws = quant.int8_product(x, fc_w)
    h = quick_gelu(acc.float() * xs * ws + fc_b.float())
    return F.linear(h.to(pr_w.dtype), pr_w, pr_b).to(x.dtype)


def kernel_eligible(width: int) -> bool:
    """The JAX ``MLP``'s fused test (fused_mlp.py:83: width % 128 == 0);
    other widths take the plain composition on every device, as they stay
    on XLA there."""
    return width % 128 == 0


def resolve_mlp_impl(impl, width: int, device) -> str:
    """'fused' or 'xla' (the counterpart of ``resolve_mlp_impl``,
    fused_mlp.py:71-90). None or 'auto' gives 'fused' on a device other
    than the CPU (a meta tensor stands for the card's in the tests) for a
    kernel-eligible width outside ``disable_fused_kernels()``, and 'xla' on
    the CPU, as the JAX function does off the TPU. No row gate: the TPU's
    was a TPU measurement. An explicit 'fused' gives 'fused' for an
    eligible width even inside ``disable_fused_kernels()``."""
    if impl is not None and impl not in MLP_IMPLS:
        raise ValueError(f"mlp impl {impl!r} is not one of {MLP_IMPLS}")
    if not kernel_eligible(width) or impl == "xla":
        return "xla"
    if impl == "fused":
        return "fused"
    on_card = torch.device(device).type != "cpu"
    return "fused" if on_card and not fused_kernels_disabled() else "xla"


def layernorm_f32(x, ln_w, ln_b) -> torch.Tensor:
    """Row LayerNorm in float32 as the block kernels compute it
    (``_layernorm_f32``, fused_mlp.py:119-125): the mean, then the mean of
    the squared deviations, rsqrt(var + 1e-5), then * w + b."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + LN_EPS) * ln_w.float() + ln_b.float()


def _c_proj_residual(h, x, pr_w, pr_b) -> torch.Tensor:
    """h (float32) rounded to c_proj's type, h . c_proj^T + b + x summed in
    float32 and rounded once to x's type (fused_mlp.py:140-146)."""
    return (F.linear(h.to(pr_w.dtype).float(), pr_w.float(), pr_b.float())
            + x.float()).to(x.dtype)


def block_mlp_plain(x, ln_w, ln_b, fc_w, fc_b, pr_w, pr_b) -> torch.Tensor:
    """The block MLP kernel's function written plainly
    (``_block_mlp_kernel``): xn = LN_2(x) in float32, rounded to x's type;
    c_fc and c_proj accumulate in float32, QuickGELU in float32, the hidden
    rounded to c_proj's type; x + MLP(xn) rounded once. Differentiable."""
    xn = layernorm_f32(x, ln_w, ln_b).to(x.dtype)
    h = quick_gelu(F.linear(xn.float(), fc_w.float(), fc_b.float()))
    return _c_proj_residual(h, x, pr_w, pr_b)


def block_mlp_int8_plain(x, ln_w, ln_b, fc_w, fc_b, pr_w, pr_b) -> torch.Tensor:
    """The int8 block MLP kernel's function written plainly
    (``_block_mlp_kernel_int8``): the float32 xn = LN_2(x), unrounded,
    quantized per row; c_fc as the int8 product, ``float(acc) * xs * ws +
    fc_b``; the rest as ``block_mlp_plain``. Reads no context."""
    acc, xs, ws = quant.int8_product(layernorm_f32(x, ln_w, ln_b), fc_w)
    h = quick_gelu(acc.float() * xs * ws + fc_b.float())
    return _c_proj_residual(h, x, pr_w, pr_b)


def _check_mlp(name, x, fc_w, fc_b, pr_w, pr_b, **ln) -> torch.Tensor:
    """The wrappers' checks before a launch (``ln``: the block kernels'
    LayerNorm weight and bias); returns x as (rows, C)."""
    c = x.shape[-1]
    if not kernel_eligible(c):
        raise ValueError(f"{name}: width {c} is not a multiple of 128")
    if fc_w.shape != (4 * c, c) or pr_w.shape != (c, 4 * c):
        raise ValueError(f"{name}: weights {tuple(fc_w.shape)}, {tuple(pr_w.shape)} "
                         f"do not fit width {c}")
    if fc_b.shape != (4 * c,) or pr_b.shape != (c,):
        raise ValueError(f"{name}: biases {tuple(fc_b.shape)}, {tuple(pr_b.shape)} "
                         f"do not fit width {c}")
    if any(t.shape != (c,) for t in ln.values()):
        raise ValueError(f"{name}: LayerNorm parameters do not fit width {c}")
    _kernels.check_inference(name, x, fc_w, fc_b, pr_w, pr_b, *ln.values())
    x2d = x.reshape(-1, c)
    _kernels.check_cuda_inputs(name, x.device, x.dtype, x=x2d, fc_w=fc_w,
                               fc_b=fc_b, pr_w=pr_w, pr_b=pr_b, **ln)
    return x2d


MLP_ROW_TILE = 64  # rows a CTA of csrc/mlp_tile.cuh owns
MLP_MAX_SLAB = 512  # output columns a CTA accumulates: 64 x 512 f32 is 128 floats a thread
MLP_HIDDEN_CHUNK = 128  # hidden columns of one step of the kernel's walk
H100_SMS = 132


def mlp_launch_plan(rows: int, c: int, sms: int = H100_SMS) -> dict:
    """The launch of the MLP family's tile (all four bodies): row tiles of
    ``MLP_ROW_TILE``, output slabs of min(C, 512) columns (above C = 512
    each slab recomputes the hidden), and ``split``, the number of CTAs the
    4C / 128 hidden chunks are shared over (a divisor of the chunk count). One CTA fits an SM (its
    registers), so the time goes as the waves of CTAs over the split:
    - tiles and slabs below one wave of ``sms``: the least split that
      reaches a full wave, every chunk its own CTA where none does;
    - a wave or more: the split of at most 4 with the fewest waves per
      split, where it saves at least a tenth on one CTA per tile (19,456
      rows: 304 CTAs in 3 waves, or 608 half-CTAs in 5, 2.5 waves' time),
      else 1.
    With ``split`` > 1 each CTA writes a float32 partial and a second kernel
    sums them in order."""
    if rows < 1 or c < 128 or c % 128:
        raise ValueError(f"fused_mlp: rows {rows}, width {c}: rows >= 1 and a width that is "
                         "a multiple of 128")
    tiles = -(-rows // MLP_ROW_TILE)
    slab = min(c, MLP_MAX_SLAB)
    slabs = -(-c // slab)
    chunks = 4 * c // MLP_HIDDEN_CHUNK
    work = tiles * slabs
    splits = [d for d in range(1, chunks + 1) if chunks % d == 0]
    if work < sms:
        split = next((d for d in splits if work * d >= sms), chunks)
    else:
        def cost(d):
            return -(-work * d // sms) / d
        best = min((d for d in splits if d <= 4), key=cost)
        split = best if cost(best) <= 0.9 * cost(1) else 1
    return dict(row_tile=MLP_ROW_TILE, slab=slab, slabs=slabs, split=split,
                ctas=work * split)


def mlp_workspace(plan: dict, rows: int, c: int, device) -> torch.Tensor | None:
    """The float32 workspace of a launch that splits the hidden: one (rows,
    C) partial per CTA of the split, summed in split order by the reduction;
    None without a split."""
    if plan["split"] == 1:
        return None
    return torch.empty((plan["split"], rows, c), dtype=torch.float32, device=device)


def _launch(name, lib, fn, x, fc_w, fc_b, pr_w, pr_b, *, ln=None, int8=False):
    """One launch of the MLP family's tile: the checks, c_fc (quantized and
    cached with ``int8``), the operands read by 16-byte copies checked for
    alignment (c_fc and c_proj; x too, which the exact bodies copy and the
    block bodies' reduction reads as vectors, but not the int8 MLP's, which
    it quantizes), the plan and its workspace; then the C function ``fn`` of
    library ``lib`` (built at first use, after the checks) and the count.
    ``ln``: the block bodies' LayerNorm weight and bias, by name."""
    ln = ln or {}
    x2d = _check_mlp(name, x, fc_w, fc_b, pr_w, pr_b, **ln)
    cfc = quant.quantized_weight(fc_w) if int8 else (fc_w,)
    aligned = dict(fc_w=cfc[0], pr_w=pr_w)
    if ln or not int8:
        aligned["x"] = x2d
    _kernels.check_aligned(name, **aligned)
    rows, c = x2d.shape
    plan = mlp_launch_plan(rows, c)
    ws = mlp_workspace(plan, rows, c, x2d.device)
    out = torch.empty_like(x2d)
    entry = getattr(_kernels.library(lib), fn)
    ptrs = [t.data_ptr() for t in (x2d, *ln.values(), *cfc, fc_b, pr_w, pr_b, out)]
    rc = entry(*ptrs, None if ws is None else ws.data_ptr(), rows, c, plan["slab"],
               plan["split"], _kernels.dtype_code(x2d), _kernels.stream_of(x2d))
    _kernels.check(name, rc)
    _kernels.LAUNCHES[name] += 1
    return out.reshape(x.shape)


def fused_mlp(x, fc_w, fc_b, pr_w, pr_b) -> torch.Tensor:
    """QuickGELU MLP over (..., C) with the (rows, 4C) hidden kept on chip."""
    if x.device.type == "cpu":
        return mlp_plain(x, fc_w, fc_b, pr_w, pr_b)
    return _launch("fused_mlp", "fused_mlp", "fused_mlp_forward", x, fc_w, fc_b, pr_w, pr_b)


def fused_mlp_int8(x, fc_w, fc_b, pr_w, pr_b) -> torch.Tensor:
    """The int8-c_fc MLP over (..., C), inference only. CPU tensors take
    ``mlp_int8_plain``; CUDA tensors launch the kernel or raise, with fc_w
    quantized once per weight version. An input that requires grad raises
    on either device: the int8 product has no gradient."""
    name = "fused_mlp_int8"
    _kernels.check_inference(name, x, fc_w, fc_b, pr_w, pr_b)
    if x.device.type == "cpu":
        return mlp_int8_plain(x, fc_w, fc_b, pr_w, pr_b)
    return _launch(name, name, "fused_mlp_int8_forward", x, fc_w, fc_b, pr_w, pr_b, int8=True)


def fused_block_mlp(x, ln_w, ln_b, fc_w, fc_b, pr_w, pr_b, int8_cfc: bool = False):
    """x + MLP(LN_2(x)) over (..., C) in one pass, torch weight layout (the
    counterpart of ``fused_block_mlp``, fused_mlp.py:359). CPU tensors take
    ``block_mlp_plain`` (``block_mlp_int8_plain`` with ``int8_cfc``); CUDA
    tensors launch ``csrc/block_mlp.cu`` or raise. Inference-only on the
    card; the int8 body raises under grad on either device."""
    name = "block_mlp_int8" if int8_cfc else "block_mlp"
    args = (x, ln_w, ln_b, fc_w, fc_b, pr_w, pr_b)
    if int8_cfc:
        _kernels.check_inference(name, *args)
    if x.device.type == "cpu":
        return (block_mlp_int8_plain if int8_cfc else block_mlp_plain)(*args)
    return _launch(name, "block_mlp", f"{name}_forward", x, fc_w, fc_b, pr_w, pr_b,
                   ln=dict(ln_w=ln_w, ln_b=ln_b), int8=int8_cfc)
