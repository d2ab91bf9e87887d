"""MIL-NCE contrastive-grid denominators: the plain composition and the
hand-written CUDA kernel with its backward.

Counterpart of ``exoground_tpu/ops/milnce_grid.py``. Per encoder stage s the
TAN loss needs two logsumexp reductions over the (R = B*T video rows) x
(Cc = Bc*N text columns) similarity grid z = v_s . t_s^T * inv_temp, with
invalid (padded) text columns filled with ``NEG_FILL``:

  * ``v_den`` (S, R): logsumexp over the columns of each row;
  * ``t_den`` (S, Cc): logsumexp over the rows of each column (an
    all-invalid column gives NEG_FILL + log R).

Layout: video3 (S, R, C); text3 (St, Cc, C) with St in {1, S} (1 = the dual
tower's text, shared by every stage); col_valid (Cc,) bool.

  * ``grid_lse2_plain`` — the function written plainly: z materialised,
    ``torch.logsumexp`` both ways; autograd gives its backward.
  * ``grid_lse2`` — the dispatch: a CUDA tensor that passes
    ``kernel_eligible`` goes through ``GridLse2`` (forward and backward
    launch ``csrc/milnce_grid.cu``; z never reaches device memory), or
    raises; a CUDA tensor that fails the test takes the plain composition,
    as the JAX package's scan branch does; a CPU tensor takes the plain
    version.

The kernels stage video3 and text3 by 16-byte ``cp.async``: both must start
on a 16-byte boundary (``_kernels.check_aligned`` raises first).
"""

from __future__ import annotations

import torch

from exoground_tpu_torch.ops import _kernels

NEG_FILL = -6e4  # as losses/milnce.py: exp(NEG_FILL - m) underflows to exactly 0
FWD_ROWS = 64  # video rows per CTA of the forward and dv kernels (kTile in csrc/milnce_grid.cu)
DT_ROWS = 64  # video rows per walked tile of the dt kernel (kTile)
DT_COLS = 64  # text columns per CTA of the dt kernel (kTile)
COL_SPLITS = 2  # column splits of the forward (kColSplits): its per-row partials


def grid_lse2_plain(video3, text3, col_valid, inv_temp: float):
    """(v_den (S, R), t_den (S, Cc)) in float32 from a materialised z; the
    products run in float32 whatever the input type."""
    z = torch.matmul(video3.float(), text3.float().transpose(1, 2)) * inv_temp
    z = torch.where(col_valid.to(torch.bool)[None, None, :], z,
                    torch.full((), NEG_FILL, dtype=z.dtype, device=z.device))
    return torch.logsumexp(z, dim=2), torch.logsumexp(z, dim=1)


def kernel_eligible(r: int, c: int) -> bool:
    """The JAX package's ``supported`` (milnce_grid.py:290-296) without its
    TPU-only parts: feature width a multiple of 128 and at least 8 rows. No
    column cap: that was TPU VMEM, and the CUDA kernel tiles the columns."""
    return c % 128 == 0 and r >= 8


def _check(name, video3, text3):
    if video3.dim() != 3 or text3.dim() != 3:
        raise ValueError(f"{name}: video3 {tuple(video3.shape)} and text3 "
                         f"{tuple(text3.shape)} must be 3-d")
    s, r, c = video3.shape
    st, cc, c2 = text3.shape
    if c2 != c or st not in (1, s):
        raise ValueError(f"{name}: text3 {tuple(text3.shape)} does not fit video3 "
                         f"{tuple(video3.shape)} (St must be 1 or S)")
    if not kernel_eligible(r, c):
        raise ValueError(f"{name}: R={r}, C={c} outside the kernel test "
                         "(C % 128 == 0, R >= 8)")
    _kernels.check_cuda_inputs(name, video3.device, video3.dtype,
                               video3=video3, text3=text3)
    return s, st, r, cc, c


def bwd_slab(c: int, dtype: torch.dtype) -> int:
    """Width of the backward kernels' output slab: C itself up to 256, else
    512 (128 f32 accumulators a thread; a 256-column slab computes z twice at
    C 512 and ran 1.6-1.8x slower); above 512 columns f32 takes 256, where 512
    spills. The kernels have instances for these widths alone."""
    if c <= 256:
        return c
    return 256 if c > 512 and dtype == torch.float32 else 512


def _nsplit(device, cc: int, st: int, s: int, r: int, c: int, slab: int) -> int:
    """Splits of the dt kernel's (stage, row block) work list. The kernel
    runs one CTA an SM, so a split count costs ceil(CTAs / SMs) waves of
    ceil(items / splits) items; among the counts that give at least two
    CTAs an SM (where the list allows), take the fewest splits (the least
    partial traffic) within 5% of the cheapest."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ctas = -(-cc // DT_COLS) * st * -(-c // slab)
    items = (s if st == 1 else 1) * -(-r // DT_ROWS)
    first = max(1, min(items, -(-2 * sms // ctas)))
    cost = {n: -(-ctas * n // sms) * -(-items // n) for n in range(first, items + 1)}
    best = min(cost.values())
    return min(n for n, x in cost.items() if x <= 1.05 * best)


def grid_lse2_forward(video3, text3, cvalid, inv_temp: float):
    """Launch the forward kernel: cvalid (Cc,) int32 on the same card."""
    name = "milnce_grid_fwd"
    s, st, r, cc, c = _check(name, video3, text3)
    _kernels.check_aligned(name, video3=video3, text3=text3)
    code = _kernels.dtype_code(video3)
    f32 = dict(dtype=torch.float32, device=video3.device)
    nr = -(-r // FWD_ROWS)
    vden = torch.empty((s, r), **f32)
    tden = torch.empty((s, cc), **f32)
    # per-column partials (S, nR, Cc), then per-row partials (COL_SPLITS, S, R)
    part_m = torch.empty(s * nr * cc + COL_SPLITS * s * r, **f32)
    part_l = torch.empty(s * nr * cc + COL_SPLITS * s * r, **f32)
    rc = _kernels.library("milnce_grid").milnce_grid_forward(
        video3.data_ptr(), text3.data_ptr(), cvalid.data_ptr(), vden.data_ptr(),
        tden.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), s, st, r, cc, c, nr,
        float(inv_temp), code, _kernels.stream_of(video3))
    _kernels.check(name, rc)
    _kernels.count_launch(name)
    return vden, tden


def grid_lse2_backward(video3, text3, cvalid, vden, tden, g_v, g_t, inv_temp: float):
    """Launch the backward kernels: (dv (S, R, C), dt (St, Cc, C)) in the
    input type from float32 upstream grads g_v (S, R) and g_t (S, Cc)."""
    name = "milnce_grid_bwd"
    s, st, r, cc, c = _check(name, video3, text3)
    for arg, t, shape in (("v_den", vden, (s, r)), ("t_den", tden, (s, cc)),
                          ("g_v", g_v, (s, r)), ("g_t", g_t, (s, cc))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} != {shape}")
    _kernels.check_cuda_inputs(name, video3.device, torch.float32, v_den=vden,
                               t_den=tden, g_v=g_v, g_t=g_t)
    _kernels.check_aligned(name, video3=video3, text3=text3)
    code = _kernels.dtype_code(video3)
    slab = bwd_slab(c, video3.dtype)
    nsplit = _nsplit(video3.device, cc, st, s, r, c, slab)
    dv = torch.empty_like(video3)
    dt = torch.empty_like(text3)
    dt_part = torch.empty((nsplit, st, cc, c), dtype=torch.float32, device=video3.device)
    rc = _kernels.library("milnce_grid").milnce_grid_backward(
        video3.data_ptr(), text3.data_ptr(), cvalid.data_ptr(), vden.data_ptr(),
        tden.data_ptr(), g_v.data_ptr(), g_t.data_ptr(), dv.data_ptr(), dt.data_ptr(),
        dt_part.data_ptr(), s, st, r, cc, c, nsplit, slab, float(inv_temp), code,
        _kernels.stream_of(video3))
    _kernels.check(name, rc)
    _kernels.count_launch(name)
    return dv, dt


class GridLse2(torch.autograd.Function):
    """Both denominators through the kernel; the backward kernels recompute
    z from the saved inputs and the forward's v_den/t_den (the residuals of
    the TPU kernel's custom VJP, milnce_grid.py:212)."""

    @staticmethod
    def forward(ctx, video3, text3, col_valid, inv_temp: float):
        cvalid = col_valid.to(device=video3.device, dtype=torch.int32).contiguous()
        vden, tden = grid_lse2_forward(video3, text3, cvalid, inv_temp)
        ctx.save_for_backward(video3, text3, cvalid, vden, tden)
        ctx.inv_temp = inv_temp
        return vden, tden

    @staticmethod
    def backward(ctx, g_vden, g_tden):
        video3, text3, cvalid, vden, tden = ctx.saved_tensors
        g_v = (torch.zeros_like(vden) if g_vden is None
               else g_vden.to(torch.float32).contiguous())
        g_t = (torch.zeros_like(tden) if g_tden is None
               else g_tden.to(torch.float32).contiguous())
        dv, dt = grid_lse2_backward(video3, text3, cvalid, vden, tden, g_v, g_t,
                                    ctx.inv_temp)
        return dv, dt, None, None


def grid_lse2(video3, text3, col_valid, inv_temp: float, impl: str = "auto"):
    """Both MIL-NCE logsumexp denominators, differentiable in video3 and
    text3. ``impl``: 'auto' (the dispatch above), 'plain' (the composition
    on every device) or 'kernel' (CUDA tensors skip the eligibility test and
    launch the kernel or raise)."""
    if impl not in ("auto", "plain", "kernel"):
        raise ValueError(f"grid impl {impl!r} is not 'auto', 'plain' or 'kernel'")
    if impl == "plain" or video3.device.type == "cpu":
        return grid_lse2_plain(video3, text3, col_valid, inv_temp)
    if impl == "auto" and not kernel_eligible(video3.shape[1], video3.shape[2]):
        return grid_lse2_plain(video3, text3, col_valid, inv_temp)
    return GridLse2.apply(video3.contiguous(), text3.contiguous(), col_valid, inv_temp)
