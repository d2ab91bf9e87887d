"""Mask builders and masked statistics used by the TAN loss.

Counterpart of ``exoground_tpu/ops/masks.py`` (reference train/loss.py:
26-43, 120-135, 194-197): static-shape, mask-based forms of the reference's
ragged-tensor surgery.

  * ``mask_from_time`` — (start, end) second lists -> binary (B, N, T)
    segment masks; padded texts carry ``PAD_START``/``PAD_END`` and give
    all-zero rows.
  * ``window_scan_kernel`` — the sliding average-pool window bank the
    agreement self-labelling scans for the best window per sentence.
  * ``masked_mean`` / ``masked_quantile`` — statistics over a masked subset;
    the quantile follows torch.quantile's linear interpolation over the
    valid entries.
"""

from __future__ import annotations

import torch

PAD_START = 1e4  # start pad value: no timestep satisfies start <= t
PAD_END = -1e4  # end pad value: no timestep satisfies t < end


def mask_from_time(start: torch.Tensor, end: torch.Tensor, num_timestamps: int) -> torch.Tensor:
    """Binary float32 (B, N, T) mask: 1 where start[b, n] <= t < end[b, n]."""
    steps = torch.arange(num_timestamps, dtype=torch.float32, device=start.device)
    return ((start[:, :, None] <= steps) & (steps < end[:, :, None])).to(torch.float32)


def window_scan_kernel(durations: torch.Tensor, num_timestamps: int) -> torch.Tensor:
    """Normalized sliding-window bank (B, N, T, T): ``out[b, n, i, t]``
    weights timestep t inside the duration-long window starting at i.
    Windows that run past the end are removed, timesteps 0 and T-1 are never
    selectable and surviving windows renormalise over what remains; a
    duration of 0 (padded text) gives all-zero rows."""
    t_idx = torch.arange(num_timestamps, dtype=torch.float32, device=durations.device)
    dur = durations[:, :, None, None]
    start = t_idx[None, None, :, None]
    pos = t_idx[None, None, None, :]
    w = ((pos >= start) & (pos < start + dur)).to(torch.float32)
    row_ok = (start + dur <= num_timestamps) & (dur > 0)
    w = w * row_ok.to(torch.float32)
    w[..., 0] = 0.0
    w[..., -1] = 0.0
    denom = torch.clamp(w.sum(-1, keepdim=True), min=1e-3)
    return w / denom


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over entries where mask is truthy (weights allowed); safe
    on an empty mask."""
    mask = mask.to(x.dtype)
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1e-6)


def masked_quantile(x: torch.Tensor, valid: torch.Tensor, q: float) -> torch.Tensor:
    """q-th quantile of x[valid] with linear interpolation (torch.quantile's
    default): invalid entries sort to +inf, the index comes from the valid
    count."""
    flat = torch.where(valid, x, torch.full((), float("inf"), dtype=x.dtype,
                                            device=x.device)).reshape(-1)
    flat = torch.sort(flat).values
    n = valid.sum().to(torch.float32)
    pos = q * torch.clamp(n - 1.0, min=0.0)
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    w = pos - lo.to(torch.float32)
    # gather, not flat[lo]: a 0-d index tensor would be read back to the host
    lo_v, hi_v = flat.gather(0, torch.stack([lo, hi]))
    return lo_v * (1.0 - w) + hi_v * w
