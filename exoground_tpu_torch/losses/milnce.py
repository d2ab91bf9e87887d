"""TAN MIL-NCE loss + agreement self-labelling + alignability BCE.

Counterpart of ``exoground_tpu/losses/milnce.py`` (reference train/loss.py:
57-376). Everything stays static-shape over the full (B*T, Bc*N) grid with
``NEG_FILL`` for padded text columns: exp(NEG_FILL) underflows to 0 inside
logsumexp, so the math is the reference's boolean indexing without dynamic
shapes. Like the reference, padded VIDEO timesteps are NOT masked out of
the MIL-NCE grid (the HTM loader pads by repeating the last frame); only
padded text columns are.

Two grid modes, selected by what ``logits`` carries:

* **volume mode** (``logits_dual``/``logits_joint`` present): the
  reference's materialised (B, S, T, Bc, N) similarity volumes.
* **fused feature mode** (normalized ``*_feature_*`` present, no volumes):
  only the diagonal block (B, S, T, N), which holds every positive, is
  computed densely; the row and column logsumexp denominators come from
  ``ops/milnce_grid.py::grid_lse2`` (the CUDA kernel on the card, its plain
  composition on the CPU), so the volumes are never built.

``set_grid_impl('auto'|'plain'|'kernel')`` forces a side of that dispatch
for tests and comparisons.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from exoground_tpu_torch.ops.masks import (
    mask_from_time,
    masked_mean,
    masked_quantile,
    window_scan_kernel,
)
from exoground_tpu_torch.ops.milnce_grid import NEG_FILL, grid_lse2

TEMP = 0.07  # contrastive temperature (loss.py:67-72)

_GRID_IMPL = "auto"


def set_grid_impl(impl: str) -> None:
    """Denominator dispatch of fused feature mode: 'auto' (kernel on CUDA
    tensors that pass ``kernel_eligible``), 'plain' or 'kernel'."""
    global _GRID_IMPL
    if impl not in ("auto", "plain", "kernel"):
        raise ValueError(f"grid impl {impl!r} is not 'auto', 'plain' or 'kernel'")
    _GRID_IMPL = impl


@dataclasses.dataclass(frozen=True)
class TANLossConfig:
    sim: str = "cos"  # 'cos' scales by 1/0.07
    model: str = "init"  # 'init' | 'cotrain' (cotrain uses EMA logits for agreement)
    learn_agreement: bool = False
    temporal_agreement_type: str = "keep"  # i | u | keep | keep-joint
    loss_threshold: float = 0.0
    use_alignability_head: bool = False
    optim_policy: str = "default"  # 'bce' zeroes the NCE term
    alignability_joint_layer: int = 2  # 3rd layer works best (loss.py:344)


def _update_slice(base: torch.Tensor, update: torch.Tensor, offset: int, dim: int):
    """``jax.lax.dynamic_update_slice`` along one dim: the offset is clamped
    so the update fits, as XLA clamps it."""
    size, n = base.shape[dim], update.shape[dim]
    off = min(max(int(offset), 0), size - n)
    head = base.narrow(dim, 0, off)
    tail = base.narrow(dim, off + n, size - off - n)
    return torch.cat([head, update.to(base.dtype), tail], dim=dim)


def _diag_batch(x: torch.Tensor, col_offset=0) -> torch.Tensor:
    """(Br,S,T,Bc,N) -> (Br,S,T,N): video-batch row i pairs text column
    i + col_offset (clamped into range, as the JAX gather clamps)."""
    br, bc = x.shape[0], x.shape[3]
    rows = torch.arange(br, device=x.device)
    cols = torch.clamp(rows + col_offset, 0, bc - 1)
    return x[rows, :, :, cols, :]


def _feature_diag(video, text, temp, col_offset=0):
    """Diagonal-block logits (B,S,T,N) / temp from normalized features,
    accumulated in float32. video (B,S,T,C); text (Bc,N,C) dual or
    (Bc,S,N,C) joint."""
    b = video.shape[0]
    rows = torch.clamp(torch.arange(b, device=video.device) + col_offset, 0,
                       text.shape[0] - 1)
    txt = text[rows]
    eq = "astc,askc->astk" if text.dim() == 4 else "astc,akc->astk"
    return torch.einsum(eq, video.float(), txt.float()) / temp


def _masked_std(x, mask, dim=0):
    """Unbiased (n-1) std over masked entries, matching torch .std()."""
    n = mask.sum(dim, keepdim=True)
    mu = (x * mask).sum(dim, keepdim=True) / torch.clamp(n, min=1e-6)
    var = (((x - mu) ** 2) * mask).sum(dim, keepdim=True) / torch.clamp(n - 1, min=1e-6)
    return mu, torch.sqrt(var)


def _best_window_scan(prob_tn, logits_tn, windows):
    """Sliding-window scan (loss.py:120-147). prob_tn/logits_tn (B,T,N);
    windows (B,N,T,T). Returns (self_tgt (B,T,N), max_prob (B,N),
    max_logits (B,N))."""
    prob_scan = torch.einsum("btn,bnit->bni", prob_tn, windows)
    max_prob = prob_scan.amax(dim=-1)
    max_pos = torch.argmax(prob_scan, dim=-1)  # first maximum, as jnp.argmax
    t = windows.shape[-1]
    best_w = torch.gather(windows, 2, max_pos[:, :, None, None].expand(-1, -1, 1, t))[:, :, 0]
    max_logits = torch.einsum("btn,bnt->bn", logits_tn, best_w)
    self_tgt = (best_w > 0).to(torch.float32).permute(0, 2, 1)
    return self_tgt, max_prob, max_logits


def _two_way_softmax(diag_logits, video_pad, text_pad):
    """softmax over texts, /0.07, softmax over time (loss.py:100-109)."""
    fill = torch.full((), NEG_FILL, dtype=diag_logits.dtype, device=diag_logits.device)
    x = torch.where(video_pad[:, None, :, None], fill, diag_logits)
    x = torch.where(text_pad[:, None, None, :], fill, x)
    prob = torch.softmax(torch.softmax(x, dim=-1) / TEMP, dim=-2)
    return x, prob


def _agreement_targets(dual_diag, joint_diag, binary_tgt_raw, video_pad, text_pad,
                       cfg) -> Dict[str, torch.Tensor]:
    """Self-labelling pipeline (loss.py:91-232), on the diagonal blocks;
    the caller runs it without gradient."""
    n = joint_diag.shape[-1]
    t = joint_diag.shape[2]
    durations = torch.clamp(binary_tgt_raw.sum(-1), min=1.0)
    durations = torch.where(text_pad, torch.zeros_like(durations), durations)
    windows = window_scan_kernel(durations, t)

    jd, j_prob = _two_way_softmax(joint_diag, video_pad, text_pad)
    j_tgt, _, j_max_logits = _best_window_scan(j_prob[:, -1], jd[:, -1], windows)
    dd, d_prob = _two_way_softmax(dual_diag, video_pad, text_pad)
    d_tgt, _, d_max_logits = _best_window_scan(d_prob[:, -1], dd[:, -1], windows)

    # mutual IoU between dual/joint window labels (loss.py:184-189)
    inter = (j_tgt * d_tgt).sum(1)
    union = torch.maximum(j_tgt, d_tgt).sum(1)
    iou = inter / torch.clamp(union, min=1e-5)

    valid_text = ~text_pad
    d_conf = d_max_logits >= masked_quantile(d_max_logits, valid_text, 0.3)
    j_conf = j_max_logits >= masked_quantile(j_max_logits, valid_text, 0.3)
    conf_iou = iou >= 0.5
    conf_mask = d_conf & j_conf & conf_iou

    bt_raw_tn = binary_tgt_raw.permute(0, 2, 1)
    inter_tn = j_tgt * d_tgt
    union_tn = torch.maximum(j_tgt, d_tgt)
    zero = torch.zeros_like(inter_tn)
    kind = cfg.temporal_agreement_type
    if kind == "i":
        agree = torch.where(conf_mask[:, None, :], inter_tn, zero)
    elif kind == "u":
        agree = torch.where(conf_mask[:, None, :], union_tn, zero)
    elif kind == "keep":
        agree = torch.where(conf_iou[:, None, :], union_tn, bt_raw_tn)
    elif kind == "keep-joint":
        agree = torch.where(conf_iou[:, None, :], j_tgt, bt_raw_tn)
    else:
        raise ValueError(kind)

    # exclusive principle: per timestep keep only the first labelled text
    # (loss.py:219-229); text 0 keeps its original values
    first = torch.argmax(agree, dim=2)
    dedup = (torch.arange(n, device=agree.device)[None, None, :] == first[:, :, None])
    dedup = dedup.to(torch.float32)
    dedup[:, :, 0] = agree[:, :, 0]
    # texts that lost every timestep fall back to the original target
    no_pos = dedup.sum(1) == 0
    dedup = torch.where(no_pos[:, None, :], bt_raw_tn, dedup)

    conf_ratio = masked_mean(conf_mask.to(torch.float32), valid_text.to(torch.float32))
    return {"tgt_tn": dedup, "confidence-ratio": conf_ratio}


def _vt_means(v_loss, t_loss, row_has_pos, col_has_pos):
    v_mean = masked_mean(v_loss, row_has_pos[None, :].expand_as(v_loss))
    t_mean = masked_mean(t_loss, col_has_pos[None, :].expand_as(t_loss))
    return (v_mean + t_mean) / 2


def _milnce_two_way(logits, tgt_flat, col_valid, row_has_pos, col_has_pos):
    """Two-directional MIL-NCE over the (S, B*T, Bc*N) grid (loss.py:243-278).
    Returns (v_loss (S,R), t_loss (S,Cc), scalar mean)."""
    b, s, t = logits.shape[:3]
    flat = logits.permute(1, 0, 2, 3, 4).reshape(s, b * t, -1)
    fill = torch.full((), NEG_FILL, dtype=flat.dtype, device=flat.device)
    flat = torch.where(col_valid[None, None, :], flat, fill)
    pos = torch.where(tgt_flat[None] > 0, flat, fill)
    v_loss = torch.logsumexp(flat, -1) - torch.logsumexp(pos, -1)
    t_loss = torch.logsumexp(flat, -2) - torch.logsumexp(pos, -2)
    return v_loss, t_loss, _vt_means(v_loss, t_loss, row_has_pos, col_has_pos)


def _feature_two_way(video, text, diag, tgt_tn, own_valid, col_valid2, row_has_pos,
                     col_has_pos, col_offset, temp):
    """Two-directional MIL-NCE from normalized features without the volume
    (the JAX package's _feature_two_way, kernel branch :281-303).
    Numerators come from the diagonal block, where every positive lives;
    the denominators from ``grid_lse2``. video (B,S,T,C); text (Bc,N,C) or
    (Bc,S,N,C); diag (B,S,T,N) scaled logits."""
    b, s, t, c = video.shape
    bc, n = col_valid2.shape
    pos_mask = (tgt_tn > 0) & own_valid[:, None, :]
    fill = torch.full((), NEG_FILL, dtype=diag.dtype, device=diag.device)
    pos = torch.where(pos_mask[:, None], diag, fill)
    v_num = torch.logsumexp(pos, -1)  # (B,S,T)
    t_num_own = torch.logsumexp(pos, 2)  # (B,S,N)

    video3 = video.permute(1, 0, 2, 3).reshape(s, b * t, c)
    text3 = (text.permute(1, 0, 2, 3).reshape(s, bc * n, c) if text.dim() == 4
             else text.reshape(1, bc * n, c))
    v_den3, t_den = grid_lse2(video3, text3, col_valid2.reshape(-1), 1.0 / temp,
                              impl=_GRID_IMPL)
    v_den = v_den3.reshape(s, b, t).permute(1, 0, 2)
    v_loss = (v_den - v_num).permute(1, 0, 2).reshape(s, b * t)
    t_num = _update_slice(
        torch.full((s, bc, n), NEG_FILL, dtype=torch.float32, device=video.device),
        t_num_own.permute(1, 0, 2), col_offset, 1).reshape(s, bc * n)
    t_loss = t_den - t_num
    return v_loss, t_loss, _vt_means(v_loss, t_loss, row_has_pos, col_has_pos)


def _bce_with_pos_weight(logits, labels, select, pos_weight):
    """Weighted binary cross-entropy over selected entries (loss.py:348-354)."""
    per = -(pos_weight * labels * F.logsigmoid(logits)
            + (1.0 - labels) * F.logsigmoid(-logits))
    return masked_mean(per, select.to(torch.float32))


def tan_loss(
    start: torch.Tensor,  # (B, N) padded with ops.masks.PAD_START
    end: torch.Tensor,  # (B, N) padded with ops.masks.PAD_END
    logits: Dict[str, torch.Tensor],
    video_padding_mask: torch.Tensor,  # (B, T) True=PAD
    text_padding_mask: torch.Tensor,  # (B, N) True=PAD
    cfg: TANLossConfig,
    abs_text_pos: Optional[torch.Tensor] = None,  # (B, N, 2) normalized
    col_text_padding_mask: Optional[torch.Tensor] = None,  # (Bc, N): global pads
    col_offset: int = 0,  # this row block's position among the columns
) -> Dict[str, torch.Tensor]:
    """TAN loss over materialised volumes or normalized features (see the
    module docstring); returns the JAX package's loss dict of 0-d tensors."""
    fused = "logits_dual" not in logits
    temp = TEMP if cfg.sim == "cos" else 1.0
    dev = start.device
    if fused:
        vd, td = logits["dual_feature_video"], logits["dual_feature_text"]
        vj, tj = logits["joint_feature_video"], logits["joint_feature_text"]
        b, _, t = vd.shape[:3]
        bc, n = td.shape[0], td.shape[-2]
        dual_diag = _feature_diag(vd, td, temp, col_offset)
        joint_diag = _feature_diag(vj, tj, temp, col_offset)
    else:
        logits_dual = logits["logits_dual"] / temp
        logits_joint = logits["logits_joint"] / temp
        b, _, t, bc, n = logits_dual.shape
        dual_diag = _diag_batch(logits_dual, col_offset)
        joint_diag = _diag_batch(logits_joint, col_offset)
    if col_text_padding_mask is None:
        col_text_padding_mask = text_padding_mask
    col_valid2 = ~col_text_padding_mask
    col_valid = col_valid2.reshape(-1)
    rows_idx = torch.clamp(torch.arange(b, device=dev) + col_offset, 0, bc - 1)
    own_valid = col_valid2[rows_idx]
    loss_dict: Dict[str, torch.Tensor] = {}

    binary_tgt_raw = mask_from_time(start, end, t)  # (B,N,T)
    bt_tn = binary_tgt_raw.permute(0, 2, 1)

    if cfg.learn_agreement:
        with torch.no_grad():
            if cfg.model == "cotrain":
                if fused:
                    # the diagonal needs only this row block's own columns
                    a_dual = _feature_diag(logits["ema-dual_feature_video"],
                                           logits["ema-dual_feature_text"], temp)
                    a_joint = _feature_diag(logits["ema-joint_feature_video"],
                                            logits["ema-joint_feature_text"], temp)
                else:
                    a_dual = _diag_batch(logits["ema-logits_dual"] / temp, col_offset)
                    a_joint = _diag_batch(logits["ema-logits_joint"] / temp, col_offset)
            else:
                a_dual, a_joint = dual_diag, joint_diag
            agree = _agreement_targets(a_dual.detach(), a_joint.detach(), binary_tgt_raw,
                                       video_padding_mask, text_padding_mask, cfg)
        tgt_tn = agree["tgt_tn"]
        loss_dict["confidence-ratio"] = agree["confidence-ratio"]
        loss_dict["iou-threshold"] = torch.full((), 0.5, device=dev)
    else:
        tgt_tn = bt_tn

    # positives only in the diagonal block of the (B*T, Bc*N) grid
    pos_mask_tn = (tgt_tn > 0) & own_valid[:, None, :]
    row_has_pos = pos_mask_tn.any(-1).reshape(b * t)
    own_col_pos = pos_mask_tn.any(1)  # (B,N)
    col_has_pos = _update_slice(torch.zeros((bc, n), dtype=torch.bool, device=dev),
                                own_col_pos, col_offset, 0).reshape(-1) & col_valid
    own_cols = own_col_pos & own_valid

    if fused:
        v_loss_d, t_loss_d, loss_dual = _feature_two_way(
            vd, td, dual_diag, tgt_tn, own_valid, col_valid2, row_has_pos,
            col_has_pos, col_offset, temp)
        v_loss_j, t_loss_j, loss_joint = _feature_two_way(
            vj, tj, joint_diag, tgt_tn, own_valid, col_valid2, row_has_pos,
            col_has_pos, col_offset, temp)
    else:
        cross = (torch.arange(bc, device=dev)[None, :]
                 == (torch.arange(b, device=dev)[:, None] + col_offset)).to(torch.float32)
        tgt = tgt_tn[:, :, None, :] * cross[:, None, :, None]  # (B,T,Bc,N)
        tgt_flat = tgt.reshape(b * t, bc * n) * col_valid[None, :]
        v_loss_d, t_loss_d, loss_dual = _milnce_two_way(
            logits_dual, tgt_flat, col_valid, row_has_pos, col_has_pos)
        v_loss_j, t_loss_j, loss_joint = _milnce_two_way(
            logits_joint, tgt_flat, col_valid, row_has_pos, col_has_pos)
    loss_dict["loss-dual"] = loss_dual
    loss_dict["loss-joint"] = loss_joint

    loss_dual_th = loss_dual
    loss_joint_th = loss_joint
    loss_bce_joint = torch.zeros((), device=dev)

    if cfg.loss_threshold > 0 or cfg.use_alignability_head:
        # per-text confidence (max over time of last-layer diag logits),
        # standardized over texts (loss.py:283-289)
        d_diag = dual_diag[:, -1]
        j_diag = joint_diag[:, -1]
        valid = ~text_padding_mask
        big_neg = torch.full_like(d_diag, NEG_FILL)
        d_max = torch.where(valid[:, None, :], d_diag, big_neg).max(dim=1).values
        j_max = torch.where(valid[:, None, :], j_diag, big_neg).max(dim=1).values
        vmask = valid.to(torch.float32)

        def standardize(x):
            mu, sd = _masked_std(x.reshape(-1)[:, None], vmask.reshape(-1)[:, None], dim=0)
            return (x - mu.reshape(())) / torch.clamp(sd.reshape(()), min=1e-6)

        metric = -(standardize(d_max) + standardize(j_max))  # lower = better
        th = masked_quantile(metric, valid, cfg.loss_threshold)
        t_th_mask = (metric <= th) & valid

        if cfg.loss_threshold > 0:
            loss_dict["loss-dual-all"] = loss_dual
            loss_dict["loss-joint-all"] = loss_joint
            t_th_cols = _update_slice(torch.zeros((bc, n), dtype=torch.bool, device=dev),
                                      t_th_mask, col_offset, 0).reshape(-1)
            row_pos_th = (pos_mask_tn & t_th_mask[:, None, :]).any(-1).reshape(b * t)
            t_sel = t_th_cols & col_has_pos

            def th_mean(v_loss, t_loss):
                t_m = masked_mean(t_loss, t_sel[None, :].expand_as(t_loss))
                v_m = masked_mean(v_loss, row_pos_th[None, :].expand_as(v_loss))
                return (v_m + t_m) / 2

            loss_dual_th = th_mean(v_loss_d, t_loss_d)
            loss_joint_th = th_mean(v_loss_j, t_loss_j)
            loss_dict["loss-dual"] = loss_dual_th
            loss_dict["loss-joint"] = loss_joint_th

        if cfg.use_alignability_head:
            # pseudo labels: 2=ignore, 1 above both medians, 0 below both
            # (loss.py:311-331)
            d_med = masked_quantile(d_max, valid, 0.5)
            j_med = masked_quantile(j_max, valid, 0.5)
            labels = torch.full((b, n), 2.0, device=dev)
            one, zero = torch.ones_like(labels), torch.zeros_like(labels)
            labels = torch.where((d_max > d_med) & (j_max > j_med), one, labels)
            labels = torch.where((d_max < d_med) & (j_max < j_med), zero, labels)
            if abs_text_pos is not None:
                center = abs_text_pos.mean(-1)
                labels = torch.where((center < 0.2) | (center > 0.8), zero, labels)

            sel = valid & own_cols & (labels != 2.0)
            lab_bin = torch.where(sel, labels, zero)
            mean_lab = masked_mean(lab_bin, sel.to(torch.float32))
            pos_weight = 1.0 / torch.clamp(mean_lab, min=1e-6) - 1.0

            n_stages = logits["joint_logits_alignability"].shape[1]
            layer = min(cfg.alignability_joint_layer, n_stages - 1)
            a_joint = logits["joint_logits_alignability"][:, layer, :, 0]
            a_dual = logits["dual_logits_alignability"][:, :, 0]
            loss_bce_joint = _bce_with_pos_weight(a_joint, lab_bin, sel, pos_weight)
            loss_bce_dual = _bce_with_pos_weight(a_dual, lab_bin, sel, pos_weight)
            top1 = masked_mean(((a_joint > 0) == (lab_bin > 0.5)).to(torch.float32),
                               sel.to(torch.float32))
            loss_dict["loss-joint-bce"] = loss_bce_joint
            loss_dict["loss-dual-bce"] = loss_bce_dual
            loss_dict["alignability_top1"] = top1

    nce_weight = 0.0 if cfg.optim_policy == "bce" else 1.0
    if cfg.loss_threshold > 0:
        loss_dict["loss-total"] = (loss_dual + loss_joint) / 2  # monitoring
        loss = (loss_dual_th + loss_joint_th) / 2
    else:
        loss = (loss_dual + loss_joint) / 2
    if cfg.use_alignability_head:
        loss = loss * nce_weight + loss_bce_joint
    loss_dict["loss"] = loss
    return loss_dict
