"""Device-resident (fused) HTM-Align overlap-seq evaluator.

Counterpart of ``exoground_tpu/evals/align_fused.py``: the protocol of
``evals/align.py::test_alignment_htm`` (reference
eval/eval_zeroshot_align.py:127-252), with each group of videos run as one
device pass:

  upload features once -> gather stride-aligned windows on the device ->
  batched model over all windows -> fold joint/dual sims into the (text,
  time) canvases -> overlap-average -> per-text argmax and scores on the
  device -> fetch one packed (4, Ntot) result.

Videos are packed ``group_videos`` at a time into one flat index space (one
concatenated video buffer, one concatenated text table), so a group runs as
one batch of a few hundred windows. Host-side active-text selection stays in
numpy and feeds index arrays.

``transfer_dtype`` int8 (per-row absmax) and int4 (group absmax, two values
a byte) quantize the features on the host and dequantize them on the device
after the window gather; ``matmul_dtype="int8"`` runs the model under
``quant.matmul_impl("int8", min_cols=int8_min_cols)``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from exoground_tpu_torch.evals.align import (
    NEG_FILL,
    AlignEvalConfig,
    _active_text_masks,
    roc_auc,
)
from exoground_tpu_torch.ops import quant
from exoground_tpu_torch.utils.device import resolve_device
from exoground_tpu_torch.utils.shapes import round_up as _round_up

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dequant_int4(packed, scales):
    """Unpack nibble-packed int4 (+8 offset) and apply the group scales:
    packed (..., D//2) uint8, scales (..., D//group) float16 -> (..., D)
    float32 (the JAX ``_dequant_int4``)."""
    lo = (packed & 15).float() - 8.0
    hi = (packed >> 4).float() - 8.0
    d = packed.shape[-1] * 2
    vals = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], d)
    n_groups = scales.shape[-1]
    vals = vals.reshape(*vals.shape[:-1], n_groups, d // n_groups)
    vals = vals * scales.float()[..., None]
    return vals.reshape(*vals.shape[:-2], d)


def _gather_features(table, scale, idx, dtype):
    """Rows ``idx`` of an uploaded feature table, dequantized when the
    transfer type is int8 (per-row scales) or int4 (uint8 nibbles, group
    scales), then cast to the compute type."""
    rows = table[idx]
    if table.dtype == torch.int8:
        rows = rows.float() * scale[idx][..., None]
    elif table.dtype == torch.uint8:
        rows = _dequant_int4(rows, scale[idx])
    return rows.to(dtype)


def _process_body(model, cfg: AlignEvalConfig, dims, video, vscale, text_embed, tscale,
                  win_start, win_len, text_idx, text_valid):
    """One group on the device (the JAX ``_process_body``, :75-213).

    Returns the packed (4, Ntot) float32 result [argmax, score, a_dual,
    a_joint] and the (Ntot, Vmax) overlap-averaged canvas it was reduced
    from. ``model`` already holds its parameters in ``cfg.compute_dtype``."""
    dtype = _DTYPES[cfg.compute_dtype]
    vmax, seq_len = dims
    w, npad = text_idx.shape
    ntot = text_embed.shape[0]
    dev = video.device

    l_idx = torch.arange(seq_len, device=dev)
    gidx = torch.clamp(win_start[:, None] + l_idx[None, :], 0, vmax - 1)  # (W, L)
    vb = _gather_features(video, vscale, gidx, dtype)  # (W, L, Dv)
    vmask = l_idx[None, :] >= win_len[:, None]  # (W, L) True=PAD
    tb = _gather_features(text_embed, tscale, text_idx, dtype)  # (W, Npad, Dt)
    tmask = ~text_valid

    with quant.matmul_impl("int8" if cfg.matmul_dtype == "int8" else "default",
                           min_cols=cfg.int8_min_cols):
        out = model.text_visual_sim(vb, tb, video_padding_mask=vmask,
                                    lang_padding_mask=tmask)
    out = {k: v.float() for k, v in out.items()}
    sim = out["sim"][:, -1].transpose(1, 2) * cfg.sim_scale  # (W, K, L)
    dual = out["dual-sim"][:, -1].transpose(1, 2) * cfg.sim_scale

    valid3 = text_valid[:, :, None] & (l_idx[None, None, :] < win_len[:, None, None])

    # text fold: a one-hot product collapses the active-text slots onto the
    # global text axis -> (W, 3, Ntot, L)
    onehot = F.one_hot(text_idx.long(), ntot).float()
    onehot = onehot * text_valid[:, :, None].float()  # (W, K, N)
    zero = torch.zeros((), device=dev)
    simv = torch.where(valid3, sim, zero)
    dualv = torch.where(valid3, dual, zero)
    packed = torch.stack([simv, dualv, valid3.float()], 1)  # (W, 3, K, L)
    folded = torch.einsum("wakl,wkn->wanl", packed, onehot)

    # time fold: window starts are stride multiples, so each window's L
    # frames split into 4 stride-wide phases landing at time slot
    # start/stride + phase. Within one phase the real windows' slots are
    # distinct; only padded windows (all zero rows) share slot 0, so the
    # index_add_ is exact whatever order the device adds in.
    stride = seq_len // 4
    s16 = vmax // stride
    slot = torch.div(win_start, stride, rounding_mode="floor").long()
    f4 = folded.reshape(w, 3, ntot, 4, stride)
    z = torch.zeros((s16 + 4, 3, ntot, stride), device=dev)
    for c in range(4):
        z.index_add_(0, slot + c, f4[:, :, :, c])
    canvas = z[:s16].permute(1, 2, 0, 3).reshape(3, ntot, vmax)
    sim_c, dual_c, cnt = canvas[0], canvas[1], canvas[2]

    neg = torch.tensor(NEG_FILL, device=dev)
    tv = text_valid.float()
    if cfg.use_alignability_head:
        # binary-head protocol (:197-204): dual head over raw text features,
        # joint head at the layer-3 joint stage (loss.py:344)
        head_dual = out["alignability-dual"][..., 0]
        aj = out["alignability-joint"]
        head_joint = aj[:, min(2, aj.shape[1] - 1), :, 0]
    else:
        # per-text window max over real frames (:191-195)
        head_dual = torch.where(valid3, dual, neg).amax(-1)
        head_joint = torch.where(valid3, sim, neg).amax(-1)
    a_dual = torch.einsum("wk,wkn->n", head_dual * tv, onehot)
    a_joint = torch.einsum("wk,wkn->n", head_joint * tv, onehot)
    t_cnt = torch.einsum("wk,wkn->n", tv, onehot)

    eps = 1e-5
    sim_avg = (sim_c + dual_c) / 2.0 / torch.clamp(cnt, min=eps)
    sim_avg = torch.where(sim_avg == 0.0, neg, sim_avg)  # uncovered cells (:221)
    a_dual = a_dual / torch.clamp(t_cnt, min=eps)
    a_joint = a_joint / torch.clamp(t_cnt, min=eps)

    argmax_t = torch.argmax(sim_avg, dim=-1)  # == prob argmax (softmax monotone)
    scores = sim_avg.amax(-1)
    result = torch.stack([argmax_t.float(), scores, a_dual, a_joint])
    return result, sim_avg


class FusedAlignEvaluator:
    """Reusable fused evaluator over a port ``TemporalAligner``.

    Holds its own copy of the model, with the parameters cast ONCE to
    ``cfg.compute_dtype`` on ``device`` (the JAX body casts them on every
    call)."""

    def __init__(self, model: torch.nn.Module, cfg: AlignEvalConfig, device="cuda"):
        if cfg.use_alignability_head and not getattr(model, "use_alignability_head", 0):
            raise ValueError(
                "cfg.use_alignability_head needs a model built with "
                "use_alignability_head=1 (the binary head emits the scores)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._model = copy.deepcopy(model).to(
            device=self.device, dtype=_DTYPES[cfg.compute_dtype]).eval()

    def update_params(self, state_dict) -> None:
        """Swap in fresh weights (e.g. a training snapshot); they are cast to
        the evaluator's compute dtype and device on the way in."""
        self._model.load_state_dict(state_dict)

    def _cfg_for(self, all_texts_active: Optional[bool]) -> AlignEvalConfig:
        if all_texts_active is None or all_texts_active == self.cfg.all_texts_active:
            return self.cfg
        return dataclasses.replace(self.cfg, all_texts_active=all_texts_active)

    def _process(self, cfg, dims, host_args):
        """Upload one planned group and run it; returns (packed, canvas)."""
        args = [torch.from_numpy(a).to(self.device) for a in host_args]
        with torch.inference_mode():
            return _process_body(self._model, cfg, dims, *args)

    def __call__(self, dataset: Iterable[Dict],
                 all_texts_active: Optional[bool] = None) -> Dict[str, float]:
        cfg = self._cfg_for(all_texts_active)
        return _reduce_metrics(_dispatch(dataset, self._process, cfg), cfg)

    def predict(self, dataset: Iterable[Dict],
                all_texts_active: Optional[bool] = None) -> List[Dict]:
        """Raw per-video predictions (serving path): per text the best second
        'argmax' (video-relative, clamped to >= 0) and max-sim 'score' /
        'align_score' (NEG_FILL sentinel = the text had no covered window)."""
        cfg = self._cfg_for(all_texts_active)
        return _reduce_predictions(_dispatch(dataset, self._process, cfg))


def _plan(dataset, cfg: AlignEvalConfig):
    """Host-side planner (the JAX ``_plan``, :690-844).

    Yields ordered entries:
      ('skip', idx, start, end, aligned, num_text) — a video with no active
        windows;
      ('group', dims, host_args, offsets) — host_args are the numpy arrays to
        upload (video, vscale, text_embed, tscale, win_start, win_len,
        text_idx, text_valid); offsets the per-video result slicing records
        (idx, start, end, aligned, num_text, text_offset, video_offset).
        The scales are always shipped: per-row float32 (ones unless int8) or,
        for int4, float16 group scales beside the nibble-packed tables.
    """
    seq_len = cfg.seq_len
    metas = []
    for item in dataset:
        video = np.asarray(item["video"], dtype=np.float32)
        start = np.asarray(item["start"], dtype=np.float64)
        end = np.asarray(item["end"], dtype=np.float64)
        aligned = np.asarray(item["aligned"]).astype(bool)
        text_embed = np.asarray(item["text_embed"], dtype=np.float32)
        vlen, num_text = video.shape[0], len(start)
        steps = np.arange(0, vlen - seq_len // 2, seq_len // 4)
        if steps.size == 0:
            # a video shorter than seq_len//2: one window covering all of it
            steps = np.zeros(1, np.int64)
        if cfg.all_texts_active:
            full = np.ones(num_text, dtype=bool)
            windows = [(int(st), full) for st in steps]
        else:
            windows = _active_text_masks(steps, vlen, seq_len, num_text,
                                         (start + end) / 2.0, aligned)
        metas.append((video, start, end, aligned, text_embed, windows))

    stride = seq_len // 4
    assert seq_len % 4 == 0 and cfg.global_len_bucket % stride == 0
    int8 = cfg.transfer_dtype == "int8"
    int4 = cfg.transfer_dtype == "int4"
    for g0 in range(0, len(metas), cfg.group_videos):
        block = list(enumerate(metas[g0 : g0 + cfg.group_videos], start=g0))
        chunk = [im for im in block if im[1][5]]
        # skips are yielded before their group; every record carries the
        # video's dataset index so reducers restore dataset order
        for idx, (_, start, end, aligned, _, _) in (im for im in block if not im[1][5]):
            yield ("skip", idx, start, end, aligned, len(start))
        if not chunk:
            continue

        vtot = _round_up(sum(_round_up(m[0].shape[0], stride) for _, m in chunk),
                         cfg.global_len_bucket)
        wtot = _round_up(max(sum(len(m[5]) for _, m in chunk), 1), 16)
        ntot = _round_up(sum(len(m[1]) for _, m in chunk), cfg.text_bucket)
        npad = _round_up(max((int(msk.sum()) for _, m in chunk for _, msk in m[5]),
                             default=1), cfg.text_bucket)
        dv, dt = chunk[0][1][0].shape[1], chunk[0][1][4].shape[1]
        if int4:
            # nibble-packed columns; 0x88 = (q=0, q=0), so the buffer padding
            # dequantizes to exact zeros (a zero byte would decode to -8)
            vb = np.full((vtot, dv // 2), 0x88, np.uint8)
            tb = np.full((ntot, dt // 2), 0x88, np.uint8)
            vscale = np.ones((vtot, dv // _int4_group(dv)), np.float16)
            tscale = np.ones((ntot, dt // _int4_group(dt)), np.float16)
        else:
            tdt = np.int8 if int8 else np.dtype(cfg.transfer_dtype)
            vb = np.zeros((vtot, dv), tdt)
            tb = np.zeros((ntot, dt), tdt)
            vscale = np.ones(vtot, np.float32)
            tscale = np.ones(ntot, np.float32)
        win_start = np.zeros(wtot, np.int64)
        win_len = np.zeros(wtot, np.int64)
        text_idx = np.zeros((wtot, npad), np.int64)
        text_valid = np.zeros((wtot, npad), bool)

        v_off = t_off = w_off = 0
        offsets = []
        for idx, (video, start, end, aligned, text_embed, windows) in chunk:
            vlen, num_text = video.shape[0], len(start)
            vrows, trows = slice(v_off, v_off + vlen), slice(t_off, t_off + num_text)
            if int8:
                vb[vrows], vscale[vrows] = _quantize_rows(video)
                tb[trows], tscale[trows] = _quantize_rows(text_embed)
            elif int4:
                vb[vrows], vscale[vrows] = _quantize_rows_int4(video)
                tb[trows], tscale[trows] = _quantize_rows_int4(text_embed)
            else:
                vb[vrows] = video
                tb[trows] = text_embed
            for i, (step, mask) in enumerate(windows):
                wi = w_off + i
                win_start[wi] = v_off + step
                win_len[wi] = min(vlen, step + seq_len) - step
                idxs = np.nonzero(mask)[0]
                text_idx[wi, : len(idxs)] = t_off + idxs
                text_valid[wi, : len(idxs)] = True
            offsets.append((idx, start, end, aligned, num_text, t_off, v_off))
            # stride-aligned video offsets keep the time fold's phases exact
            v_off += _round_up(vlen, stride)
            t_off += num_text
            w_off += len(windows)
        # padded windows (w_off..wtot) have text_valid all False: they compute
        # on video[0:seq_len] and fold nothing
        yield ("group", (vtot, seq_len),
               (vb, vscale, tb, tscale, win_start, win_len, text_idx, text_valid), offsets)


def _quantize_rows(x: np.ndarray):
    """Per-row symmetric int8 quantization: q = round(x / (absmax/127)).

    Returns (int8 array, float32 per-row scale); zero rows get scale 1."""
    absmax = np.abs(x).max(axis=1)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(x / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def _int4_group(dim: int) -> int:
    """Largest power-of-two group size <= 128 that divides ``dim``."""
    g = 128
    while dim % g:
        g //= 2
    return g


def _quantize_rows_int4(x: np.ndarray):
    """Group-wise symmetric int4 quantization, packed two values a byte.

    Each contiguous group of ``_int4_group(D)`` columns shares one float16
    absmax/7 scale. Values are stored as unsigned nibbles q+8 in [1, 15];
    byte j of a packed row holds columns 2j (low nibble) and 2j+1 (high
    nibble), the layout ``_dequant_int4`` unpacks. A zero byte decodes to
    q = -8 in both nibbles, so buffer padding uses 0x88 (q = 0).

    Returns (uint8 (R, D//2) packed array, float16 (R, D//group) scales)."""
    r, d = x.shape
    if d % 2:
        raise ValueError(f"int4 transfer needs an even feature dim, got {d}")
    g = _int4_group(d)
    grouped = x.reshape(r, d // g, g)
    absmax = np.abs(grouped).max(axis=2)
    scale = np.where(absmax > 0, absmax / 7.0, 1.0).astype(np.float16)
    q = np.clip(
        np.rint(grouped / scale.astype(np.float32)[:, :, None]), -7, 7
    ).astype(np.int8).reshape(r, d)
    u = (q + 8).astype(np.uint8)
    packed = u[:, 0::2] | (u[:, 1::2] << 4)
    return packed, scale


def _dispatch(dataset, process, cfg: AlignEvalConfig):
    """Run every planned group; returns one record per video:
    (idx, start, end, aligned, num_text, text_offset, video_offset, packed)
    where ``packed`` is the group's (4, Ntot) numpy result (None for a video
    with no active windows)."""
    pending = []
    for entry in _plan(dataset, cfg):
        if entry[0] == "skip":
            _, idx, start, end, aligned, num_text = entry
            pending.append((idx, start, end, aligned, num_text, 0, 0, None))
            continue
        _, dims, host_args, offsets = entry
        packed, _ = process(cfg, dims, host_args)
        packed = packed.cpu().numpy()
        for idx, start, end, aligned, num_text, t0, v0 in offsets:
            pending.append((idx, start, end, aligned, num_text, t0, v0, packed))
    return pending


def _reduce_predictions(pending) -> List[Dict]:
    """Per-video prediction reduction (the ``predict`` serving shape)."""
    results, order = [], []
    for idx, start, end, aligned, num_text, t0, v0, packed in pending:
        order.append(idx)
        if packed is None:
            results.append({
                "argmax": np.zeros(num_text, np.int64),
                "score": np.full(num_text, NEG_FILL, np.float32),
                "align_score": np.full(num_text, NEG_FILL, np.float32),
            })
            continue
        # an all-NEG_FILL row (text with no covered window) argmaxes the flat
        # group canvas at global 0; clamp to a video-relative second >= 0
        argmax = np.clip(packed[0, t0 : t0 + num_text].astype(np.int64) - v0, 0, None)
        results.append({
            "argmax": argmax,
            "score": packed[1, t0 : t0 + num_text],
            "align_score": packed[3, t0 : t0 + num_text],
        })
    return [r for _, r in sorted(zip(order, results), key=lambda t: t[0])]


def _reduce_metrics(pending, cfg: AlignEvalConfig) -> Dict[str, float]:
    """Metric reduction over dispatched outputs (HTM-Align R@1 + AUC)."""
    recalls: List[bool] = []
    all_scores: List[np.ndarray] = []
    all_tgts: List[np.ndarray] = []
    for _, start, end, aligned, num_text, t0, v0, packed in pending:
        all_tgts.append(aligned.astype(np.int32))
        if packed is None:
            # no active windows: the host canvas is all NEG_FILL -> uniform
            # softmax -> argmax frame 0 (eval_zeroshot_align.py:222-241)
            all_scores.append(np.zeros(num_text) if cfg.use_alignability_head
                              else np.full(num_text, NEG_FILL))
            for ti in np.nonzero(aligned)[0]:
                recalls.append(math.floor(start[ti]) <= 0 <= math.ceil(end[ti]))
            continue
        argmax_t = packed[0, t0 : t0 + num_text].astype(np.int64)
        scores = packed[1, t0 : t0 + num_text]
        a_joint = packed[3, t0 : t0 + num_text]
        all_scores.append(a_joint if cfg.use_alignability_head else scores)
        for ti in np.nonzero(aligned)[0]:
            rel = int(argmax_t[ti]) - v0
            if scores[ti] <= NEG_FILL * 0.5:  # uncovered row: host argmax is 0
                rel = 0
            recalls.append(math.floor(start[ti]) <= rel <= math.ceil(end[ti]))
    return {
        "Recall": float(np.mean(recalls)),
        "AUC": roc_auc(np.concatenate(all_tgts), np.concatenate(all_scores)),
    }
