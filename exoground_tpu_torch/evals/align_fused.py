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

Two ways to run it:

  * streaming (``__call__``, ``predict``): plan, upload and run each group;
  * resident (``preload`` and what takes its handle): the group buffers are
    uploaded once and swept many times, against one checkpoint
    (``run_preloaded``), k checkpoints (``run_many``) or q query batches
    over one video corpus (``preload_queries`` / ``run_queries``).
    ``cfg.preproject`` runs the position-independent input stages once at
    preload.

Both queue every group's work with no host sync; a group's packed result
stays on the device until a reducer reads it (``_Result``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence

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


def _dequant(rows, scale):
    """Feature rows as float32 when the transfer type is int8 (per-row
    scales) or int4 (uint8 nibbles, group scales); float rows as they are."""
    if rows.dtype == torch.int8:
        return rows.float() * scale[..., None]
    if rows.dtype == torch.uint8:
        return _dequant_int4(rows, scale)
    return rows


def _gather_features(table, scale, idx, dtype):
    """Rows ``idx`` of an uploaded feature table, dequantized, then cast to
    the compute type."""
    rows = table[idx]
    if table.dtype in (torch.int8, torch.uint8):
        rows = _dequant(rows, scale[idx])
    return rows.to(dtype)


def _process_body(model, cfg: AlignEvalConfig, dims, video, vscale, text_embed, tscale,
                  win_start, win_len, text_idx, text_valid):
    """One group on the device (the JAX ``_process_body``, :75-213).

    Returns the packed (4, Ntot) float32 result [argmax, score, a_dual,
    a_joint] and the (Ntot, Vmax) overlap-averaged canvas it was reduced
    from. ``model`` already holds its parameters in ``cfg.compute_dtype``.
    Under ``cfg.preproject`` the video and text tables hold the outputs of
    the input stages (``FusedAlignEvaluator._preproject``)."""
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
                                    lang_padding_mask=tmask,
                                    preprojected=cfg.preproject)
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


class _Body(torch.nn.Module):
    """``_process_body`` as a module over the evaluator's model, so that
    ``torch.func.functional_call`` can run it with another checkpoint's
    tensors in place of the model's (``_process_many``)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, cfg, dims, *args):
        return _process_body(self.model, cfg, dims, *args)


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
        self._body = _Body(copy.deepcopy(model).to(
            device=self.device, dtype=_DTYPES[cfg.compute_dtype]).eval())
        self._model = self._body.model
        # bumped by update_params; a preprojected handle is pinned to the
        # generation whose input stages it holds
        self._params_gen = 0

    def update_params(self, state_dict) -> None:
        """Swap in fresh weights (e.g. a training snapshot); they are cast to
        the evaluator's compute dtype and device on the way in."""
        self._model.load_state_dict(state_dict)
        self._params_gen += 1

    def _cfg_for(self, all_texts_active: Optional[bool]) -> AlignEvalConfig:
        if all_texts_active is None or all_texts_active == self.cfg.all_texts_active:
            return self.cfg
        return dataclasses.replace(self.cfg, all_texts_active=all_texts_active)

    def _process(self, cfg, dims, args):
        """Run one uploaded group (``_upload``); returns (packed, canvas)."""
        with torch.inference_mode():
            return _process_body(self._model, cfg, dims, *args)

    def _process_many(self, cfg, dims, stacked: "StackedCheckpoints", args):
        """The same body once per stacked checkpoint over one group's
        resident buffers -> one (k, 4, Ntot) device tensor."""
        with torch.inference_mode():
            return torch.stack([
                torch.func.functional_call(self._body, sd, (cfg, dims, *args))[0]
                for sd in stacked.state_dicts])

    def _process_queries(self, cfg, dims, args):
        """The same body once per query batch: the video buffers are shared,
        the text-side args carry a leading (q,) axis -> (q, 4, Ntot)."""
        video, vscale, *text_side = args
        with torch.inference_mode():
            return torch.stack([
                _process_body(self._model, cfg, dims, video, vscale, *(a[i] for a in text_side))[0]
                for i in range(text_side[0].shape[0])])

    def _preproject(self, args):
        """The index-time half of the serving split (the JAX
        ``_preproject_fn``): dequantize the uploaded video and text tables
        and run the position-independent input stages over them once
        (``preproject_video`` / ``preproject_text``; any leading dims, so a
        (q, Ntot, D) text stack goes in one call). It runs under the default
        matmul context whatever ``cfg.matmul_dtype`` says, so the input
        stages stay exact under int8. The scale args stay in place (a float
        table ignores them)."""
        dtype = _DTYPES[self.cfg.compute_dtype]
        video, vscale, text, tscale = args[:4]
        with torch.inference_mode(), quant.matmul_impl("default"):
            zv = self._model.preproject_video(_dequant(video, vscale).to(dtype))
            zt = self._model.preproject_text(_dequant(text, tscale).to(dtype))
        return (zv, vscale, zt, tscale) + tuple(args[4:])

    def _check_not_preproject(self, what: str):
        if self.cfg.preproject:
            raise ValueError(
                f"cfg.preproject is a resident-serving mode; {what} has no preload to "
                "amortize the input stages into: build this evaluator with "
                "preproject=False, or use preload/run_preloaded or "
                "preload_queries/run_queries")

    def _check_params_pin(self, pre):
        if pre.params_gen is not None and pre.params_gen != self._params_gen:
            raise ValueError(
                "this preload was preprojected with other weights (cfg.preproject "
                "holds the input stages' outputs in the resident buffers): preload "
                "again after update_params")

    def __call__(self, dataset: Iterable[Dict],
                 all_texts_active: Optional[bool] = None) -> Dict[str, float]:
        self._check_not_preproject("streaming evaluation")
        cfg = self._cfg_for(all_texts_active)
        return _reduce_metrics(
            _dispatch(_placed_plan(dataset, cfg, self.device), self._process, cfg), cfg)

    def predict(self, dataset: Iterable[Dict],
                all_texts_active: Optional[bool] = None) -> List[Dict]:
        """Raw per-video predictions (serving path): per text the best second
        'argmax' (video-relative, clamped to >= 0) and max-sim 'score' /
        'align_score' (NEG_FILL sentinel = the text had no covered window)."""
        self._check_not_preproject("predict() (one-shot streaming)")
        cfg = self._cfg_for(all_texts_active)
        return _reduce_predictions(
            _dispatch(_placed_plan(dataset, cfg, self.device), self._process, cfg))

    # ------------------------------------------------------------------
    # resident serving: upload once, sweep many times
    # ------------------------------------------------------------------

    def preload(self, dataset: Iterable[Dict],
                all_texts_active: Optional[bool] = None) -> "PreloadedEval":
        """Upload a dataset's planned group buffers to the device once and
        return a handle for repeated sweeps (``run_preloaded``,
        ``run_many``). Under ``cfg.preproject`` the input stages run here,
        once, and the handle is pinned to the current weights."""
        cfg = self._cfg_for(all_texts_active)
        entries = []
        for entry in _placed_plan(dataset, cfg, self.device):
            if entry[0] == "group" and cfg.preproject:
                _, dims, args, offsets = entry
                entry = ("group", dims, self._preproject(args), offsets)
            entries.append(entry)
        return PreloadedEval(tuple(entries), cfg,
                             self._params_gen if cfg.preproject else None)

    def dispatch_preloaded(self, pre: "PreloadedEval") -> List:
        """Queue one sweep over the resident buffers with no host sync. Pair
        with ``reduce_preloaded``; under continuous load, queue sweep k+1
        before reducing sweep k and the card does not idle between sweeps."""
        self._check_params_pin(pre)
        return _dispatch(pre.entries, self._process, pre.cfg)

    @staticmethod
    def reduce_preloaded(pending: List, pre) -> Dict[str, float]:
        """Fetch and metric-reduce one dispatched sweep (any handle's cfg)."""
        return _reduce_metrics(pending, pre.cfg)

    def run_preloaded(self, pre: "PreloadedEval") -> Dict[str, float]:
        """One metric sweep over the resident buffers (see ``preload``)."""
        return _reduce_metrics(self.dispatch_preloaded(pre), pre.cfg)

    def stack_checkpoints(self, state_dicts) -> "StackedCheckpoints":
        """k state dicts of this evaluator's model (one key set, one set of
        shapes), each cast once to the compute dtype and moved once to the
        device, for ``run_many`` / ``dispatch_many``. Build it once and reuse
        it across sweeps: each checkpoint keeps its own tensors, so the int8
        weight cache (``quant.quantized_weight``) keeps one entry each."""
        if not state_dicts:
            raise ValueError("stack_checkpoints needs at least one state dict")
        ref = self._body.state_dict()
        for i, sd in enumerate(state_dicts):
            keys = {f"model.{k}" for k in sd}
            shapes_ok = keys == set(ref) and all(
                tuple(v.shape) == tuple(ref[f"model.{k}"].shape) for k, v in sd.items())
            if not shapes_ok:
                raise ValueError(
                    f"checkpoint {i} does not match the evaluator's model: run_many needs "
                    "state dicts with its key set and shapes (one model config)")
        with torch.no_grad():
            dicts = tuple(
                {f"model.{k}": torch.as_tensor(v).to(
                    device=self.device, dtype=ref[f"model.{k}"].dtype, copy=True)
                 for k, v in sd.items()}
                for sd in state_dicts)
        return StackedCheckpoints(dicts, len(dicts))

    def run_many(self, pre: "PreloadedEval", state_dicts) -> List[Dict[str, float]]:
        """Score many checkpoints against one resident corpus, one packed
        result and one D2H copy a group for all of them. Entry i equals
        ``update_params(state_dicts[i]); run_preloaded(pre)``.
        ``state_dicts``: a sequence of state dicts, or a
        ``StackedCheckpoints`` from ``stack_checkpoints``."""
        if isinstance(state_dicts, StackedCheckpoints):
            stacked = state_dicts
        elif not state_dicts:
            return []
        else:
            stacked = self.stack_checkpoints(state_dicts)
        return [_reduce_metrics(p, pre.cfg) for p in self.dispatch_many(pre, stacked)]

    def dispatch_many(self, pre: "PreloadedEval",
                      stacked: "StackedCheckpoints") -> List[List]:
        """Queue one k-checkpoint sweep with no host sync: k pending lists,
        each reducible with ``reduce_preloaded``."""
        if pre.params_gen is not None:
            raise ValueError(
                "run_many/dispatch_many need a preload without cfg.preproject: its "
                "resident buffers hold one checkpoint's input stages")
        pendings: List[List] = [[] for _ in range(stacked.k)]
        for entry in pre.entries:
            if entry[0] == "skip":
                for p in pendings:
                    p.append(_skip_record(entry))
                continue
            _, dims, args, offsets = entry
            outs = _Result(self._process_many(pre.cfg, dims, stacked, args))
            for i, p in enumerate(pendings):
                row = _StackRow(outs, i)
                p.extend(rec + (row,) for rec in offsets)
        return pendings

    def preload_queries(self, query_batches: Sequence[Iterable[Dict]],
                        all_texts_active: Optional[bool] = None) -> "PreloadedQueries":
        """Upload ONE video corpus and q query batches over it.

        ``query_batches``: q datasets over the same videos in the same order
        (identical ``video`` features; only ``text_embed`` / ``start`` /
        ``end`` / ``aligned`` may differ), checked here: the same group
        count, the same dims and bitwise-equal video buffers, else
        ``ValueError``. Each group's text-side args are padded to the
        largest dims of the batches (text tables with 0, or 0x88 for int4;
        scales with 1) and stacked on a leading (q,) axis, uploaded once
        with the corpus. ``run_queries`` entry i equals evaluating batch i
        alone."""
        cfg = self._cfg_for(all_texts_active)
        plans = [list(_plan(ds, cfg, keep_empty=True)) for ds in query_batches]
        if not plans:
            raise ValueError("preload_queries needs at least one query batch")
        if any(len(p) != len(plans[0]) for p in plans):
            raise ValueError("query batches plan different group counts: the batches must "
                             "cover the same videos in the same order")
        pad_table = 0x88 if cfg.transfer_dtype == "int4" else 0
        entries = []
        for g, (_, dims, base, _) in enumerate(plans[0]):
            rows = [p[g] for p in plans]
            for i, (_, dims_i, args, _) in enumerate(rows):
                if dims_i != dims or args[2].shape[1:] != base[2].shape[1:]:
                    raise ValueError(f"group {g}: query batch {i} has other dims "
                                     f"({dims_i} against {dims})")
                if not (np.array_equal(args[0], base[0]) and np.array_equal(args[1], base[1])):
                    raise ValueError(f"group {g}: query batch {i} packs other video "
                                     "buffers: preload_queries serves one corpus")
            ntot = max(r[2][2].shape[0] for r in rows)
            wtot = max(r[2][4].shape[0] for r in rows)
            npad = max(r[2][6].shape[1] for r in rows)
            stacked = tuple(np.stack(x) for x in zip(*[
                (_pad_rows(a[2], ntot, pad_table), _pad_rows(a[3], ntot, 1),
                 _pad_rows(a[4], wtot), _pad_rows(a[5], wtot),
                 _pad_2d(a[6], wtot, npad), _pad_2d(a[7], wtot, npad))
                for a in (r[2] for r in rows)]))
            args = _upload(base[:2] + stacked, self.device)
            if cfg.preproject:
                args = self._preproject(args)
            entries.append(("group", dims, args, tuple(r[3] for r in rows)))
        return PreloadedQueries(tuple(entries), cfg, len(plans),
                                self._params_gen if cfg.preproject else None)

    def dispatch_queries(self, pq: "PreloadedQueries") -> List[List]:
        """Queue one q-batch sweep with no host sync: q pending lists, each
        reducible with ``reduce_preloaded``."""
        self._check_params_pin(pq)
        pendings: List[List] = [[] for _ in range(pq.q)]
        for _, dims, args, offsets_list in pq.entries:
            outs = _Result(self._process_queries(pq.cfg, dims, args))
            for i, p in enumerate(pendings):
                row = _StackRow(outs, i)
                p.extend(rec + (row,) for rec in offsets_list[i])
        return pendings

    def run_queries(self, pq: "PreloadedQueries") -> List[Dict[str, float]]:
        """Metrics of every preloaded query batch (see ``preload_queries``)."""
        return [_reduce_metrics(p, pq.cfg) for p in self.dispatch_queries(pq)]

    def predict_queries(self, pq: "PreloadedQueries") -> List[List[Dict]]:
        """``predict``-shaped results of every preloaded query batch. Entry i
        equals ``predict(batch_i)``, with one edge: a video none of whose
        texts activates a window reports align_score 0 (the uncovered-text
        value of the device canvas) where ``predict`` reports NEG_FILL;
        'score' carries the sentinel on both paths."""
        return [_reduce_predictions(p) for p in self.dispatch_queries(pq)]


@dataclasses.dataclass(frozen=True)
class StackedCheckpoints:
    """k checkpoints on the device (``FusedAlignEvaluator.stack_checkpoints``):
    one dict of tensors each, keyed for ``functional_call`` on the
    evaluator's ``_Body``."""
    state_dicts: tuple
    k: int


@dataclasses.dataclass(frozen=True)
class PreloadedEval:
    """Resident eval handle (``FusedAlignEvaluator.preload``): the uploaded
    group buffers and the result-slicing records. The weights are not part
    of it (one preload serves many checkpoints) except under
    ``cfg.preproject``, where ``params_gen`` pins it to the evaluator's
    weights generation whose input stages it holds."""
    entries: tuple
    cfg: AlignEvalConfig
    params_gen: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class PreloadedQueries:
    """q query batches resident against one uploaded video corpus
    (``FusedAlignEvaluator.preload_queries``): per group the video buffers,
    the (q, ...)-stacked text-side args and each batch's slicing records."""
    entries: tuple
    cfg: AlignEvalConfig
    q: int
    params_gen: Optional[int] = None


def _plan(dataset, cfg: AlignEvalConfig, keep_empty: bool = False):
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

    ``keep_empty`` (``preload_queries``): a video with no active window stays
    in its group with no valid window, so every query batch over one corpus
    packs the same groups. Its canvas stays uncovered: every text scores the
    NEG_FILL sentinel and argmaxes to 0, as the 'skip' entry reports it.
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
        chunk = block if keep_empty else [im for im in block if im[1][5]]
        # skips are yielded before their group; every record carries the
        # video's dataset index so reducers restore dataset order
        for idx, (_, start, end, aligned, _, _) in (im for im in block
                                                    if not keep_empty and not im[1][5]):
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


def _upload(host_args, device) -> tuple:
    """The one place where a group's host arrays become device tensors,
    shared by the streaming and the resident paths."""
    return tuple(torch.from_numpy(a).to(device) for a in host_args)


def _placed_plan(dataset, cfg: AlignEvalConfig, device):
    """``_plan`` with every group's arrays uploaded to ``device``: yields the
    'skip' entries as they are and ('group', dims, args, offsets) with
    device tensors. One device: ``eval_devices > 1`` raises in
    ``AlignEvalConfig``."""
    for entry in _plan(dataset, cfg):
        if entry[0] == "group":
            _, dims, host_args, offsets = entry
            entry = ("group", dims, _upload(host_args, device), offsets)
        yield entry


def _skip_record(entry):
    _, idx, start, end, aligned, num_text = entry
    return (idx, start, end, aligned, num_text, 0, 0, None)


def _dispatch(entries, process, cfg: AlignEvalConfig):
    """Queue every group of ``entries`` (``_placed_plan``'s, or a preload's)
    with no host sync; returns one record per video:
    (idx, start, end, aligned, num_text, text_offset, video_offset, out)
    where ``out`` is the group's lazy packed result (None for a video with
    no active windows)."""
    pending = []
    for entry in entries:
        if entry[0] == "skip":
            pending.append(_skip_record(entry))
            continue
        _, dims, args, offsets = entry
        out = _Result(process(cfg, dims, args)[0])
        pending.extend(rec + (out,) for rec in offsets)
    return pending


class _Result:
    """A dispatched group's packed result, left on the device until a reducer
    reads it. ``prefetch`` starts its D2H copy (once) into pinned host memory
    with ``non_blocking=True`` and records an event; ``np.asarray`` waits on
    that event only. A result on the CPU is read as it is, with no copy."""

    __slots__ = ("_dev", "_host", "_event")

    def __init__(self, dev: torch.Tensor):
        self._dev, self._host, self._event = dev, None, None

    def prefetch(self) -> None:
        if self._host is not None:
            return
        if self._dev.device.type == "cpu":
            self._host = self._dev
            return
        self._host = torch.empty(self._dev.shape, dtype=self._dev.dtype, pin_memory=True)
        self._host.copy_(self._dev, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def __array__(self, dtype=None, copy=None):
        self.prefetch()
        if self._event is not None:
            self._event.synchronize()
        a = self._host.numpy()
        return a if dtype is None else a.astype(dtype)


class _StackRow:
    """Row ``i`` of a stacked (k or q, 4, Ntot) ``_Result``: one D2H copy
    serves every row."""

    __slots__ = ("_stack", "_i")

    def __init__(self, stack: _Result, i: int):
        self._stack, self._i = stack, i

    def prefetch(self) -> None:
        self._stack.prefetch()

    def __array__(self, dtype=None, copy=None):
        row = np.asarray(self._stack)[self._i]
        return row if dtype is None else row.astype(dtype)


def _prefetch(pending):
    """Start every result's D2H copy before the first wait on one."""
    for rec in pending:
        if rec[-1] is not None:
            rec[-1].prefetch()
    return pending


def _pad_rows(a: np.ndarray, n: int, value=0) -> np.ndarray:
    """Pad axis 0 of ``a`` to ``n`` rows with ``value`` (a no-op when equal).
    Padded text-table rows are never indexed by a valid window."""
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], value, a.dtype)
    return np.concatenate([a, pad], axis=0)


def _pad_2d(a: np.ndarray, n0: int, n1: int) -> np.ndarray:
    """Zero-pad a 2-D array to (n0, n1) (padded cells carry valid=False)."""
    if a.shape == (n0, n1):
        return a
    out = np.zeros((n0, n1), a.dtype)
    out[: a.shape[0], : a.shape[1]] = a
    return out


def _reduce_predictions(pending) -> List[Dict]:
    """Per-video prediction reduction (the ``predict`` serving shape)."""
    results, order = [], []
    for idx, start, end, aligned, num_text, t0, v0, out in _prefetch(pending):
        order.append(idx)
        if out is None:
            results.append({
                "argmax": np.zeros(num_text, np.int64),
                "score": np.full(num_text, NEG_FILL, np.float32),
                "align_score": np.full(num_text, NEG_FILL, np.float32),
            })
            continue
        packed = np.asarray(out)
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
    for _, start, end, aligned, num_text, t0, v0, out in _prefetch(pending):
        all_tgts.append(aligned.astype(np.int32))
        if out is None:
            # no active windows: the host canvas is all NEG_FILL -> uniform
            # softmax -> argmax frame 0 (eval_zeroshot_align.py:222-241)
            all_scores.append(np.zeros(num_text) if cfg.use_alignability_head
                              else np.full(num_text, NEG_FILL))
            for ti in np.nonzero(aligned)[0]:
                recalls.append(math.floor(start[ti]) <= 0 <= math.ceil(end[ti]))
            continue
        packed = np.asarray(out)
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
