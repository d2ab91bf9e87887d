"""HTM-Align zero-shot alignment evaluation: the host protocol.

Counterpart of ``exoground_tpu/evals/align.py`` (reference
eval/eval_zeroshot_align.py:96-252):

  * overlap-seq: seq_len windows at stride seq_len/4; per window the active
    text span comes from NON-alignable texts' ASR midpoints only (:143-167);
    per-window joint+dual sims accumulate into (text, time) canvases averaged
    by overlap counters (:197-204); final sim = (joint + dual) / 2 (:205);
    uncovered cells filled -6e4 before the time softmax (:221-222); R@1 =
    argmax frame inside [floor(start), ceil(end)] for alignable texts
    (:234-237); ROC-AUC over per-text max-over-time sim or the alignability
    head (:225-229,248).
  * global: one pass over the full video with pos-emb interpolation
    (:207-216).

All windows of a video are padded to shared (window, text) shapes and
key-padding-masked, which is numerically identical to excluding them. This
host protocol is the oracle of the device-resident evaluator
(``evals/align_fused.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from exoground_tpu_torch.ops import quant
from exoground_tpu_torch.utils.shapes import round_up as _round_up

NEG_FILL = -6e4


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """ROC-AUC via the rank statistic (Mann-Whitney U), ties averaged."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores).astype(np.float64)
    n_pos = int(labels.sum())
    n_neg = int((~labels).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    sorted_scores = scores[order]
    i = 0
    rank_vals = np.arange(1, len(scores) + 1, dtype=np.float64)
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        rank_vals[i : j + 1] = (i + j + 2) / 2.0
        i = j + 1
    ranks[order] = rank_vals
    u = ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


TRANSFER_DTYPES = ("float32", "float16", "int8", "int4")


@dataclasses.dataclass
class AlignEvalConfig:
    """The JAX package's AlignEvalConfig, field for field (see its comments).
    ``transfer_dtype`` int8 / int4 quantize the features on the host and
    dequantize them on the device; ``matmul_dtype="int8"`` runs the model
    under ``quant.matmul_impl("int8", min_cols=int8_min_cols)``;
    ``preproject`` is a resident-serving mode (``FusedAlignEvaluator.preload``).
    ``eval_devices > 1`` waits for the multi-device slice and raises
    ``NotImplementedError``."""

    seq_len: int = 64
    method: str = "overlap-seq"  # 'overlap-seq' | 'global'
    use_alignability_head: bool = False
    sim_scale: float = 1.0 / 0.07
    window_chunk: int = 32
    pad_window_chunk: bool = True
    text_bucket: int = 16
    global_len_bucket: int = 128
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    group_videos: int = 8
    transfer_dtype: str = "float32"  # 'float32' | 'float16' | 'int8' | 'int4'
    matmul_dtype: str = "default"  # 'default' | 'int8' (ops/quant.py)
    int8_min_cols: int = 0  # under 'int8': products narrower than this stay exact
    all_texts_active: bool = False
    eval_devices: int = 1
    preproject: bool = False

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: float32 or bfloat16")
        if self.transfer_dtype not in TRANSFER_DTYPES:
            raise ValueError(f"transfer_dtype {self.transfer_dtype!r}: one of "
                             f"{TRANSFER_DTYPES}")
        if self.matmul_dtype not in quant.VALID_IMPLS:
            raise ValueError(f"matmul_dtype {self.matmul_dtype!r}: one of "
                             f"{quant.VALID_IMPLS}")
        if self.eval_devices > 1:
            raise NotImplementedError(
                "AlignEvalConfig.eval_devices > 1 arrives with the multi-device "
                "slice of the PyTorch port")


def make_tan_sim_fn(model) -> Callable:
    """Batched-window similarity fn for a port TemporalAligner, on the
    model's device; the features go in as the model's type (a bfloat16
    model takes bfloat16 inputs).

    Returns fn(video (W,L,Dv), vmask (W,L), text (W,N,Dt), tmask (W,N),
    interpolate_from=None, pos_interp_len=None) -> dict of numpy arrays:
      sim, dual-sim: (W, K, L) last stage
      alignability-dual (W, K), alignability-joint (W, K) (stage 2) and
      alignability-joint-last (W, K) when the head is enabled.
    """
    param = next(model.parameters())
    device, dtype = param.device, param.dtype

    def sim_fn(video, vmask, text, tmask, interpolate_from=None,
               pos_interp_len=None):
        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        with torch.inference_mode():
            kw = {}
            if interpolate_from is not None:
                kw = dict(interpolate_from=interpolate_from,
                          pos_interp_len=(np.asarray(video).shape[1]
                                          if pos_interp_len is None
                                          else pos_interp_len))
            out = model.text_visual_sim(
                dev(video, dtype), dev(text, dtype),
                video_padding_mask=dev(vmask, torch.bool),
                lang_padding_mask=dev(tmask, torch.bool), **kw)
            res = {
                "sim": out["sim"][:, -1].transpose(1, 2).float().cpu().numpy(),
                "dual-sim": out["dual-sim"][:, -1].transpose(1, 2).float().cpu().numpy(),
            }
            if "alignability-dual" in out:
                res["alignability-dual"] = out["alignability-dual"][..., 0].float().cpu().numpy()
                aj = out["alignability-joint"]
                # overlap-seq reads joint stage 2 (eval_zeroshot_align.py:186),
                # global mode the last stage (:213)
                res["alignability-joint"] = aj[:, min(2, aj.shape[1] - 1), :, 0].float().cpu().numpy()
                res["alignability-joint-last"] = aj[:, -1, :, 0].float().cpu().numpy()
        return res

    return sim_fn


def _active_text_masks(steps, vlen, seq_len, num_text, mid_ts, aligned):
    """Per-window active-text masks from non-alignable ASR midpoints
    (reference :143-167). Returns list of (step, mask) for non-skipped windows."""
    nonalignable = ~aligned.astype(bool)
    na_idx = np.arange(num_text)[nonalignable]
    na_mid = mid_ts[nonalignable]
    out = []
    for idx, step in enumerate(steps):
        in_win = (step - seq_len <= na_mid) & (na_mid <= step + 2 * seq_len)
        active_na = na_idx[in_win]
        if len(active_na) == 0:
            continue
        left, right = int(active_na.min()), int(active_na.max())
        if idx <= 3:
            left = 0
        elif idx >= len(steps) - 4:
            right = vlen  # reference quirk: clamps to num_text via slicing
        mask = np.zeros(num_text, dtype=bool)
        mask[left : right + 1] = True
        out.append((int(step), mask))
    return out


def _softmax_f32(sim: np.ndarray) -> np.ndarray:
    """Time softmax in float32, as the JAX protocol computes it."""
    return torch.softmax(torch.from_numpy(sim.astype(np.float32)), dim=-1).numpy()


def test_alignment_htm(
    dataset: Iterable[Dict],
    sim_fn: Callable,
    cfg: AlignEvalConfig,
    text_embed_fn: Optional[Callable[[List[str]], np.ndarray]] = None,
) -> Dict[str, float]:
    """Run the HTM-Align protocol over per-video dicts with 'video' (vlen, Dv),
    'start'/'end' (N,) seconds, 'aligned' (N,) 0/1 and 'text_embed' (N, Dt)
    (or 'text' with ``text_embed_fn``)."""
    recalls: List[bool] = []
    all_scores: List[np.ndarray] = []
    all_tgts: List[np.ndarray] = []
    seq_len = cfg.seq_len

    for item in dataset:
        video = np.asarray(item["video"], dtype=np.float32)
        start = np.asarray(item["start"], dtype=np.float64)
        end = np.asarray(item["end"], dtype=np.float64)
        aligned = np.asarray(item["aligned"]).astype(bool)
        if "text_embed" in item:
            text_embed = np.asarray(item["text_embed"], dtype=np.float32)
        else:
            text_embed = np.asarray(text_embed_fn(item["text"]), dtype=np.float32)
        vlen, num_text = video.shape[0], len(start)

        if cfg.method == "overlap-seq":
            steps = np.arange(0, vlen - seq_len // 2, seq_len // 4)
            mid_ts = (start + end) / 2.0
            windows = _active_text_masks(steps, vlen, seq_len, num_text, mid_ts, aligned)

            sim_canvas = np.zeros((num_text, vlen), dtype=np.float64)
            dual_canvas = np.zeros((num_text, vlen), dtype=np.float64)
            counter = np.zeros((num_text, vlen), dtype=np.float64)
            a_joint = np.zeros(num_text, dtype=np.float64)
            t_counter = np.zeros(num_text, dtype=np.float64)

            if windows:
                n_pad = _round_up(max(int(m.sum()) for _, m in windows), cfg.text_bucket)
                for lo in range(0, len(windows), cfg.window_chunk):
                    chunk = windows[lo : lo + cfg.window_chunk]
                    w_pad = cfg.window_chunk if cfg.pad_window_chunk else len(chunk)
                    vb = np.zeros((w_pad, seq_len, video.shape[1]), np.float32)
                    vm = np.ones((w_pad, seq_len), bool)
                    tb = np.zeros((w_pad, n_pad, text_embed.shape[1]), np.float32)
                    tm = np.ones((w_pad, n_pad), bool)
                    spans, idx_lists = [], []
                    for i, (step, mask) in enumerate(chunk):
                        hi = min(vlen, step + seq_len)
                        ln = hi - step
                        vb[i, :ln] = video[step:hi]
                        vm[i, :ln] = False
                        idxs = np.nonzero(mask)[0]
                        tb[i, : len(idxs)] = text_embed[idxs]
                        tm[i, : len(idxs)] = False
                        spans.append((step, hi))
                        idx_lists.append(idxs)

                    out = sim_fn(vb, vm, tb, tm)
                    sim = out["sim"] * cfg.sim_scale  # (W, K, L)
                    dual = out["dual-sim"] * cfg.sim_scale
                    for i, ((step, hi), idxs) in enumerate(zip(spans, idx_lists)):
                        ln = hi - step
                        k = len(idxs)
                        sim_canvas[idxs, step:hi] += sim[i, :k, :ln]
                        dual_canvas[idxs, step:hi] += dual[i, :k, :ln]
                        counter[idxs, step:hi] += 1
                        if cfg.use_alignability_head:
                            a_joint[idxs] += out["alignability-joint"][i, :k]
                            t_counter[idxs] += 1

            eps = 1e-5
            sim_canvas /= np.maximum(counter, eps)
            dual_canvas /= np.maximum(counter, eps)
            a_joint /= np.maximum(t_counter, eps)
            sim = (sim_canvas + dual_canvas) / 2.0

        elif cfg.method == "global":
            pad_len = _round_up(vlen, cfg.global_len_bucket)
            vb = np.zeros((1, pad_len, video.shape[1]), np.float32)
            vb[0, :vlen] = video
            vm = np.ones((1, pad_len), bool)
            vm[0, :vlen] = False
            tb = text_embed[None]
            tm = np.zeros((1, num_text), bool)
            out = sim_fn(vb, vm, tb, tm, interpolate_from=seq_len, pos_interp_len=vlen)
            sim = out["sim"][0, :, :vlen] * cfg.sim_scale
            if cfg.use_alignability_head:
                a_joint = out["alignability-joint-last"][0]
        else:
            raise ValueError(cfg.method)

        sim = np.where(sim == 0, NEG_FILL, sim)
        prob = _softmax_f32(sim)

        all_tgts.append(aligned.astype(np.int32))
        if cfg.use_alignability_head:
            all_scores.append(np.asarray(a_joint))
        else:
            all_scores.append(sim.max(axis=-1))

        for s_, e_, p in zip(start[aligned], end[aligned], prob[aligned]):
            am = int(p.argmax())
            recalls.append(math.floor(s_) <= am <= math.ceil(e_))

    scores = np.concatenate(all_scores, 0)
    tgts = np.concatenate(all_tgts, 0)
    return {"Recall": float(np.mean(recalls)), "AUC": roc_auc(tgts, scores)}
