"""YouCook2 zero-shot text->video retrieval.

Counterpart of ``exoground_tpu/evals/retrieval.py`` (reference
eval/eval_zeroshot_retrieval.py:156-256): multi-clip feature windows around
each ground-truth segment (``data/youcook2.py``), the dual-encoder video
tower, each clip trimmed back to the segment span, L2 norm -> mean over time
and clips, dot-product similarity, and R1/R5/R10/MR raw, centred and
standardised (compute_metrics from the MIL-NCE repo, :13-26).

The protocol is numpy. Only the callables touch the model: the caller binds
them to a ``TemporalAligner`` (on the card, under ``torch.inference_mode()``)
and to the word2vec tower for raw sentences.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np


def compute_retrieval_metrics(sim: np.ndarray) -> Dict[str, float]:
    """R1/R5/R10/MR from a (queries, candidates) sim matrix with diagonal GT
    (reference :13-26). Score ties with the GT take the FIRST (best) rank
    per row: the upstream np.where would return several hits per tied row
    and shift every metric."""
    sx = np.sort(-sim, axis=1)
    d = -np.diag(sim)[:, None]
    ind = np.argmax(sx == d, axis=1)
    return {
        "R1": float(np.mean(ind == 0)),
        "R5": float(np.mean(ind < 5)),
        "R10": float(np.mean(ind < 10)),
        "MR": float(np.median(ind) + 1),
    }


def test_retrieval_yc2(
    dataset: Iterable[Dict],
    visual_feature_fn: Callable,  # (clips (C,L,D), mask (C,L), interp) -> (C,[Stage,]L,F)
    text_feature_fn: Callable,  # (lang_embed (1,Dt)) -> (1,F)
    text_embed_fn: Optional[Callable[[List[str]], np.ndarray]] = None,
    sim: str = "cos",
    seq_len: int = 64,
) -> Dict[str, float]:
    """Run YC2 retrieval.

    dataset yields per-clip dicts: 'video' (num_clips, L, D), 'start_idx' /
    'end_idx' (num_clips,) segment spans inside each window, and either
    'text_embed' (Dt,) or 'str' (then text_embed_fn is required). Windows
    of ``seq_len`` tokens or more interpolate the positional table
    (``interp = seq_len``)."""
    vis_feats = []
    txt_feats = []
    for item in dataset:
        clips = np.asarray(item["video"], dtype=np.float32)  # (C, L, D)
        start_idx = np.asarray(item["start_idx"]).astype(int)
        end_idx = np.asarray(item["end_idx"]).astype(int)
        interp = seq_len if clips.shape[1] >= seq_len else None
        # all-real windows: the reference passes a zeros key-padding mask
        # (eval_zeroshot_retrieval.py:181-185)
        mask = np.zeros(clips.shape[:2], dtype=bool)
        feats = np.asarray(visual_feature_fn(clips, mask, interp))
        if feats.ndim == 4:  # (C, Stage, L, F): the last stage
            feats = feats[:, -1]

        # trim each clip back to the GT segment span, norm first, then
        # average across time and clips (reference :195-203)
        per_clip = []
        for i in range(feats.shape[0]):
            seg = feats[i, start_idx[i]:end_idx[i]]
            if sim == "cos":
                seg = seg / np.linalg.norm(seg, axis=-1, keepdims=True)
            per_clip.append(seg.mean(axis=0))
        v = np.stack(per_clip, 0).mean(axis=0, keepdims=True)  # (1, F)

        if "text_embed" in item:
            lang = np.asarray(item["text_embed"], dtype=np.float32)[None]
        else:
            lang = np.asarray(text_embed_fn([item["str"]]), dtype=np.float32)
        t = np.asarray(text_feature_fn(lang))  # (1, F)

        if sim == "cos":
            v = v / np.linalg.norm(v, axis=-1, keepdims=True)
            t = t / np.linalg.norm(t, axis=-1, keepdims=True)
        vis_feats.append(v[0])
        txt_feats.append(t[0])

    vis = np.stack(vis_feats, 0)
    txt = np.stack(txt_feats, 0)

    metrics = compute_retrieval_metrics(txt @ vis.T)
    vis_c = vis - vis.mean(0, keepdims=True)
    txt_c = txt - txt.mean(0, keepdims=True)
    center = compute_retrieval_metrics(txt_c @ vis_c.T)
    vis_s = vis_c / vis_c.std(0, keepdims=True)
    txt_s = txt_c / txt_c.std(0, keepdims=True)
    standard = compute_retrieval_metrics(txt_s @ vis_s.T)

    metrics.update({f"C-{k}": v for k, v in center.items()})
    metrics.update({f"S-{k}": v for k, v in standard.items()})
    return metrics
