"""Batch assembly with static shapes.

A copy of ``exoground_tpu/data/collate.py`` (the port imports nothing of the
JAX package). The reference collates to max-length-in-batch (pad_sequence_by_last,
data/loader_htm.py:13-23; pad_sequence(padding_value=1) for masks,
loader_htm.py:115). Dynamic max-length shapes would force one XLA
recompilation per batch in the JAX package (and a new shape for
every cached allocation and plan on the card), so here every array is padded to a *fixed bucket*
(seq_bucket / text_bucket) instead; the extra tail is masked. Semantics kept:

  * video padded by REPEATING THE LAST FRAME (not zeros)
  * padding masks pad with True (=PAD)
  * per-text start/end padded with 0
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def pad_by_last(x: np.ndarray, length: int) -> np.ndarray:
    """(t, ...) -> (length, ...), tail filled with x[-1] (loader_htm.py:13-23).

    A zero-length input (annotation window past the end of a truncated
    feature file) pads with zeros — there is no last frame to repeat."""
    t = x.shape[0]
    if t >= length:
        return x[:length]
    if t == 0:
        return np.zeros((length,) + x.shape[1:], dtype=x.dtype)
    out = np.empty((length,) + x.shape[1:], dtype=x.dtype)
    out[:t] = x
    out[t:] = x[-1]
    return out


def pad_zeros(x: np.ndarray, length: int, value=0) -> np.ndarray:
    t = x.shape[0]
    if t >= length:
        return x[:length]
    out = np.full((length,) + x.shape[1:], value, dtype=x.dtype)
    out[:t] = x
    return out


def stack_videos(videos: Sequence[np.ndarray], seq_bucket: int) -> Dict[str, np.ndarray]:
    """List of (t_i, C) -> video (B, T, C) f32 + padding_mask (B, T) bool."""
    b = len(videos)
    c = videos[0].shape[-1]
    video = np.empty((b, seq_bucket, c), dtype=np.float32)
    mask = np.ones((b, seq_bucket), dtype=bool)
    for i, v in enumerate(videos):
        t = min(v.shape[0], seq_bucket)
        video[i] = pad_by_last(np.asarray(v, np.float32), seq_bucket)
        mask[i, :t] = False
    return {"video": video, "video_padding_mask": mask}


def stack_texts(
    tokens: Sequence[np.ndarray],  # per-sample (n_i, L) int arrays
    starts: Sequence[Sequence[float]],
    ends: Sequence[Sequence[float]],
    text_bucket: int,
) -> Dict[str, np.ndarray]:
    """Ragged per-sample sentence sets -> fixed (B, N, L)/(B, N) arrays."""
    b = len(tokens)
    l = tokens[0].shape[-1] if tokens[0].ndim == 2 else 1
    tok = np.zeros((b, text_bucket, l), dtype=np.int32)
    start = np.zeros((b, text_bucket), dtype=np.float32)
    end = np.zeros((b, text_bucket), dtype=np.float32)
    mask = np.ones((b, text_bucket), dtype=bool)
    for i in range(b):
        n = min(len(starts[i]), text_bucket)
        if n:
            tok[i, :n] = np.asarray(tokens[i], np.int32).reshape(len(starts[i]), l)[:n]
            start[i, :n] = np.asarray(starts[i], np.float32)[:n]
            end[i, :n] = np.asarray(ends[i], np.float32)[:n]
            mask[i, :n] = False
    return {"token": tok, "start": start, "end": end, "text_padding_mask": mask}


def stack_features(
    feats: Sequence[np.ndarray], bucket: int, dim: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """Ragged (n_i, C) feature sets -> (B, N, C) zero-padded + mask."""
    b = len(feats)
    c = dim if dim is not None else next(
        (f.shape[-1] for f in feats if f.size), 1
    )
    out = np.zeros((b, bucket, c), dtype=np.float32)
    mask = np.ones((b, bucket), dtype=bool)
    for i, f in enumerate(feats):
        f = np.asarray(f, np.float32).reshape(-1, c) if f.size else f
        n = min(len(f), bucket) if f.size else 0
        if n:
            out[i, :n] = f[:n]
            mask[i, :n] = False
    return {"features": out, "padding_mask": mask}


def collate_dicts(items: List[Dict[str, np.ndarray]], meta_keys=("metadata",)) -> Dict:
    """default_collate parity for fixed-shape dict samples: np.stack every
    array key, list-ify metadata (reference loader_egoexo4d.py:164-176)."""
    out: Dict = {}
    for k in items[0].keys():
        vals = [it[k] for it in items]
        if k in meta_keys:
            out[k] = {
                mk: [v[mk] for v in vals] for mk in vals[0].keys()
            } if isinstance(vals[0], dict) else vals
        elif isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating, bool, np.bool_)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals
    return out
