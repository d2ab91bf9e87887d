"""HowTo100M feature datasets: HTM train windows + HTM-Align eval.

A copy of ``exoground_tpu/data/htm.py`` (the port imports nothing of the JAX
package), which rebuilds data/loader_htm.py (HTM_FeatureLoader), data/loader_htm_align.py
(HTM_Align window-style) and eval/eval_zeroshot_align.py:32-93 (HTM_Align
full-video eval items) on the FeatureStore/static-shape-collate stack.

Differences from the reference (deliberate, kept from the JAX package):
  * samples collate to FIXED buckets (duration x text_bucket), not
    max-in-batch, so every step sees one shape;
  * randomness is keyed per (seed, epoch, index) instead of global
    np.random — reproducible under threaded workers;
  * the '[UNK]' fallback for unlucky sampling is kept (loader_htm.py:229-238).

``htm_vlen.csv`` is read with the ``csv`` module (no pandas), rows
``vid,vlen`` with no header, as the JAX package's
``pd.read_csv(names=["vid", "vlen"])`` reads it; a row whose length is not a
number (a header line) is skipped. The batched window gather through the
JAX package's native reader (``defer_video_io``) is not ported: items carry
their window's features.
"""

from __future__ import annotations

import csv
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from exoground_tpu_torch.data.collate import collate_dicts, stack_texts, stack_videos
from exoground_tpu_torch.data.io import FeatureStore


@dataclass
class HTMConfig:
    """Paths + sampling hyperparameters (reference train/config.py:6-57)."""

    video_feature_root: str = ""
    feature_suffixes: Sequence[str] = (".mp4.npy", ".webm.npy")
    text_tag: str = "htm-370k"
    asr_json: str = ""  # sentencified {vid: {'text': [...], 'start': [...], 'end': [...]}}
    holdout_file: str = ""  # one vid per line (data/htm_holdout_vid.txt)
    vlen_csv: str = ""  # vid,vlen (data/htm_vlen.csv)
    duration: int = 64
    text_bucket: int = 32  # max sentences per window (static shape)
    token_len: int = 32
    min_vlen: int = 64
    max_vlen: int = 1000
    seed: int = 0


def read_vlen_csv(path: str) -> Dict[str, float]:
    """``vid,vlen`` rows (no header) -> {vid: vlen}; rows whose vlen is not
    a number are skipped."""
    out: Dict[str, float] = {}
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) < 2:
                continue
            try:
                out[row[0]] = float(row[1])
            except ValueError:
                continue
    return out


def _clip_sentences(cap, start_ts, end_ts, duration, tokenizer, token_len,
                    break_on_empty_trim=True):
    """Walk sentences from the anchor forward, trimming into the window
    (loader_htm.py:202-227). cap: dict of lists text/start/end(/aligned).
    Returns lists (texts, tokens, starts, ends[, aligned]).

    ``break_on_empty_trim``: loader_htm.py:218-219 stops at a sentence whose
    trimmed span is empty, but loader_htm_align.py:112-137 has NO such check
    and appends the zero-width segment — HTMAlignDataset passes False."""
    texts, tokens, starts, ends, aligned = [], [], [], [], []
    has_flag = "aligned" in cap
    n = len(cap["text"])
    i0 = cap["_anchor"]
    for idx in range(i0, n):
        text = str(cap["text"][idx]).replace("\n", " ").strip()
        s, e = round(cap["start"][idx]), round(cap["end"][idx])
        if len(text.split()) > 256:
            text = " ".join(text.split()[:256])
        if s > end_ts or e - s < 1:
            break
        e = min(e, end_ts)
        token = np.asarray(
            tokenizer(text)["input_ids"], dtype=np.int32
        ).reshape(-1)[:token_len]
        token = np.pad(token, (0, token_len - token.shape[0]))
        trim_s = max(s - start_ts, 0)
        trim_e = min(e - start_ts, duration)
        if break_on_empty_trim and trim_e == trim_s:
            break
        if int(np.sum(token != 0)) == 0:  # all stop words (loader_htm.py:221)
            break
        texts.append(text)
        tokens.append(token)
        starts.append(trim_s)
        ends.append(trim_e)
        if has_flag:
            aligned.append(int(cap["aligned"][idx]))
    out = {"text": texts, "token": tokens, "start": starts, "end": ends}
    if has_flag:
        out["aligned"] = aligned
    return out


class HTMFeatureDataset:
    """Train/val windows over HowTo100M ASR sentences (loader_htm.py:62-257).

    ``asr``: {vid: {'text': [...], 'start': [...], 'end': [...]}} — either
    passed directly (tests) or loaded from cfg.asr_json (the sentencified
    json format, htm_zoo). Split: first min(5%, 1000) sorted vids = val.
    """

    def __init__(
        self,
        cfg: HTMConfig,
        tokenizer,
        mode: str = "train",
        asr: Optional[Dict] = None,
        store: Optional[FeatureStore] = None,
    ):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.mode = mode
        self.epoch = 0
        self.store = store or FeatureStore(cfg.video_feature_root, cfg.feature_suffixes)

        if asr is None:
            with open(cfg.asr_json) as f:
                asr = json.load(f)
        self.asr = asr
        vids = list(asr.keys())
        if cfg.holdout_file and os.path.exists(cfg.holdout_file):
            with open(cfg.holdout_file) as f:
                holdout = {l.strip() for l in f}
            vids = [v for v in vids if v not in holdout]
        if cfg.vlen_csv and os.path.exists(cfg.vlen_csv):
            lengths = read_vlen_csv(cfg.vlen_csv)
            ok = {v for v, n in lengths.items() if cfg.min_vlen < n < cfg.max_vlen}
            vids = [v for v in vids if v in ok]
        vids = sorted(vids)
        num_val = min(int(len(vids) * 0.05), 1000)
        self.video_info = vids[num_val:] if mode == "train" else vids[:num_val]

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.video_info)

    def _rng(self, index: int) -> np.random.RandomState:
        return np.random.RandomState(
            (self.cfg.seed * 1_000_003 + self.epoch * 7919 + index) % (2**31 - 1)
        )

    def __getitem__(self, index: int) -> Dict:
        cfg = self.cfg
        vid = self.video_info[index]
        vlen = self.store.length(vid)
        rng = self._rng(index)

        entry = self.asr[vid]
        keep = [i for i, e in enumerate(entry["end"]) if e < vlen]
        cap = {k: [entry[k][i] for i in keep] for k in ("text", "start", "end")}

        no_caption = not cap["end"]
        if not no_caption:
            last_ts = cap["end"][-1]
            cand = [i for i, s in enumerate(cap["start"]) if s < last_ts - cfg.duration]
            no_caption = len(cand) == 0
        if not no_caption:
            cap["_anchor"] = int(rng.choice(cand))
            start_ts = int(round(cap["start"][cap["_anchor"]]))
            end_ts = start_ts + cfg.duration
            clipped = _clip_sentences(
                cap, start_ts, end_ts, cfg.duration, self.tokenizer, cfg.token_len
            )
        else:
            clipped = {"text": [], "token": [], "start": [], "end": []}

        if not clipped["text"]:  # unlucky sampling (loader_htm.py:229-238)
            tok = np.asarray(
                self.tokenizer("[UNK]")["input_ids"], np.int32
            ).reshape(-1)[: cfg.token_len]
            tok = np.pad(tok, (0, cfg.token_len - tok.shape[0]))
            clipped = {
                "text": ["[UNK]"], "token": [tok], "start": [0], "end": [cfg.duration],
            }
            if no_caption:
                start_ts, end_ts = 0, cfg.duration

        video = self.store.read(vid, start_ts, min(end_ts, vlen))
        abs_start = (np.asarray(clipped["start"], np.float32) + start_ts) / vlen
        abs_end = (np.asarray(clipped["end"], np.float32) + start_ts) / vlen
        item = {
            "_video": video,
            "_texts": clipped,
            "vid": vid,
            "cut_start": start_ts,
            "cut_end": end_ts,
            "abs_text_start": abs_start,
            "abs_text_end": abs_end,
        }
        return item

    def collate_fn(self, items: List[Dict]) -> Dict:
        cfg = self.cfg
        out = stack_videos([it["_video"] for it in items], cfg.duration)
        texts = stack_texts(
            [np.stack(it["_texts"]["token"]) for it in items],
            [it["_texts"]["start"] for it in items],
            [it["_texts"]["end"] for it in items],
            cfg.text_bucket,
        )
        out.update(texts)
        ab = np.zeros((len(items), cfg.text_bucket, 2), np.float32)
        for i, it in enumerate(items):
            n = min(len(it["abs_text_start"]), cfg.text_bucket)
            ab[i, :n, 0] = it["abs_text_start"][:n]
            ab[i, :n, 1] = it["abs_text_end"][:n]
        out["abs_text_pos"] = ab
        out["vid"] = [it["vid"] for it in items]
        out["text"] = [it["_texts"]["text"] for it in items]
        out["cut_start"] = np.asarray([it["cut_start"] for it in items])
        out["cut_end"] = np.asarray([it["cut_end"] for it in items])
        if "aligned" in items[0]["_texts"]:
            al = np.zeros((len(items), cfg.text_bucket), np.int32)
            for i, it in enumerate(items):
                n = min(len(it["_texts"]["aligned"]), cfg.text_bucket)
                al[i, :n] = np.asarray(it["_texts"]["aligned"], np.int32)[:n]
            out["aligned"] = al
        return out


class HTMAlignDataset:
    """HTM-Align labelled eval set (80 videos).

    mode='window': training-protocol windows with align flags
    (data/loader_htm_align.py:78-164).
    mode='full': one item per full-length video with every text — the
    protocol input of the overlap-seq evaluator
    (eval/eval_zeroshot_align.py:32-93); items match evals/align.py:
    {'video' (T,C), 'start', 'end', 'aligned', 'text' or 'text_embed'}.

    ``anno``: {vid: [[aligned, start, end, text], ...]} (htm_align json).
    """

    def __init__(
        self,
        cfg: HTMConfig,
        tokenizer=None,
        mode: str = "full",
        anno: Optional[Dict] = None,
        store: Optional[FeatureStore] = None,
    ):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.mode = mode
        self.epoch = 0
        self.store = store or FeatureStore(cfg.video_feature_root, cfg.feature_suffixes)
        if anno is None:
            with open(cfg.asr_json) as f:
                anno = json.load(f)
        self.anno = anno
        self.video_info = sorted(anno.keys())

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.video_info)

    def _rng(self, index: int) -> np.random.RandomState:
        # per-(seed, epoch, index) stream, same derivation as
        # HTMFeatureDataset._rng; tests pin anchors by overriding this hook
        return np.random.RandomState(
            (self.cfg.seed * 1_000_003 + self.epoch * 7919 + index) % (2**31 - 1)
        )

    def _segments(self, vid):
        segs = self.anno[vid]
        return {
            "aligned": [s[0] for s in segs],
            "start": [s[1] for s in segs],
            "end": [s[2] for s in segs],
            "text": [s[3] for s in segs],
        }

    def __getitem__(self, index: int) -> Dict:
        cfg = self.cfg
        vid = self.video_info[index]
        seg = self._segments(vid)
        if self.mode == "full":
            item = {
                "video": self.store.read(vid),
                "start": np.asarray(seg["start"], np.float32),
                "end": np.asarray(seg["end"], np.float32),
                "aligned": np.asarray(seg["aligned"], np.int64),
                "text": seg["text"],
                "vid": vid,
            }
            if self.tokenizer is not None:
                tok = self.tokenizer(seg["text"])
                item["token"] = np.asarray(tok["input_ids"], np.int32)
            return item

        # window mode (loader_htm_align.py:78-164)
        rng = self._rng(index)
        last_ts = seg["end"][-1]
        cand = [i for i, s in enumerate(seg["start"]) if s < last_ts - cfg.duration]
        anchor = int(rng.choice(cand)) if cand else 0
        start_ts = int(math.ceil(seg["start"][anchor]))
        end_ts = start_ts + cfg.duration
        cap = {**seg, "_anchor": anchor}
        clipped = _clip_sentences(
            cap, start_ts, end_ts, cfg.duration, self.tokenizer, cfg.token_len,
            break_on_empty_trim=False,  # loader_htm_align.py has no trim break
        )
        if not clipped["text"]:
            # anchor sentence itself can clip away (sub-second segment or
            # all-stop-word tokens): same [UNK] fallback as HTMFeatureDataset
            # (loader_htm.py:229-238) so collate never sees an empty stack
            tok = np.asarray(
                self.tokenizer("[UNK]")["input_ids"], np.int32
            ).reshape(-1)[: cfg.token_len]
            tok = np.pad(tok, (0, cfg.token_len - tok.shape[0]))
            clipped = {"text": ["[UNK]"], "token": [tok], "start": [0],
                       "end": [cfg.duration], "aligned": [0]}
        vlen = self.store.length(vid)
        video = self.store.read(vid, start_ts, min(end_ts, vlen))
        return {"_video": video, "_texts": clipped, "vid": vid,
                "cut_start": start_ts, "cut_end": end_ts}

    def collate_fn(self, items: List[Dict]) -> Dict:
        if self.mode == "full":
            return collate_dicts(items)
        cfg = self.cfg
        out = stack_videos([it["_video"] for it in items], cfg.duration)
        out.update(
            stack_texts(
                [np.stack(it["_texts"]["token"]) for it in items],
                [it["_texts"]["start"] for it in items],
                [it["_texts"]["end"] for it in items],
                cfg.text_bucket,
            )
        )
        al = np.zeros((len(items), cfg.text_bucket), np.int32)
        for i, it in enumerate(items):
            n = min(len(it["_texts"]["aligned"]), cfg.text_bucket)
            al[i, :n] = np.asarray(it["_texts"]["aligned"], np.int32)[:n]
        out["aligned"] = al
        out["vid"] = [it["vid"] for it in items]
        out["text"] = [it["_texts"]["text"] for it in items]
        return out
