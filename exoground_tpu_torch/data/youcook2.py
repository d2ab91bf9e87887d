"""YouCook2 feature dataset for zero-shot clip retrieval.

Counterpart of ``exoground_tpu/data/youcook2.py`` (reference
eval/eval_zeroshot_retrieval.py:29-153, the eval loader, and the split of
data/loader_yc2.py). One item per annotated clip: ``num_clips`` feature
windows around the ground-truth segment, either fixed ``seq_len`` windows
inside the segment span or (``seq_len == -1``) adaptive windows covering it,
with the reference's linspace placement. Items feed
``evals/retrieval.py::test_retrieval_yc2``. Features come through
``FeatureStore`` (per-video ``.pth.tar`` files read by ``load_pt``, or a
``mem`` dict).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from exoground_tpu_torch.data.io import FeatureStore

# videos dropped for inconsistent lengths (reference loader_yc2.py:60)
DROP_LIST = ("FtHLUsOntqI", "HQtOXHghaL0", "ffoRmenLSLs", "wKHC2gbRdA0")


@dataclass
class YouCook2Config:
    num_clips: int = 4
    seq_len: int = 32  # -1 = adaptive windows covering the segment
    seed: int = 0


class YouCook2Dataset:
    """anno: youcookii_annotations 'database' dict
    {vid: {'annotations': [{'segment': [s, e], 'sentence': str}, ...]}}.
    store: vid -> (T, C) features at 1 feature/sec."""

    def __init__(self, cfg: YouCook2Config, store: FeatureStore, anno: Dict,
                 mode: str = "val", half_val: bool = True):
        self.cfg = cfg
        self.store = store
        vids = sorted(v for v in anno.keys() if v not in DROP_LIST and store.exists(v))
        if mode == "val" and half_val:  # fast-eval half split (loader_yc2.py:63-66)
            rng = np.random.RandomState(0)
            vids = sorted(rng.permutation(vids)[: len(vids) // 2].tolist())
        self.video_info: List[Dict] = []
        for vid in vids:
            for seg in anno[vid]["annotations"]:
                self.video_info.append({"vid": vid, **seg})

    def __len__(self):
        return len(self.video_info)

    def __getitem__(self, idx: int) -> Dict:
        cfg = self.cfg
        info = self.video_info[idx]
        vid = info["vid"]
        text = info["sentence"]
        s, e = info["segment"]  # int seconds in the json, used unconverted
        feature = self.store.read(vid)
        vlen = feature.shape[0]

        if cfg.seq_len == -1:
            # adaptive windows covering the segment (reference :114-139)
            duration = int(np.floor(e - s))
            chosen_vlen = int(np.clip(duration * 2, 32, 256))
            if chosen_vlen >= duration:
                lead = np.floor(np.linspace(0.25 * (chosen_vlen - duration),
                                            0.75 * (chosen_vlen - duration),
                                            cfg.num_clips)).astype(int)
                chosen_start = s - lead
                start_idx, end_idx = lead, lead + duration
            else:
                lag = np.floor(np.linspace(0.25 * (duration - chosen_vlen),
                                           0.75 * (duration - chosen_vlen),
                                           cfg.num_clips)).astype(int)
                chosen_start = s + lag
                start_idx = np.zeros_like(lag)
                end_idx = start_idx + chosen_vlen
            seq = np.arange(chosen_vlen)
        else:
            chosen_start = np.floor(
                np.linspace(0, e - s - cfg.seq_len - 1, cfg.num_clips)
            ).astype(int) + int(s)
            seq = np.arange(cfg.seq_len)
            start_idx = np.zeros(cfg.num_clips, int)
            end_idx = start_idx + cfg.seq_len

        frame_idx = np.clip(chosen_start[:, None] + seq[None, :], 0, vlen - 1
                            ).astype(int).reshape(-1)
        clips = feature[frame_idx].reshape(cfg.num_clips, len(seq), -1)
        return {
            "video": clips,
            "start": float(s),
            "end": float(e),
            "vid": vid,
            "str": text,
            "start_idx": np.asarray(start_idx),
            "end_idx": np.asarray(end_idx),
        }
