"""LEMMA keystep grounding dataset (2 views: ego fpv1 + exo master).

Counterpart of ``exoground_tpu/data/lemma.py`` (reference
data/loader_lemma.py), copied because the port imports nothing of the JAX
package: a fixed ego/exo camera pair, HOI keystep annotations mapped to
natural-language text, windows precomputed per split (test also emits the
ego view, :122-124), constant distillation targets (ego best, exo negative,
:152-157), same-view negatives as EgoExo4D's. fps defaults to 24 (:27).

Video features are keyed "{video_id}_{cam}" and narration features by HOI
index, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from exoground_tpu_torch.data.collate import collate_dicts
from exoground_tpu_torch.data.egoexo4d import EgoExo4DDataset
from exoground_tpu_torch.data.io import FeatureStore

LEMMA_EGO_CAM = "fpv1"
LEMMA_EXO_CAM = "master"


@dataclass
class LemmaConfig:
    duration: int = 64
    hop_length: int = 5
    views: str = "all"
    use_distill_nce_loss: bool = False
    curriculum_train: bool = False
    same_view_negative: bool = False
    reverse_ranking: bool = False
    randomize_ranking: bool = False
    fps: int = 24
    feature_dim: int = 4096
    seed: int = 0


class LemmaDataset:
    """split_rows: [{video_id, duration_sec}, ...]
    annotations: [{vid_name, unique_narration_id, start_frame, end_frame,
                   narration ('HOI <idx>')}, ...]
    hoi_text_map: {hoi_index: natural_language}
    video_store keyed "{video_id}_{cam}"; narration_store keyed by hoi idx."""

    def __init__(
        self,
        cfg: LemmaConfig,
        split_rows: List[Dict],
        annotations: List[Dict],
        hoi_text_map: Dict[int, str],
        video_store: FeatureStore,
        narration_store: FeatureStore,
        split: str = "train",
    ):
        if cfg.curriculum_train:
            assert split == "train"
        self.cfg = cfg
        self.split = split
        self.video_store = video_store
        self.narration_store = narration_store
        self.hoi_text_map = hoi_text_map
        self.epoch = 0
        self.current_phase = 0
        self._anno_by_vid: Dict[str, List[Dict]] = {}
        for a in annotations:
            self._anno_by_vid.setdefault(a["vid_name"], []).append(a)
        self._anno_by_id = {a["unique_narration_id"]: a for a in annotations}
        self.nid_to_hoi = {
            a["unique_narration_id"]: str(a["narration"]).removeprefix("HOI ")
            for a in annotations
        }
        self.windows = self._precompute_windows(split_rows)

    def _precompute_windows(self, split_rows) -> List[Dict]:
        cfg = self.cfg
        windows = []
        for row in split_rows:
            vid = row["video_id"]
            max_start = int(row["duration_sec"]) - cfg.duration
            for start in range(0, max_start + 1, cfg.hop_length):
                end = start + cfg.duration
                narrs = [
                    a for a in self._anno_by_vid.get(vid, [])
                    if a["start_frame"] / cfg.fps <= end
                    and a["end_frame"] / cfg.fps >= start
                ]
                if not narrs:
                    continue
                nids = [
                    a["unique_narration_id"] for a in narrs
                    if self.narration_store.exists(
                        self.nid_to_hoi[a["unique_narration_id"]]
                    )
                ]
                nid_str = ",".join(nids)
                windows.append({
                    "video_id": vid, "exo_cam": LEMMA_EXO_CAM,
                    "ego_cam": LEMMA_EGO_CAM, "start_sec": start,
                    "end_sec": end, "narration_ids": nid_str,
                })
                if self.split == "test":  # also eval the ego view (:123-124)
                    windows.append({
                        "video_id": vid, "exo_cam": LEMMA_EGO_CAM,
                        "ego_cam": LEMMA_EGO_CAM, "start_sec": start,
                        "end_sec": end, "narration_ids": nid_str,
                    })
        return windows

    def set_phase(self, phase: int):
        self.current_phase = phase

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.windows)

    def _rng(self, idx):
        return np.random.RandomState(
            (self.cfg.seed * 1_000_003 + self.epoch * 7919 + idx) % (2**31 - 1)
        )

    def __getitem__(self, idx: int) -> Dict:
        cfg = self.cfg
        w = self.windows[idx]
        vid, exo_cam, ego_cam = w["video_id"], w["exo_cam"], w["ego_cam"]
        start, end = int(w["start_sec"]), int(w["end_sec"])
        rng = self._rng(idx)
        nids = [n for n in str(w["narration_ids"]).split(",") if n]

        video = self.video_store.read(f"{vid}_{exo_cam}", start, end)

        # constant 2-view distill target: ego(0) positive, exo(1) negative
        # (reference :144-160). The ego-track read only feeds the distill
        # tensors, so skip it when the loss won't consume them.
        if cfg.use_distill_nce_loss:
            ego_feats = self.video_store.read(f"{vid}_{ego_cam}", start, end)
            exo_stack = np.stack([ego_feats, video], 0)
        tgt = np.zeros(cfg.duration, np.int64)
        ntg = np.ones(cfg.duration, np.int64)
        valid = np.zeros((2, cfg.duration), bool)
        valid[0] = True
        per_second_views = (
            ["0"] * cfg.duration
            if self.split == "test" and exo_cam != LEMMA_EXO_CAM
            else ["1"] * cfg.duration
        )

        narr_feats, texts, starts, ends, u_starts, u_ends = [], [], [], [], [], []
        for nid in nids:
            hoi = self.nid_to_hoi[nid]
            if not self.narration_store.exists(hoi):
                continue
            a = self._anno_by_id[nid]
            narr_feats.append(self.narration_store.read(hoi).reshape(-1))
            texts.append(self.hoi_text_map[int(hoi)])
            ss = a["start_frame"] / cfg.fps - start
            ee = a["end_frame"] / cfg.fps - start
            u_starts.append(ss)
            u_ends.append(ee)
            starts.append(max(ss / cfg.duration, 0.0))
            ends.append(min(ee / cfg.duration, 1.0))
        narr_feats = narr_feats[: cfg.duration]
        texts, starts, ends = (
            texts[: cfg.duration], starts[: cfg.duration], ends[: cfg.duration]
        )

        out: Dict = {}
        if cfg.same_view_negative:
            # always emit the key (zeros fallback for narration-less windows,
            # matching EgoExo4DDataset) so collate sees consistent dicts
            out["same_view_neg_idxs"] = (
                EgoExo4DDataset._same_view_neg_idxs(
                    self, video, narr_feats, u_starts, u_ends, rng
                )
                if narr_feats
                else np.zeros(video.shape[0], np.int64)
            )

        pad_narr = np.zeros((cfg.duration, cfg.feature_dim), np.float32)
        pad_start = np.zeros(cfg.duration, np.float32)
        pad_end = np.zeros(cfg.duration, np.float32)
        narr_mask = np.ones(cfg.duration, bool)
        if narr_feats:
            k = len(narr_feats)
            pad_narr[:k] = np.stack(narr_feats)[:, : cfg.feature_dim]
            pad_start[:k] = starts
            pad_end[:k] = ends
            narr_mask[:k] = False

        out.update({
            "video_features": video,
            "video_padding_mask": np.zeros(video.shape[0], bool),
            "narration_features": pad_narr,
            "narration_padding_mask": narr_mask,
            "starts": pad_start,
            "ends": pad_end,
            "mean": (pad_start + pad_end) / 2,
            "duration": np.abs(pad_end - pad_start),
            "metadata": {
                "narrations": texts, "video_id": vid, "exo_camera": exo_cam,
                "start_sec": start, "per_second_views": per_second_views,
            },
        })
        if cfg.use_distill_nce_loss:
            out["ego_video_features"] = exo_stack
            out["view_rank_label"] = tgt
            out["view_rank_neg_label"] = ntg
            out["valid_views_mask"] = valid
        return out

    collate_fn = staticmethod(collate_dicts)
