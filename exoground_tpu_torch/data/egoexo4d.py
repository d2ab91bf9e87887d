"""EgoExo4D keystep / narration grounding dataset.

Counterpart of ``exoground_tpu/data/egoexo4d.py`` (``EgoExoConfig`` :48,
``EgoExoSource`` :90, ``camera_view_order`` :176, ``EgoExo4DDataset``
:243-660; reference data/loader_egoexo4d.py), copied because the port
imports nothing of the JAX package: window precompute with the CSV cache,
per-window EgoVLPv2 video feature reads, narration features, normalised
start/end and center/duration labels, camera-pose view ordering, per-second
camera-ranking distillation targets (phased / reversed / randomised
curricula), stitched multi-view sequences with availability masks,
same-view negatives and narration-order shuffling. Every item, and the
order of the draws of its per-item ``RandomState``, is the JAX reader's.

The JAX reader reads its CSV files with pandas; the port reads and writes
them with ``data/table.py``, which types each column as pandas does, so a
window cache written by either package reads back to the same windows in
both. ``EgoExo4DTANDataset`` (the JAX :662-726) is the TAN-protocol variant:
raw video windows with ragged start / end lists for ``mask_from_time``; no
route of either command line uses it.

Intended-behavior fixes vs the reference, as in the JAX package:
  * multi-view stitching places EVERY view's features at view_idx*duration
    (reference loader_egoexo4d.py:461-464 only writes the last view);
  * the multi-view padding mask is ~view_available_mask (reference :569
    calls undefined create_video_mask).
"""

from __future__ import annotations

import ast
import os
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from exoground_tpu_torch.data.collate import collate_dicts
from exoground_tpu_torch.data.io import FeatureStore
from exoground_tpu_torch.data.table import read_csv_records, write_csv_records

# cam name -> stitched-view slot (reference loader_egoexo4d.py:140-142)
VIEW_MAP_EGOEXO = {
    "aria": 0, "cam01": 1, "gp01": 1, "cam02": 2, "gp02": 2, "cam03": 3,
    "gp03": 3, "cam04": 4, "gp04": 4, "cam05": 5, "gp05": 5, "gp06": 6,
}
VIEW_MAP_EXO = {
    "cam01": 0, "gp01": 0, "cam02": 1, "gp02": 1, "cam03": 2, "gp03": 2,
    "cam04": 3, "gp04": 3, "cam05": 4, "gp05": 4, "gp06": 5,
}
MAX_DISTILL_VIEWS = 7  # reference :343


@dataclass
class EgoExoConfig:
    duration: int = 20
    hop_length: int = 10
    use_audio: bool = False
    use_keysteps: bool = False
    views: str = "exo"  # exo | ego | all | multi
    use_distill_nce_loss: bool = False
    use_center_duration: bool = True
    multi_view_single_exo_inference: bool = False
    multi_view_egoexo: bool = False
    num_max_views: Optional[int] = None
    randomize_narration_order: bool = False
    curriculum_train: bool = False
    sorted_curr_train: str = "sorted"  # sorted | phased
    model: str = "joint"  # grounding | view_invariant | joint
    exo_mode: str = "all"
    minimum_four_exo_takes: bool = False
    same_view_negative: bool = False
    reverse_ranking: bool = False
    randomize_ranking: bool = False
    exo_exo_distill: bool = False
    fps: int = 30
    feature_dim: int = 4096
    seed: int = 0

    @property
    def multi_view(self) -> bool:
        return self.views == "multi"

    def view_map(self) -> Dict[str, int]:
        return VIEW_MAP_EGOEXO if self.multi_view_egoexo else VIEW_MAP_EXO


@dataclass
class EgoExoSource:
    """Injected data roots (reference loader_egoexo4d.py:66-115).

    split_rows: [{take_name, take_uid, duration_sec, ego_cam}, ...]
    annotations: [{video_id, unique_narration_id, start_frame, end_frame,
                   narration}, ...]  (the reference's take_uid column holds
                   take NAMES at precompute time, loader_egoexo4d.py:268)
    camera_rankings: {take_uid: {str(sec): {str(rank): cam_name}}}
    takes_cams: {take_name: [exo cam names]}
    video_store: features keyed "{take_name}_{cam}" -> (T, C)
    narration_store: keyed "{take_name}/{nid}" -> (1, C) or (C,)
    camera_pose_loader: take_uid -> camera-pose dict (ego_pose json) or None
    """

    split_rows: List[Dict]
    annotations: List[Dict]
    camera_rankings: Dict
    takes_cams: Dict[str, List[str]]
    video_store: FeatureStore
    narration_store: FeatureStore
    audio_store: Optional[FeatureStore] = None
    camera_pose_loader: Optional[Callable[[str], Optional[Dict]]] = None

    @classmethod
    def from_paths(
        cls,
        split_csv: str,
        annotations_csv: str,
        camera_rankings_json: str,
        takes_json: str,
        video_feature_root: str,
        narration_feature_root: str,
        audio_feature_root: Optional[str] = None,
        camera_pose_root: Optional[str] = None,
    ) -> "EgoExoSource":
        """Build from the reference's on-disk layout (loader_egoexo4d.py:66-92)."""
        import json

        split_rows = [
            {
                "take_name": r["take_name"],
                "take_uid": r["take_uid"],
                "duration_sec": int(r["duration_sec"]),
                "ego_cam": str(r["ego_camera_path"]).split("/")[-1].split(".")[0],
            }
            for r in read_csv_records(split_csv)
        ]
        annotations = [
            {
                "video_id": r["take_uid"],
                "unique_narration_id": r["unique_narration_id"],
                "start_frame": int(r["start_frame"]),
                "end_frame": int(r["end_frame"]),
                "narration": r["narration"],
            }
            for r in read_csv_records(annotations_csv)
        ]
        with open(camera_rankings_json) as f:
            camera_rankings = json.load(f)
        with open(takes_json) as f:
            takes = json.load(f)
        takes_cams = {
            t["take_name"]: [
                k for k in t["frame_aligned_videos"].keys()
                if ("cam" in k.lower()) or ("gp" in k.lower())
            ]
            for t in takes
        }
        pose_loader = None
        if camera_pose_root:
            def pose_loader(take_uid):
                p = os.path.join(camera_pose_root, f"{take_uid}.json")
                if not os.path.exists(p):
                    return None
                with open(p) as f:
                    return json.load(f)

        return cls(
            split_rows=split_rows,
            annotations=annotations,
            camera_rankings=camera_rankings,
            takes_cams=takes_cams,
            video_store=FeatureStore(video_feature_root, (".pt",)),
            narration_store=FeatureStore(narration_feature_root, (".pt",)),
            audio_store=FeatureStore(audio_feature_root, (".npy",))
            if audio_feature_root else None,
            camera_pose_loader=pose_loader,
        )


def camera_view_order(
    camera_pose: Optional[Dict],
    cam_list: List[str],
    start_sec: float,
    end_sec: float,
    ego_cam: str,
    fps: int = 30,
    ego_cam_ray_point: float = 0.7,
):
    """Order cameras far->near w.r.t. the ego actor's gaze point
    (reference loader_egoexo4d.py:182-248). Returns (sorted_cams_far_first,
    {cam: distance_rank}). Falls back to ego-first listing when no pose."""
    if camera_pose is None:
        cams = [c for c in cam_list if c != ego_cam]
        cams.insert(0, ego_cam)
        return cams[::-1], {c: i for i, c in enumerate(cams)}

    frame_idx = int((start_sec + (end_sec - start_sec) / 2) * fps)
    positions, labels, rotations = [], [], []
    ego_label = None
    for cam, details in camera_pose.items():
        try:
            if cam.lower().startswith("aria"):
                extrinsic = np.array(details["camera_extrinsics"][str(frame_idx)])
                ego_label = cam
            elif cam.lower().startswith(("cam", "gp")):
                extrinsic = np.array(details["camera_extrinsics"])
            else:
                continue
        except (KeyError, TypeError):
            continue
        ext = np.linalg.inv(np.vstack([extrinsic, [0, 0, 0, 1]]))[:3, :]
        positions.append(ext[:, -1])
        rotations.append(ext[:, :3])
        labels.append(cam)
    if ego_label is None:
        # aria pose missing the window-midpoint frame (pose coverage can be
        # shorter than the take): no gaze ray to sort by — ego-first fallback
        cams = [c for c in cam_list if c != ego_cam]
        cams.insert(0, ego_cam)
        return cams[::-1], {c: i for i, c in enumerate(cams)}
    positions = np.asarray(positions)
    rotations = np.asarray(rotations)
    ego_idx = labels.index(ego_label)

    gaze_pt = positions[ego_idx] + ego_cam_ray_point * rotations[ego_idx] @ [0, 0, 1]
    to_gaze = gaze_pt - positions
    orient = rotations @ [0, 0, 1]
    cos = np.sum(orient * to_gaze, axis=-1) / (
        np.linalg.norm(orient, axis=-1) * np.linalg.norm(to_gaze, axis=-1) + 1e-8
    )
    xy_cos = (orient[:, :2] @ orient[ego_idx, :2]) / (
        np.linalg.norm(orient[:, :2], axis=1) * np.linalg.norm(orient[ego_idx, :2]) + 1e-8
    )
    neg_group = np.where(xy_cos > 0)[0]
    pos_group = np.where(xy_cos <= 0)[0]
    order = np.concatenate(
        [pos_group[np.argsort(cos[pos_group])[::-1]],
         neg_group[np.argsort(cos[neg_group])[::-1]]]
    )
    sorted_cams = [labels[i] for i in order]
    sorted_cams.remove(ego_label)
    sorted_cams.insert(0, ego_cam)
    distances = {c: sorted_cams.index(c) for c in sorted_cams}
    return sorted_cams[::-1], distances


class EgoExo4DDataset:
    """Grounding/VI windows (reference EgoExo4DDataLoader)."""

    def __init__(
        self,
        cfg: EgoExoConfig,
        source: EgoExoSource,
        split: str = "train",
        window_csv_path: Optional[str] = None,
    ):
        # mutual exclusions (reference :117-123)
        assert not (cfg.views == "ego" and cfg.use_distill_nce_loss)
        if cfg.curriculum_train:
            assert cfg.exo_mode == "all" and split == "train"
        if split != "train":
            assert cfg.exo_mode == "all"
        self.cfg = cfg
        self.src = source
        self.split = split
        self.current_phase = 0
        self.epoch = 0
        self.window_csv_path = window_csv_path
        self._anno_by_take: Dict[str, List[Dict]] = {}
        for a in source.annotations:
            self._anno_by_take.setdefault(a["video_id"], []).append(a)
        self._anno_by_id = {a["unique_narration_id"]: a for a in source.annotations}
        self.windows = self._precompute_windows()
        if cfg.curriculum_train and cfg.sorted_curr_train == "sorted":
            # sort easy->hard by cam-ego distance (reference :155-159)
            self.windows.sort(key=lambda w: w["cam_ego_distance"])

    # ---------------------------------------------------------------- windows
    def _precompute_windows(self) -> List[Dict]:
        cfg = self.cfg
        if self.window_csv_path and os.path.exists(self.window_csv_path):
            return read_csv_records(self.window_csv_path)
        windows: List[Dict] = []
        for row in self.src.split_rows:
            take, uid = row["take_name"], row["take_uid"]
            ego_cam = row["ego_cam"]
            exo_cams = [c.split(".")[0] for c in self.src.takes_cams.get(take, [])]
            cams = (
                exo_cams if cfg.views == "exo"
                else ([ego_cam] if cfg.views == "ego" else [ego_cam] + exo_cams)
            )
            max_start = int(row["duration_sec"]) - cfg.duration
            for start_sec in range(0, max_start + 1, cfg.hop_length):
                end_sec = start_sec + cfg.duration
                narrs = [
                    a for a in self._anno_by_take.get(take, [])
                    if a["start_frame"] / cfg.fps <= end_sec
                    and a["end_frame"] / cfg.fps >= start_sec
                ]
                if not narrs:
                    continue
                nids = [
                    a["unique_narration_id"] for a in narrs
                    if self.src.narration_store.exists(
                        f"{take}/{a['unique_narration_id']}"
                    )
                ]
                nid_str = ",".join(nids)
                if cfg.multi_view:
                    windows.append({
                        "video_id": take,
                        "exo_cam": cams if cfg.multi_view_egoexo else exo_cams,
                        "ego_cam": ego_cam, "start_sec": start_sec,
                        "end_sec": end_sec, "narration_ids": nid_str,
                    })
                elif cfg.curriculum_train:
                    pose = (
                        self.src.camera_pose_loader(uid)
                        if self.src.camera_pose_loader else None
                    )
                    sorted_cams, dist = camera_view_order(
                        pose, list(cams), start_sec, end_sec, ego_cam, cfg.fps
                    )
                    import itertools

                    for cam1, cam2 in itertools.combinations(sorted_cams, 2):
                        windows.append({
                            "video_id": take, "exo_cam": cam1, "ego_cam": cam2,
                            "start_sec": start_sec, "end_sec": end_sec,
                            "narration_ids": nid_str,
                            "cam_ego_distance": dist[cam1],
                        })
                    if ego_cam in cams:
                        windows.append({
                            "video_id": take, "exo_cam": ego_cam,
                            "ego_cam": ego_cam, "start_sec": start_sec,
                            "end_sec": end_sec, "narration_ids": nid_str,
                            "cam_ego_distance": 0,
                        })
                else:
                    view_cams = exo_cams if cfg.views != "ego" else [ego_cam]
                    for camera in view_cams:
                        windows.append({
                            "video_id": take, "exo_cam": camera,
                            "ego_cam": ego_cam, "start_sec": start_sec,
                            "end_sec": end_sec, "narration_ids": nid_str,
                        })
        if self.window_csv_path:
            write_csv_records(self.window_csv_path, windows)
        return windows

    def set_phase(self, phase: int):
        self.current_phase = phase

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.windows)

    def _rng(self, idx: int) -> np.random.RandomState:
        return np.random.RandomState(
            (self.cfg.seed * 1_000_003 + self.epoch * 7919 + idx) % (2**31 - 1)
        )

    # ------------------------------------------------------------- rank target
    def _find_rank(self, rank_dict: Dict, cam: str) -> str:
        for k, v in (rank_dict or {}).items():
            if v == cam:
                return k
        return "unk"

    def _exo_features_and_target(self, take, ego_cam, exo_cam, start, end, rng,
                                 read_features: bool = True):
        """Distillation views + per-second best/worst indices
        (reference :327-393).

        ``read_features=False`` skips the per-view feature-file reads (up to
        MAX_DISTILL_VIEWS full (T, 4096) windows) and returns a dummy feats
        array — for callers that only need the rankings-derived outputs
        (per_second_views for the rank-binned metrics). The reference reads
        every view unconditionally (:482) even when the loss discards them.
        """
        cfg = self.cfg
        uid = next(
            r["take_uid"] for r in self.src.split_rows if r["take_name"] == take
        )
        view_names = ["ego"] + [c.split(".")[0] for c in self.src.takes_cams[take]]
        if ego_cam != exo_cam and exo_cam in view_names:
            view_names.remove(exo_cam)
        if read_features:
            feats = [self.src.video_store.read(f"{take}_{ego_cam}", start, end)]
            for c in view_names[1:]:
                feats.append(self.src.video_store.read(f"{take}_{c}", start, end))
            exo_feats = np.stack(feats, 0)  # (V, T, C)
        else:
            exo_feats = np.zeros(
                (min(len(view_names), MAX_DISTILL_VIEWS), 0, 0), np.float32
            )
        v = exo_feats.shape[0]
        if v < MAX_DISTILL_VIEWS:
            exo_feats = np.pad(
                exo_feats, ((0, MAX_DISTILL_VIEWS - v), (0, 0), (0, 0))
            )
        elif v > MAX_DISTILL_VIEWS:
            # the reference only pads UP to 7 (loader_egoexo4d.py:343-348):
            # a take with more views would make its collate crash on ragged
            # shapes. Truncate instead (and clamp indices below) so such
            # takes train on their first 7 views rather than aborting.
            exo_feats = exo_feats[:MAX_DISTILL_VIEWS]

        ranking = self.src.camera_rankings[uid]
        tgt = np.zeros(cfg.duration, np.int64)
        neg = np.zeros(cfg.duration, np.int64)
        per_second_views: List[str] = []
        for t in range(start, end):
            # a second missing from camera_rankings falls through to the
            # empty-rank path (ego-view target) like an empty dict does; the
            # reference asserts-then-KeyErrors on such coverage gaps
            # (loader_egoexo4d.py:355-356) — same crash class it tolerates
            # for pose gaps, so robustness here is an intentional fix
            rank = dict(ranking.get(str(t)) or {})
            if cfg.randomize_ranking:
                vals = list(rank.values())
                rng.shuffle(vals)
                rank = {str(i): vals[i] for i in range(len(vals))}
            elif cfg.reverse_ranking:
                vals = list(rank.values())[::-1]
                rank = {str(i): vals[i] for i in range(len(vals))}
            curr = "ego" if ego_cam == exo_cam else self._find_rank(rank, exo_cam)
            per_second_views.append(curr)
            if rank:
                if curr in ("ego", "unk"):
                    best = rank["0"]
                else:
                    if cfg.curriculum_train and cfg.sorted_curr_train == "phased":
                        best_rank = (
                            max(0, int(curr) - (self.current_phase + 1))
                            if int(curr) != 0 else -1
                        )
                    else:
                        best_rank = 0 if int(curr) != 0 else -1
                    if cfg.exo_exo_distill and best_rank == -1:
                        for r, name in rank.items():
                            if name in view_names:
                                best_rank = int(r)
                                break
                    best = "ego" if best_rank == -1 else rank[str(best_rank)]
                best_idx = view_names.index(best)
                worst_rank = max(int(k) for k in rank.keys())
                if curr == str(worst_rank):  # don't use self as negative (:384-385)
                    worst_rank -= 1
                # single-camera ranking where self is the only entry: the
                # only non-self negative left is the ego view (rank '-1'
                # does not exist)
                worst = rank[str(worst_rank)] if worst_rank >= 0 else "ego"
                worst_idx = view_names.index(worst)
                tgt[t - start] = best_idx
                neg[t - start] = worst_idx
            # an empty per-second ranking leaves tgt/neg at the ego view
            # (index 0) instead of reusing a stale neighbour or crashing

        # indices pointing at views truncated away (>7-view takes, see
        # MAX_DISTILL_VIEWS above) fall back to the ego view (0) — the same
        # convention as empty rankings and missing negatives — instead of
        # clamping: clamping both best and worst onto view 6 would make the
        # distill loss pull toward and push away from the SAME view
        kept = exo_feats.shape[0]
        tgt = np.where(tgt < kept, tgt, 0)
        neg = np.where(neg < kept, neg, 0)
        valid = np.zeros((exo_feats.shape[0], cfg.duration), bool)
        valid[tgt, np.arange(cfg.duration)] = True  # reference :320-325
        return exo_feats, tgt, neg, valid, per_second_views

    def _same_view_neg_idxs(self, ego_feats, narr_feats, u_starts, u_ends, rng):
        """Hard temporal negatives on the ego track (reference :402-442)."""
        d = self.cfg.duration
        out = []
        if len(narr_feats) == 1:
            rs = int(max(0, u_starts[0]))
            re = int(min(d - 1, u_ends[0]))
            for i in range(ego_feats.shape[0]):
                if rs <= i <= re:
                    choices = list(range(0, rs)) + list(range(re + 1, d))
                    out.append(int(rng.choice(choices)) if choices
                               else int(rng.randint(0, d)))
                else:
                    # rs > re when the lone narration starts exactly at the
                    # window boundary; fall back to a uniform draw like the
                    # multi-narration branch
                    out.append(int(rng.randint(rs, re + 1)) if rs <= re
                               else int(rng.randint(0, d)))
        else:
            narr = np.stack([f.reshape(-1) for f in narr_feats])
            sim = ego_feats @ narr.T
            sim = sim / (
                np.linalg.norm(ego_feats, axis=1, keepdims=True)
                * np.linalg.norm(narr, axis=1) + 1e-8
            )
            least = sim.argmin(axis=1)
            for li in least:
                rs = int(max(0, u_starts[li]))
                re = int(min(d - 1, u_ends[li]))
                out.append(int(rng.randint(rs, re + 1)) if rs <= re
                           else int(rng.randint(0, d)))
        return np.asarray(out, np.int64)

    # ----------------------------------------------------------------- getitem
    def __getitem__(self, idx: int) -> Dict:
        cfg = self.cfg
        w = self.windows[idx]
        take, ego_cam = w["video_id"], w["ego_cam"]
        start, end = int(w["start_sec"]), int(w["end_sec"])
        rng = self._rng(idx)
        exo_cams = w["exo_cam"]
        if isinstance(exo_cams, str):
            # CSV cache round-trip stringifies the list; literal_eval parses
            # exactly the legitimate format and nothing else
            exo_cams = (
                ast.literal_eval(exo_cams) if exo_cams.startswith("[")
                else [exo_cams]
            )
        nids = [n for n in str(w["narration_ids"]).split(",") if n]

        feats_list = [
            self.src.video_store.read(f"{take}_{c}", start, end) for c in exo_cams
        ]
        c_dim = feats_list[0].shape[-1]
        vmap = cfg.view_map()

        if cfg.multi_view:
            total = cfg.num_max_views * cfg.duration
            video = np.ones((total, c_dim), np.float32)
            avail = np.zeros(total, bool)
            for cam, f in zip(exo_cams, feats_list):
                vi = 0 if "aria" in cam.lower() else vmap[cam]
                video[vi * cfg.duration : vi * cfg.duration + cfg.duration] = f
                avail[vi * cfg.duration : vi * cfg.duration + cfg.duration] = True
            video_pad = ~avail
        elif cfg.multi_view_single_exo_inference:
            assert len(exo_cams) == 1
            vi = vmap[exo_cams[0]]
            total = cfg.num_max_views * cfg.duration
            video = np.ones((total, c_dim), np.float32)
            video[vi * cfg.duration : (vi + 1) * cfg.duration] = feats_list[0]
            video_pad = np.ones(total, bool)
            video_pad[vi * cfg.duration : (vi + 1) * cfg.duration] = False
            avail = ~video_pad
        else:
            video = np.concatenate(feats_list, 0)
            video_pad = np.zeros(video.shape[0], bool)
            avail = None

        # narration features + labels (reference :489-546)
        narr_feats, texts, starts, ends, u_starts, u_ends = [], [], [], [], [], []
        for nid in nids:
            key = f"{take}/{nid}"
            if not self.src.narration_store.exists(key):
                continue
            a = self._anno_by_id[nid]
            narr_feats.append(self.src.narration_store.read(key).reshape(-1))
            texts.append(a["narration"])
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
        u_starts, u_ends = u_starts[: cfg.duration], u_ends[: cfg.duration]

        out: Dict = {}
        if cfg.use_distill_nce_loss or cfg.model in ("view_invariant", "joint"):
            exo_feats, tgt, ntgt, valid, per_second_views = (
                self._exo_features_and_target(
                    take, ego_cam, exo_cams[0], start, end, rng,
                    # the distill tensors only reach the output dict under
                    # use_distill_nce_loss (below); for rankings-only callers
                    # skip the ~MAX_DISTILL_VIEWS full-window feature reads
                    read_features=cfg.use_distill_nce_loss,
                )
            )
        else:
            per_second_views = []

        if cfg.same_view_negative:
            ego_feats = self.src.video_store.read(f"{take}_{ego_cam}", start, end)
            out["same_view_neg_idxs"] = self._same_view_neg_idxs(
                ego_feats, narr_feats, u_starts, u_ends, rng
            ) if narr_feats else np.zeros(cfg.duration, np.int64)

        if cfg.randomize_narration_order and narr_feats:
            perm = rng.permutation(len(narr_feats))
            narr_feats = [narr_feats[i] for i in perm]
            texts = [texts[i] for i in perm]
            starts = [starts[i] for i in perm]
            ends = [ends[i] for i in perm]

        n_pad = int(cfg.duration)
        pad_narr = np.zeros((n_pad, cfg.feature_dim), np.float32)
        pad_start = np.zeros(n_pad, np.float32)
        pad_end = np.zeros(n_pad, np.float32)
        narr_mask = np.ones(n_pad, bool)
        if narr_feats:
            k = len(narr_feats)
            pad_narr[:k] = np.stack(narr_feats)[:, : cfg.feature_dim]
            pad_start[:k] = starts
            pad_end[:k] = ends
            narr_mask[:k] = False

        # majority per-narration camera rank (reference :548-558)
        narr_ranks = []
        for i in range(len(narr_feats)):
            si = int(starts[i] * cfg.duration)
            ei = min(int(ends[i] * cfg.duration) + 1, cfg.duration - 1)
            cur = per_second_views[si:ei]
            narr_ranks.append(
                max(cur, key=Counter(cur).get) if cur else "unk"
            )

        out.update({
            "video_features": video,
            "video_padding_mask": video_pad,
            "narration_features": pad_narr,
            "narration_padding_mask": narr_mask,
            "starts": pad_start,
            "ends": pad_end,
            "metadata": {
                "narrations": texts,
                "video_id": take,
                "exo_camera": exo_cams[0],
                "start_sec": start,
                "per_second_views": per_second_views,
                "narr_ranks": narr_ranks,
            },
        })
        if cfg.multi_view or cfg.multi_view_single_exo_inference:
            out["view_available_mask"] = avail
        if cfg.use_audio and self.src.audio_store is not None:
            audio = self.src.audio_store.read(
                f"{take}_{exo_cams[0]}", start, end
            )
            out["audio_features"] = audio
            out["audio_padding_mask"] = np.zeros(audio.shape[0], bool)
        if cfg.use_distill_nce_loss:
            out["ego_video_features"] = exo_feats
            out["view_rank_label"] = tgt
            out["view_rank_neg_label"] = ntgt
            out["valid_views_mask"] = valid
        if cfg.use_center_duration:
            out["mean"] = (pad_start + pad_end) / 2
            out["duration"] = np.abs(pad_end - pad_start)
        return out

    collate_fn = staticmethod(collate_dicts)


class EgoExo4DTANDataset(EgoExo4DDataset):
    """TAN-protocol variant (the JAX :662-726; reference
    loader_egoexo4d_tan.py:270-342): returns the raw 'video' window and its
    'padding_mask', the per-window unnormalised start/end lists for
    ``mask_from_time``, and the narration features."""

    def __getitem__(self, idx: int) -> Dict:
        cfg = self.cfg
        w = self.windows[idx]
        take = w["video_id"]
        start, end = int(w["start_sec"]), int(w["end_sec"])
        exo_cam = w["exo_cam"] if isinstance(w["exo_cam"], str) else w["exo_cam"][0]
        nids = [n for n in str(w["narration_ids"]).split(",") if n]

        video = self.src.video_store.read(f"{take}_{exo_cam}", start, end)

        narr_feats, texts, starts, ends = [], [], [], []
        for nid in nids:
            key = f"{take}/{nid}"
            if not self.src.narration_store.exists(key):
                continue
            a = self._anno_by_id[nid]
            narr_feats.append(self.src.narration_store.read(key).reshape(-1))
            texts.append(a["narration"])
            starts.append(max(a["start_frame"] / cfg.fps - start, 0))
            ends.append(min(a["end_frame"] / cfg.fps - start, cfg.duration))
        narr_feats = narr_feats[: cfg.duration]
        texts, starts, ends = (texts[: cfg.duration], starts[: cfg.duration],
                               ends[: cfg.duration])

        n_pad = int(cfg.duration)
        pad_narr = np.zeros((n_pad, cfg.feature_dim), np.float32)
        narr_mask = np.ones(n_pad, bool)
        if narr_feats:
            pad_narr[: len(narr_feats)] = np.stack(narr_feats)[:, : cfg.feature_dim]
            narr_mask[: len(narr_feats)] = False

        return {
            "video": video,
            "padding_mask": np.zeros(video.shape[0], bool),
            "start": starts,
            "end": ends,
            "narration_features": pad_narr,
            "narration_padding_mask": narr_mask,
            "metadata": {"narrations": texts, "video_id": take, "exo_camera": exo_cam,
                         "start_sec": start},
        }

    @staticmethod
    def collate_fn(items: List[Dict]) -> Dict:
        """Arrays stacked; start/end stay ragged lists (reference tan collate
        :123-139), for the trainer's ``mask_from_time`` with its text
        bucket; the metadata by key."""
        rest = [{k: v for k, v in it.items() if k not in ("metadata", "start", "end")}
                for it in items]
        out = collate_dicts(rest, meta_keys=())
        out["start"] = [it["start"] for it in items]
        out["end"] = [it["end"] for it in items]
        out["metadata"] = {k: [it["metadata"][k] for it in items] for k in items[0]["metadata"]}
        return out
