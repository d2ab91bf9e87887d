"""Seeded EgoExo4D and LEMMA trees for the keystep-grounding command line.

``make_egoexo_tree(root, ...)`` writes the ``--data_root`` layout that
``train/main.py`` reads for ``--dataset egoexo4d --use_keysteps``: per split
``splits/{split}.csv`` and ``keystep_annotations/{split}.csv``,
``takes.json`` (each take with its ego camera and its exo cameras),
``all_camera_rankings.json`` (a ranking of the exo cameras every second),
``egovlpv2_video_features/{take}_{cam}.pt`` (one row a second) and
``narration_features/{take}/{nid}.pt``. ``make_lemma_tree(root, ...)`` writes
``--dataset lemma``'s: ``splits/``, ``keystep_annotations/`` with ``all.csv``,
``vid_feats/{video_id}_{cam}.pt`` and ``keystep_feats/{hoi}.pt``. Every
array comes from ``seed``; nothing is downloaded. The widths are the
caller's (the scripts' 4096-d EgoVLPv2 video and narration features at full
width); only the number of takes and their length set the scale.

    python -m exoground_tpu_torch.tools.synth_egoexo OUT_DIR [--lemma] [--takes N] ...
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from exoground_tpu_torch.data.table import write_csv_records

FPS_EGOEXO, FPS_LEMMA = 30, 24


def _keysteps(rng, seconds: int, gap: float, length=(4.0, 14.0)):
    """(start_s, end_s) keysteps about every ``gap`` seconds over a video."""
    out, t = [], float(rng.uniform(0.0, gap))
    while t < seconds - 1:
        out.append((t, min(t + float(rng.uniform(*length)), seconds - 0.5)))
        t += float(rng.uniform(0.5 * gap, 1.5 * gap))
    return out


def _save(path: str, arr: np.ndarray) -> None:
    torch.save(torch.from_numpy(np.ascontiguousarray(arr, np.float32)), path)


def make_egoexo_tree(root: str, takes=None, seconds: int = 220, n_exo: int = 4,
                     video_dim: int = 4096, text_dim: int = 4096, keystep_gap: float = 8.0,
                     seed: int = 0) -> str:
    """Write an EgoExo4D tree under ``root`` and return it. ``takes`` maps a
    split to its number of takes (default train 4, val 1, test 1), each
    ``seconds`` long with an ego camera (aria01) and ``n_exo`` exo cameras
    (cam01..), ``video_dim``-d features a second for every camera,
    ``text_dim``-d keystep features, a keystep about every ``keystep_gap``
    seconds."""
    takes = takes or {"train": 4, "val": 1, "test": 1}
    rng = np.random.RandomState(seed)
    vdir = os.path.join(root, "egovlpv2_video_features")
    ndir = os.path.join(root, "narration_features")
    for d in (vdir, ndir, os.path.join(root, "splits"),
              os.path.join(root, "keystep_annotations")):
        os.makedirs(d, exist_ok=True)
    exo = [f"cam{i + 1:02d}" for i in range(n_exo)]
    ego = "aria01"
    takes_json, rankings = [], {}
    for split, n in takes.items():
        split_rows, annos = [], []
        for i in range(n):
            name, uid = f"{split}_take{i:03d}", f"uid_{split}_{i:03d}"
            takes_json.append({"take_name": name,
                               "frame_aligned_videos": {c: {} for c in [ego] + exo}})
            split_rows.append({"take_name": name, "take_uid": uid, "duration_sec": seconds,
                               "ego_camera_path": f"takes/{name}/{ego}.mp4"})
            for cam in [ego] + exo:
                _save(os.path.join(vdir, f"{name}_{cam}.pt"),
                      rng.standard_normal((seconds, video_dim)))
            os.makedirs(os.path.join(ndir, name), exist_ok=True)
            for j, (s, e) in enumerate(_keysteps(rng, seconds, keystep_gap)):
                nid = f"{name}_ks{j:04d}"
                annos.append({"take_uid": name, "unique_narration_id": nid,
                              "start_frame": int(s * FPS_EGOEXO),
                              "end_frame": int(e * FPS_EGOEXO), "narration": f"keystep {j}"})
                _save(os.path.join(ndir, name, f"{nid}.pt"),
                      rng.standard_normal((1, text_dim)))
            rankings[uid] = {str(t): {str(r): c for r, c in enumerate(rng.permutation(exo))}
                             for t in range(seconds)}
        write_csv_records(os.path.join(root, "splits", f"{split}.csv"), split_rows)
        write_csv_records(os.path.join(root, "keystep_annotations", f"{split}.csv"), annos)
    with open(os.path.join(root, "takes.json"), "w") as f:
        json.dump(takes_json, f)
    with open(os.path.join(root, "all_camera_rankings.json"), "w") as f:
        json.dump(rankings, f)
    return root


def make_lemma_tree(root: str, videos=None, seconds: int = 200, video_dim: int = 4096,
                    text_dim: int = 4096, n_hoi: int = 12, keystep_gap: float = 8.0,
                    seed: int = 0) -> str:
    """Write a LEMMA tree under ``root`` and return it: ``videos`` maps a
    split to its number of videos (default train 3, val 1, test 1), each
    ``seconds`` long with the fpv1 and master cameras; ``n_hoi`` HOI
    keysteps with ``text_dim``-d features."""
    videos = videos or {"train": 3, "val": 1, "test": 1}
    rng = np.random.RandomState(seed)
    vdir = os.path.join(root, "vid_feats")
    kdir = os.path.join(root, "keystep_feats")
    adir = os.path.join(root, "keystep_annotations")
    for d in (vdir, kdir, adir, os.path.join(root, "splits")):
        os.makedirs(d, exist_ok=True)
    for h in range(n_hoi):
        _save(os.path.join(kdir, f"{h}.pt"), rng.standard_normal((1, text_dim)))
    write_csv_records(os.path.join(adir, "all.csv"),
                      [{"hoi_index": h, "natural_language": f"hoi step {h}"}
                       for h in range(n_hoi)])
    for split, n in videos.items():
        rows, annos = [], []
        for i in range(n):
            vid = f"{split}_vid{i:03d}"
            rows.append({"video_id": vid, "duration_sec": seconds})
            for cam in ("fpv1", "master"):
                _save(os.path.join(vdir, f"{vid}_{cam}.pt"),
                      rng.standard_normal((seconds, video_dim)))
            for j, (s, e) in enumerate(_keysteps(rng, seconds, keystep_gap)):
                annos.append({"vid_name": vid, "unique_narration_id": f"{vid}_ks{j:04d}",
                              "start_frame": int(s * FPS_LEMMA), "end_frame": int(e * FPS_LEMMA),
                              "narration": f"HOI {int(rng.randint(n_hoi))}"})
        write_csv_records(os.path.join(root, "splits", f"{split}.csv"), rows)
        write_csv_records(os.path.join(adir, f"{split}.csv"), annos)
    return root


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--lemma", action="store_true", help="write a LEMMA tree")
    ap.add_argument("--takes", type=int, default=4, help="training takes (videos)")
    ap.add_argument("--seconds", type=int, default=220)
    ap.add_argument("--video_dim", type=int, default=4096)
    ap.add_argument("--text_dim", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    widths = dict(seconds=args.seconds, video_dim=args.video_dim, text_dim=args.text_dim,
                  seed=args.seed)
    if args.lemma:
        print(make_lemma_tree(args.root, {"train": args.takes, "val": 1, "test": 1}, **widths))
    else:
        print(make_egoexo_tree(args.root, {"train": args.takes, "val": 1, "test": 1}, **widths))


if __name__ == "__main__":
    main()
