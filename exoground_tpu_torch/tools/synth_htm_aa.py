"""A seeded HTM-AA tree for the end-to-end S3D finetune command line.

``make_htm_aa_tree(root, ...)`` writes the ``--data_root`` layout that
``train/main.py::run_htm_e2e`` reads, with nothing downloaded:

  htm_aa_v1.csv        vid,timestamp,text rows (texts hold commas and quotes)
  htm_vlen.csv         vid,vlen; some videos outside 64 < vlen < 2000
  s3d_dict.npy         the vocabulary, words 'w1'..'w<vocab>'
  s3d_howto100m.pth    a MIL-NCE-layout state dict: the S3D-G trunk with BN
                       running stats, fc 1024 -> out_dim, and
                       text_module.{word_embd, fc1, fc2}
  videos/<vid>.mp4     a few short test-pattern videos (ffmpeg's lavfi
                       testsrc), only when ffmpeg is on PATH

Every value comes from ``seed`` through numpy, so the same tree comes out on
any machine. ``s3d_reference_state`` is the trunk's state alone (the
weights the tests carry to the JAX package).

    python -m exoground_tpu_torch.tools.synth_htm_aa OUT_DIR [--videos N] [--rows R]
"""

from __future__ import annotations

import argparse
import csv
import os
import subprocess
from typing import Dict, Optional

import numpy as np
import torch

from exoground_tpu_torch.data.video_clips import ffmpeg_available


def s3d_reference_state(num_classes: int = 512, seed: int = 0) -> Dict[str, np.ndarray]:
    """The S3D-G trunk's seeded state by the MIL-NCE names (float32 numpy):
    convolutions He-normal, BN scales in [0.8, 1.2], biases N(0, 0.1),
    running means N(0, 0.05) and variances in [0.5, 1.5], the gating and
    ``fc`` Linears N(0, 1 / fan_in) (``fc`` a tenth of that)."""
    from exoground_tpu_torch.models.s3d import S3D

    model = S3D(num_classes=num_classes, device="cpu")
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("bias"):
            v = rng.normal(0.0, 0.1, shape)
        elif len(shape) == 5:  # conv (O, I, kT, kH, kW)
            v = rng.normal(0.0, np.sqrt(2.0 / np.prod(shape[1:])), shape)
        elif len(shape) == 1:  # BN scale
            v = rng.uniform(0.8, 1.2, shape)
        else:  # Linear (out, in)
            v = rng.normal(0.0, (0.1 if name == "fc.weight" else 1.0) / np.sqrt(shape[1]), shape)
        out[name] = v.astype(np.float32)
    for name, t in model.init_batch_stats().items():
        shape = tuple(t.shape)
        v = (rng.normal(0.0, 0.05, shape) if name.endswith("mean")
             else rng.uniform(0.5, 1.5, shape))
        out[name] = v.astype(np.float32)
    return out


def text_module_state(vocab: int, embed_dim: int = 300, hidden: int = 2048,
                      out_dim: int = 512, seed: int = 0) -> Dict[str, np.ndarray]:
    """The Sentence_Embedding's seeded ``text_module.*`` state: ``vocab`` + 1
    rows (0 the pad id) of ``embed_dim``, fc1 -> ``hidden``, fc2 -> ``out_dim``."""
    rng = np.random.RandomState(seed + 1)
    f32 = np.float32
    return {
        "text_module.word_embd.weight": rng.standard_normal((vocab + 1, embed_dim)).astype(f32),
        "text_module.fc1.weight": (rng.standard_normal((hidden, embed_dim))
                                   / np.sqrt(embed_dim)).astype(f32),
        "text_module.fc1.bias": rng.normal(0.0, 0.1, hidden).astype(f32),
        "text_module.fc2.weight": (rng.standard_normal((out_dim, hidden))
                                   * 0.1 / np.sqrt(hidden)).astype(f32),
        "text_module.fc2.bias": rng.normal(0.0, 0.01, out_dim).astype(f32),
    }


def _text(rng, vocab: int) -> str:
    words = [f"w{i}" for i in rng.randint(1, vocab + 1, rng.randint(3, 9))]
    words[1] += ","  # csv quoting: a comma and quotes inside the field
    words[-1] = f'"{words[-1]}"'
    return " ".join(words)


def _write_video(path: str, seconds: float) -> None:
    subprocess.run(["ffmpeg", "-nostdin", "-loglevel", "error", "-y", "-f", "lavfi", "-i",
                    f"testsrc=duration={seconds}:size=320x240:rate=10", "-pix_fmt", "yuv420p",
                    path], check=True, timeout=120)


def make_htm_aa_tree(root: str, n_videos: int = 12, rows_per_video: int = 4, vocab: int = 199,
                     embed_dim: int = 300, hidden: int = 2048, out_dim: int = 512,
                     seed: int = 0, clip_seconds: float = 3.2, videos: Optional[bool] = None,
                     n_mp4: int = 2, mp4_seconds: float = 12.0) -> str:
    """Write the tree under ``root`` and return it. ``n_videos`` videos of
    65-400 s, every fifth one of a length the vlen filter drops, each with
    ``rows_per_video`` aligned rows whose ``clip_seconds`` clips lie inside
    the video. With ``videos`` (default: when ffmpeg is on PATH) the first
    ``n_mp4`` kept videos get an mp4 of ``mp4_seconds`` and their rows lie
    inside it."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    videos = ffmpeg_available() if videos is None else videos
    rows, vlens, mp4s = [], [], []
    for i in range(n_videos):
        vid = f"aa{i:04d}"
        dropped = i % 5 == 4
        vlen = int(rng.choice([30, 2500])) if dropped else int(rng.randint(65, 401))
        vlens.append({"vid": vid, "vlen": vlen})
        span = float(vlen)
        if videos and not dropped and len(mp4s) < n_mp4:
            mp4s.append(vid)
            span = mp4_seconds
        ts = np.sort(rng.uniform(clip_seconds / 2, span - clip_seconds / 2, rows_per_video))
        rows += [{"vid": vid, "timestamp": round(float(t), 2), "text": _text(rng, vocab)}
                 for t in ts]
    for name, records in (("htm_aa_v1.csv", rows), ("htm_vlen.csv", vlens)):
        with open(os.path.join(root, name), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(records[0]))
            w.writeheader()
            w.writerows(records)
    np.save(os.path.join(root, "s3d_dict.npy"), np.array([f"w{i}" for i in range(1, vocab + 1)]))
    state = {**s3d_reference_state(out_dim, seed),
             **text_module_state(vocab, embed_dim, hidden, out_dim, seed)}
    torch.save({k: torch.from_numpy(v) for k, v in state.items()},
               os.path.join(root, "s3d_howto100m.pth"))
    if mp4s:
        os.makedirs(os.path.join(root, "videos"), exist_ok=True)
        for vid in mp4s:
            _write_video(os.path.join(root, "videos", f"{vid}.mp4"), mp4_seconds)
    return root


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--videos", type=int, default=12)
    ap.add_argument("--rows", type=int, default=4, help="aligned rows a video")
    ap.add_argument("--vocab", type=int, default=199)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_mp4", action="store_true", help="write no mp4 even with ffmpeg")
    args = ap.parse_args(argv)
    print(make_htm_aa_tree(args.root, n_videos=args.videos, rows_per_video=args.rows,
                           vocab=args.vocab, seed=args.seed,
                           videos=False if args.no_mp4 else None))


if __name__ == "__main__":
    main()
