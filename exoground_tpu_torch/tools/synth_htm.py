"""A seeded HowTo100M feature tree for the TAN command line.

``make_htm_tree(root, ...)`` writes the ``--data_root`` layout that
``train/main.py`` reads (as ``tests/test_main_cli.py`` builds one for the
JAX package): per-second video features, sentencified ASR, an
``htm_vlen.csv``, an ``htm_align.json`` over some of the videos, and the
word2vec vocabulary and tower as a MIL-NCE-style torch checkpoint. Every
array comes from ``seed``; nothing is downloaded.

    python -m exoground_tpu_torch.tools.synth_htm OUT_DIR [--videos N] [--asr_gap S]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


# The ASR cadence of the JAX package's own command-line tree
# (tests/test_main_cli.py:21-26): 10 sentences of 8 words, 4 s each, with
# starts uniform over the first 140 of 160 s, i.e. one every 14 s. It is the
# one cadence with a source in the repo; real sentencified HowTo100M ASR is
# not in the repo, and its density is not measured here.
ASR_GAP_S, ASR_WORDS, ASR_LEN_S = 14.0, 8, 4.0


def _sentences(rng, vlen: float, vocab: int, gap: float = ASR_GAP_S):
    """ASR sentences over a video: one a ``gap`` seconds on average, starts
    uniform over all but the last 20 s (sorted), ``ASR_LEN_S`` long, of
    ``ASR_WORDS`` words from the vocabulary (ids 1..vocab as 'w<id>')."""
    span = max(vlen - 20.0, 1.0)
    n = max(1, int(round(span / gap)))
    start = np.sort(rng.rand(n) * span)
    words = rng.randint(1, vocab + 1, (n, ASR_WORDS))
    return {"text": [" ".join(f"w{i}" for i in row) for row in words],
            "start": [round(float(t), 2) for t in start],
            "end": [round(float(t) + ASR_LEN_S, 2) for t in start]}


def make_htm_tree(root: str, n_videos: int = 40, vlen=(80, 160), dim: int = 32,
                  vocab: int = 199, embed_dim: int = 16, hidden: int = 24, out_dim: int = 512,
                  n_align: int = 4, seed: int = 0, asr_gap: float = ASR_GAP_S,
                  feature_files: int = None) -> str:
    """Write the tree under ``root`` and return it. Videos of ``vlen`` seconds
    (uniform) with ``dim``-d float32 features and an ASR sentence every
    ``asr_gap`` seconds on average; a vocabulary of ``vocab`` words and a
    tower embedding ``vocab`` + 1 ids (0 the pad id) -> ``hidden`` ->
    ``out_dim``; ``n_align`` videos labelled in ``htm_align.json``. With
    ``feature_files``, only that many feature arrays are written and video
    i links to array i mod ``feature_files`` (a long epoch on little disk)."""
    rng = np.random.RandomState(seed)
    feat = os.path.join(root, "howto100m_s3d_features")
    os.makedirs(feat, exist_ok=True)
    asr, lengths = {}, {}
    for i in range(n_videos):
        vid = f"v{i:05d}"
        path = os.path.join(feat, f"{vid}.mp4.npy")
        if feature_files and i >= feature_files:
            src = i % feature_files
            os.symlink(f"v{src:05d}.mp4.npy", path)
            n = lengths[f"v{src:05d}"]
        else:
            n = int(rng.randint(vlen[0], vlen[1] + 1))
            np.save(path, rng.standard_normal((n, dim)).astype(np.float32))
        asr[vid] = _sentences(rng, n, vocab, asr_gap)
        lengths[vid] = n
    with open(os.path.join(root, "sentencified_htm_370k.json"), "w") as f:
        json.dump(asr, f)
    with open(os.path.join(root, "htm_vlen.csv"), "w") as f:
        f.writelines(f"{vid},{n}\n" for vid, n in lengths.items())
    align = {}
    for vid in sorted(asr)[-n_align:]:
        cap = _sentences(rng, lengths[vid], vocab, gap=9.0)
        align[vid] = [[int(rng.rand() < 0.6), s, e, t]
                      for t, s, e in zip(cap["text"], cap["start"], cap["end"])]
    with open(os.path.join(root, "htm_align.json"), "w") as f:
        json.dump(align, f)

    write_word2vec(root, vocab, embed_dim, hidden, out_dim, seed)
    return root


def write_word2vec(root: str, vocab: int, embed_dim: int, hidden: int, out_dim: int,
                   seed: int) -> None:
    """The vocabulary (``s3d_dict.npy``: words 'w1'..'w<vocab>', ids 1..vocab)
    and a seeded tower over it as a MIL-NCE-style checkpoint
    (``s3d_howto100m.pth``, the ``text_module.*`` keys)."""
    np.save(os.path.join(root, "s3d_dict.npy"), np.array([f"w{i}" for i in range(1, vocab + 1)]))
    g = torch.Generator().manual_seed(seed)
    state = {
        "text_module.word_embd.weight": torch.randn(vocab + 1, embed_dim, generator=g),
        "text_module.fc1.weight": torch.randn(hidden, embed_dim, generator=g) * embed_dim ** -0.5,
        "text_module.fc1.bias": torch.randn(hidden, generator=g) * 0.1,
        "text_module.fc2.weight": torch.randn(out_dim, hidden, generator=g) * hidden ** -0.5,
        "text_module.fc2.bias": torch.randn(out_dim, generator=g) * 0.1,
    }
    torch.save({"state_dict": state}, os.path.join(root, "s3d_howto100m.pth"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--videos", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--asr_gap", type=float, default=ASR_GAP_S,
                    help="mean seconds between ASR sentence starts")
    args = ap.parse_args(argv)
    print(make_htm_tree(args.root, n_videos=args.videos, seed=args.seed, asr_gap=args.asr_gap))


if __name__ == "__main__":
    main()
