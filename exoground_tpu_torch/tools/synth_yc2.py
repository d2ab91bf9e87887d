"""A seeded YouCook2 feature tree for the retrieval evaluation.

``make_yc2_tree(root, ...)`` writes what ``data/youcook2.py`` reads: one
float32 feature file per video (``features/<vid>.pth.tar``, a torch-saved
(T, dim) tensor at one feature a second, read through
``FeatureStore(root + "/features", suffixes=(".pth.tar",))``), a
``youcookii_annotations.json`` shaped as the YouCook2 release's
(``{'database': {vid: {'annotations': [{'segment': [s, e], 'sentence':
str}]}}}``, integer seconds), and the word2vec vocabulary and tower that
``tools/synth_htm.py`` writes (``s3d_dict.npy``, ``s3d_howto100m.pth``), so
raw sentences go through the tokenizer and the tower. Every array comes
from ``seed``; nothing is downloaded.

    python -m exoground_tpu_torch.tools.synth_yc2 OUT_DIR [--videos N] [--seed S]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from exoground_tpu_torch.tools.synth_htm import write_word2vec

SEGMENTS = (6, 10)  # annotated segments a video, uniform
SEGMENT_S = (5, 90)  # seconds a segment, uniform
LONG_SEGMENT = (257, 300)  # seconds: past the adaptive windows' 256-token cap
SENTENCE_WORDS = (6, 14)  # words a sentence, uniform
OOV_SHARE = 0.1  # words outside the vocabulary (token id 0)


def _segments(rng, vlen: int, n: int, long_share: float):
    """n (start, end) integer-second segments inside [0, vlen], sorted by
    start: most last ``SEGMENT_S`` seconds; ``long_share`` of them, in a
    video that holds one, last ``LONG_SEGMENT`` seconds."""
    out = []
    for _ in range(n):
        if vlen > LONG_SEGMENT[1] and rng.rand() < long_share:
            dur = int(rng.randint(LONG_SEGMENT[0], LONG_SEGMENT[1] + 1))
        else:
            dur = int(rng.randint(SEGMENT_S[0], SEGMENT_S[1] + 1))
        start = int(rng.randint(0, vlen - dur + 1))
        out.append((start, start + dur))
    return sorted(out)


def sentence(rng, vocab: int) -> str:
    """A sentence of ``SENTENCE_WORDS`` words: ``w<id>`` from the vocabulary
    of ``vocab`` words, ``OOV_SHARE`` of them ``x<id>`` (out of it)."""
    n = int(rng.randint(SENTENCE_WORDS[0], SENTENCE_WORDS[1] + 1))
    ids = rng.randint(1, vocab + 1, n)
    oov = rng.rand(n) < OOV_SHARE
    return " ".join(f"x{i}" if o else f"w{i}" for i, o in zip(ids, oov))


def make_yc2_tree(root: str, n_videos: int = 16, vlen=(200, 600), dim: int = 512,
                  long_share: float = 0.05, vocab: int = 199, embed_dim: int = 16,
                  hidden: int = 24, out_dim: int = 512, seed: int = 0) -> str:
    """Write the tree under ``root`` and return it: ``n_videos`` videos of
    ``vlen`` seconds (uniform) with ``dim``-d features, ``SEGMENTS`` annotated
    segments each as ``_segments`` draws them, a sentence of
    ``SENTENCE_WORDS`` words each; the vocabulary and tower as
    ``synth_htm.write_word2vec`` writes them."""
    rng = np.random.RandomState(seed)
    feat = os.path.join(root, "features")
    os.makedirs(feat, exist_ok=True)
    database = {}
    for i in range(n_videos):
        vid = f"yc{i:05d}"
        n = int(rng.randint(vlen[0], vlen[1] + 1))
        x = rng.standard_normal((n, dim)).astype(np.float32)
        torch.save(torch.from_numpy(x), os.path.join(feat, f"{vid}.pth.tar"))
        k = int(rng.randint(SEGMENTS[0], SEGMENTS[1] + 1))
        database[vid] = {"duration": float(n), "annotations": [
            {"id": j, "segment": [s, e], "sentence": sentence(rng, vocab)}
            for j, (s, e) in enumerate(_segments(rng, n, k, long_share))]}
    with open(os.path.join(root, "youcookii_annotations.json"), "w") as f:
        json.dump({"database": database}, f)
    write_word2vec(root, vocab, embed_dim, hidden, out_dim, seed)
    return root


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--videos", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(make_yc2_tree(args.root, n_videos=args.videos, seed=args.seed))


if __name__ == "__main__":
    main()
