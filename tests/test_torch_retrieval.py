"""YouCook2 retrieval in the port (``evals/retrieval.py``,
``data/youcook2.py``, ``tools/synth_yc2.py``) against the JAX package.

* ``compute_retrieval_metrics`` equal to the JAX function's on random sims
  and on sims with ties (a tie with the ground truth takes the best rank).
* ``test_retrieval_yc2`` with closures over the port's ``TemporalAligner``
  against closures over the JAX model on the same weights (clips shorter
  than ``seq_len``, equal and longer, where the positional table is
  interpolated; ``'str'`` items through the tokenizer and the word2vec
  tower): the twelve metrics equal, the pooled features within 1e-5 of
  max|JAX|; the tower's video features at 32-256 tokens within 1e-5.
* The golden ``retrieval_protocol.npz`` through the port's protocol with the
  numpy closures of ``tests/golden_common.py``: the metrics at the JAX
  package's own golden bar (1e-9).
* ``YouCook2Dataset`` items equal to the JAX dataset's and to
  ``yc2_loader.npz`` in the three frozen configurations; the half-val split;
  the ``.pth.tar`` features of a ``tools/synth_yc2.py`` tree.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.data.io import FeatureStore as JaxStore
from exoground_tpu.data.youcook2 import YouCook2Config as JaxConfig
from exoground_tpu.data.youcook2 import YouCook2Dataset as JaxDataset
from exoground_tpu.evals.retrieval import compute_retrieval_metrics as jax_metrics
from exoground_tpu.evals.retrieval import test_retrieval_yc2 as jax_yc2
from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.models.word2vec import Word2VecModel as JaxTower
from exoground_tpu.models.word2vec import Word2VecTokenizer as JaxTokenizer
from exoground_tpu.utils.convert import convert_word2vec_from_s3d as jax_convert_tower
from exoground_tpu_torch.data import FeatureStore, YouCook2Config, YouCook2Dataset
from exoground_tpu_torch.data.youcook2 import DROP_LIST
from exoground_tpu_torch.evals import compute_retrieval_metrics
from exoground_tpu_torch.evals.retrieval import test_retrieval_yc2 as run_yc2
from exoground_tpu_torch.models import TemporalAligner
from exoground_tpu_torch.models.word2vec import Word2VecModel, Word2VecTokenizer
from exoground_tpu_torch.tools.synth_yc2 import make_yc2_tree
from exoground_tpu_torch.utils.convert import convert_word2vec_from_s3d, load_tan_params
from tests import golden_common as G
from tests import world_yc2 as WY
from tests.test_torch_small import jax_params
from tests.torch_text_common import TEXT_DIM, VOCAB, sentences, tower_state
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

VDIM, TDIM, SEQ = 24, TEXT_DIM, 16
ARCH = dict(num_encoder_layers=1, num_joint_layers=1, width=64, heads=4, max_pos=64,
            random_pos_start=0)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------------ metrics
def _sims(case):
    r = np.random.RandomState(3)
    if case == "random":
        return r.randn(23, 23)
    sim = np.round(r.randn(30, 30), 1)  # many ties, some with the diagonal
    sim[np.arange(0, 30, 3), np.arange(1, 30, 3)] = np.diag(sim)[np.arange(0, 30, 3)]
    sim[5] = 0.0  # a whole row tied
    return sim


@pytest.mark.parametrize("case", ["random", "ties", "perfect"])
def test_retrieval_metrics_match_jax(case):
    sim = np.eye(12) if case == "perfect" else _sims(case)
    got, want = compute_retrieval_metrics(sim), jax_metrics(sim)
    assert got == want
    if case == "perfect":
        assert got == {"R1": 1.0, "R5": 1.0, "R10": 1.0, "MR": 1.0}
    if case == "ties":  # row 5: every score tied with the ground truth, rank 1
        assert compute_retrieval_metrics(sim[5:6, 5:6].repeat(2, 0).repeat(2, 1))["R1"] == 1.0


# ------------------------------------------------------------------ protocol
@pytest.fixture(scope="module")
def models():
    """The JAX and the port's aligner on the same weights, the two towers
    and the tokenizers."""
    jm = JaxAligner(**ARCH, attn_impl="xla")
    params = jax_params(jm, jnp.zeros((1, 8, VDIM)), jnp.zeros((1, 2, TDIM)),
                        jnp.zeros((1, 8), bool), jnp.zeros((1, 2), bool), seed=2)
    tm = TemporalAligner(**ARCH, video_dim=VDIM, text_dim=TDIM, device="cpu")
    load_tan_params(tm, params)
    state = tower_state(1)
    tower = Word2VecModel(convert_word2vec_from_s3d(
        {k: torch.from_numpy(v) for k, v in state.items()}), device="cpu")
    return dict(jm=jm, params={"params": params}, tm=tm, tower=tower,
                jtower=JaxTower(jax_convert_tower(state)))


def _port_fns(m):
    """The feature closures over the port's model and tower."""
    tm, tower, tok = m["tm"], m["tower"], Word2VecTokenizer(dict(VOCAB))

    def visual(clips, mask, interp):
        with torch.inference_mode():
            return tm.get_visual_feature(torch.from_numpy(clips), torch.from_numpy(mask),
                                         interpolate_from=interp).numpy()

    def text(lang):
        with torch.inference_mode():
            return tm.get_textual_feature(torch.from_numpy(lang)).numpy()

    def embed(strs):
        enc = tok(strs)
        return tower(enc["input_ids"], attention_mask=enc["attention_mask"])[
            "pooler_output"].numpy()

    return visual, text, embed


def _jax_fns(m):
    jm, params, tower, tok = m["jm"], m["params"], m["jtower"], JaxTokenizer(dict(VOCAB))

    seen = {}  # eager (the JAX interpolation reads host values): each input once

    def visual(clips, mask, interp):
        key = (clips.tobytes(), interp)
        if key not in seen:
            kw = {} if interp is None else {"interpolate_from": interp}
            seen[key] = np.asarray(jm.apply(params, jnp.asarray(clips), jnp.asarray(mask),
                                            method=type(jm).get_visual_feature, **kw))
        return seen[key]

    def text(lang):
        return np.asarray(jm.apply(params, jnp.asarray(lang),
                                   method=type(jm).get_textual_feature))

    def embed(strs):
        enc = tok(strs)
        return np.asarray(tower(enc["input_ids"], enc["attention_mask"])["pooler_output"])

    return visual, text, embed


def _items(n=9):
    """Items with windows shorter than, equal to and longer than SEQ tokens
    (the last two interpolate the positional table); half carry a raw
    sentence ('str') and no embedding."""
    r = np.random.RandomState(4)
    texts = sentences(6, n)
    items = []
    for i in range(n):
        ln, c = (12, 16, 24)[i % 3], 3
        start = r.randint(0, ln // 2, c)
        item = {"video": r.randn(c, ln, VDIM).astype(np.float32), "start_idx": start,
                "end_idx": start + r.randint(2, ln // 2, c)}
        if i % 2:
            item["str"] = texts[i]
        else:
            item["text_embed"] = r.randn(TDIM).astype(np.float32)
        items.append(item)
    return items


def test_retrieval_protocol_matches_jax(models):
    """The protocol over the port's model and tower against the JAX
    function over the JAX model: the pooled features within 1e-5 of
    max|JAX|, the twelve metrics equal."""
    items = _items()
    pv, pt, pe = _port_fns(models)
    jv, jt, je = _jax_fns(models)
    got = run_yc2(items, pv, pt, pe, seq_len=SEQ)
    want = jax_yc2(items, jv, jt, je, seq_len=SEQ)
    assert set(got) == set(G.YC2_METRIC_KEYS) and got == want
    for item in items:
        interp = SEQ if item["video"].shape[1] >= SEQ else None
        mask = np.zeros(item["video"].shape[:2], bool)
        assert _rel(pv(item["video"], mask, interp), jv(item["video"], mask, interp)) <= 1e-5
        if "str" in item:
            assert _rel(pe([item["str"]]), je([item["str"]])) <= 1e-5
            lang = pe([item["str"]])
            assert _rel(pt(lang), jt(lang)) <= 1e-5


@pytest.mark.parametrize("length", [32, 64, 128, 256])
def test_video_tower_interpolation_matches_jax(models, length):
    """The video tower at the adaptive windows' token counts, with the eval's
    ``seq_len=64`` gate (interpolate from 64 at 64 tokens and more)."""
    pv, _, _ = _port_fns(models)
    jv, _, _ = _jax_fns(models)
    clips = np.random.RandomState(length).randn(2, length, VDIM).astype(np.float32)
    mask = np.zeros((2, length), bool)
    interp = 64 if length >= 64 else None
    got = pv(clips, mask, interp)
    assert got.shape == (2, 1, length, 64)
    assert _rel(got, jv(clips, mask, interp)) <= 1e-5


def test_golden_retrieval_protocol():
    """``retrieval_protocol.npz`` (the reference's metrics) through the port's
    protocol with the numpy closures of tests/golden_common.py."""
    z = np.load(os.path.join(G.GOLDEN_DIR, "retrieval_protocol.npz"))
    items, _, w_vis, w_txt = G.yc2_protocol_items()
    got = run_yc2(items, lambda c, m, interp: G.yc2_vis_primitive(c, w_vis, interp is not None),
                  lambda lang: np.asarray(lang, np.float32) @ w_txt, seq_len=G.YC2_SEQ_LEN)
    for k in G.YC2_METRIC_KEYS:
        np.testing.assert_allclose(got[k], z[f"out::{k}"], atol=1e-9, err_msg=k)


# ------------------------------------------------------------------ dataset
def _same_item(got, want, kid):
    assert set(got) == set(want), kid
    for k in ("video", "start_idx", "end_idx"):
        assert got[k].dtype == want[k].dtype, (kid, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{kid} {k}")
    for k in ("start", "end", "vid", "str"):
        assert got[k] == want[k], (kid, k)


@pytest.mark.parametrize("tag", sorted(WY.GOLDEN_CONFIGS))
def test_dataset_items_match_jax_and_golden(tag):
    """Every item of the synthetic world against the JAX dataset's, and
    against the frozen reference items of ``yc2_loader.npz``."""
    num_clips, seq_len = WY.GOLDEN_CONFIGS[tag]
    world = WY.build_yc2_world()
    ours = YouCook2Dataset(YouCook2Config(num_clips=num_clips, seq_len=seq_len),
                           FeatureStore(mem=world["feats"]), world["anno"], half_val=False)
    theirs = WY.make_our_loader(world, num_clips, seq_len)
    z = np.load(os.path.join(G.GOLDEN_DIR, "yc2_loader.npz"))
    assert len(ours) == len(theirs) == int(z[f"{tag}::n"])
    for i in range(len(ours)):
        kid = f"{tag}::{i}"
        o = ours[i]
        _same_item(o, theirs[i], kid)
        np.testing.assert_array_equal(o["video"], z[f"{kid}::video"], err_msg=kid)
        assert (o["str"], o["start"], o["end"]) == (
            str(z[f"{kid}::str"]), float(z[f"{kid}::start"]), float(z[f"{kid}::end"]))
        if seq_len == -1:
            np.testing.assert_array_equal(o["start_idx"], z[f"{kid}::start_idx"], err_msg=kid)
            np.testing.assert_array_equal(o["end_idx"], z[f"{kid}::end_idx"], err_msg=kid)


def test_half_val_split_matches_jax():
    """The half-val split (``RandomState(0).permutation``), DROP_LIST and
    videos without features, against the JAX dataset in each mode."""
    r = np.random.RandomState(9)
    vids = [f"v{i:03d}" for i in range(13)] + [DROP_LIST[1]]
    feats = {v: r.randn(int(r.randint(60, 90)), 4).astype(np.float32) for v in vids}
    anno = {v: {"annotations": [{"segment": [2 * k, 2 * k + 20], "sentence": f"{v} {k}"}
                                for k in range(int(r.randint(1, 4)))]} for v in vids}
    anno["no_features"] = {"annotations": [{"segment": [0, 10], "sentence": "x"}]}
    for mode, half in (("val", True), ("val", False), ("train", True)):
        ours = YouCook2Dataset(YouCook2Config(), FeatureStore(mem=feats), anno, mode=mode,
                               half_val=half)
        theirs = JaxDataset(JaxConfig(), JaxStore(mem=feats), anno, mode=mode, half_val=half)
        assert ours.video_info == theirs.video_info, (mode, half)
        assert not any(i["vid"] in (DROP_LIST[1], "no_features") for i in ours.video_info)
    assert len({i["vid"] for i in ours.video_info}) == 13
    halved = YouCook2Dataset(YouCook2Config(), FeatureStore(mem=feats), anno)
    assert len({i["vid"] for i in halved.video_info}) == 6


def test_synth_tree_reads_through_the_feature_store(tmp_path):
    """A ``tools/synth_yc2.py`` tree: its ``.pth.tar`` features through
    ``FeatureStore`` give the items of the same arrays held in memory (the
    JAX dataset's too); every segment lies inside its video, and both
    adaptive branches occur (segments over and under 256 s)."""
    root = make_yc2_tree(str(tmp_path / "yc2"), n_videos=6, vlen=(300, 420), dim=8,
                         long_share=0.5, vocab=len(VOCAB), embed_dim=8, hidden=8, out_dim=8)
    with open(os.path.join(root, "youcookii_annotations.json")) as f:
        anno = json.load(f)["database"]
    feats = {v: torch.load(os.path.join(root, "features", f"{v}.pth.tar")).numpy()
             for v in anno}
    durations = []
    for v, entry in anno.items():
        for seg in entry["annotations"]:
            s, e = seg["segment"]
            assert isinstance(s, int) and 0 <= s < e <= len(feats[v])
            durations.append(e - s)
    assert max(durations) > 256 and min(durations) <= 128
    cfg = dict(num_clips=10, seq_len=-1)
    disk = YouCook2Dataset(YouCook2Config(**cfg),
                           FeatureStore(os.path.join(root, "features"), suffixes=(".pth.tar",)),
                           anno, half_val=False)
    theirs = JaxDataset(JaxConfig(**cfg), JaxStore(mem=feats), anno, half_val=False)
    assert len(disk) == len(theirs) == len(durations)
    lengths = set()
    for i in range(len(disk)):
        o = disk[i]
        _same_item(o, theirs[i], i)
        lengths.add(o["video"].shape[1])
    assert max(lengths) == 256 and min(lengths) <= 128
    tok = Word2VecTokenizer.from_dict_file(os.path.join(root, "s3d_dict.npy"))
    words = [w for i in range(len(disk)) for w in tok.tokenize(disk[i]["str"])]
    assert np.mean([w in tok.word_to_token for w in words]) > 0.8  # the tree's vocabulary
