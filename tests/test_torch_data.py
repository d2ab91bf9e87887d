"""The port's host data layer against the JAX package: collate, samplers,
the threaded loader, the HowTo100M readers and the pinned-copy prefetch.

The same seeded numpy inputs and the synthetic worlds of
``tests/world_htm.py`` go through ``exoground_tpu/data`` and
``exoground_tpu_torch/data``. Everything here is host numpy, so every
comparison is exact (array-equal), except float32 positions that the JAX
golden test itself holds at 1e-7.
"""

import os
import sys

import numpy as np
import pytest
import torch

from exoground_tpu.data import collate as jcollate
from exoground_tpu.data import sampling as jsampling
from exoground_tpu.data.htm import HTMConfig as JaxHTMConfig
from exoground_tpu.data.htm import HTMFeatureDataset as JaxFeatureDataset
from exoground_tpu.data.pipeline import ThreadedLoader as JaxLoader
from exoground_tpu.models.word2vec import Word2VecTokenizer as JaxTokenizer
from exoground_tpu_torch.data import (
    CurriculumShardedSampler,
    FeatureStore,
    HTMAlignDataset,
    HTMConfig,
    HTMFeatureDataset,
    ShardedSampler,
    ThreadedLoader,
    batched,
    collate,
    device_prefetch,
    get_phase,
    read_vlen_csv,
)
from exoground_tpu_torch.models.word2vec import Word2VecTokenizer
from tests import golden_common as G
from tests import world_htm as WH


def _eq(a, b, path=""):
    """Deep equality of two batches/items (arrays exactly, lists, scalars)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _eq(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


# ------------------------------------------------------------------ collate
def _ragged(seed):
    r = np.random.RandomState(seed)
    videos = [r.randn(t, 6).astype(np.float32) for t in (3, 9, 0, 12)]
    toks = [r.randint(0, 9, (n, 5)).astype(np.int32) for n in (2, 7, 1, 4)]
    starts = [list(r.rand(len(t)) * 5) for t in toks]
    ends = [list(np.asarray(s) + 2) for s in starts]
    feats = [r.randn(n, 6).astype(np.float32) for n in (0, 3, 8, 2)]
    return videos, toks, starts, ends, feats


@pytest.mark.parametrize("bucket", [4, 8, 16])
def test_collate_matches_jax(bucket):
    videos, toks, starts, ends, feats = _ragged(bucket)
    for v in videos:
        _eq(collate.pad_by_last(v, bucket), jcollate.pad_by_last(v, bucket))
        _eq(collate.pad_zeros(v, bucket, 7), jcollate.pad_zeros(v, bucket, 7))
    _eq(collate.stack_videos([v for v in videos if len(v)], bucket),
        jcollate.stack_videos([v for v in videos if len(v)], bucket))
    _eq(collate.stack_texts(toks, starts, ends, bucket),
        jcollate.stack_texts(toks, starts, ends, bucket))
    _eq(collate.stack_features(feats, bucket), jcollate.stack_features(feats, bucket))
    items = [{"a": np.full((2,), i, np.float32), "n": i, "s": f"x{i}",
              "metadata": {"vid": f"v{i}", "k": i}} for i in range(3)]
    _eq(collate.collate_dicts(items), jcollate.collate_dicts(items))


# ----------------------------------------------------------------- sampling
SAMPLERS = {
    "shuffle": dict(dataset_len=23, num_shards=1, shard=0, seed=5),
    "shards": dict(dataset_len=23, num_shards=4, shard=3, seed=5),
    "drop_last": dict(dataset_len=23, num_shards=4, shard=1, seed=5, drop_last=True),
    "ordered": dict(dataset_len=23, num_shards=3, shard=2, shuffle=False),
}


@pytest.mark.parametrize("case", sorted(SAMPLERS))
def test_sampler_order_matches_jax(case):
    ours, theirs = ShardedSampler(**SAMPLERS[case]), jsampling.ShardedSampler(**SAMPLERS[case])
    for epoch in (0, 1, 7):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert [int(i) for i in ours] == [int(i) for i in theirs]
        assert len(ours) == len(theirs)
    assert list(batched(iter(range(10)), 4, False)) == list(jsampling.batched(iter(range(10)), 4, False))
    assert list(batched(iter(range(10)), 4)) == list(jsampling.batched(iter(range(10)), 4))


@pytest.mark.parametrize("fixed_ramp", [False, True])
def test_curriculum_sampler_and_phase_match_jax(fixed_ramp):
    kw = dict(dataset_len=31, num_shards=2, shard=1, seed=3, max_epochs=8, start_frac=0.4,
              end_epoch_frac=0.6, fixed_ramp=fixed_ramp)
    ours, theirs = CurriculumShardedSampler(**kw), jsampling.CurriculumShardedSampler(**kw)
    for epoch in range(8):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert ours.curriculum_progress() == theirs.curriculum_progress()
        assert [int(i) for i in ours] == [int(i) for i in theirs]
    for args in ((0, 10, 3, 0.3), (6, 10, 3, 0.3), (9, 10, 4, 0.5), (2, 5, 1, 0.2)):
        assert get_phase(*args) == jsampling.get_phase(*args)
    with pytest.raises(ValueError):
        ShardedSampler(5, num_shards=2, shard=2)


# ------------------------------------------------------------- HTM readers
def _port_loader(world, mode="val"):
    cfg = HTMConfig(video_feature_root=world["root"], duration=WH.DUR, token_len=WH.TOKEN_LEN,
                    text_bucket=8)
    ds = HTMFeatureDataset(cfg, Word2VecTokenizer(dict(WH.VOCAB), max_words=WH.TOKEN_LEN),
                           mode=mode, asr=world["asr"])
    ds.video_info = sorted(world["asr"].keys())
    return ds


def _port_align_loader(align_root, mode="window"):
    cfg = HTMConfig(video_feature_root=align_root, duration=WH.DUR, token_len=WH.TOKEN_LEN,
                    text_bucket=8)
    return HTMAlignDataset(cfg, Word2VecTokenizer(dict(WH.VOCAB), max_words=WH.TOKEN_LEN),
                           mode=mode, anno=WH.ALIGN_ANNO)


@pytest.mark.parametrize("epoch", [0, 3])
def test_htm_feature_items_and_batches_match_jax(tmp_path, epoch):
    world = WH.build_htm_world(tmp_path)
    ours, theirs = _port_loader(world), WH.make_our_loader(world)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    items = []
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        _eq(a, b, f"item {i}")
        items.append(a)
    _eq(ours.collate_fn(items), theirs.collate_fn([theirs[i] for i in range(len(theirs))]))


def test_htm_align_items_match_jax(tmp_path):
    root = WH.build_align_world(tmp_path)
    for mode in ("window", "full"):
        ours = _port_align_loader(root, mode)
        theirs = WH.make_our_align_loader(root)
        theirs.mode = mode
        items = [ours[i] for i in range(len(ours))]
        for i, a in enumerate(items):
            _eq(a, theirs[i], f"{mode} item {i}")
        if mode == "window":  # full-mode items differ in length: no batch
            _eq(ours.collate_fn(items),
                theirs.collate_fn([theirs[i] for i in range(len(theirs))]))


@pytest.fixture(scope="module")
def htm_fixture():
    return np.load(os.path.join(G.GOLDEN_DIR, "htm_loader.npz"))


def test_golden_htm_loader(tmp_path, htm_fixture):
    """The port's readers against the frozen reference items, as
    tests/test_golden_data.py holds the JAX package's."""
    z = htm_fixture
    (tmp_path / "f").mkdir()
    (tmp_path / "a").mkdir()
    ours = _port_loader(WH.build_htm_world(tmp_path / "f"))
    assert list(ours.video_info) == [str(v) for v in z["feat::vids"]]
    for i, vid in enumerate(ours.video_info):
        for seed in WH.GOLDEN_SEEDS:
            ours._rng = lambda idx, s=seed: np.random.RandomState(s)
            o, kid = ours[i], f"feat::{vid}::{seed}"
            assert o["_texts"]["text"] == [str(t) for t in z[f"{kid}::text"]], kid
            np.testing.assert_allclose(o["_texts"]["start"], z[f"{kid}::start"], err_msg=kid)
            np.testing.assert_allclose(o["_texts"]["end"], z[f"{kid}::end"], err_msg=kid)
            np.testing.assert_array_equal(np.stack(o["_texts"]["token"]), z[f"{kid}::token"])
            np.testing.assert_array_equal(o["_video"], z[f"{kid}::video"].astype(np.float32))
            np.testing.assert_allclose(o["abs_text_start"], z[f"{kid}::abs_text_start"], atol=1e-7)
            np.testing.assert_allclose(o["abs_text_end"], z[f"{kid}::abs_text_end"], atol=1e-7)
            assert (int(o["cut_start"]), int(o["cut_end"])) == (
                int(z[f"{kid}::cut_start"]), int(z[f"{kid}::cut_end"])), kid
    align = _port_align_loader(WH.build_align_world(tmp_path / "a"))
    assert list(align.video_info) == [str(v) for v in z["align::vids"]]
    for i, vid in enumerate(align.video_info):
        for seed in WH.GOLDEN_SEEDS:
            with WH.pinned_align_rng(align, seed):
                o = align[i]
            kid = f"align::{vid}::{seed}"
            assert o["_texts"]["text"] == [str(t) for t in z[f"{kid}::text"]], kid
            np.testing.assert_allclose(o["_texts"]["start"], z[f"{kid}::start"], err_msg=kid)
            np.testing.assert_array_equal(np.asarray(o["_texts"]["aligned"]), z[f"{kid}::aligned"])
            np.testing.assert_array_equal(np.stack(o["_texts"]["token"]), z[f"{kid}::token"])
            np.testing.assert_array_equal(o["_video"], z[f"{kid}::video"].astype(np.float32))


def _split_world(tmp_path, n=100):
    """ASR for ``n`` videos (the split reads no features) and the filters."""
    r = np.random.RandomState(7)
    feat = tmp_path / "feat"
    asr = {}
    for i in range(n):
        vid = f"w{i:03d}"
        starts = sorted(float(s) for s in r.rand(6) * 30)
        asr[vid] = {"text": ["add the flour"] * 6, "start": starts, "end": [s + 3 for s in starts]}
    # no header, as the JAX reader's pd.read_csv(names=[vid, vlen]) expects
    (tmp_path / "htm_vlen.csv").write_text(
        "".join(f"w{i:03d},{[30, 70, 1200][i % 3]}\n" for i in range(n)))
    (tmp_path / "holdout.txt").write_text("w004\nw010\n")
    return feat, asr


@pytest.mark.parametrize("mode", ["train", "val"])
def test_split_and_vlen_csv_without_pandas(tmp_path, monkeypatch, mode):
    feat, asr = _split_world(tmp_path)
    kw = dict(video_feature_root=str(feat), vlen_csv=str(tmp_path / "htm_vlen.csv"),
              holdout_file=str(tmp_path / "holdout.txt"), duration=16)
    theirs = JaxFeatureDataset(JaxHTMConfig(**kw), JaxTokenizer(dict(WH.VOCAB)), mode=mode,
                               asr=asr)
    monkeypatch.setitem(sys.modules, "pandas", None)  # the port must not need it
    ours = HTMFeatureDataset(HTMConfig(**kw), Word2VecTokenizer(dict(WH.VOCAB)), mode=mode,
                             asr=asr)
    assert ours.video_info == theirs.video_info and len(ours) > 0
    lengths = read_vlen_csv(str(tmp_path / "htm_vlen.csv"))
    assert lengths["w001"] == 70.0 and len(lengths) == 100


def test_vlen_csv_skips_a_header_row(tmp_path):
    p = tmp_path / "vlen.csv"
    p.write_text("vid,vlen\na,100\nb,7.5\n\nc\n")
    assert read_vlen_csv(str(p)) == {"a": 100.0, "b": 7.5}


# ----------------------------------------------------------------- loaders
@pytest.mark.parametrize("drop_last", [True, False])
def test_threaded_loader_batches_match_jax(tmp_path, drop_last):
    world = WH.build_htm_world(tmp_path)
    ours_ds, theirs_ds = _port_loader(world), WH.make_our_loader(world)
    ours = ThreadedLoader(ours_ds, 3, sampler=ShardedSampler(len(ours_ds), seed=2),
                          num_workers=3, drop_last=drop_last)
    theirs = JaxLoader(theirs_ds, 3, sampler=jsampling.ShardedSampler(len(theirs_ds), seed=2),
                       num_workers=3, drop_last=drop_last)
    try:
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            a, b = list(ours), list(theirs)
            assert len(a) == len(b) == len(ours) == len(theirs)
            for x, y in zip(a, b):
                _eq(x, y)
    finally:
        ours.close()


def test_background_iterator_raises_on_the_consumer():
    ds = [{"x": np.zeros(2)}] * 4

    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("boom")
            return ds[i]

    loader = ThreadedLoader(Bad(), 2, num_workers=2)
    try:
        with pytest.raises(KeyError):
            list(loader)
    finally:
        loader.close()


def test_device_prefetch_on_the_cpu_keeps_order_and_values():
    batches = [{"a": np.full((2, 3), i, np.float32), "m": np.array([i % 2 == 0])}
               for i in range(5)]
    got = list(device_prefetch(iter(batches), "cpu", size=2))
    assert len(got) == 5
    for b, g in zip(batches, got):
        assert set(g) == {"a", "m"} and all(isinstance(t, torch.Tensor) for t in g.values())
        np.testing.assert_array_equal(g["a"].numpy(), b["a"])
        assert g["m"].dtype == torch.bool


def test_feature_store_backends(tmp_path):
    arr = np.arange(24, dtype=np.float32).reshape(6, 4)
    np.save(tmp_path / "a.webm.npy", arr)
    torch.save(torch.from_numpy(arr[:, None, :].copy()), tmp_path / "b.pt")
    store = FeatureStore(str(tmp_path), (".mp4.npy", ".webm.npy", ".pt"))
    assert store.exists("a") and store.exists("b") and not store.exists("c")
    np.testing.assert_array_equal(store.read("a", 2, 4), arr[2:4])
    np.testing.assert_array_equal(store.read("b", 1, 3), arr[1:3])  # (T,1,C) -> (T,C)
    assert store.length("a") == store.length("b") == 6
    mem = FeatureStore(mem={"m": arr})
    np.testing.assert_array_equal(mem.read("m", 0, 2), arr[:2])
    with pytest.raises(FileNotFoundError):
        store.read("c")
