"""The port's EgoExo4D and LEMMA readers against the JAX package's.

* ``EgoExo4DDataset`` over ``tests/world_egoexo.py``: every window and
  every item (arrays equal bit for bit, metadata equal) against the JAX
  reader, across views all / multi / ego, the phased and sorted curricula
  (phases 0 and 2), randomised rankings and narration order; the golden
  configurations also against
  ``tests/golden/egoexo_loader.npz`` at the JAX golden test's tolerance
  (1e-6). The first batch of each collated as the JAX collate does.
* ``LemmaDataset`` over ``tests/world_lemma.py`` likewise, against
  ``tests/golden/lemma_loader.npz``.
* The window cache: a cache written by the port reads back to the same
  windows (and items) in the JAX reader, and the JAX reader's in the port;
  both files are the same bytes.
* ``data/table.py`` against ``pandas.read_csv(...).to_dict("records")`` on
  the column types pandas infers (ints, ints with a gap, floats, strings
  with gaps, booleans, an empty column).
* The command line's dataset functions (``build_egoexo_dataset``,
  ``build_lemma_dataset``) against the JAX package's on a
  ``tools/synth_egoexo.py`` tree, with same-view negatives (they need the
  video and narration widths equal, as the scripts' 4096-d features are,
  which the worlds above are not).
"""

import dataclasses
import math
import os

import numpy as np
import pytest

from exoground_tpu.data import collate as jcollate
from exoground_tpu.data.egoexo4d import EgoExo4DDataset as JaxEgoExo
from exoground_tpu.data.egoexo4d import EgoExoConfig as JaxEgoExoConfig
from exoground_tpu.data.egoexo4d import EgoExoSource as JaxSource
from exoground_tpu.train import main as jax_main
from exoground_tpu.train.config import parse_args as jax_parse_args
from exoground_tpu_torch.data import collate_dicts
from exoground_tpu_torch.data.egoexo4d import EgoExo4DDataset, EgoExoConfig, EgoExoSource
from exoground_tpu_torch.data.io import FeatureStore
from exoground_tpu_torch.data.lemma import LemmaConfig, LemmaDataset
from exoground_tpu_torch.data.table import read_csv_records, write_csv_records
from exoground_tpu_torch.tools.synth_egoexo import make_egoexo_tree, make_lemma_tree
from exoground_tpu_torch.train import main as port_main
from exoground_tpu_torch.train.config import parse_args
from tests import golden_common as G
from tests import world_egoexo as W
from tests import world_lemma as WL


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.build_egoexo_world(tmp_path_factory.mktemp("egoexo_world"))


@pytest.fixture(scope="module")
def lemma_world(tmp_path_factory):
    return WL.build_lemma_world(tmp_path_factory.mktemp("lemma_world"))


def _source(world, cls):
    return cls.from_paths(
        split_csv=world["split_csv"], annotations_csv=world["annos_csv"],
        camera_rankings_json=world["rankings_json"], takes_json=world["takes_json"],
        video_feature_root=world["vfeat"], narration_feature_root=world["nfeat"],
        camera_pose_root=world["poses_dir"])


def _pair(world, flags, cache=None):
    """(port reader, JAX reader) over the world with ``flags``."""
    flags = dict(flags)
    split = flags.pop("split", "val")
    phase, epoch = flags.pop("phase", 0), flags.pop("epoch", 0)
    kw = dict(duration=W.DUR, hop_length=W.HOP, fps=W.FPS, feature_dim=W.NDIM, **flags)
    out = []
    for cls, cfg_cls, src_cls, path in ((EgoExo4DDataset, EgoExoConfig, EgoExoSource, cache),
                                        (JaxEgoExo, JaxEgoExoConfig, JaxSource, cache)):
        ds = cls(cfg_cls(**kw), _source(world, src_cls), split=split, window_csv_path=path)
        ds.set_epoch(epoch)
        ds.set_phase(phase)
        out.append(ds)
    return out


def _same_item(got, want, msg):
    assert set(got) == set(want), msg
    for k in want:
        if k == "metadata":
            assert got[k] == want[k], f"{msg}: metadata"
        else:
            assert got[k].dtype == want[k].dtype, f"{msg}: {k}"
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{msg}: {k}")


def _same_batch(got, want, msg):
    assert set(got) == set(want), msg
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{msg}: {k}")
        else:
            assert got[k] == want[k], f"{msg}: {k}"


def _check_readers(port, jax_ds, tag):
    assert [W.window_key(w) for w in port.windows] == [W.window_key(w) for w in jax_ds.windows]
    items = [port[i] for i in range(len(port))]
    for i, item in enumerate(items):
        _same_item(item, jax_ds[i], f"{tag}[{i}]")
    n = min(4, len(items))
    _same_batch(collate_dicts(items[:n]), jcollate.collate_dicts([jax_ds[i] for i in range(n)]),
                f"{tag} batch")
    return items


EXTRA = {
    "all_vi_train": dict(split="train", views="all", model="view_invariant",
                         use_distill_nce_loss=True),
    "multi_joint": dict(split="val", views="multi", num_max_views=4, model="joint",
                        use_distill_nce_loss=True),
    "ego_grounding": dict(split="val", views="ego", model="grounding"),
    "phased_p0": dict(split="train", views="all", model="joint", use_distill_nce_loss=True,
                      curriculum_train=True, sorted_curr_train="phased", epoch=1, phase=0),
    "phased_p2": dict(split="train", views="all", model="joint", use_distill_nce_loss=True,
                      curriculum_train=True, sorted_curr_train="phased", epoch=2, phase=2),
    "sorted": dict(split="train", views="all", model="joint", use_distill_nce_loss=True,
                   curriculum_train=True, sorted_curr_train="sorted"),
    "randomized": dict(split="train", views="exo", model="joint", use_distill_nce_loss=True,
                       randomize_ranking=True, randomize_narration_order=True, epoch=3),
}


@pytest.mark.parametrize("tag", sorted(EXTRA))
def test_egoexo_items_match_jax(world, tag):
    port, jax_ds = _pair(world, EXTRA[tag])
    assert len(port) > 0
    _check_readers(port, jax_ds, tag)


@pytest.mark.parametrize("tag", sorted(W.GOLDEN_CONFIGS))
def test_egoexo_golden_items_match_jax_and_the_fixture(world, tag):
    z = np.load(os.path.join(G.GOLDEN_DIR, "egoexo_loader.npz"))
    port, jax_ds = _pair(world, W.GOLDEN_CONFIGS[tag])
    items = _check_readers(port, jax_ds, tag)
    stored = [str(k) for k in z[f"{tag}::keys"]]
    by_key = {}
    for pos, k in enumerate(stored):
        by_key.setdefault(k, []).append(pos)
    keys = ["|".join(map(str, W.window_key(w))) for w in port.windows]
    assert sorted(keys) == sorted(stored)
    for key, item in zip(keys, items):
        kid = f"{tag}::{by_key[key].pop(0)}"
        for k in W.COMPARE_KEYS:
            fid = f"{kid}::{k}"
            assert (fid in z.files) == (k in item), fid
            if fid in z.files:
                np.testing.assert_allclose(np.asarray(item[k], np.float64),
                                           z[fid].astype(np.float64), atol=1e-6, err_msg=fid)
        for k in W.META_KEYS:
            got = [str(x) for x in np.atleast_1d(item["metadata"][k])]
            assert got == [str(x) for x in z[f"{kid}::meta.{k}"]], f"{kid}: {k}"


def _lemma_pair(world, split, **flags):
    kw = dict(duration=WL.DUR, hop_length=WL.HOP, fps=WL.FPS, feature_dim=WL.NDIM, **flags)
    port = LemmaDataset(
        LemmaConfig(**kw),
        split_rows=[{"video_id": v, "duration_sec": d} for v, d in world["videos"]],
        annotations=[{"vid_name": v, "unique_narration_id": n, "start_frame": s,
                      "end_frame": e, "narration": f"HOI {h}"} for v, n, s, e, h in world["annos"]],
        hoi_text_map=dict(world["hoi_text"]), video_store=FeatureStore(mem=world["mem_video"]),
        narration_store=FeatureStore(mem=world["mem_narr"]), split=split)
    return port, WL.make_our_loader(world, split, **flags)


LEMMA_CASES = {**{k: (s, dict(use_distill_nce_loss=d)) for k, (s, d) in WL.GOLDEN_CONFIGS.items()},
               "test_plain": ("test", dict(use_distill_nce_loss=False))}


@pytest.mark.parametrize("tag", sorted(LEMMA_CASES))
def test_lemma_items_match_jax_and_the_fixture(lemma_world, tag):
    split, flags = LEMMA_CASES[tag]
    port, jax_ds = _lemma_pair(lemma_world, split, **flags)
    port.set_epoch(1)
    jax_ds.set_epoch(1)
    assert port.windows == jax_ds.windows
    items = [port[i] for i in range(len(port))]
    for i, item in enumerate(items):
        _same_item(item, jax_ds[i], f"{tag}[{i}]")
    _same_batch(collate_dicts(items[:4]), jcollate.collate_dicts([jax_ds[i] for i in range(4)]),
                f"{tag} batch")
    if tag not in WL.GOLDEN_CONFIGS:
        return
    z = np.load(os.path.join(G.GOLDEN_DIR, "lemma_loader.npz"))
    assert ["|".join(map(str, WL.window_key(w))) for w in port.windows] == [
        str(k) for k in z[f"{tag}::keys"]]
    port.set_epoch(0)
    for pos in range(len(port)):
        item, kid = port[pos], f"{tag}::{pos}"
        for k in WL.COMPARE_KEYS:
            fid = f"{kid}::{k}"
            assert (fid in z.files) == (k in item), fid
            if fid in z.files:
                np.testing.assert_allclose(np.asarray(item[k], np.float64),
                                           z[fid].astype(np.float64), atol=1e-6, err_msg=fid)
        for k in WL.META_KEYS:
            got = [str(x) for x in np.atleast_1d(item["metadata"][k])]
            assert got == [str(x) for x in z[f"{kid}::meta.{k}"]], f"{kid}: {k}"


@pytest.mark.parametrize("tag", ["phased_p0", "multi_joint", "ego_grounding"])
def test_window_cache_reads_back_in_both_packages(world, tmp_path, tag):
    """The port writes its cache, the JAX reader reads it; the JAX reader
    writes its own, the port reads it: the same windows and items, and the
    same bytes on disk."""
    port_csv, jax_csv = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    port_w, _ = _pair(world, EXTRA[tag], cache=port_csv)
    _, jax_w = _pair(world, EXTRA[tag], cache=jax_csv)
    with open(port_csv, "rb") as a, open(jax_csv, "rb") as b:
        assert a.read() == b.read()
    _, jax_r = _pair(world, EXTRA[tag], cache=port_csv)  # JAX reads the port's
    port_r, _ = _pair(world, EXTRA[tag], cache=jax_csv)  # the port reads JAX's
    keys = [W.window_key(w) for w in port_w.windows]
    for ds in (jax_r, port_r, jax_w):
        assert [W.window_key(w) for w in ds.windows] == keys
    for i in range(len(keys)):
        _same_item(port_r[i], jax_r[i], f"{tag}[{i}] read back")


def _norm(v):
    v = v.item() if hasattr(v, "item") else v
    if isinstance(v, float) and math.isnan(v):
        return ("nan",)
    return (type(v).__name__, v)


def test_table_types_columns_as_pandas(tmp_path):
    import pandas as pd

    path = str(tmp_path / "t.csv")
    with open(path, "w") as f:
        f.write("a,b,c,d,e,f,g,h\n"
                "1,2,0.5,x,True,,007,\"n1,n2\"\n"
                "3,,1,,False,,8,NA\n"
                "-4,5,2.25,y z,True,,9,n3\n")
    want = [{k: _norm(v) for k, v in r.items()} for r in pd.read_csv(path).to_dict("records")]
    got = [{k: _norm(v) for k, v in r.items()} for r in read_csv_records(path)]
    assert got == want
    records = [{"x": 1, "y": "['a', 'b']", "z": ""}, {"x": 2, "w": 0, "z": "p,q"}]
    write_csv_records(str(tmp_path / "w.csv"), records)
    pd.DataFrame(records).to_csv(str(tmp_path / "p.csv"), index=False)
    assert open(tmp_path / "w.csv").read() == open(tmp_path / "p.csv").read()


def test_window_cache_is_never_seen_half_written(tmp_path, monkeypatch):
    """The ranks of a data-parallel run on one host write the same window
    cache; a rank that finds it (``os.path.exists``) reads it whole, so the
    file appears only complete, renamed into place."""
    from exoground_tpu_torch.data import table

    path = str(tmp_path / "windows.csv")
    seen = []
    real = table.csv.writer

    def writer(f, **kw):
        w = real(f, **kw)

        class Spy:
            def writerow(self, row):
                seen.append(os.path.exists(path))
                return w.writerow(row)

        return Spy()

    monkeypatch.setattr(table.csv, "writer", writer)
    records = [{"video_id": f"v{i}", "start_sec": i} for i in range(5)]
    write_csv_records(path, records)
    assert seen == [False] * 6  # the header and 5 rows, none with the file in place
    assert os.listdir(tmp_path) == ["windows.csv"]  # no temporary left behind
    assert read_csv_records(path) == records


@pytest.fixture(scope="module")
def synth_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    widths = dict(seconds=40, video_dim=16, text_dim=16)
    return (make_egoexo_tree(str(root / "egoexo"), {"train": 2, "val": 1}, **widths),
            make_lemma_tree(str(root / "lemma"), {"train": 2, "val": 1}, **widths))


@pytest.mark.parametrize("route", ["egoexo4d_joint_curriculum", "egoexo4d_vi", "lemma_joint"])
def test_command_line_readers_match_jax(synth_trees, route):
    """The port's ``build_egoexo_dataset`` / ``build_lemma_dataset`` (CSV
    files read without pandas) against the JAX functions on the same tree."""
    eg, lm = synth_trees
    dataset, model = route.split("_")[:2]
    argv = ["--dataset", dataset, "--model", "joint" if model == "joint" else "view_invariant",
            "--use_keysteps", "--views", "all", "--exos", "all", "--use_distill_nce_loss",
            "--same_view_negative", "--seq_len", "16", "--text_feature_dim", "16",
            "--data_root", eg if dataset == "egoexo4d" else lm]
    if route.endswith("curriculum"):
        argv.append("--curriculum_train")
    cfg, jcfg = parse_args(argv), jax_parse_args(argv)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if dataset == "egoexo4d":
        port = port_main.build_egoexo_dataset(cfg, "train")
        os.remove(port.window_csv_path)  # the JAX reader builds its own windows
        jax_ds = jax_main.build_egoexo_dataset(jcfg, "train")
        os.remove(jax_ds.window_csv_path)
        key = W.window_key
    else:
        port = port_main.build_lemma_dataset(cfg, "train")
        jax_ds = jax_main.build_lemma_dataset(jcfg, "train")
        key = WL.window_key
    assert [key(w) for w in port.windows] == [key(w) for w in jax_ds.windows]
    for i in range(0, len(port), max(1, len(port) // 6)):
        _same_item(port[i], jax_ds[i], f"{route}[{i}]")
