"""Orbax checkpoint directories in the port, on the CPU: the port's OCDBT
store, zarr reader and writer (``utils/ocdbt.py``, ``utils/orbax.py``)
against orbax, TensorStore and the JAX package, which the port does not
import (the reads below run with ``orbax``, ``tensorstore`` and
``zstandard`` unimportable).

* The JAX ``save_state_orbax`` -> the port's ``load_state``: what the JAX
  ``load_state_orbax`` returns, keys, types, dtypes and values bit for bit
  (bfloat16 as ``torch.bfloat16`` tensors), for float32 / float64 / int32
  / int64 / bool / bfloat16 arrays, 0-d arrays, Python scalars, nested and
  empty dicts, and arrays that orbax writes in several chunks and data
  files (its data-file target patched small);
* the port's ``save_state_orbax`` -> the JAX ``load_state_orbax``: equal to
  the JAX writer's own directory of the same tree, its ``_METADATA`` and
  ``.zarray`` files the same JSON;
* OCDBT against TensorStore: stores TensorStore writes (many versions,
  inline and indirect values, interior nodes, uncompressed nodes) read
  equal; the port's store read by TensorStore; zarr arrays TensorStore
  writes in several chunks, one missing (its fill value), each dtype;
* a ``TANTrainer`` resumed (and loaded for pretrain / test) from each
  committed JAX orbax fixture equals one resumed from its msgpack twin bit
  for bit, before and after its next step (tests/test_torch_checkpoint.py
  holds that step to the JAX trainer's);
* ``--vi_encoder_path <dir>`` (``load_frozen_vi_encoder``) and
  ``GroundingService.from_checkpoint(<dir>)`` equal their msgpack twins
  (and the JAX service on the directory); chip_smoke's
  ``jax_grounding_tree`` and orbax ``write_jax_checkpoint`` write the JAX
  package's layout;
* a bad CRC, a directory that is not an orbax checkpoint, ``use_zarr3`` and
  ``use_ocdbt: false`` raise ``ValueError``, naming what is wrong.
"""

import contextlib
import json
import os
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import tensorstore as ts
import torch
from flax import serialization

from exoground_tpu.models.grounding import ExoGroundingTransformer as JaxExo
from exoground_tpu.models.vi_encoder import ViewInvariantMLP as JaxVIMLP
from exoground_tpu.serve import GroundingService as JaxService
from exoground_tpu.train.checkpoint import load_state_orbax as jax_load_orbax
from exoground_tpu.train.checkpoint import save_state as jax_save
from exoground_tpu.train.checkpoint import save_state_orbax as jax_save_orbax
from exoground_tpu_torch.evals.bench_items import make_grounding_requests
from exoground_tpu_torch.models import ExoGroundingTransformer, GroundingModel
from exoground_tpu_torch.serve import GroundingService
from exoground_tpu_torch.train import optimizer_state_dict
from exoground_tpu_torch.train import checkpoint as ckpt
from exoground_tpu_torch.train.main import load_frozen_vi_encoder
from exoground_tpu_torch.utils import ocdbt, orbax
from exoground_tpu_torch.utils.convert import UNUSED_REFERENCE_KEYS, grounding_state_dict_from_jax
from tests import jax_tan_fixtures as F
from tests.test_torch_checkpoint import _port_trainer
from tests.test_torch_grounding import SVC
from tests.test_torch_small import jax_params

HIDDEN = ("orbax", "orbax.checkpoint", "tensorstore", "zstandard")
FIELDS = {k: v for k, v in SVC.items() if k not in ("heads", "max_pos")}  # GroundingModel's


@contextlib.contextmanager
def _without_orbax():
    """orbax, TensorStore and zstandard unimportable inside the block."""
    saved = {k: sys.modules[k] for k in HIDDEN if k in sys.modules}
    try:
        sys.modules.update({k: None for k in HIDDEN})
        yield
    finally:
        for k in HIDDEN:
            sys.modules.pop(k, None)
        sys.modules.update(saved)


def _port_load(path):
    with _without_orbax():
        return ckpt.load_state(path)


def _same(got, want, path=""):
    """``got`` (the port's) is ``want`` (orbax's): the same containers and
    keys, numpy arrays of the same dtype and bits, bfloat16 as a
    ``torch.bfloat16`` tensor of the same bits, scalars of the same type."""
    if isinstance(want, dict):
        assert type(got) is dict and set(got) == set(want), (path, got, want)
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray) and want.dtype == ml_dtypes.bfloat16:
        assert torch.is_tensor(got) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16),
                                      err_msg=path)
    elif isinstance(want, np.ndarray):
        assert type(got) is np.ndarray and got.dtype == want.dtype, (path, got, want)
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _trees():
    """Each case's tree, as the JAX package saves it (numpy leaves)."""
    rng = np.random.RandomState(0)
    return {
        "dtypes": {"f32": rng.randn(5, 7).astype(np.float32),
                   "f64": rng.randn(3, 2, 4),
                   "i32": rng.randint(-2**31, 2**31 - 1, (6,)).astype(np.int32),
                   "i64": rng.randint(-2**62, 2**62, (2, 3)).astype(np.int64),
                   "bool": rng.rand(9) > 0.5,
                   "bf16": rng.randn(4, 6).astype(ml_dtypes.bfloat16),
                   "zero_d": {"f32": np.float32(-2.5).reshape(()), "i32": np.asarray(np.int32(7)),
                              "bf16": np.asarray(1.5, ml_dtypes.bfloat16)}},
        "scalars": {"epoch": 3, "best_acc": -1e5, "flag": True, "off": False, "big": 2**40,
                    "neg": -7, "iteration": np.int64(12), "lr": 0.125},
        "nested_empty": {"optimizer": {"mini_step": np.int32(1), "skip_state": {},
                                       "inner_opt_state": {"0": {"0": {"count": np.int32(3)},
                                                                 "1": {"inner_state": {}}}}},
                         "nothing": {}, "deep": {"a": {"b": {"c": np.arange(4.0)}}}},
        "chunks": {"big": rng.randn(300, 170).astype(np.float32),
                   "long": rng.randn(40_000),
                   "bf16": rng.randn(257, 129).astype(ml_dtypes.bfloat16),
                   "small": np.arange(3, dtype=np.int32)},
    }


CASES = ("chunks", "dtypes", "nested_empty", "scalars")


@pytest.fixture
def small_data_files(monkeypatch):
    """orbax's data-file target (2 GiB) at 64 KB: it splits the larger
    arrays into chunks of at most that."""
    from orbax.checkpoint._src.serialization import tensorstore_utils

    monkeypatch.setattr(tensorstore_utils, "_DEFAULT_OCDBT_TARGET_DATA_FILE_SIZE", 65536)


@pytest.mark.parametrize("case", CASES)
def test_port_reads_what_the_jax_package_writes(case, tmp_path, small_data_files):
    tree = _trees()[case]
    path = str(tmp_path / case)
    jax_save_orbax(path, tree)
    assert ckpt.checkpoint_format(path) == "orbax"
    _same(_port_load(path), jax_load_orbax(path))
    if case == "chunks":  # several chunks an array, several data files
        with ocdbt.open(path) as store:
            chunks = [k for k in store if k.startswith(b"big/") and not k.endswith(b"zarray")]
        assert len(chunks) > 1
        assert len(os.listdir(os.path.join(path, "ocdbt.process_0", "d"))) > 2


def _as_port(tree):
    """The tree as the port holds it: tensors (bfloat16 ones as
    ``torch.bfloat16``) for every other array."""
    flip = [True]

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, np.ndarray) and node.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(node.view(np.int16).copy()).view(torch.bfloat16)
        if isinstance(node, np.ndarray) and node.dtype != bool:
            flip[0] = not flip[0]
            return torch.from_numpy(node.copy()) if flip[0] else node
        return node

    return conv(tree)


def _zarrays(path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}"}).result()
    out = {}
    for k in kv.list().result():
        if k.endswith(b".zarray"):
            meta = json.loads(kv.read(k).result().value)
            meta.pop("chunks")  # orbax's chunking is its own
            out[k] = meta
    return out


@pytest.mark.parametrize("case", CASES)
def test_jax_package_reads_what_the_port_writes(case, tmp_path):
    tree = _trees()[case]
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    with _without_orbax():
        ckpt.save_state_orbax(port, _as_port(tree))
        ckpt.save_state_orbax(port, _as_port(tree))  # over the first, as force=True
    jax_save_orbax(ref, tree)
    got, want = jax_load_orbax(port), jax_load_orbax(ref)
    jax.tree_util.tree_map(lambda g, w: np.testing.assert_array_equal(g, w), got, want)
    jax.tree_util.tree_map(lambda g, w: np.asarray(g).tobytes() == np.asarray(w).tobytes()
                           or pytest.fail(f"{g} != {w}"), got, want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert jax.tree_util.tree_map(type, got) == jax.tree_util.tree_map(type, want)
    metas = [json.load(open(os.path.join(p, "_METADATA"))) for p in (port, ref)]
    assert metas[0] == metas[1]
    assert _zarrays(port) == _zarrays(ref)
    cps = [json.load(open(os.path.join(p, "_CHECKPOINT_METADATA"))) for p in (port, ref)]
    assert set(cps[0]) == set(cps[1]) and cps[0]["item_handlers"] == cps[1]["item_handlers"]
    assert sorted(os.listdir(tmp_path)) == ["jax", "port"]  # no temporary left


# ------------------------------------------------------ OCDBT and zarr alone
def _ts_store(path, config=None):
    spec = {"driver": "ocdbt", "base": f"file://{path}"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def _ts_items(path):
    kv = _ts_store(path)
    return {k: kv.read(k).result().value for k in kv.list().result()}


OCDBT_CASES = {
    "versions": dict(config=None, batches=40),
    "interior_nodes": dict(config={"max_decoded_node_bytes": 256,
                                   "max_inline_value_bytes": 64}, batches=1),
    "uncompressed": dict(config={"compression": None, "max_inline_value_bytes": 100},
                         batches=3),
}


@pytest.mark.parametrize("case", sorted(OCDBT_CASES))
def test_ocdbt_reads_what_tensorstore_writes(case, tmp_path):
    spec = OCDBT_CASES[case]
    kv = _ts_store(tmp_path, spec["config"])
    rng = np.random.RandomState(1)
    for b in range(spec["batches"]):
        txn = ts.Transaction()
        for i in range(80 // spec["batches"] + 1):
            key = f"prefix/common/{b:02d}/key{i:03d}".encode()
            size = int(rng.choice([0, 3, 100, 2000]))
            kv.with_transaction(txn).write(key, rng.bytes(size)).result()
        txn.commit_async().result()
    want = _ts_items(tmp_path)
    with _without_orbax(), ocdbt.open(str(tmp_path)) as store:
        got = {k: store[k] for k in store}
    assert got == want and len(want) > 50


def test_tensorstore_reads_what_ocdbt_writes(tmp_path):
    rng = np.random.RandomState(2)
    items = {f"k/{i:04d}".encode(): rng.bytes(int(rng.choice([0, 1, 1024, 1025, 5000])))
             for i in range(300)}
    with _without_orbax():
        ocdbt.write(str(tmp_path / "s"), items)
        with ocdbt.open(str(tmp_path / "s")) as store:
            assert {k: store[k] for k in store} == items
    assert _ts_items(tmp_path / "s") == items
    with _without_orbax():
        ocdbt.write(str(tmp_path / "empty"), {})
        assert len(ocdbt.open(str(tmp_path / "empty"))) == 0
    assert _ts_items(tmp_path / "empty") == {}


@pytest.mark.parametrize("dtype,fill", [("<f4", 7.5), ("<f8", None), ("<i4", -3), ("<i8", None),
                                        ("|b1", True), ("bfloat16", None)])
@pytest.mark.parametrize("compressor", [{"id": "zstd", "level": 3}, None])
def test_zarr_chunks_and_fill_values(dtype, fill, compressor, tmp_path):
    meta = {"shape": [5, 7], "chunks": [2, 3], "dtype": dtype, "fill_value": fill,
            "compressor": compressor, "order": "C", "filters": None}
    arr = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}"},
                   "path": "a.b", "metadata": meta}, create=True).result()
    rng = np.random.RandomState(3)
    vals = (rng.randn(5, 7) * 100).astype(arr.dtype.numpy_dtype)
    arr[0:4, 0:6] = vals[0:4, 0:6]  # 4 of the 9 chunks; (4, 6) written alone
    arr[4:5, 6:7] = vals[4:5, 6:7]
    want = arr.read().result()
    with _without_orbax(), ocdbt.open(str(tmp_path)) as store:
        assert f"a.b/{'2.0'}".encode() not in store
        got = orbax.read_array(store, "a.b")
    if dtype == "bfloat16":
        got = got.view(torch.int16).numpy()
        want = want.view(np.int16)
    assert got.shape == (5, 7) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- resume and serving
def _resumed(layout, path, mode="resume"):
    tr = _port_trainer(layout)
    with _without_orbax():
        tr.load_checkpoint(path, mode=mode)
    return tr


def _state(tr):
    opt = optimizer_state_dict(tr.opt_state)
    trees = {"params": tr.params, "ema": tr.target_params, "mu": opt["mu"], "nu": opt["nu"]}
    if "acc_grads" in opt:
        trees["acc"] = opt["acc_grads"]
    return trees, (opt["count"], opt.get("mini_step"), tr.iteration, tr.start_epoch,
                   tr.best_acc)


@pytest.mark.parametrize("layout", sorted(F.LAYOUTS))
def test_resume_from_an_orbax_directory_equals_the_msgpack_twin(layout):
    """The committed twins (the next step from a JAX-written directory is
    held to the JAX trainer's in tests/test_torch_checkpoint.py)."""
    for mode in ("pretrain", "test", "resume"):
        a = _resumed(layout, F.orbax_fixture_path(layout), mode)
        b = _resumed(layout, F.fixture_path(layout), mode)
        (ta, ca), (tb, cb) = _state(a), _state(b)
        names = ("params", "ema", "mu", "nu", "acc") if mode == "resume" else ("params", "ema")
        for name in names:
            if name not in tb:
                continue
            assert set(ta[name]) == set(tb[name]), name
            for k in tb[name]:
                assert torch.equal(ta[name][k], tb[name][k]), f"{mode} {name} {k}"
        assert ca == cb
    assert ca[2] == 3 and ca[3] == 1  # the resume's iteration and epoch
    la, lb = (t.train_epoch([F.batch(F.SEED + 10)], 1) for t in (a, b))
    assert la == lb
    for name, tree in _state(a)[0].items():
        for k, v in tree.items():
            assert torch.equal(v, _state(b)[0][name][k]), f"after the step: {name} {k}"


def _both_formats(tmp_path, name, state):
    """``state`` written by the JAX package as a msgpack file and as an
    orbax directory: (file, directory)."""
    path, dir_ = str(tmp_path / f"{name}.pth.tar"), str(tmp_path / f"{name}.orbax")
    jax_save(path, state)
    jax_save_orbax(dir_, state)
    return path, dir_


def test_frozen_vi_encoder_from_an_orbax_directory(tmp_path):
    params = jax_params(JaxVIMLP(video_embed_dim=24), jnp.zeros((1, 8, 24)), seed=5)
    paths = _both_formats(tmp_path, "vi", {"epoch": 0, "state_dict": params, "best_acc": 0.0})
    got = []
    for path in paths:
        model = GroundingModel(vi_encoder_type="mlp", **FIELDS, device="cpu")
        trainer = types.SimpleNamespace(params=dict(model.named_parameters()))
        with _without_orbax(), torch.no_grad():
            assert load_frozen_vi_encoder(trainer, types.SimpleNamespace(vi_encoder_path=path))
        got.append({k: v.detach().clone() for k, v in model.vi_encoder.state_dict().items()})
    want = grounding_state_dict_from_jax(params)
    assert set(got[0]) == set(got[1]) == set(want)
    for k, v in want.items():
        assert torch.equal(got[0][k], v) and torch.equal(got[1][k], v), k


def test_grounding_service_from_an_orbax_directory(tmp_path):
    jm = JaxExo(**SVC, attn_impl="xla")
    params = jax_params(jm, jnp.zeros((1, 16, 24)), jnp.zeros((1, 8, 16)),
                        jnp.zeros((1, 16), bool), jnp.zeros((1, 8), bool), seed=11)
    path, dir_ = _both_formats(tmp_path, "ground", {"epoch": 0, "state_dict": params,
                                                    "best_acc": 0.0})
    reqs = make_grounding_requests(3, 5, video_dim=24, text_dim=16, max_t=16, max_k=11)
    got = {}
    for p in (path, dir_):
        with _without_orbax():
            svc = GroundingService.from_checkpoint(
                p, model=ExoGroundingTransformer(**SVC, device="cpu"), device="cpu",
                seq_len=16, text_bucket=8)
        got[p] = svc.ground_batch(reqs)
    for g, w in zip(got[dir_], got[path]):
        for k in ("start", "end"):
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
    want = JaxService.from_checkpoint(dir_, model=jm, seq_len=16, text_bucket=8).ground_batch(reqs)
    scale = max(np.abs(w[k]).max() for w in want for k in ("start", "end"))
    for g, w in zip(got[dir_], want):
        for k in ("start", "end"):
            assert np.abs(np.asarray(g[k]) - w[k]).max() <= 1e-5 * scale


@pytest.mark.parametrize("kind", ["exo", "grounding"])
def test_chip_smoke_writes_a_grounding_orbax_directory(kind, tmp_path):
    """chip_smoke.py's ``jax_grounding_tree`` (phase 9 serves its orbax
    directory): the JAX model's param tree, keys and shapes; bridged back,
    the model's tensors bit for bit; served, the in-memory model's answers."""
    import chip_smoke

    torch.manual_seed(3)
    if kind == "exo":
        model = ExoGroundingTransformer(**SVC, device="cpu")
        jm = JaxExo(**SVC)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 24)),
                                jnp.zeros((1, 8, 16)), jnp.zeros((1, 16), bool),
                                jnp.zeros((1, 8), bool))["params"]
        tree = chip_smoke.jax_grounding_tree(model)
        assert (jax.tree_util.tree_map(lambda a: a.shape, tree)
                == jax.tree_util.tree_map(lambda s: s.shape, shapes))
    else:
        model = GroundingModel(vi_encoder_type="mlp", **FIELDS, device="cpu")
        tree = chip_smoke.jax_grounding_tree(model)
        assert set(tree) == {"trunk", "vi_encoder"}
    back = grounding_state_dict_from_jax(tree)
    own = {k: v for k, v in model.state_dict().items() if k not in UNUSED_REFERENCE_KEYS}
    assert set(back) == set(own)
    for k, v in back.items():
        assert torch.equal(v, own[k]), k
    path = str(tmp_path / "g.orbax")
    with _without_orbax():
        ckpt.save_state_orbax(path, {"epoch": 0, "state_dict": tree, "best_acc": 0.0})
        fresh = (ExoGroundingTransformer(**SVC, device="cpu") if kind == "exo" else
                 GroundingModel(vi_encoder_type="mlp", **FIELDS, device="cpu"))
        served = GroundingService.from_checkpoint(path, model=fresh, device="cpu", seq_len=16,
                                                  text_bucket=8)
    _same(jax_load_orbax(path)["state_dict"], jax.tree_util.tree_map(np.asarray, tree))
    reqs = make_grounding_requests(2, 4, video_dim=24, text_dim=16, max_t=16, max_k=7)
    want = GroundingService(model, device="cpu", seq_len=16, text_bucket=8).ground_batch(reqs)
    for g, w in zip(served.ground_batch(reqs), want):
        for k in ("start", "end"):
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


def test_chip_smoke_writes_the_jax_trainer_layout_as_an_orbax_directory(tmp_path):
    """chip_smoke.py's ``write_jax_checkpoint(..., "orbax")`` (phase 8
    resumes the command line from its directory at full width): the JAX
    package reads the same tree as from the msgpack file written from the
    same ``jax_checkpoint_tree``, and the port resumes from it to the port
    file's state bit for bit."""
    import chip_smoke

    tr = _resumed("multisteps_k2", F.fixture_path("multisteps_k2"))
    tr.train_epoch([F.batch(F.SEED + 10)], 1)
    tr.cfg.model_path = str(tmp_path)
    tr.save_epoch(0)
    port = str(tmp_path / "epoch0.pth.tar")
    tree = chip_smoke.jax_checkpoint_tree(port)
    path, dir_ = str(tmp_path / "jax.pth.tar"), str(tmp_path / "jax.orbax")
    assert chip_smoke.write_jax_checkpoint(tree, path) == os.path.getsize(path)
    assert chip_smoke.write_jax_checkpoint(tree, dir_, "orbax") == orbax.directory_bytes(dir_)
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = jax_load_orbax(dir_)
    _same(got, want)
    a, b = _resumed("multisteps_k2", dir_), _resumed("multisteps_k2", path)
    (ta, ca), (tb, cb) = _state(a), _state(b)
    assert ca == cb
    for name in tb:
        for k in tb[name]:
            assert torch.equal(ta[name][k], tb[name][k]), f"{name} {k}"


# -------------------------------------------------------------------- errors
def _bad_crc(path):
    leaf = os.path.join(path, "d", os.listdir(os.path.join(path, "d"))[0])
    raw = bytearray(open(leaf, "rb").read())
    raw[20] ^= 0x01
    open(leaf, "wb").write(raw)
    return "CRC-32C mismatch"


def _metadata(field, value):
    def edit(path):
        with open(os.path.join(path, "_METADATA")) as f:
            meta = json.load(f)
        meta[field] = value
        with open(os.path.join(path, "_METADATA"), "w") as f:
            json.dump(meta, f)
        return field
    return edit


def _remove(name):
    def edit(path):
        os.remove(os.path.join(path, name))
        return f"without {name}"
    return edit


BROKEN = {"bad_crc": _bad_crc, "use_zarr3": _metadata("use_zarr3", True),
          "no_ocdbt": _metadata("use_ocdbt", False), "no_metadata": _remove("_METADATA"),
          "no_manifest": _remove("manifest.ocdbt")}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_broken_directories_raise(case, tmp_path):
    path = str(tmp_path / "c")
    shutil.copytree(F.orbax_fixture_path("fused"), path)
    match = BROKEN[case](path)
    with pytest.raises(ValueError, match=match):
        _port_load(path)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="without _METADATA and manifest.ocdbt"):
        ckpt.load_state(str(empty))
