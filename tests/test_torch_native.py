"""The port's native feature reader and the deferred HTM batches, against
the JAX package, on the CPU.

* ``utils/native.py::gather_windows`` (the port's own build of
  ``csrc/exoground_io.cpp``) against the JAX package's ``gather_windows``
  and the port's numpy plain version: windows inside a file, past its end
  and empty, 1-D and (T, 1, C) files, float16 files, truncated and missing
  files (which raise). Every comparison is exact: the same rows are copied.
* ``FeatureStore.read_windows`` (npy and memory backends) against the JAX
  store's, and ``FeatureStore.length`` through the header against
  ``np.load``'s.
* ``HTMFeatureDataset(defer_video_io=True)`` batches against the port's
  per-item reads and the JAX package's deferred batches; the feature width
  probed once; a reader that does not build raises.
* The port never names the JAX package's checked-in library.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest

from exoground_tpu.data.htm import HTMConfig as JaxHTMConfig
from exoground_tpu.data.htm import HTMFeatureDataset as JaxHTMFeatureDataset
from exoground_tpu.data.io import FeatureStore as JaxFeatureStore
from exoground_tpu.utils import native as jax_native
from exoground_tpu_torch.data import HTMConfig, HTMFeatureDataset
from exoground_tpu_torch.data.io import FeatureStore
from exoground_tpu_torch.utils import native

PORT = Path(__file__).resolve().parent.parent / "exoground_tpu_torch"


class _Tok:
    """Word ids from a fixed vocabulary (as the JAX data tests' tokenizer)."""

    def __call__(self, text):
        ids = [1 + (sum(map(ord, w)) % 50) for w in str(text).split()][:16]
        return {"input_ids": np.asarray(ids or [0], np.int32)}


def _save(tmp_path, name, arr):
    p = str(tmp_path / name)
    np.save(p, arr)
    return p


@pytest.fixture
def files(tmp_path):
    rng = np.random.RandomState(0)
    return [_save(tmp_path, f"w{i}.npy", rng.randn(40 + 30 * i, 16).astype(np.float32))
            for i in range(4)]


# (starts, ends): inside, past the end (clamped), entirely past the end
# (empty), longer than the bucket, a negative start (clamped to 0)
WINDOWS = {
    "inside": ([3, 10, 0, 50], [35, 42, 32, 82]),
    "past_end": ([30, 60, 90, 120], [62, 92, 122, 152]),
    "empty": ([45, 200, 5, 0], [77, 232, 5, 0]),
    "long_and_negative": ([-4, 0, 7, 2], [60, 100, 100, 20]),
}


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_gather_windows_matches_jax_and_plain(files, case):
    starts, ends = (np.asarray(a) for a in WINDOWS[case])
    got = native.gather_windows(files, starts, ends, 32, 16)
    for want in (jax_native.gather_windows(files, starts, ends, 32, 16),
                 native.gather_windows_plain(files, starts, ends, 32, 16)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.float32 and got[1].dtype == bool


def test_gather_windows_one_d_and_float16(tmp_path):
    p1 = _save(tmp_path, "one_d.npy", np.arange(7, dtype=np.float32))
    p2 = _save(tmp_path, "half.npy",
               np.random.RandomState(1).randn(20, 1).astype(np.float16))
    assert native.npy_shape(p1) == jax_native.npy_shape(p1) == (7, 1)
    args = ([p1, p2], np.asarray([0, 3]), np.asarray([7, 19]), 8, 1)
    got = native.gather_windows(*args)
    for want in (jax_native.gather_windows(*args), native.gather_windows_plain(*args)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert got[0][0, :7, 0].tolist() == list(range(7)) and got[1][0, 7]


@pytest.mark.parametrize("bad", ["three_d", "truncated", "missing", "other_width"])
def test_gather_windows_raises_on_unreadable_files(tmp_path, files, bad):
    p = str(tmp_path / f"{bad}.npy")
    if bad == "three_d":  # (T, 1, C): the native parser reads 1-D and 2-D only
        np.save(p, np.zeros((10, 1, 16), np.float32))
    elif bad == "truncated":  # a valid header that claims more rows than the file holds
        np.save(p, np.ones((100, 16), np.float32))
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) - 2000)
    elif bad == "other_width":
        np.save(p, np.ones((10, 8), np.float32))
    args = ([files[0], p], np.asarray([0, 0]), np.asarray([8, 8]), 8, 16)
    for gather in (native.gather_windows, jax_native.gather_windows,
                   native.gather_windows_plain):
        with pytest.raises((IOError, ValueError)):
            gather(*args)
    assert native.npy_shape(p) == jax_native.npy_shape(p) or bad == "other_width"


def test_empty_files_read_as_empty_windows(tmp_path):
    p = _save(tmp_path, "empty.npy", np.zeros((0, 16), np.float32))
    assert native.npy_shape(p) == (0, 16)
    assert native.npy_shape(_save(tmp_path, "cols.npy", np.zeros((5, 0), np.float32))) == (5, 0)
    v, m = native.gather_windows([p], np.asarray([0]), np.asarray([4]), 4, 16)
    assert m.all() and not v.any()


def test_unbuildable_source_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.library(bad)
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        HTMFeatureDataset(HTMConfig(video_feature_root=str(tmp_path)), _Tok(), asr={"v": {
            "text": ["a"], "start": [0.0], "end": [1.0]}}, defer_video_io=True)


@pytest.mark.parametrize("backend", ["npy", "mem"])
def test_read_windows_matches_jax_store(tmp_path, files, backend):
    vids = [Path(p).stem for p in files]
    if backend == "npy":
        port, jax_store = FeatureStore(str(tmp_path)), JaxFeatureStore(str(tmp_path))
    else:
        mem = {v: np.load(p) for v, p in zip(vids, files)}
        port, jax_store = FeatureStore(mem=mem), JaxFeatureStore(mem=mem)
    starts, ends = [5, 90, 0, 60], [37, 122, 32, 92]
    got = port.read_windows(vids, starts, ends, 32, 16)
    want = jax_store.read_windows(vids, starts, ends, 32, 16)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for i, v in enumerate(vids):  # each row as its per-item read, padded by its last row
        rows = port.read(v, starts[i], ends[i])[:32]
        np.testing.assert_array_equal(got[0][i, :len(rows)], rows)
        assert not got[1][i, :len(rows)].any() and got[1][i, len(rows):].all()


def test_length_reads_the_header_once(tmp_path, files, monkeypatch):
    three_d = _save(tmp_path, "n.npy", np.zeros((12, 1, 16), np.float32))
    one_d = _save(tmp_path, "o.npy", np.zeros(9, np.float32))
    store = FeatureStore(str(tmp_path))
    for p in files + [three_d, one_d]:
        vid = Path(p).stem
        assert store.length(vid) == np.load(p, mmap_mode="r").shape[0]
        assert store.length(vid) == JaxFeatureStore(str(tmp_path)).length(vid)
    monkeypatch.setattr(native, "npy_shape", lambda p: pytest.fail("read twice"))
    monkeypatch.setattr(np, "load", lambda *a, **k: pytest.fail("read twice"))
    assert store.length("w1") == 70  # remembered


def _htm_tree(tmp_path, n=8):
    rng = np.random.RandomState(0)
    asr = {}
    for i in range(n):
        vid = f"d{i}"
        np.save(str(tmp_path / f"{vid}.mp4.npy"),
                rng.randn(int(rng.randint(100, 160)), 16).astype(np.float32))
        starts = np.sort(rng.rand(8) * 110).tolist()
        asr[vid] = {"text": [f"step {j} of {vid}" for j in range(8)], "start": starts,
                    "end": [s + 4 for s in starts]}
    return asr


@pytest.mark.parametrize("epoch", [0, 1])
def test_deferred_batches_match_per_item_reads_and_jax(tmp_path, epoch):
    asr = _htm_tree(tmp_path)
    kw = dict(duration=32, text_bucket=8, video_feature_root=str(tmp_path))
    port = {d: HTMFeatureDataset(HTMConfig(**kw), _Tok(), mode="train", asr=asr,
                                 defer_video_io=d) for d in (False, True)}
    jax_ds = JaxHTMFeatureDataset(JaxHTMConfig(**kw), _Tok(), mode="train", asr=asr,
                                  defer_video_io=True)
    for ds in (*port.values(), jax_ds):
        ds.set_epoch(epoch)
    idx = list(range(len(jax_ds)))
    eager = port[False].collate_fn([port[False][i] for i in idx])
    lazy = port[True].collate_fn([port[True][i] for i in idx])
    want = jax_ds.collate_fn([jax_ds[i] for i in idx])
    assert set(lazy) == set(eager) == set(want)
    for k in want:
        for other in (eager, want):
            if isinstance(want[k], np.ndarray):
                np.testing.assert_array_equal(lazy[k], other[k], err_msg=k)
            else:
                assert lazy[k] == other[k], k


def test_deferred_collate_probes_the_width_once(tmp_path, monkeypatch):
    asr = _htm_tree(tmp_path, n=4)
    ds = HTMFeatureDataset(HTMConfig(duration=32, text_bucket=8,
                                     video_feature_root=str(tmp_path)), _Tok(), asr=asr,
                           defer_video_io=True)
    items = [ds[i] for i in range(len(ds))]
    assert all(isinstance(it["_video"], tuple) for it in items)
    reads = []
    real = ds.store.read
    monkeypatch.setattr(ds.store, "read", lambda *a: reads.append(a) or real(*a))
    ds.collate_fn(items)
    ds.collate_fn(items)
    assert len(reads) == 1 and reads[0][1:] == (0, 1)


def test_the_port_never_names_the_jax_library():
    """The port builds its own reader; the JAX package's checked-in
    ``csrc/libexoground_io.so`` (and its build script) stay the JAX
    package's."""
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert "libexoground_io" not in node.value, path
                assert "build.sh" not in node.value, path
    assert native.SOURCE.parent == PORT / "csrc"
    assert native.BUILD_DIR.name == "native" and native.BUILD_DIR.parent.name == "build"
