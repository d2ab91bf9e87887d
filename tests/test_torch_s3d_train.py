"""The port's end-to-end S3D finetune around the step: the HTM-AA clip
reader, ``S3DTrainer``, the ``--dataset htm-aa`` command line and the step
over a 2-rank gloo group, against the JAX package on the CPU.

The clip reader's items must equal the JAX reader's bit for bit, grey and
decoded (a stand-in ``ffmpeg`` on PATH writes seeded rgb24 frames, so the
crop draws that follow a decode are exercised). The trainer and the command
line run at small clips (``ClipConfig``'s crop and scale patched) on a
``tools/synth_htm_aa.py`` tree; checkpoints hold the BN stats and resume
bit for bit. The 2-rank step (train_bn, gathered negatives, the fused
optimizer) is held against the JAX step over a 2-device mesh in float64 on
both sides as ``tests/torch_s3d_jax.py::hold_float64_step`` says, and in
float32 against the same as ``hold_train_bn_step`` says.
"""

import functools
import glob
import json
import os
import stat
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from exoground_tpu.data.video_clips import ClipConfig as JaxClipConfig
from exoground_tpu.data.video_clips import HTMClipDataset as JaxClipDataset
from exoground_tpu.models.word2vec import Word2VecTokenizer as JaxTokenizer
from exoground_tpu.utils.convert import convert_s3d_state_dict as jax_convert
from exoground_tpu.utils.convert import convert_sentence_embedding_from_s3d as jax_text
from exoground_tpu_torch.data import video_clips
from exoground_tpu_torch.data.video_clips import ClipConfig, HTMClipDataset
from exoground_tpu_torch.models.s3d import S3D
from exoground_tpu_torch.models.word2vec import Word2VecTokenizer
from exoground_tpu_torch.parallel.mesh import free_port
from exoground_tpu_torch.tools.synth_htm_aa import make_htm_aa_tree
from exoground_tpu_torch.train import ExperimentConfig, S3DTrainer
from exoground_tpu_torch.train import main as cli
from exoground_tpu_torch.train.checkpoint import load_state
from exoground_tpu_torch.train.config import parse_args
from exoground_tpu_torch.utils.convert import convert_sentence_embedding_from_s3d
from tests import torch_s3d_common
from tests.torch_cli_common import in_tmp  # noqa: F401
from tests.torch_s3d_common import (  # noqa: F401 (few_threads: an autouse fixture)
    D,
    clips,
    few_threads,
    port_state,
    reference_states,
    tokens,
)
from tests.torch_s3d_jax import hold_float64_step, hold_train_bn_step, jax_run

PAIRS = [{"vid": f"v{i}", "text": f"w{i} w{i + 3}, \"w2\"", "start": 1.5 * i,
          "end": 1.5 * i + 0.4 + (3.0 if i % 2 else 0.0)} for i in range(5)]
VOCAB = {f"w{i}": i for i in range(1, 12)}


# ------------------------------------------------------------- clip reader
FAKE_FFMPEG = """#!{python} -S
# writes seeded rgb24 frames: (t * fps - 3) of them, each scale x scale
import random
import sys
a = sys.argv
ss, t = float(a[a.index("-ss") + 1]), float(a[a.index("-t") + 1])
vf = a[a.index("-vf") + 1]
fps = int(vf.split("fps=")[1].split(",")[0])
scale = int(vf.split("scale=")[1].split(":")[0])
n = max(1, int(t * fps) - 3)
sys.stdout.buffer.write(random.Random(int(ss * 1000)).randbytes(n * scale * scale * 3))
"""


def _readers(root, dtype, seed=3):
    kw = dict(video_root=str(root), fps=5, num_frames=4, num_clips=2, crop_size=12,
              scale_size=20, token_len=5, seed=seed, clip_dtype=dtype)
    return (JaxClipDataset(JaxClipConfig(**kw), PAIRS, JaxTokenizer(VOCAB)),
            HTMClipDataset(ClipConfig(**kw), PAIRS, Word2VecTokenizer(VOCAB)))


def _items_equal(jds, pds):
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        for i in range(len(PAIRS)):
            a, b = jds[i], pds[i]
            assert sorted(a) == sorted(b) and a["vid"] == b["vid"]
            for k in ("video", "token"):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_clip_items_match_jax_grey(tmp_path, monkeypatch, dtype):
    """No ffmpeg: grey clips (128 in uint8, 0.5 in float32), tokens and the
    per-item draws as the JAX reader's; every clip counted grey."""
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not video_clips.ffmpeg_available()
    jds, pds = _readers(tmp_path, dtype)
    _items_equal(jds, pds)
    assert (pds.decoded, pds.grey) == (0, 2 * 2 * len(PAIRS))
    assert np.all(pds[0]["video"] == (128 if dtype == "uint8" else 0.5))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_clip_items_match_jax_decoded(tmp_path, monkeypatch, dtype):
    """A stand-in ffmpeg (fewer frames than asked: the last repeated): the
    decoded clips, their random crops and jitter equal the JAX reader's bit
    for bit; a video that is missing stays grey and is counted so."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "ffmpeg"
    fake.write_text(FAKE_FFMPEG.format(python=sys.executable))
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    for p in PAIRS[:-1]:  # the last video is missing
        (tmp_path / f"{p['vid']}.mp4").write_bytes(b"")
    jds, pds = _readers(tmp_path, dtype)
    _items_equal(jds, pds)
    assert (pds.decoded, pds.grey) == (2 * 2 * (len(PAIRS) - 1), 2 * 2)
    first = pds[0]["video"]
    assert first.shape == (2, 4, 12, 12, 3) and np.array_equal(first[0, -1], first[0, -2])


# ------------------------------------------------------------ the 2 ranks
def test_s3d_step_two_ranks_matches_jax_mesh(tmp_path):
    """train_bn, freeze_early, gathered negatives, the fused optimizer
    (backbone LR): each of 2 gloo ranks steps on its 4 clips (each
    normalizing with its own batch moments, the stats averaged), in float64
    and in float32 from the same state; the ranks agree bit for bit. Rank 0
    is held against the JAX step over a 2-device mesh in float64 on both
    sides (weights, clips, stats, compute, the loss) as
    ``tests/torch_s3d_jax.py::hold_float64_step`` says, and its float32 run
    against the same as ``hold_train_bn_step`` says (the rounding check)."""
    trunk, text = reference_states()
    batch = {"video": clips(11, (8, 1, 4, 48, 48, 3), np.float32).astype(np.float64),
             "token": tokens(11, 8)}
    dtypes = ("float64", "float32")
    mp.start_processes(torch_s3d_common.rank_step, nprocs=2, start_method="spawn",
                       args=(2, free_port(), batch, True, str(tmp_path), dtypes))
    runs = {dt: [torch.load(tmp_path / f"rank{r}_{dt}.pt", weights_only=False)
                 for r in range(2)] for dt in dtypes}
    for ranks in runs.values():
        for name in ("params", "mu", "stats"):
            for k, v in ranks[0][name].items():
                assert torch.equal(v, ranks[1][name][k]), (name, k)
        assert ranks[0]["metrics"] == ranks[1]["metrics"]
    want = jax_run(jax_convert(trunk), jax_text(text), batch, fused=True, train_bn=True,
                   world=2, gather=True, x64=True)
    r = runs["float64"][0]
    hold_float64_step(r["metrics"], r["params"], r["mu"], r["stats"], want)
    r = runs["float32"][0]
    assert all(v.dtype == torch.float32 for v in r["stats"].values())
    hold_train_bn_step(r["metrics"], r["mu"], r["stats"], want)


# --------------------------------------------------------------- trainer
def _cfg(tmp_path, **kw):
    return ExperimentConfig(dataset="htm-aa", model="s3d", lr=1e-3, epochs=1,
                            model_path=str(tmp_path), **kw)


def _loader(n=2, b=2):
    return [{"video": clips(20 + i, (b, 1, 4, 32, 32, 3)), "token": tokens(20 + i, b)}
            for i in range(n)]


def _trainer(cfg):
    model, _, _ = port_state()
    _, text = reference_states()
    return S3DTrainer(model, cfg, convert_sentence_embedding_from_s3d(text), iters_per_epoch=2,
                      device="cpu")


@pytest.mark.parametrize("freeze_bn", [False, True])
def test_s3d_trainer_epoch_checkpoints_batch_stats(tmp_path, freeze_bn):
    """One epoch of ``fit``: the checkpoint holds the BN stats (moved by
    train_bn, as they were under --freezeBN), best is the lowest loss, and
    ``--resume`` restores parameters, stats, moments and counts bit for bit;
    ``load_backbone`` is non-strict (an ``fc`` the state lacks keeps its
    value)."""
    tr = _trainer(_cfg(tmp_path, freezeBN=freeze_bn, lr_backbone=1e-4))
    before = {k: v.clone() for k, v in tr.batch_stats.items()}
    fc = tr.params["s3d.fc.weight"].clone()
    state = {"params": {k[4:]: v.clone() + 1 for k, v in tr.params.items()
                        if k.startswith("s3d.") and not k.startswith("s3d.fc.")},
             "batch_stats": {k: v.clone() for k, v in before.items()}}
    tr.load_backbone(state)
    assert torch.equal(tr.params["s3d.fc.weight"], fc)
    assert torch.equal(tr.params["s3d.conv1.conv1.weight"], state["params"]["conv1.conv1.weight"])
    assert tr.model.conv1.conv1.weight.data_ptr() == tr.params["s3d.conv1.conv1.weight"].data_ptr()
    tr.load_backbone({"params": {k[4:]: v - 1 for k, v in tr.params.items()
                                 if k.startswith("s3d.") and not k.startswith("s3d.fc.")},
                      "batch_stats": before})
    last = tr.fit(_loader())
    assert np.isfinite(last) and tr.best_acc == last and tr.iteration == 2
    blob = load_state(str(tmp_path / "epoch0.pth.tar"))
    assert sorted(blob["batch_stats"]) == sorted(before)
    moved = any(not torch.equal(blob["batch_stats"][k], before[k]) for k in before)
    assert moved != freeze_bn
    resumed = _trainer(_cfg(tmp_path, freezeBN=freeze_bn, lr_backbone=1e-4))
    resumed.load_checkpoint(str(tmp_path / "epoch0.pth.tar"), mode="resume")
    assert (resumed.iteration, resumed.start_epoch, resumed.best_acc) == (2, 1, last)
    assert resumed.opt_state.count == tr.opt_state.count == 2
    for name in ("params", "batch_stats"):
        for k, v in getattr(tr, name).items():
            assert torch.equal(getattr(resumed, name)[k], v), (name, k)
    for k, v in tr.opt_state.mu.items():
        assert torch.equal(resumed.opt_state.mu[k], v) and torch.equal(
            resumed.opt_state.nu[k], tr.opt_state.nu[k]), k


# ----------------------------------------------------------- command line
SMALL_CLIPS = dict(crop_size=32, scale_size=40)


def _small_clips(monkeypatch):
    monkeypatch.setattr(video_clips, "ClipConfig", functools.partial(ClipConfig, **SMALL_CLIPS))


ARGV = ["--dataset", "htm-aa", "--model", "s3d", "--freezeBN", "--batch_size", "4",
        "--num_frames", "4", "--fps", "5", "--epochs", "1", "--num_workers", "2",
        "--lr_backbone", "1e-5"]


def test_main_htm_aa_trains_and_resumes(in_tmp, monkeypatch, capsys):  # noqa: F811
    """``main --dataset htm-aa --model s3d`` on a synthetic tree: the clip
    windows are the JAX command line's, the run prints its grey / decoded
    counts, its checkpoint holds the BN stats, and ``--resume`` restores the
    state bit for bit before a second epoch; ``--convert_from_frozen_bn``
    reads a FrozenBN file (``.scale``) as the same weights."""
    _small_clips(monkeypatch)
    root = make_htm_aa_tree(str(in_tmp / "tree"), n_videos=10, rows_per_video=3, embed_dim=16,
                            hidden=32, out_dim=D, videos=False)
    built, loaded = [], []
    real_build, real_load = cli.build_htm_e2e, S3DTrainer.load_checkpoint

    def build_spy(cfg, device, mesh=None):
        run = real_build(cfg, device, mesh)
        built.append(run)
        return run

    def load_spy(self, path, mode="resume"):
        real_load(self, path, mode)
        loaded.append((path, {k: v.clone() for k, v in self.params.items()},
                       {k: v.clone() for k, v in self.batch_stats.items()},
                       {k: v.clone() for k, v in self.opt_state.mu.items()}))

    monkeypatch.setattr(cli, "build_htm_e2e", build_spy)
    monkeypatch.setattr(S3DTrainer, "load_checkpoint", load_spy)
    cfg = parse_args(ARGV + ["--data_root", root])
    pairs = cli.htm_aa_pairs(cfg)
    assert pairs == _jax_pairs(cfg)
    vlen = {r.split(",")[0]: int(r.split(",")[1]) for r in
            open(os.path.join(root, "htm_vlen.csv")).read().split()[1:]}
    assert pairs and all(64 < vlen[p["vid"]] < 2000 for p in pairs)
    assert len({p["vid"] for p in pairs}) < len(vlen)  # the filter dropped some

    last = cli.main(ARGV + ["--data_root", root, "--prefix", "_a"], device="cpu")
    out = capsys.readouterr().out
    clips_line = json.loads(out.split("clips ", 1)[1].splitlines()[0])
    steps = len(pairs) // 4
    assert clips_line["ffmpeg"] is False and clips_line["decoded"] == 0
    assert clips_line["grey"] == steps * 4 and clips_line["reader_ms_a_batch"] > 0
    assert built[-1].dataset[0]["video"].shape == (1, 4, 32, 32, 3)
    assert np.isfinite(last)
    (ckpt,) = glob.glob(str(in_tmp / "log_a" / "*" / "model" / "epoch0.pth.tar"))
    blob = load_state(ckpt)
    tr = built[-1].trainer
    assert sorted(blob["batch_stats"]) == sorted(tr.batch_stats) and blob["iteration"] == steps
    assert tr.tx._groups and any(s for *_, s in tr.tx._groups)  # the backbone LR group

    cli.main(ARGV + ["--data_root", root, "--prefix", "_b", "--epochs", "2", "--resume", ckpt],
             device="cpu")
    path, params, stats, mu = loaded[-1]
    assert path == ckpt
    for name, got in (("state_dict", params), ("batch_stats", stats)):
        for k, v in blob[name].items():
            assert torch.equal(got[k], v), (name, k)
    for k, v in blob["optimizer"]["mu"].items():
        assert torch.equal(mu[k], v), k
    resumed = built[-1].trainer
    assert [s["epoch"] for s in resumed.epoch_stats] == [1] and resumed.iteration == 2 * steps

    # a FrozenBN checkpoint: '.scale' in place of the BN weights
    state = torch.load(os.path.join(root, "s3d_howto100m.pth"), weights_only=True)
    frozen = {(k[:-len("weight")] + "scale" if ".bn" in k and k.endswith(".weight") else k): v
              for k, v in state.items()}
    torch.save(frozen, os.path.join(root, "s3d_howto100m.pth"))
    cli.main(ARGV + ["--data_root", root, "--prefix", "_c", "--epochs", "0",
                     "--convert_from_frozen_bn"], device="cpu")
    loaded_bn = built[-1].trainer.params["s3d.mixed_4b.conv_b0.bn1.weight"]
    assert torch.equal(loaded_bn, state["mixed_4b.conv_b0.bn1.weight"])


def _jax_pairs(cfg):
    """The clip windows the JAX ``run_htm_e2e`` builds (pandas, its own
    filter), taken from the reader it constructs: the JAX trainer is stopped
    before it initializes the model."""
    from exoground_tpu.data import video_clips as jvc
    from exoground_tpu.train import main as jax_main
    from exoground_tpu.train import trainer as jax_trainer

    seen = []

    class Stop(Exception):
        pass

    class Spy(jvc.HTMClipDataset):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)

    def stop(*a, **k):
        raise Stop

    mp_ = pytest.MonkeyPatch()
    mp_.setattr(jvc, "HTMClipDataset", Spy)
    mp_.setattr(jvc, "ClipConfig", functools.partial(jvc.ClipConfig, **SMALL_CLIPS))
    mp_.setattr(jax_trainer, "S3DTrainer", stop)
    try:
        with pytest.raises(Stop):
            jax_main.run_htm_e2e(cfg)
    finally:
        mp_.undo()
    return seen[0].pairs
