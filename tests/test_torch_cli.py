"""TAN training through the port's command line, against the JAX package.

* The train step on token batches (the word2vec tower inside the step)
  against the JAX step with ``text_tower_params``, 1 and 3 cotrain steps, at
  tests/test_torch_train.py's tolerances: metrics 1e-4 relative, first
  moments 1e-4 of their largest entry, parameters and EMA twin 2e-6
  absolute (Adam eps 1e-3, as there).
* The eval step against the JAX ``make_tan_eval_step``, init and cotrain:
  every scalar 1e-4 relative (1e-6 absolute), ``_rows`` equal.
* The aligner with 32-d video and 512-d text against the JAX model on the
  same weights: features within 1e-5 of max|JAX|.
* Checkpoints: resume restores everything bit for bit; pretrain and test
  load parameters only, non-strictly; writes are atomic.
* ``parse_args`` field for field against the JAX ``parse_args``.
* ``main(..., device="cpu")`` on a seeded tree (1 + 1 layers, seq 32, B 8,
  2 epochs), ``--resume`` and ``--test``; ``--fused_steps 2`` against
  ``--fused_steps 1``; the routes of later slices raise.
"""

import dataclasses
import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.losses.milnce import TANLossConfig as JaxLossConfig
from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.models import ema_init as jax_ema_init
from exoground_tpu.parallel import make_mesh, replicate, shard_batch
from exoground_tpu.parallel import make_tan_train_step as jax_make_step
from exoground_tpu.parallel.train_step import make_tan_eval_step as jax_make_eval
from exoground_tpu.train.config import parse_args as jax_parse_args
from exoground_tpu.train.optim import FusedAdamWEMA as JaxFusedAdamWEMA
from exoground_tpu.utils.convert import convert_word2vec_from_s3d as jax_convert_tower
from exoground_tpu_torch.losses.milnce import TANLossConfig
from exoground_tpu_torch.models import TemporalAligner, ema_init
from exoground_tpu_torch.parallel import make_tan_eval_step, make_tan_train_step
from exoground_tpu_torch.tools.synth_htm import make_htm_tree
from exoground_tpu_torch.train import ExperimentConfig, FusedAdamWEMA, TANTrainer
from exoground_tpu_torch.train import checkpoint as ckpt
from exoground_tpu_torch.train import main as main_mod
from exoground_tpu_torch.train.config import parse_args
from exoground_tpu_torch.utils.convert import (
    UNUSED_REFERENCE_KEYS,
    convert_word2vec_from_s3d,
    load_tan_params,
    tan_state_dict_from_jax,
)

SMALL = dict(num_encoder_layers=2, num_joint_layers=2, width=128, heads=4, max_pos=256,
             use_alignability_head=1, random_pos_start=0)
VDIM, TDIM, VOCAB = 48, 32, 41
LOSS = dict(model="cotrain", learn_agreement=True, temporal_agreement_type="keep",
            loss_threshold=0.5, use_alignability_head=True)
INIT_LOSS = dict(model="init", loss_threshold=0.5, use_alignability_head=True)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _numpy_params(model, seed, vdim=VDIM, tdim=TDIM):
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, vdim)), jnp.zeros((1, 2, tdim)),
        jnp.zeros((1, 8), bool), jnp.zeros((1, 2), bool))
    rng = np.random.RandomState(seed)

    def draw(path, sd):
        name = jax.tree_util.keystr(path)
        a = rng.standard_normal(sd.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.05 * a
        return a * (0.02 if len(sd.shape) == 1 or "pos_embed" in name
                    else sd.shape[0] ** -0.5)

    return jax.tree_util.tree_map_with_path(draw, shapes)["params"]


def _tower_state(seed=0, emb=24, hid=48):
    r = np.random.RandomState(seed)
    return {"text_module.word_embd.weight": r.randn(VOCAB, emb).astype(np.float32),
            "text_module.fc1.weight": (r.randn(hid, emb) * emb ** -0.5).astype(np.float32),
            "text_module.fc1.bias": (r.randn(hid) * 0.1).astype(np.float32),
            "text_module.fc2.weight": (r.randn(TDIM, hid) * hid ** -0.5).astype(np.float32),
            "text_module.fc2.bias": (r.randn(TDIM) * 0.1).astype(np.float32)}


def _token_batch(seed, b=4, t=16, n=5, l=7):
    rng = np.random.RandomState(seed)
    start = rng.randint(0, t - 4, (b, n)).astype(np.float32)
    end = start + rng.randint(2, 5, (b, n))
    tp = np.zeros((b, n), bool)
    tp[0, -1] = True
    start[tp], end[tp] = 1e4, -1e4
    vp = np.zeros((b, t), bool)
    vp[1, -3:] = True
    token = rng.randint(0, VOCAB, (b, n, l)).astype(np.int32)
    token[:, :, -2:] = 0  # pad ids
    token[2, 1] = 0  # an all-stop-word sentence
    token[tp] = 0
    return {"video": rng.randn(b, t, VDIM).astype(np.float32), "token": token,
            "video_padding_mask": vp, "text_padding_mask": tp, "start": start, "end": end,
            "abs_text_pos": np.stack([start / t, end / t], -1).astype(np.float32)}


def _jax_tower(state):
    # as the JAX Word2VecModel holds them: device arrays
    return jax.tree_util.tree_map(jnp.asarray, jax_convert_tower(state))


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -------------------------------------------------------- the train step
@pytest.fixture(scope="module")
def token_steps():
    """The JAX step and the port's on token batches, 3 steps from the same
    weights; metrics, parameters, EMA twin and first moments after 1 and 3."""
    jm = JaxAligner(**SMALL, attn_impl="xla")
    jparams = _numpy_params(jm, 0)
    state = _tower_state()
    opt_kw = dict(lr=1e-3, weight_decay=1e-2, total_iterations=20, warmup_iterations=0)
    mesh = make_mesh(1)
    jtx = JaxFusedAdamWEMA(jparams, eps=1e-3, **opt_kw)
    jstep = jax_make_step(jm, JaxLossConfig(**LOSS), jtx, mesh, ema_momentum=0.9,
                          text_tower_params=_jax_tower(state))
    jp = replicate(jax.tree_util.tree_map(jnp.copy, jparams), mesh)
    jt = replicate(jax_ema_init(jparams), mesh)
    jo = replicate(jtx.init(jparams), mesh)

    tm = TemporalAligner(**SMALL, video_dim=VDIM, text_dim=TDIM, device="cpu")
    load_tan_params(tm, {"params": jparams})
    p = {k: v.detach() for k, v in tm.named_parameters()}
    tx = FusedAdamWEMA(p, eps=1e-3, **opt_kw)
    step = make_tan_train_step(tm, TANLossConfig(**LOSS), tx, ema_momentum=0.9,
                               text_tower_params=convert_word2vec_from_s3d(state))
    t, o = ema_init(p), tx.init(p)
    record = {}
    for i in range(3):
        b = _token_batch(10 + i)
        jp, jt, jo, jmet = jstep(jp, jt, jo, shard_batch(b, mesh), jax.random.PRNGKey(i))
        p, t, o, met = step(p, t, o, _torch(b), torch.Generator().manual_seed(i))
        if i in (0, 2):
            record[i + 1] = (
                ({k: float(v) for k, v in jmet.items()},
                 tan_state_dict_from_jax({"params": jax.device_get(jp)}),
                 tan_state_dict_from_jax({"params": jax.device_get(jt)}),
                 tan_state_dict_from_jax({"params": jax.device_get(jo.mu)})),
                ({k: float(v) for k, v in met.items()}, {k: v.clone() for k, v in p.items()},
                 {k: v.clone() for k, v in t.items()}, {k: v.clone() for k, v in o.mu.items()}))
    return record


@pytest.mark.parametrize("n_steps", [1, 3])
def test_token_train_step_matches_jax(token_steps, n_steps):
    (jmet, jp, jt, jmu), (met, p, t, mu) = token_steps[n_steps]
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(met[k], jmet[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert set(jp) == set(p) - set(UNUSED_REFERENCE_KEYS)
    for k, want in jmu.items():
        scale = max(want.abs().max().item(), 1e-12)
        np.testing.assert_allclose(mu[k].numpy(), want.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=f"first moment {k}")
    for name, want, got in (("params", jp, p), ("ema", jt, t)):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=2e-6,
                                       err_msg=f"{name} {k}")


def test_token_batch_equals_its_embedded_text_batch():
    """A token batch trains exactly as the batch of its tower embeddings."""
    from exoground_tpu_torch.models.word2vec import word2vec_forward

    tm = TemporalAligner(**SMALL, video_dim=VDIM, text_dim=TDIM, device="cpu")
    tower = convert_word2vec_from_s3d(_tower_state(1))
    p = {k: v.detach() for k, v in tm.named_parameters()}
    step = make_tan_train_step(tm, TANLossConfig(**LOSS), FusedAdamWEMA(p),
                               ema_momentum=0.9, text_tower_params=tower)
    b = _torch(_token_batch(3))
    tok = b["token"].reshape(-1, b["token"].shape[-1])
    text = word2vec_forward(tower, tok, tok != 0)["pooler_output"].reshape(4, 5, TDIM)
    b_text = {k: v for k, v in b.items() if k != "token"} | {"text": text}
    m_tok, g_tok = step.loss_and_grads(p, p, b)
    m_txt, g_txt = step.loss_and_grads(p, p, b_text)
    for k in m_tok:
        assert torch.equal(m_tok[k], m_txt[k]), k
    for k, g in g_tok.items():
        assert (g is None and g_txt[k] is None) or torch.equal(g, g_txt[k]), k
    with pytest.raises(ValueError, match="text_tower_params"):
        make_tan_train_step(tm, TANLossConfig(**LOSS), FusedAdamWEMA(p)).loss_and_grads(p, p, b)


# --------------------------------------------------------- the eval step
@pytest.mark.parametrize("loss", ["init", "cotrain"])
def test_eval_step_matches_jax(loss):
    lcfg = INIT_LOSS if loss == "init" else LOSS
    cotrain = loss == "cotrain"
    jm = JaxAligner(**SMALL, attn_impl="xla")
    jparams, jtarget = _numpy_params(jm, 4), _numpy_params(jm, 5)
    state = _tower_state(2)
    mesh = make_mesh(1)
    jstep = jax_make_eval(jm, JaxLossConfig(**lcfg), mesh, is_cotrain=cotrain,
                          text_tower_params=_jax_tower(state))
    b = _token_batch(20)
    want = jstep(replicate(jparams, mesh), replicate(jtarget, mesh), shard_batch(b, mesh))

    tm = TemporalAligner(**SMALL, video_dim=VDIM, text_dim=TDIM, device="cpu")
    load_tan_params(tm, {"params": jparams})
    p = {k: v.detach() for k, v in tm.named_parameters()}
    target = {k: v.clone() for k, v in p.items()}
    target.update(tan_state_dict_from_jax({"params": jtarget}))
    step = make_tan_eval_step(tm, TANLossConfig(**lcfg), is_cotrain=cotrain,
                              text_tower_params=convert_word2vec_from_s3d(state))
    got = step(p, target, _torch(b))
    assert set(got) == set(want)
    assert float(got["_rows"]) == float(want["_rows"]) == 4.0
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert not tm.training  # eval mode


def test_aligner_with_video_and_text_widths_apart_matches_jax():
    """32-d video against 512-d word2vec text, as the JAX command line trains
    (its Dense layers take each input's width from the input)."""
    cfg = dict(num_encoder_layers=1, num_joint_layers=1, width=128, heads=4, max_pos=64,
               random_pos_start=0)
    jm = JaxAligner(**cfg, attn_impl="xla")
    jparams = _numpy_params(jm, 6, vdim=32, tdim=512)
    tm = TemporalAligner(**cfg, video_dim=32, text_dim=512, device="cpu")
    load_tan_params(tm, {"params": jparams})
    assert tm.video_pre_proj.weight.shape == (128, 32)
    assert tm.text_pre_proj.weight.shape == (128, 512)
    r = np.random.RandomState(7)
    video, text = r.randn(2, 12, 32).astype(np.float32), r.randn(2, 4, 512).astype(np.float32)
    vp, tp = np.zeros((2, 12), bool), np.zeros((2, 4), bool)
    vp[1, -2:], tp[0, -1] = True, True
    want = jm.apply({"params": jparams}, video, text, vp, tp, deterministic=True)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (video, text, vp, tp)), deterministic=True)
    for k in ("dual_feature_video", "dual_feature_text", "joint_feature_video",
              "joint_feature_text", "logits_dual", "logits_joint"):
        assert _rel(got[k].numpy(), want[k]) <= 1e-5, k
    # one width for both stays the default
    assert TemporalAligner(**cfg, input_dim=24, device="cpu").text_pre_proj.weight.shape == (128, 24)


# ---------------------------------------------------------- checkpoints
def _trainer(tmp_path, seed, model="cotrain", **kw):
    torch.manual_seed(seed)
    tm = TemporalAligner(**SMALL, video_dim=VDIM, text_dim=TDIM, device="cpu")
    cfg = ExperimentConfig(model=model, lr=1e-3, momentum_m=0.9, epochs=2,
                           model_path=str(tmp_path), seed=seed, **kw)
    return TANTrainer(tm, cfg, iters_per_epoch=4, device="cpu",
                      text_tower=convert_word2vec_from_s3d(_tower_state()))


def _train(tr, n=2):
    for i in range(n):
        tr.train_step(tr.to_device(tr.prepare_batch(_token_batch(30 + i))))


def test_checkpoint_resume_restores_exactly(tmp_path):
    a = _trainer(tmp_path, 0)
    _train(a)
    a.best_acc = 0.375
    a.save_epoch(0, is_best=True, keep_all=True)
    path = tmp_path / "epoch0.pth.tar"
    blob = torch.load(path, weights_only=True)  # plain tensors and numbers only
    assert set(blob) == {"epoch", "state_dict", "target_state_dict", "optimizer",
                         "iteration", "best_acc"}
    assert all(v.device.type == "cpu" for v in blob["state_dict"].values())
    b = _trainer(tmp_path, 1)
    assert not torch.equal(b.params["text_pre_proj.weight"], a.params["text_pre_proj.weight"])
    b.load_checkpoint(str(path), mode="resume")
    for name, x, y in (("params", a.params, b.params), ("ema", a.target_params, b.target_params),
                       ("mu", a.opt_state.mu, b.opt_state.mu),
                       ("nu", a.opt_state.nu, b.opt_state.nu)):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), f"{name} {k}"
    assert b.opt_state.count == a.opt_state.count == 2
    assert (b.iteration, b.start_epoch, b.best_acc) == (2, 1, 0.375)
    # the module itself holds the restored weights (shared storage)
    assert torch.equal(b.model.text_pre_proj.weight, a.params["text_pre_proj.weight"])
    assert os.path.exists(tmp_path / "model_best_epoch0.pth.tar")


@pytest.mark.parametrize("mode", ["pretrain", "test"])
def test_checkpoint_pretrain_and_test_load_parameters_only(tmp_path, mode):
    a = _trainer(tmp_path, 0)
    _train(a)
    state = {k: v.clone() for k, v in a.params.items() if k != "ln_text_init.weight"}
    state["extra.weight"] = torch.zeros(3)
    ckpt.save_state(str(tmp_path / "p.pth.tar"),
                    {"epoch": 5, "state_dict": state, "iteration": 9, "best_acc": 1.0})
    b = _trainer(tmp_path, 1)
    kept = b.params["ln_text_init.weight"].clone()
    b.load_checkpoint(str(tmp_path / "p.pth.tar"), mode=mode)
    for k, v in state.items():
        if k in b.params:
            assert torch.equal(b.params[k], v), k
            assert torch.equal(b.target_params[k], v), k  # the twin from state_dict
    assert torch.equal(b.params["ln_text_init.weight"], kept)  # non-strict
    assert (b.iteration, b.start_epoch, b.best_acc, b.opt_state.count) == (0, 0, -1e5, 0)
    with pytest.raises(ValueError, match="mode"):
        b.load_checkpoint(str(tmp_path / "p.pth.tar"), mode="other")


def test_checkpoint_writes_are_atomic_and_pruned(tmp_path, monkeypatch):
    path = str(tmp_path / "epoch0.pth.tar")
    ckpt.save_state(path, {"epoch": 0, "w": torch.ones(4)})

    def broken(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", broken)
    with pytest.raises(OSError):
        ckpt.save_state(path, {"epoch": 1, "w": torch.zeros(4)})
    monkeypatch.undo()
    assert torch.equal(ckpt.load_state(path)["w"], torch.ones(4))  # the old file is whole
    # epoch files: the previous one pruned unless keep_all; 2 newest bests kept
    for e in range(4):
        ckpt.save_checkpoint({"epoch": e}, is_best=True,
                             filename=str(tmp_path / f"epoch{e}.pth.tar"), keep_all=e < 2)
    names = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "*.pth.tar")))
    assert names == ["epoch0.pth.tar", "epoch3.pth.tar",  # epochs 2, 3 pruned 1, 2
                     "model_best_epoch2.pth.tar", "model_best_epoch3.pth.tar"]
    rt = str(tmp_path / "runtime.pth.tar")
    assert ckpt.latest_runtime_checkpoint(rt) is None
    ckpt.save_runtime_checkpoint({"iteration": 3}, rt)
    assert ckpt.load_state(ckpt.latest_runtime_checkpoint(rt))["iteration"] == 3
    with pytest.raises(ValueError):
        ckpt.save_runtime_checkpoint({}, str(tmp_path / "runtime.pt"))


def test_runtime_save_is_a_threshold(tmp_path):
    tr = _trainer(tmp_path, 0, runtime_save_iter=3)
    tr.iteration = 2
    tr.maybe_save_runtime(0)
    assert ckpt.latest_runtime_checkpoint(str(tmp_path / "runtime.pth.tar")) is None
    tr.iteration = 4  # passed 3 without landing on it
    tr.maybe_save_runtime(0)
    saved = ckpt.latest_runtime_checkpoint(str(tmp_path / "runtime.pth.tar"))
    assert ckpt.load_state(saved)["iteration"] == 4


# ------------------------------------------------------------ parse_args
ARGVS = {
    "defaults": [],
    "htm_cotrain": ["--dataset", "htm-370k", "--model", "cotrain", "--seq_len", "32",
                    "--batch_size", "8", "--eval_freq", "1", "--data_root", "/d"],
    "htm_aa_default_model": ["--dataset", "htm-aa"],
    "lemma_fps": ["--dataset", "lemma", "--model", "joint"],
    "explicit_fps": ["--dataset", "lemma", "--model", "joint", "--fps", "30"],
    "bools_and_tuples": ["--no-use_decoder", "--iou_thresholds", "0.2", "0.4", "--amp",
                         "--attn_impl", "flash", "--no-fused_grid"],
    "equals_form": ["--model=init", "--dataset=htm-fe", "--lr", "3e-4", "--clip_grad", "3.0",
                    "--resume", "log/x/model/epoch3.pth.tar"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_parse_args_matches_jax(case):
    ours, theirs = parse_args(ARGVS[case]), jax_parse_args(ARGVS[case])
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_parse_args_rejects_abbreviations():
    for parse in (parse_args, jax_parse_args):
        with pytest.raises(SystemExit):
            parse(["--dataset", "htm-aa", "--mode", "joint"])


# ------------------------------------------------------------------ main
ARGV = ["--dataset", "htm-370k", "--model", "cotrain", "--seq_len", "32", "--batch_size", "8",
        "--epochs", "2", "--num_workers", "2", "--num_encoder_layers", "1",
        "--num_decoder_layers", "1", "--hidden_dim", "64", "--eval_freq", "1",
        "--print_freq", "100"]


@pytest.fixture(scope="module")
def htm_tree(tmp_path_factory):
    # 40 videos: 2 in the validation split, 38 (4 steps at B 8) to train
    return make_htm_tree(str(tmp_path_factory.mktemp("htm")), n_videos=40)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # set_path writes log<prefix>/ under the cwd
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the JSONL log
    return tmp_path


def _spy_fit(monkeypatch):
    seen = []
    real = TANTrainer.fit

    def fit(self, *a, **k):
        seen.append(dict(start_epoch=self.start_epoch, iteration=self.iteration,
                         best_acc=self.best_acc))
        return real(self, *a, **k)

    monkeypatch.setattr(TANTrainer, "fit", fit)
    return seen


def test_main_trains_validates_and_resumes(htm_tree, in_tmp, monkeypatch):
    argv = ARGV + ["--data_root", htm_tree]
    seen = _spy_fit(monkeypatch)
    best = main_mod.main(argv, device="cpu")
    assert np.isfinite(best) and 0.0 <= best <= 1.0  # the HTM-Align Recall
    assert seen == [dict(start_epoch=0, iteration=0, best_acc=-1e5)]
    (cmd,) = glob.glob("log/**/running_command.txt", recursive=True)
    exp = os.path.dirname(os.path.dirname(cmd))
    for e in (0, 1):  # cotrain keeps every epoch
        assert os.path.exists(os.path.join(exp, "model", f"epoch{e}.pth.tar"))
    tags = {json.loads(l)["tag"] for l in open(os.path.join(exp, "log", "metrics.jsonl"))}
    assert {"train/loss", "train/total_epoch_loss", "val/loss", "val/Recall", "val/AUC",
            "time/step_ms", "time/data_share", "time/val_s", "time/save_s"} <= tags
    e0 = os.path.join(exp, "model", "epoch0.pth.tar")
    blob = torch.load(e0, weights_only=True)
    assert blob["epoch"] == 0 and blob["iteration"] == 4

    best2 = main_mod.main(argv + ["--resume", e0], device="cpu")
    assert seen[1] == dict(start_epoch=1, iteration=4, best_acc=blob["best_acc"])
    assert np.isfinite(best2) and best2 >= blob["best_acc"]
    assert len(glob.glob("log/**/running_command.txt", recursive=True)) == 1  # same dir
    res = main_mod.main(argv + ["--test", e0], device="cpu")
    assert set(res) == {"Recall", "AUC"}


def test_main_fused_steps_checkpoint_equals_single_steps(htm_tree, in_tmp):
    """--fused_steps 2 (4 steps an epoch: two groups of 2) trains through
    the command line; its epoch-0 checkpoint equals --fused_steps 1's bit for
    bit (on the CPU the runner loops over the eager step, drawing the pos
    starts from the same generator in the same order)."""
    blobs = {}
    for n in (1, 2):
        main_mod.main(ARGV + ["--data_root", htm_tree, "--epochs", "1", "--fused_steps",
                              str(n), "--prefix", f"_f{n}"], device="cpu")
        (path,) = glob.glob(f"log_f{n}/*/model/epoch0.pth.tar")
        blobs[n] = torch.load(path, weights_only=True)
    a, b = blobs[1], blobs[2]
    assert a["iteration"] == b["iteration"] == 4
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 4
    for got, want in ((b["state_dict"], a["state_dict"]),
                      (b["target_state_dict"], a["target_state_dict"]),
                      (b["optimizer"]["mu"], a["optimizer"]["mu"]),
                      (b["optimizer"]["nu"], a["optimizer"]["nu"])):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


LATER = {
    "egoexo4d": (["--dataset", "egoexo4d", "--model", "joint"], "item 7"),
    "lemma": (["--dataset", "lemma", "--model", "joint"], "item 7"),
    "htm_aa": (["--dataset", "htm-aa"], "item 9"),
    "grounding": (["--dataset", "htm-370k", "--model", "grounding"], "item 7"),
    "view_invariant": (["--dataset", "htm-370k", "--model", "view_invariant"], "item 7"),
    "multihost": (["--dataset", "htm-370k", "--model", "init", "--multihost"], "item 4"),
    "backprop_freq": (ARGV + ["--backprop_freq", "2"], "item 4"),
    "gather_negatives": (ARGV + ["--gather_negatives"], "item 4"),
}


@pytest.mark.parametrize("case", sorted(LATER))
def test_routes_of_later_slices_raise(htm_tree, in_tmp, case):
    argv, item = LATER[case]
    with pytest.raises(NotImplementedError, match=item):
        main_mod.main(argv + ["--data_root", htm_tree], device="cpu")


def test_main_takes_the_card_unless_asked(htm_tree, in_tmp):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; main would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        main_mod.main(ARGV + ["--data_root", htm_tree])
    assert not os.path.exists("log")  # nothing written before the device check
