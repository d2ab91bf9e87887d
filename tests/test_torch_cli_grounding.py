"""The grounding scripts' flags through the port's command line, against
the JAX package.

``scripts/train_vi.sh``, ``train_grounding.sh``, ``train_joint_model.sh``,
``train_joint_model_lemma.sh``, then the matching ``scripts/test_*.sh``,
through ``main`` on a ``tools/synth_egoexo.py`` tree (1 + 1 layers, width
64, 32-d inputs, seq 16, B 4, one epoch): training, validation, ``--test``
with the IoU by camera rank and ``test_results_epoch_0.json``; the joint
script's ``--resume`` / ``--pretrain`` / ``--fused_steps 2``; ``--test`` of
a JAX package checkpoint against the JAX command line's results (1e-4
relative); ``--vi_encoder_path`` naming a JAX package file. The TAN routes
of the command line are in ``tests/test_torch_cli.py``.
"""

import glob
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.train import main as jax_main
from exoground_tpu.train.config import parse_args as jax_parse_args
from exoground_tpu_torch.train import main as main_mod
from tests.torch_cli_common import in_tmp  # noqa: F401  (a fixture)
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

# ------------------------------------------- EgoExo4D / LEMMA grounding
# the repo's scripts' flags (scripts/train_*.sh, scripts/test_*.sh), then the
# small sizes of these tests (argparse keeps the last value of a flag)
_EGO = ["--dataset", "egoexo4d", "--batch_size", "16", "--num_workers", "0", "--use_keysteps",
        "--views", "all", "--exos", "all"]
_LEMMA = ["--dataset", "lemma", "--batch_size", "16", "--num_workers", "0", "--use_keysteps",
          "--views", "all", "--exos", "all"]
SCRIPTS = {
    "vi": _EGO + ["--epochs", "100", "--model", "view_invariant", "--use_distill_nce_loss",
                  "--minimum_four_exo_takes", "--same_view_negative"],
    "grounding": _EGO + ["--epochs", "100", "--model", "grounding", "--minimum_four_exo_takes"],
    "joint": _EGO + ["--epochs", "100", "--model", "joint", "--minimum_four_exo_takes",
                     "--use_distill_nce_loss", "--same_view_negative", "--curriculum_train"],
    "lemma": _LEMMA + ["--epochs", "100", "--model", "joint", "--use_distill_nce_loss"],
}
TEST_SCRIPTS = {
    "vi": _EGO + ["--model", "view_invariant", "--use_distill_nce_loss",
                  "--minimum_four_exo_takes", "--same_view_negative"],
    "grounding": _EGO + ["--model", "grounding", "--minimum_four_exo_takes"],
    "joint": _EGO + ["--model", "joint", "--minimum_four_exo_takes", "--use_distill_nce_loss",
                     "--same_view_negative"],
    "lemma": _LEMMA + ["--model", "joint", "--use_distill_nce_loss"],
}
TINY = ["--num_encoder_layers", "1", "--num_decoder_layers", "1", "--feature_dim", "64",
        "--video_feature_dim", "32", "--text_feature_dim", "32", "--seq_len", "16",
        "--batch_size", "4", "--epochs", "1", "--print_freq", "100"]


@pytest.fixture(scope="module")
def grounding_trees(tmp_path_factory):
    from exoground_tpu_torch.tools.synth_egoexo import make_egoexo_tree, make_lemma_tree

    root = tmp_path_factory.mktemp("grounding")
    widths = dict(seconds=40, video_dim=32, text_dim=32)
    splits = {"train": 2, "val": 1, "test": 1}
    return {"egoexo4d": make_egoexo_tree(str(root / "egoexo"), splits, **widths),
            "lemma": make_lemma_tree(str(root / "lemma"), splits, **widths)}


def _root(trees, argv):
    return ["--data_root", trees[argv[argv.index("--dataset") + 1]]]


@pytest.fixture(scope="module")
def vi_checkpoint(grounding_trees, tmp_path_factory):
    """scripts/train_vi.sh's run, one epoch: its checkpoint."""
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("vi_run"))
    try:
        main_mod.main(SCRIPTS["vi"] + _root(grounding_trees, SCRIPTS["vi"]) + TINY,
                      device="cpu")
        return os.path.abspath(glob.glob("log/*/model/epoch0.pth.tar")[0])
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("script", ["vi", "grounding", "joint", "lemma"])
def test_grounding_scripts_train_validate_and_test(grounding_trees, vi_checkpoint, in_tmp,
                                                   monkeypatch, script):
    """Each grounding script's flags through ``main`` on the CPU: one epoch
    with validation and a checkpoint, then its test script's flags on that
    checkpoint: the results printed and returned, and for grounding / joint
    the IoU by camera rank and ``test_results_epoch_0.json``."""
    from exoground_tpu_torch.train.trainer import EgoExoTrainer

    extra = ["--vi_encoder_path", vi_checkpoint] if script == "grounding" else []
    argv = SCRIPTS[script] + _root(grounding_trees, SCRIPTS[script]) + TINY + extra
    fitted, evaluated = [], []
    real_fit, real_eval = EgoExoTrainer.fit, EgoExoTrainer.evaluate
    monkeypatch.setattr(EgoExoTrainer, "fit",
                        lambda self, *a, **k: fitted.append(self) or real_fit(self, *a, **k))
    monkeypatch.setattr(EgoExoTrainer, "evaluate", lambda self, *a, **k: evaluated.append(
        real_eval(self, *a, **k)) or evaluated[-1])
    best = main_mod.main(argv, device="cpu")
    tr = fitted[0]
    assert np.isfinite(best) and tr.iteration == len(tr.epoch_stats[0]["step_s"]) > 0
    val_loss, val = evaluated[0]
    assert np.isfinite(val_loss) and ("mean IoU" in val) == (script != "vi")
    if script == "grounding":  # the frozen pre-pass, from the VI run: no gradient reaches it
        vi = torch.load(vi_checkpoint, weights_only=True)["state_dict"]
        assert set(vi) == {k[len("vi_encoder."):] for k in tr.params if k.startswith("vi_")}
        assert all(tr.opt_state.mu[k].abs().max() == 0 for k in tr.params
                   if k.startswith("vi_encoder."))
    ckpt_path = glob.glob("log/*/model/epoch0.pth.tar")[0]
    test_argv = TEST_SCRIPTS[script] + _root(grounding_trees, TEST_SCRIPTS[script]) + TINY
    res = main_mod.main(test_argv + ["--test", ckpt_path], device="cpu")
    assert all(np.isfinite(v) for v in res.values())
    log_dir = os.path.join(os.path.dirname(os.path.dirname(ckpt_path)), "log")
    written = os.path.join(log_dir, "test_results_epoch_0.json")
    if script in ("grounding", "joint"):
        ranks = {k for k in res if k.startswith("Rank ")}
        assert ranks and sum(v for k, v in res.items() if k.endswith("count")) > 0
        with open(written) as f:
            rows = json.load(f)
        assert rows and {"loss_dict", "metadata"} == set(rows[0])
    elif script == "lemma":
        assert os.path.exists(written) and not any(k.startswith("Rank ") for k in res)
    else:
        assert not os.path.exists(written)


def test_grounding_resume_pretrain_and_fused_steps(grounding_trees, in_tmp, monkeypatch):
    """The joint script: ``--resume`` restores everything bit for bit and
    continues at the next epoch; ``--pretrain`` loads the parameters only;
    ``--fused_steps 2`` ends its epoch on the checkpoint of single steps."""
    from exoground_tpu_torch.train.trainer import EgoExoTrainer

    argv = SCRIPTS["joint"] + _root(grounding_trees, SCRIPTS["joint"]) + TINY
    main_mod.main(argv + ["--name_prefix", "one"], device="cpu")
    # a copy: the resumed run prunes its experiment's epoch-0 file
    path = str(in_tmp / "epoch0.pth.tar")
    shutil.copy(glob.glob("log/one_*/model/epoch0.pth.tar")[0], path)
    blob = torch.load(path, weights_only=True)
    seen = []
    real = EgoExoTrainer.fit

    def fit(self, *a, **k):
        seen.append((self.start_epoch, self.iteration, self.opt_state.count,
                     {k: v.clone() for k, v in self.params.items()},
                     {k: v.clone() for k, v in self.opt_state.nu.items()}))
        return real(self, *a, **k)

    monkeypatch.setattr(EgoExoTrainer, "fit", fit)
    os.makedirs("x/model")
    shutil.copy(path, "x/model/epoch0.pth.tar")
    main_mod.main(argv + ["--epochs", "2", "--resume", "x/model/epoch0.pth.tar"], device="cpu")
    start, it, count, params, nu = seen[-1]
    assert (start, it, count) == (1, blob["iteration"], blob["optimizer"]["count"])
    for k in blob["state_dict"]:
        assert torch.equal(params[k], blob["state_dict"][k]), k
        assert torch.equal(nu[k], blob["optimizer"]["nu"][k]), k
    main_mod.main(argv + ["--pretrain", path, "--name_prefix", "pre"], device="cpu")
    start, it, count, params, _ = seen[-1]
    assert (start, it, count) == (0, 0, 0)
    assert all(torch.equal(params[k], v) for k, v in blob["state_dict"].items())
    main_mod.main(argv + ["--fused_steps", "2", "--name_prefix", "two"], device="cpu")
    fused = torch.load(glob.glob("log/two_*/model/epoch0.pth.tar")[0], weights_only=True)
    assert fused["iteration"] == blob["iteration"]
    for k, v in blob["state_dict"].items():
        assert torch.equal(fused["state_dict"][k], v), k


def _jax_grounding_file(jcfg, path, seed):
    """A JAX package checkpoint of ``jcfg``'s model with seeded weights, as
    its ``save_state`` writes one (the test mode reads the parameters)."""
    from exoground_tpu.train.checkpoint import save_state
    from tests.test_torch_small import jax_params

    jm = jax_main.build_model(jcfg)
    b, t, n, c = 2, jcfg.seq_len, jcfg.seq_len, jcfg.video_feature_dim
    kw = {} if jcfg.model == "view_invariant" else dict(
        egocentric_video_embed=jnp.zeros((b, t, c)) if jcfg.use_distill_nce_loss else None)
    params = jax_params(jm, jnp.zeros((b, t, c)), jnp.zeros((b, n, jcfg.text_feature_dim)),
                        jnp.zeros((b, t), bool), jnp.zeros((b, n), bool), seed=seed, **kw)
    save_state(path, {"epoch": 0, "state_dict": params, "best_acc": 0.0, "iteration": 0})
    return params


def test_test_of_a_jax_grounding_checkpoint_matches_jax(grounding_trees, in_tmp, capsys):
    """scripts/test_joint_model.sh's ``--test`` on a JAX package checkpoint:
    the port's results against the JAX command line's on the same tree, each
    at 1e-4 relative (1e-6 absolute), the rank counts equal."""
    argv = TEST_SCRIPTS["joint"] + _root(grounding_trees, TEST_SCRIPTS["joint"]) + TINY
    path = str(in_tmp / "jax_joint.pth.tar")
    _jax_grounding_file(jax_parse_args(argv), path, seed=3)
    want = jax_main.main(argv + ["--test", path])
    got = main_mod.main(argv + ["--test", path], device="cpu")
    assert set(got) == set(want) and any(k.startswith("Rank ") for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_test_at_feature_dim_1024_matches_jax(grounding_trees, in_tmp):
    """The grounding command line at --feature_dim 1024 (8 heads: head size
    128, which the wide-head bodies serve on the card), depth 1:
    scripts/test_joint_model.sh's ``--test`` on a JAX package checkpoint of
    that width, the port's results against the JAX command line's on the
    same tree at 1e-4 relative (1e-6 absolute), the rank counts equal."""
    argv = (TEST_SCRIPTS["joint"] + _root(grounding_trees, TEST_SCRIPTS["joint"]) + TINY
            + ["--feature_dim", "1024"])
    path = str(in_tmp / "jax_joint_1024.pth.tar")
    _jax_grounding_file(jax_parse_args(argv), path, seed=4)
    want = jax_main.main(argv + ["--test", path])
    got = main_mod.main(argv + ["--test", path], device="cpu")
    assert set(got) == set(want) and any(k.startswith("Rank ") for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_frozen_vi_encoder_from_a_jax_file(grounding_trees, in_tmp, monkeypatch):
    """``--vi_encoder_path`` naming a JAX package view_invariant checkpoint:
    the grounding model's VI branch holds its weights, bridged."""
    from exoground_tpu_torch.train.trainer import EgoExoTrainer
    from exoground_tpu_torch.utils.convert import grounding_state_dict_from_jax

    vi_argv = SCRIPTS["vi"] + _root(grounding_trees, SCRIPTS["vi"]) + TINY
    path = str(in_tmp / "jax_vi.pth.tar")
    params = _jax_grounding_file(jax_parse_args(vi_argv), path, seed=4)
    seen = []
    monkeypatch.setattr(EgoExoTrainer, "fit", lambda self, *a, **k: seen.append(
        {k: v.clone() for k, v in self.params.items()}) or 0.0)
    argv = SCRIPTS["grounding"] + _root(grounding_trees, SCRIPTS["grounding"]) + TINY
    main_mod.main(argv + ["--vi_encoder_path", path], device="cpu")
    want = grounding_state_dict_from_jax({"params": params})
    assert len(want) == 7
    for k, v in want.items():
        assert torch.equal(seen[0][f"vi_encoder.{k}"], v), k
