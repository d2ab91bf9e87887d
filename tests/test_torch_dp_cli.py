"""Data parallelism through the port's command line, on the CPU (gloo).

* ``main --dp_devices 2`` on the TAN route (cotrain, gathered negatives,
  ``--pretrain`` of a JAX package file of seeded weights): two spawned ranks
  train, validate and checkpoint; only rank 0 writes (one
  ``running_command.txt`` record, each metric of the log once); the epoch-0
  checkpoint (parameters, EMA twin, first moments), the logged losses and
  the returned score equal the JAX command line's with the same flags (a
  2-device mesh of the suite's CPU devices); ``--resume`` of its checkpoint
  over 2 ranks continues it.
* ``--multihost``: two processes under a torch.distributed.run launch's
  environment train the same model as ``--dp_devices 2``, bit for bit.
* ``--test`` at ``--dp_devices 2`` against the JAX command line with the
  same flag, on the same JAX package checkpoint: the TAN route's validation
  loss (sharded over the ranks, a ragged tail repeated) at 1e-4 relative,
  and the joint grounding script's results with the IoU by camera rank (the
  host's rows gathered from the ranks) at 1e-4 relative (1e-6 absolute),
  the counts equal.
* The joint grounding model trains at ``--dp_devices 2`` from a JAX package
  file as the JAX command line does: checkpoint, losses and score.

A run held against the JAX command line has the model's random pos start
off and Adam's eps at 1e-3 on both sides (``torch_dp_cases.deterministic_cli``
in each spawned rank, the same patch of the JAX package here): the two
packages draw pos starts from generators of their own, and at eps 1e-8 a
grad that differs by rounding alone becomes an update of +-lr. The bars are
tests/test_torch_train.py's: losses 1e-4 relative (1e-6 absolute),
parameters 2e-6 absolute, first moments 1e-4 of their largest entry.
"""

import contextlib
import glob
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.train import logging as jax_logging
from exoground_tpu.train import main as jax_main
from exoground_tpu.train import trainer as jax_trainer
from exoground_tpu.train.checkpoint import load_state, save_state
from exoground_tpu.train.config import parse_args as jax_parse_args
from exoground_tpu.utils.convert import convert_tan_state_dict
from exoground_tpu_torch.parallel.mesh import free_port, launch_env
from exoground_tpu_torch.tools.synth_htm import make_htm_tree
from exoground_tpu_torch.train import main as main_mod
from exoground_tpu_torch.utils.convert import (
    UNUSED_REFERENCE_KEYS,
    find_adam,
    grounding_state_dict_from_jax,
    tan_state_dict_from_jax,
)
from tests import torch_dp_cases
from tests.test_torch_cli import ARGV
from tests.test_torch_cli_grounding import TEST_SCRIPTS, TINY, _jax_grounding_file, _root
from tests.test_torch_cli_grounding import grounding_trees  # noqa: F401  (a fixture)
from tests.test_torch_small import jax_params
from tests.torch_cli_common import in_tmp  # noqa: F401  (a fixture)

DP = ["--dp_devices", "2", "--gather_negatives", "--epochs", "1"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def _one_thread_a_rank():
    """The spawned ranks share this process's threads (main gives each
    threads // ranks): 2 here, so each of the 2 ranks takes 1 and the test
    workers do not oversubscribe the host; the launched processes of
    --multihost take 1 as well, so both runs compute alike."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def htm_tree(tmp_path_factory):
    # 40 videos: 2 in the validation split (one batch of 2 rows), 38 (4
    # steps at B 8, 4 rows a rank) to train; no htm_align.json, so --test
    # returns the validation loss
    root = make_htm_tree(str(tmp_path_factory.mktemp("htm")), n_videos=40)
    os.remove(os.path.join(root, "htm_align.json"))
    return root


@contextlib.contextmanager
def _deterministic_ranks():
    """The spawned ranks of ``main --dp_devices`` under
    ``torch_dp_cases.deterministic_cli``."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(main_mod, "_rank_main", torch_dp_cases.deterministic_rank_main)
        yield


@contextlib.contextmanager
def _deterministic_jax():
    """The JAX command line as ``torch_dp_cases.deterministic_cli`` patches
    the port's: the random pos start off, Adam's eps ``CLI_EPS``. Yields
    the losses it logs, {(tag, step): value} (its writer's queue is not
    drained when ``main`` returns)."""
    build, fused = jax_main.build_model, jax_trainer.make_fused_optimizer
    logged, add = {}, jax_logging.AsyncWriter.add_data

    def add_data(self, tag, value, step):
        if "loss" in tag:
            logged[tag, int(step)] = float(value)
        add(self, tag, value, step)

    def make_fused_optimizer(*a, **k):
        tx = fused(*a, **k)
        tx.eps = torch_dp_cases.CLI_EPS
        return tx

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_main, "build_model", lambda cfg: build(cfg).clone(random_pos_start=0))
        m.setattr(jax_trainer, "make_fused_optimizer", make_fused_optimizer)
        m.setattr(jax_logging.AsyncWriter, "add_data", add_data)
        m.setitem(sys.modules, "torch.utils.tensorboard", None)  # the JSONL log
        yield logged


@pytest.fixture(scope="module")
def tan_init(htm_tree, tmp_path_factory):
    """A JAX package file of seeded TAN weights at ARGV's widths (32-d
    video, the tower's 512-d text): both command lines start from it."""
    jcfg = jax_parse_args(ARGV + ["--data_root", htm_tree])
    b, t, n = 2, jcfg.seq_len, 4
    params = jax_params(jax_main.build_model(jcfg), jnp.zeros((b, t, 32)),
                        jnp.zeros((b, n, 512)), jnp.zeros((b, t), bool),
                        jnp.zeros((b, n), bool), seed=4)
    path = str(tmp_path_factory.mktemp("tan_init") / "init.pth.tar")
    save_state(path, {"epoch": 0, "state_dict": params, "best_acc": 0.0, "iteration": 0})
    return path


@pytest.fixture(scope="module")
def dp_run(htm_tree, tan_init, tmp_path_factory):
    """``main --dp_devices 2`` from a directory of its own, from
    ``tan_init``, its ranks under ``deterministic_cli``: its experiment
    directory and result."""
    work = tmp_path_factory.mktemp("dp_run")
    cwd = os.getcwd()
    blocked = sys.modules.get("torch.utils.tensorboard", "unset")
    sys.modules["torch.utils.tensorboard"] = None  # the JSONL log, in the ranks too
    os.chdir(work)
    try:
        with _one_thread_a_rank(), _deterministic_ranks():
            best = main_mod.main(ARGV + DP + ["--data_root", htm_tree, "--pretrain", tan_init],
                                 device="cpu")
    finally:
        os.chdir(cwd)
        if blocked == "unset":
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = blocked
    (exp,) = glob.glob(str(work / "log" / "*"))
    return exp, best


def _logged(exp) -> dict:
    """The losses an experiment logged: {(tag, step): value}."""
    (path,) = glob.glob(os.path.join(exp, "**", "metrics.jsonl"), recursive=True)
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return {(r["tag"], r["step"]): r["value"] for r in rows if "loss" in r["tag"]}


def _hold_cli(got_exp, got_best, want_exp, want_best, want_log, to_port, tags):
    """The port's experiment against the JAX command line's: the score and
    the logged losses (``tags`` among them) at 1e-4, the epoch-0 checkpoint's
    trees at the step tests' bars."""
    np.testing.assert_allclose(got_best, want_best, rtol=1e-4, atol=1e-6)
    got_log = _logged(got_exp)
    assert {t for t, _ in want_log} >= set(tags) and set(got_log) == set(want_log)
    for k, v in want_log.items():
        np.testing.assert_allclose(got_log[k], v, rtol=1e-4, atol=1e-6, err_msg=str(k))
    got = torch.load(os.path.join(got_exp, "model", "epoch0.pth.tar"), weights_only=True)
    want = load_state(os.path.join(want_exp, "model", "epoch0.pth.tar"))
    assert got["iteration"] == want["iteration"] > 0
    for tree in ("state_dict", "target_state_dict"):
        if tree not in want:
            continue
        ref = to_port(want[tree])
        assert set(ref) == set(got[tree]) - set(UNUSED_REFERENCE_KEYS)
        for k, v in ref.items():
            np.testing.assert_allclose(got[tree][k].numpy(), v.numpy(), rtol=0, atol=2e-6,
                                       err_msg=f"{tree} {k}")
    mu = to_port(find_adam(want["optimizer"])["mu"])
    for k, v in mu.items():
        np.testing.assert_allclose(got["optimizer"]["mu"][k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-4 * max(v.abs().max().item(), 1e-12),
                                   err_msg=f"first moment {k}")


def test_main_dp_devices_2_trains_writes_once_and_resumes(htm_tree, dp_run, in_tmp):
    exp, best = dp_run
    assert np.isfinite(best)  # the negated validation loss
    assert sorted(os.listdir(os.path.join(exp, "model"))) == ["epoch0.pth.tar",
                                                              "model_best_epoch0.pth.tar"]
    with open(os.path.join(exp, "log", "running_command.txt")) as f:
        assert f.read().count('"command_time_stamp"') == 1  # rank 0's record alone
    with open(os.path.join(exp, "log", "metrics.jsonl")) as f:
        keys = [(r["tag"], r["step"]) for r in map(json.loads, f)]
    assert ("val/loss", 0) in keys and len(keys) == len(set(keys))
    e0 = os.path.join(exp, "model", "epoch0.pth.tar")
    blob = torch.load(e0, weights_only=True)
    assert blob["iteration"] == 4 and blob["optimizer"]["count"] == 4
    # --resume of that checkpoint over 2 ranks: epoch 1 continues from it
    shutil.copytree(exp, in_tmp / "exp")
    resume = str(in_tmp / "exp" / "model" / "epoch0.pth.tar")
    with _one_thread_a_rank():
        main_mod.main(ARGV + DP + ["--data_root", htm_tree, "--epochs", "2", "--resume", resume],
                      device="cpu")
    e1 = torch.load(str(in_tmp / "exp" / "model" / "epoch1.pth.tar"), weights_only=True)
    assert (e1["epoch"], e1["iteration"], e1["optimizer"]["count"]) == (1, 8, 8)
    assert any(not torch.equal(v, blob["state_dict"][k]) for k, v in e1["state_dict"].items())


def test_multihost_equals_dp_devices(htm_tree, tan_init, dp_run, in_tmp):
    """Two processes in a launch environment (what torch.distributed.run
    sets) join one group through --multihost: the model equals the
    spawned --dp_devices 2 run's bit for bit."""
    code = ("import sys, torch; sys.modules['torch.utils.tensorboard'] = None; "
            "torch.set_num_threads(1); from tests.torch_dp_cases import deterministic_cli; "
            "deterministic_cli(); from exoground_tpu_torch.train import main as m; "
            "m.main(sys.argv[1:], device='cpu')")
    argv = ARGV + DP[2:] + ["--data_root", htm_tree, "--pretrain", tan_init, "--multihost",
                            "--prefix", "_mh"]
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", code] + argv, cwd=in_tmp,
                              env=dict(env, **launch_env(r, 2, port)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-3000:] for o in outs]
    assert sum(o[0].count("run_summary") for o in outs) == 1  # the chief's line
    (mh,) = glob.glob(str(in_tmp / "log_mh" / "*" / "model" / "epoch0.pth.tar"))
    got = torch.load(mh, weights_only=True)
    want = torch.load(os.path.join(dp_run[0], "model", "epoch0.pth.tar"), weights_only=True)
    for tree in ("state_dict", "target_state_dict"):
        for k, v in want[tree].items():
            assert torch.equal(got[tree][k], v), (tree, k)
    for k, v in want["optimizer"]["mu"].items():
        assert torch.equal(got["optimizer"]["mu"][k], v), k


def test_dp_devices_2_test_of_a_jax_file_matches_the_jax_command_line(htm_tree, dp_run, in_tmp):
    """TAN: the validation loss of ``--test`` at --dp_devices 2."""
    blob = torch.load(os.path.join(dp_run[0], "model", "epoch0.pth.tar"), weights_only=True)

    def tree(sd):
        return convert_tan_state_dict({k: v.numpy() for k, v in sd.items()})

    path = str(in_tmp / "jax_tan.pth.tar")
    save_state(path, {"epoch": 0, "state_dict": tree(blob["state_dict"]),
                      "target_state_dict": tree(blob["target_state_dict"]),
                      "best_acc": 0.0, "iteration": 0})
    argv = ARGV + ["--data_root", htm_tree, "--dp_devices", "2", "--test", path]
    want = jax_main.main(argv)
    with _one_thread_a_rank():
        got = main_mod.main(argv, device="cpu")
    assert set(got) == set(want) == {"val_loss"}
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)


def test_dp_devices_2_grounding_test_matches_the_jax_command_line(grounding_trees, in_tmp):
    """scripts/test_joint_model.sh at --dp_devices 2 on a JAX checkpoint."""
    argv = (TEST_SCRIPTS["joint"] + _root(grounding_trees, TEST_SCRIPTS["joint"]) + TINY
            + ["--dp_devices", "2"])
    path = str(in_tmp / "jax_joint.pth.tar")
    _jax_grounding_file(jax_parse_args(argv), path, seed=3)
    want = jax_main.main(argv + ["--test", path])
    with _one_thread_a_rank():
        got = main_mod.main(argv + ["--test", path], device="cpu")
    assert set(got) == set(want) and any(k.startswith("Rank ") for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    (res,) = glob.glob(str(in_tmp / "*" / "test_results_epoch_0.json")) or glob.glob(
        str(in_tmp / "**" / "test_results_epoch_0.json"), recursive=True)
    assert os.path.getsize(res) > 0


def test_main_dp_devices_2_training_matches_the_jax_command_line(htm_tree, tan_init, dp_run,
                                                                in_tmp):
    """TAN cotrain with gathered negatives at --dp_devices 2, one epoch from
    the same JAX package file, against the JAX command line."""
    with _deterministic_jax() as want_log:
        want_best = jax_main.main(ARGV + DP + ["--data_root", htm_tree, "--pretrain", tan_init])
    (want_exp,) = glob.glob(str(in_tmp / "log" / "*"))
    _hold_cli(dp_run[0], dp_run[1], want_exp, want_best, want_log, tan_state_dict_from_jax,
              ("train/total_epoch_loss", "val/loss"))


def test_dp_devices_2_grounding_training_matches_the_jax_command_line(grounding_trees, in_tmp):
    """The joint model's flags (scripts/test_joint_model.sh's: without
    --curriculum_train, which the JAX command line hands to its val reader,
    whose check refuses it) training at --dp_devices 2, one epoch from the
    same JAX package file, against the JAX command line."""
    argv = TEST_SCRIPTS["joint"] + _root(grounding_trees, TEST_SCRIPTS["joint"]) + TINY + [
        "--dp_devices", "2"]
    path = str(in_tmp / "jax_joint_init.pth.tar")
    _jax_grounding_file(jax_parse_args(argv), path, seed=5)
    argv += ["--pretrain", path]
    with _one_thread_a_rank(), _deterministic_ranks():
        got_best = main_mod.main(argv + ["--prefix", "_port"], device="cpu")
    with _deterministic_jax() as want_log:
        want_best = jax_main.main(argv + ["--prefix", "_jax"])
    (got_exp,) = glob.glob(str(in_tmp / "log_port" / "*"))
    (want_exp,) = glob.glob(str(in_tmp / "log_jax" / "*"))
    _hold_cli(got_exp, got_best, want_exp, want_best, want_log, grounding_state_dict_from_jax,
              ("train/total_epoch_loss", "val/loss"))
