"""The JAX package's checkpoint files read by the port, on the CPU.

* The pure-Python reader (``utils/flax_msgpack.py``) against
  ``flax.serialization.msgpack_restore`` on files the JAX ``save_state``
  wrote, with ``msgpack`` and ``flax`` hidden from the reader
  (``sys.modules`` entries set to None): float32 and bfloat16 arrays, numpy
  scalars, nested optax states (the fused state, the chain's
  ``MultiStepsState`` with bfloat16 moments), and chunked arrays (flax's
  ``MAX_CHUNK_SIZE`` patched small). Arrays equal, bfloat16 ones as
  ``torch.bfloat16`` tensors.
* ``load_state`` / ``checkpoint_format``: the two formats told apart by
  their first bytes; anything else raises ``ValueError``, a directory
  ``NotImplementedError``.
* Resume from a JAX ``TANTrainer``'s file of each optimizer layout (fused,
  ``MultiStepsState`` at k = 2): the restored tensors equal the file's, and
  the port's next step equals the JAX trainer's next step from the same
  file at tests/test_torch_train.py's train-step tolerances (loss 1e-4
  relative, first moments 1e-4 of their largest entry, parameters and EMA
  twin 2e-6 absolute, the accumulator 1e-4 of its largest entry).
* The committed fixtures under ``exoground_tpu_torch/testdata/`` decode to
  the arrays of the files rebuilt here from their seed
  (tests/jax_tan_fixtures.py): structure and integers equal, floats within
  1e-6 of each tensor's largest entry (XLA's CPU code may round
  differently on another host).
* ``GroundingService.from_checkpoint`` on a JAX file against the JAX
  service on the same file (1e-5 of the largest interval end), and the
  default model's tensors against the JAX default ``ExoGroundingTransformer``.
"""

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from exoground_tpu.models.grounding import ExoGroundingTransformer as JaxExo
from exoground_tpu.serve import GroundingService as JaxService
from exoground_tpu.train.checkpoint import save_state
from exoground_tpu.train.optim import FusedAdamWEMA as JaxFusedAdamWEMA
from exoground_tpu.train.optim import make_optimizer as jax_make_optimizer
from exoground_tpu_torch.evals.bench_items import make_grounding_requests
from exoground_tpu_torch.models import ExoGroundingTransformer, TemporalAligner
from exoground_tpu_torch.serve import GroundingService
from exoground_tpu_torch.train import ExperimentConfig, TANTrainer, optimizer_state_dict
from exoground_tpu_torch.train import checkpoint as ckpt
from exoground_tpu_torch.utils import flax_msgpack
from exoground_tpu_torch.utils.convert import (
    UNUSED_REFERENCE_KEYS,
    find_adam,
    grounding_state_dict_from_jax,
    tan_checkpoint_from_jax,
    tan_state_dict_from_jax,
)
from tests import jax_tan_fixtures as F
from tests.test_torch_grounding import SVC
from tests.test_torch_small import jax_params


@contextlib.contextmanager
def _without_msgpack_or_flax():
    """msgpack and flax unimportable inside the block."""
    names = ("msgpack", "flax", "flax.serialization")
    saved = {k: sys.modules[k] for k in names if k in sys.modules}
    try:
        sys.modules.update({k: None for k in names})
        yield
    finally:
        for k in names:
            sys.modules.pop(k, None)
        sys.modules.update(saved)


def _hidden_restore(path):
    """The reader on ``path`` with msgpack and flax unimportable."""
    with _without_msgpack_or_flax():
        return ckpt.load_state(path)


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif torch.is_tensor(got):
        assert str(want.dtype) == "bfloat16" and tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32),
                                      err_msg=path)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def _state_tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"proj": {"kernel": rng.randn(8, 16).astype(np.float32),
                     "bias": rng.randn(16).astype(np.float32)},
            "ln_1": {"scale": rng.randn(16).astype(np.float32)},
            "logit_scale": np.float32(rng.randn())}


def test_reader_matches_flax_without_msgpack_or_flax(tmp_path):
    params = jax.tree_util.tree_map(jnp.asarray, _state_tree())
    fused = JaxFusedAdamWEMA(params, moment_dtype="bfloat16")
    chain = jax_make_optimizer(params, accumulate_steps=2, grad_clip=1.0)
    state = {"epoch": 3, "best_acc": -1e5, "iteration": np.int64(12), "name": "tan",
             "flag": True, "none": None, "complex": 1.5 - 2j,
             "scalars": {"f32": np.float32(0.25), "i32": np.int32(-7), "u8": np.uint8(200),
                         "bf16": np.asarray(jnp.bfloat16(1.5)), "ints": [0, 127, 128, -32,
                                                                         -33, 70000, -2**40]},
             "state_dict": params, "bf16": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4),
             "optimizer": fused.init(params), "chain": chain.init(params),
             "empty": np.zeros((0, 3), np.float32)}
    path = str(tmp_path / "state.pth.tar")
    save_state(path, state)
    assert ckpt.checkpoint_format(path) == "flax_msgpack"
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = _hidden_restore(path)
    _assert_same_tree(got, want)
    assert got["optimizer"]["mu"]["proj"]["kernel"].dtype == torch.bfloat16
    assert set(got["chain"]) == {"mini_step", "gradient_step", "inner_opt_state", "acc_grads",
                                 "skip_state"}
    # numpy scalars stay scalars (ext type 3) where a tree holds them as
    # they are: save_state turns every leaf with a shape into an array
    scalars = {"f32": np.float32(0.25), "i64": np.int64(-2**40), "u8": np.uint8(200),
               "bf16": jnp.bfloat16(1.5), "c": 1.5 - 2j}
    raw = serialization.msgpack_serialize(scalars)
    assert raw.count(b"\xd4\x03") + raw.count(b"\xc7") >= 1  # an npscalar ext
    with _without_msgpack_or_flax():
        got = flax_msgpack.msgpack_restore(raw)
    want = serialization.msgpack_restore(raw)
    for k in ("f32", "i64", "u8"):
        assert type(got[k]) is type(want[k]) and got[k] == want[k], k
    assert got["bf16"].dtype == torch.bfloat16 and float(got["bf16"]) == 1.5
    assert got["c"] == want["c"] == 1.5 - 2j


def test_reader_joins_chunked_arrays(tmp_path, monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    state = {"big": np.arange(50 * 7, dtype=np.float32).reshape(50, 7),
             "bf16": jnp.linspace(0, 1, 70, dtype=jnp.bfloat16).reshape(7, 10),
             "small": np.arange(4, dtype=np.int32)}
    path = str(tmp_path / "chunked.pth.tar")
    save_state(path, state)
    with open(path, "rb") as f:
        raw = f.read()
    assert raw.count(b"__msgpack_chunked_array__") == 2
    want = serialization.msgpack_restore(raw)
    got = _hidden_restore(path)
    _assert_same_tree(got, want)
    assert got["big"].shape == (50, 7) and tuple(got["bf16"].shape) == (7, 10)


def test_format_detection_and_malformed_files(tmp_path):
    port = str(tmp_path / "port.pth.tar")
    ckpt.save_state(port, {"a": torch.ones(2)})
    assert ckpt.checkpoint_format(port) == "torch"
    assert torch.equal(ckpt.load_state(port)["a"], torch.ones(2))
    junk = tmp_path / "junk.pth.tar"
    junk.write_bytes(b"\x00\x01 not a checkpoint")
    with pytest.raises(ValueError, match="neither"):
        ckpt.load_state(str(junk))
    trailing = tmp_path / "trailing.pth.tar"
    trailing.write_bytes(b"\x80\x02pickle")  # an empty fixmap, then bytes
    with pytest.raises(ValueError, match="after the msgpack value"):
        ckpt.load_state(str(trailing))
    truncated = tmp_path / "truncated.pth.tar"
    save_state(str(truncated), {"w": np.ones(100, np.float32)})
    truncated.write_bytes(truncated.read_bytes()[:-10])
    with pytest.raises(ValueError, match="truncated"):
        ckpt.load_state(str(truncated))
    with pytest.raises(NotImplementedError, match="orbax"):
        ckpt.load_state(str(tmp_path))


# ------------------------------------------------------- resume from JAX files
@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each layout's JAX trainer, its file (3 steps from the seed) and the
    JAX trainer's next step from that file."""
    d = tmp_path_factory.mktemp("jax_tan")
    out = {}
    for layout in F.LAYOUTS:
        path = str(d / f"{layout}.pth.tar")
        tr = F.write(layout, path)
        tr.load_checkpoint(path, mode="resume")
        loss = tr.train_epoch([F.batch(F.SEED + 10)], 1)
        state = serialization.to_state_dict(jax.device_get(tr.opt_state))
        out[layout] = dict(path=path, loss=loss, params=jax.device_get(tr.params),
                           target=jax.device_get(tr.target_params), opt=state)
    return out


def _port_trainer(layout):
    torch.manual_seed(1)  # not the file's weights: the resume must bring them
    cfg = ExperimentConfig(**F.CONFIG, **F.LAYOUTS[layout])
    tr = TANTrainer(TemporalAligner(**F.MODEL, video_dim=F.DIM, text_dim=F.DIM, device="cpu"),
                    cfg, iters_per_epoch=F.ITERS_PER_EPOCH, device="cpu")
    tr.tx.eps = F.EPS
    return tr


@pytest.mark.parametrize("layout", sorted(F.LAYOUTS))
def test_resume_from_a_jax_file_continues_the_jax_step(jax_runs, layout):
    run = jax_runs[layout]
    blob = tan_checkpoint_from_jax(ckpt.load_state(run["path"]))
    tr = _port_trainer(layout)
    tr.load_checkpoint(run["path"], mode="resume")
    assert (tr.iteration, tr.start_epoch) == (3, 1)
    state = optimizer_state_dict(tr.opt_state)
    assert state["count"] == blob["optimizer"]["count"] == (3 if layout == "fused" else 1)
    for name, got, want in (("params", tr.params, blob["state_dict"]),
                            ("ema", tr.target_params, blob["target_state_dict"]),
                            ("mu", state["mu"], blob["optimizer"]["mu"]),
                            ("nu", state["nu"], blob["optimizer"]["nu"])):
        assert set(got) - set(UNUSED_REFERENCE_KEYS) == set(want), name
        for k in want:
            assert torch.equal(got[k], want[k]), f"{name} {k}"
    if layout != "fused":
        assert state["mini_step"] == blob["optimizer"]["mini_step"] == 1
        acc = blob["optimizer"]["acc_grads"]
        assert any(v.abs().max() > 0 for v in acc.values())  # the third mini-batch's
        for k, v in acc.items():
            assert torch.equal(state["acc_grads"][k], v), k

    loss = tr.train_epoch([F.batch(F.SEED + 10)], 1)
    np.testing.assert_allclose(loss, run["loss"], rtol=1e-4)
    adam = find_adam(run["opt"])
    state = optimizer_state_dict(tr.opt_state)
    assert state["count"] == int(adam["count"])
    for k, want in tan_state_dict_from_jax(adam["mu"]).items():
        scale = max(want.abs().max().item(), 1e-12)
        np.testing.assert_allclose(state["mu"][k].numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=f"first moment {k}")
    if layout != "fused":
        assert state["mini_step"] == int(run["opt"]["mini_step"]) == 0
        for k, want in tan_state_dict_from_jax(run["opt"]["acc_grads"]).items():
            assert not want.any() and not state["acc_grads"][k].any(), k
    for name, want, got in (("params", run["params"], tr.params),
                            ("ema", run["target"], tr.target_params)):
        for k, w in tan_state_dict_from_jax(want).items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=2e-6,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("layout", sorted(F.LAYOUTS))
def test_committed_fixtures_decode_to_the_rebuilt_files(jax_runs, layout):
    committed = ckpt.load_state(F.fixture_path(layout))
    with open(jax_runs[layout]["path"], "rb") as f:
        rebuilt = serialization.msgpack_restore(f.read())

    def same(got, want, path=""):
        if isinstance(want, dict):
            assert set(got) == set(want), path
            for k in want:
                same(got[k], want[k], f"{path}/{k}")
        elif isinstance(want, np.ndarray) and want.dtype.kind == "f":
            assert got.dtype == want.dtype and got.shape == want.shape, path
            scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale, err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)

    same(committed, rebuilt)
    assert os.path.getsize(F.fixture_path(layout)) < 2**20


def test_chip_smoke_resumes_the_fixtures_as_they_were_written():
    """chip_smoke.py (which imports nothing of JAX) holds its own copy of
    the fixtures' configuration and batch."""
    import chip_smoke

    assert chip_smoke.JAX_FIXTURE_MODEL == F.MODEL and chip_smoke.JAX_FIXTURE_DIM == F.DIM
    assert chip_smoke.JAX_FIXTURE_CONFIG == F.CONFIG
    assert chip_smoke.JAX_FIXTURE_LAYOUTS == F.LAYOUTS
    for k, v in F.batch(F.SEED + 10).items():
        np.testing.assert_array_equal(chip_smoke._fixture_batch(F.SEED + 10)[k], v, err_msg=k)


def test_chip_smoke_writes_the_jax_package_layout(tmp_path):
    """chip_smoke.py's ``write_jax_checkpoint`` (phase 8 resumes the command
    line from its output at full width): flax reads the file into the
    layout of the JAX trainer's own (the committed MultiStepsState fixture:
    keys, shapes and dtypes), its trees are the JAX package's
    ``convert_tan_state_dict`` of the port's, and the port reads it back to
    the port file's state bit for bit (the unused ``mlp`` aside)."""
    import chip_smoke
    from exoground_tpu.utils.convert import convert_tan_state_dict

    tr = _port_trainer("multisteps_k2")
    tr.load_checkpoint(F.fixture_path("multisteps_k2"), mode="resume")
    tr.train_epoch([F.batch(F.SEED + 10)], 1)  # moments and accumulator of its own
    tr.train_epoch([F.batch(F.SEED + 11)], 1)
    tr.cfg.model_path = str(tmp_path)
    tr.save_epoch(0)
    port, path = str(tmp_path / "epoch0.pth.tar"), str(tmp_path / "jax.pth.tar")
    assert chip_smoke.write_jax_checkpoint(port, path) == os.path.getsize(path)
    with open(path, "rb") as f:
        got = serialization.msgpack_restore(f.read())
    with open(F.fixture_path("multisteps_k2"), "rb") as f:
        fixture = serialization.msgpack_restore(f.read())

    def layout(node):
        if isinstance(node, dict):
            return {k: layout(v) for k, v in node.items()}
        if isinstance(node, np.ndarray):
            return node.shape, node.dtype
        return type(node)

    assert layout(got) == layout(fixture)
    blob = torch.load(port, weights_only=True)
    opt = blob["optimizer"]
    assert opt["mini_step"] == 1 and any(v.any() for v in opt["acc_grads"].values())
    adam = find_adam(got["optimizer"])
    for tree, sd in ((got["state_dict"], blob["state_dict"]),
                     (got["target_state_dict"], blob["target_state_dict"]),
                     (adam["mu"], opt["mu"]), (adam["nu"], opt["nu"]),
                     (got["optimizer"]["acc_grads"], opt["acc_grads"])):
        _assert_same_tree(tree, convert_tan_state_dict({k: v.numpy() for k, v in sd.items()}))
    assert (int(adam["count"]), int(got["optimizer"]["mini_step"])) == (opt["count"], 1)
    back = tan_checkpoint_from_jax(ckpt.load_state(path))
    for key in ("state_dict", "target_state_dict"):
        for k, v in back[key].items():
            assert torch.equal(v, blob[key][k]), k
    for key in ("mu", "nu", "acc_grads"):
        assert set(back["optimizer"][key]) == set(opt[key]) - set(UNUSED_REFERENCE_KEYS)
        for k, v in back["optimizer"][key].items():
            assert torch.equal(v, opt[key][k]), k
    assert {k: back[k] for k in ("epoch", "iteration", "best_acc")} == {
        k: blob[k] for k in ("epoch", "iteration", "best_acc")}


# ----------------------------------------------------------- grounding service


def test_grounding_service_from_a_jax_checkpoint(tmp_path):
    jm = JaxExo(**SVC, attn_impl="xla")
    params = jax_params(jm, jnp.zeros((1, 16, 24)), jnp.zeros((1, 8, 16)),
                       jnp.zeros((1, 16), bool), jnp.zeros((1, 8), bool), seed=11)
    path = str(tmp_path / "ground.pth.tar")
    save_state(path, {"epoch": 0, "state_dict": params, "best_acc": 0.0})
    jsvc = JaxService.from_checkpoint(path, model=jm, seq_len=16, text_bucket=8)
    svc = GroundingService.from_checkpoint(
        path, model=ExoGroundingTransformer(**SVC, device="cpu"), device="cpu",
        seq_len=16, text_bucket=8)
    reqs = make_grounding_requests(3, 5, video_dim=24, text_dim=16, max_t=16, max_k=11)
    got, want = svc.ground_batch(reqs), jsvc.ground_batch(reqs)
    scale = max(np.abs(w[k]).max() for w in want for k in ("start", "end"))
    for g, w in zip(got, want):
        for k in ("start", "end"):
            assert np.abs(np.asarray(g[k]) - w[k]).max() <= 1e-5 * scale
    port = str(tmp_path / "port.pth.tar")
    ckpt.save_state(port, {"state_dict": {}})
    with pytest.raises(KeyError, match="missing"):
        GroundingService.from_checkpoint(port, device="cpu")


def test_grounding_default_model_fits_the_jax_default():
    shapes = jax.eval_shape(JaxExo().init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 4096)),
                            jnp.zeros((1, 4, 4096)), jnp.zeros((1, 8), bool),
                            jnp.zeros((1, 4), bool))["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = grounding_state_dict_from_jax(zeros)
    from exoground_tpu_torch.models import GroundingModel

    model = GroundingModel(vi_encoder_type="none", device="cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    buffers = {name for name, _ in model.named_buffers()}
    assert set(got) - set(UNUSED_REFERENCE_KEYS) - buffers == set(want)
    assert all(got[k] == tuple(v.shape) for k, v in want.items())
