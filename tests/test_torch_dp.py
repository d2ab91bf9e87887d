"""The port's data parallelism against the JAX package's, on the CPU.

One gloo pool a world size (W = 2 and 4 ranks, spawned once for the module,
each rank running every case of ``tests/torch_dp_cases.py``) against the
JAX steps over ``make_mesh(W)``, the suite's first W CPU devices, on the
same global batches and numpy-seeded weights:

* ``all_gather_tiled`` forward and backward against ``jax.lax.all_gather``
  (tiled) under ``shard_map`` and its transpose (``jax.vjp``), at 1e-6;
* the TAN train step after steps 1 and 3 (cotrain with the EMA twin;
  gathered negatives off and on, fused grid and volumes, ``--backprop_freq
  2`` through the optax chain) at tests/test_torch_train.py's bars:
  metrics 1e-4 relative (1e-6 absolute), first moments 1e-4 of their
  largest entry, parameters and twin 2e-6 absolute (Adam eps 1e-3 on both
  sides, ``random_pos_start=0``), every rank's replica equal to rank 0's
  bit for bit;
* bf16 compute, gathered negatives and the N-step runner together (the JAX
  ``test_amp_gather_fused_compose``): float32 masters, the two losses at
  2e-2 of the JAX bf16 step's;
* the per-rank pos-start draws: apart between ranks, the same in two runs;
* the joint grounding train step at W = 2, at the same bars;
* the sharded eval steps on ragged batches padded as both trainers pad them
  (``_pad_rows``: repeats for TAN, masked rows for grounding), every scalar
  at 1e-5 relative (1e-6 absolute), the IoU map of every rank at 1e-5;
* ``parallel/multihost_check.py``: the real ``TANTrainer`` and a sharded
  grounding eval over 2 gloo processes against the JAX trainer over a
  2-device mesh (losses 1e-4, scalars 1e-5, the host's IoU rows 1e-5),
  and only rank 0 writing; ``dryrun_multichip(2)``.

Summation order over the ranks differs from XLA's; every bar above is the
single-device tests' own.
"""

import functools
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from flax import serialization
from jax import shard_map
from jax.sharding import PartitionSpec as P

from exoground_tpu.losses import grounding as jgnd
from exoground_tpu.losses.milnce import TANLossConfig as JaxLossConfig
from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.models import ema_init as jax_ema_init
from exoground_tpu.models.grounding import ExoGroundingTransformer as JaxExo
from exoground_tpu.parallel import make_mesh, replicate, shard_batch
from exoground_tpu.parallel import make_tan_train_step as jax_make_step
from exoground_tpu.parallel.mesh import DATA_AXIS
from exoground_tpu.parallel.train_step import make_grounding_eval_step as jax_make_gnd_eval
from exoground_tpu.parallel.train_step import make_grounding_train_step as jax_make_gnd_step
from exoground_tpu.parallel.train_step import make_tan_eval_step as jax_make_tan_eval
from exoground_tpu.train.optim import FusedAdamWEMA as JaxFusedAdamWEMA
from exoground_tpu.train.optim import make_optimizer as jax_make_optimizer
from exoground_tpu.train.trainer import BaseTrainer as JaxBaseTrainer
from exoground_tpu_torch.parallel import Mesh, multihost_check
from exoground_tpu_torch.parallel.mesh import free_port
from exoground_tpu_torch.train.trainer import BaseTrainer
from exoground_tpu_torch.utils.convert import (
    UNUSED_REFERENCE_KEYS,
    find_adam,
    grounding_state_dict_from_jax,
    tan_state_dict_from_jax,
)
from tests import torch_dp_cases
from tests.test_torch_grounding_train import TRUNK
from tests.test_torch_grounding_train import _batch as _gbatch
from tests.test_torch_small import jax_params
from tests.test_torch_train import LOSS, SMALL, _batch, _numpy_params

TINY = dict(SMALL, num_encoder_layers=1, num_joint_layers=1, width=64)
OPT = dict(lr=1e-3, weight_decay=1e-2, total_iterations=20, warmup_iterations=0)
B_LOCAL = 2  # rows a rank
TAN_CASES = {  # name: (gather_negatives, fused_grid, optax chain kwargs or None)
    "fused": (False, True, None),
    "fused_gather": (True, True, None),
    "volumes": (False, False, None),
    "volumes_gather": (True, False, None),
    "backprop_freq_2_gather": (True, True, dict(accumulate_steps=2)),
}
# the cases a world size runs (each a JAX compile): every one at W = 2 and 4
WORLD_CASES = {2: sorted(TAN_CASES), 4: sorted(TAN_CASES)}
GND_FLAGS = dict(use_distill_nce_loss=True, same_view_negative=True)
GND_MODEL = dict(TRUNK, use_distill_nce_loss=True)
_JAX = {}  # the JAX side's results by (world, case)


@functools.lru_cache(maxsize=None)
def _tan_params():
    return _numpy_params(JaxAligner(**TINY), 0)["params"]


@functools.lru_cache(maxsize=None)
def _gnd_params():
    jm = JaxExo(**GND_MODEL, attn_impl="xla")
    b = _gbatch(0, "joint")
    return jax_params(jm, b["video_features"], b["narration_features"],
                      b["video_padding_mask"], b["narration_padding_mask"], seed=0,
                      egocentric_video_embed=b["ego_video_features_flat"])


def _padded(batch, w, mode):
    """``batch`` padded to the W-device mesh as the JAX trainer pads it."""
    return JaxBaseTrainer._pad_rows(types.SimpleNamespace(mesh=make_mesh(w)), batch, mode)


def _spec(w):
    b = w * B_LOCAL
    rng = np.random.RandomState(w)
    spec = {"gather": ("gather", dict(x=rng.randn(w * 3, 5).astype(np.float32),
                                      g=rng.randn(w, w * 3, 5).astype(np.float32)))}
    batches = [_batch(10 + i, b=b) for i in range(3)]
    for name in WORLD_CASES[w]:
        gather, fused, chain = TAN_CASES[name]
        opt = dict(OPT, **(chain or {}))
        spec[name] = ("tan", dict(params=_tan_params(), model=TINY, loss=LOSS, opt=opt,
                                  batches=batches, gather=gather, fused_grid=fused,
                                  chain=chain is not None))
    spec["tan_eval"] = ("tan_eval", dict(params=_tan_params(), model=TINY, loss=LOSS,
                                         batch=_padded(_batch(20, b=b + 1), w, "wrap")))
    spec["pos"] = ("pos", dict(model=dict(TINY, random_pos_start=1), batch=batches[0]))
    if w == 2:
        spec["compose"] = ("tan", dict(params=_tan_params(), model=TINY, loss=LOSS,
                                       opt=OPT, batches=batches[:2], gather=True,
                                       fused_grid=True, compute_dtype="bfloat16", scan=2))
        spec["grounding"] = ("grounding", dict(
            params=_gnd_params(), model=GND_MODEL, loss=dict(model="joint", **GND_FLAGS),
            opt=OPT, batches=[_gbatch(10 + i, "joint", b=b) for i in range(3)]))
        spec["grounding_eval"] = ("grounding_eval", dict(
            params=_gnd_params(), model=GND_MODEL, loss=dict(model="joint", **GND_FLAGS),
            batch=_padded(_gbatch(30, "joint", b=b + 1), w, "zeros")))
    return spec


def _pool(w, out_dir):
    spec = _spec(w)
    mp.start_processes(torch_dp_cases.run, nprocs=w, start_method="spawn",
                       args=(w, free_port(), spec, str(out_dir)))
    return spec, [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(w)]


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _pool(2, tmp_path_factory.mktemp("dp2"))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _pool(4, tmp_path_factory.mktemp("dp4"))


def _ranks(request, w):
    return request.getfixturevalue(f"ranks{w}")


# ------------------------------------------------------------- collectives
@pytest.mark.parametrize("w", [2, 4])
def test_all_gather_tiled_matches_jax(request, w):
    spec, res = _ranks(request, w)
    x, g = spec["gather"][1]["x"], spec["gather"][1]["g"]
    f = shard_map(lambda xl: jax.lax.all_gather(xl, DATA_AXIS, tiled=True)[None],
                  mesh=make_mesh(w), in_specs=P(DATA_AXIS), out_specs=P(DATA_AXIS),
                  check_vma=False)
    y, vjp = jax.vjp(f, jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(g))
    b = x.shape[0] // w
    for r in range(w):
        got = res[r]["gather"]
        np.testing.assert_array_equal(got["y"], np.asarray(y)[r])
        np.testing.assert_allclose(got["grad"], np.asarray(gx)[r * b:(r + 1) * b], rtol=1e-6,
                                   atol=1e-6)
        # gloo: the backward is an all-reduce of which each rank keeps its slice
        assert got["issued"] == dict(all_reduce=1, all_gather=1, reduce_scatter=0, broadcast=0)


# ------------------------------------------------------------- TAN step
def _jax_tan(w, name, spec):
    if (w, name) in _JAX:
        return _JAX[w, name]
    gather, fused, chain = TAN_CASES[name]
    kw = spec[name][1]
    jm = JaxAligner(**TINY, attn_impl="xla")
    mesh = make_mesh(w)
    params = _tan_params()
    if chain:
        with pytest.MonkeyPatch.context() as m:
            m.setattr(optax, "adamw", functools.partial(optax.adamw, eps=1e-3))
            jtx = jax_make_optimizer(params, **kw["opt"])
    else:
        jtx = JaxFusedAdamWEMA(params, eps=1e-3, **kw["opt"])
    jstep = jax_make_step(jm, JaxLossConfig(**LOSS), jtx, mesh, ema_momentum=0.9,
                          gather_negatives=gather, fused_grid=fused)
    jp = replicate(jax.tree_util.tree_map(jnp.copy, params), mesh)
    jt, jo = replicate(jax_ema_init(params), mesh), replicate(jtx.init(params), mesh)
    out = {}
    for i, b in enumerate(kw["batches"]):
        jp, jt, jo, jmet = jstep(jp, jt, jo, shard_batch(b, mesh), jax.random.PRNGKey(i))
        if i in (0, 2):
            mu = (find_adam(serialization.to_state_dict(jax.device_get(jo)))["mu"] if chain
                  else {"params": jax.device_get(jo.mu)})
            out[i + 1] = ({k: float(v) for k, v in jmet.items()},
                          {"params": tan_state_dict_from_jax({"params": jax.device_get(jp)}),
                           "ema": tan_state_dict_from_jax({"params": jax.device_get(jt)}),
                           "mu": tan_state_dict_from_jax(mu)})
    _JAX[w, name] = out
    return out


def _hold(rec, jmet, jtrees, ranks_recs):
    assert set(rec["metrics"]) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(rec["metrics"][k], jmet[k], rtol=1e-4, atol=1e-6, err_msg=k)
    trees = rec["trees"]
    for k, want in jtrees["mu"].items():
        scale = max(want.abs().max().item(), 1e-12)
        np.testing.assert_allclose(trees["mu"][k].numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=f"first moment {k}")
    for name in ("params", "ema"):
        if name not in jtrees or name not in trees:
            continue
        assert set(jtrees[name]) == set(trees[name]) - set(UNUSED_REFERENCE_KEYS)
        for k, want in jtrees[name].items():
            np.testing.assert_allclose(trees[name][k].numpy(), want.numpy(), rtol=0, atol=2e-6,
                                       err_msg=f"{name} {k}")
    for other in ranks_recs:  # every replica equals rank 0's bit for bit
        assert other["digest"] == rec["digest"] and other["metrics"] == rec["metrics"]


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("w,case", [(w, c) for w, cases in WORLD_CASES.items() for c in cases])
def test_tan_step_matches_jax(request, w, case, n_steps):
    spec, res = _ranks(request, w)
    jmet, jtrees = _jax_tan(w, case, spec)[n_steps]
    _hold(res[0][case][n_steps], jmet, jtrees, [r[case][n_steps] for r in res[1:]])


def test_amp_gather_fused_compose(ranks2):
    """bf16 compute, gathered negatives and the 2-step runner in one step:
    float32 masters, the replicas equal, the losses at 2e-2 of JAX's."""
    spec, res = ranks2
    kw = spec["compose"][1]
    jm = JaxAligner(**TINY, attn_impl="xla")
    mesh = make_mesh(2)
    params = _tan_params()
    jtx = JaxFusedAdamWEMA(params, eps=1e-3, **OPT)
    jstep = jax_make_step(jm, JaxLossConfig(**LOSS), jtx, mesh, ema_momentum=0.9,
                          gather_negatives=True, compute_dtype="bfloat16", scan_steps=2)
    stacked = {k: np.stack([b[k] for b in kw["batches"]]) for k in kw["batches"][0]}
    _, _, _, ms = jstep(replicate(jax.tree_util.tree_map(jnp.copy, params), mesh),
                        replicate(jax_ema_init(params), mesh),
                        replicate(jtx.init(params), mesh), shard_batch(stacked, mesh, dim=1),
                        jax.random.PRNGKey(3))
    got = res[0]["compose"]
    assert got["dtypes"] == ["torch.float32"] and len(got["losses"]) == 2
    assert all(r["compose"] == got for r in res[1:])
    np.testing.assert_allclose(got["losses"], np.asarray(ms["loss"]), rtol=2e-2)


@pytest.mark.parametrize("w", [2, 4])
def test_pos_starts_apart_between_ranks_and_repeated(request, w):
    _, res = _ranks(request, w)
    draws = [r["pos"] for r in res]
    for d in draws:
        assert d[0] == d[1]  # a second run draws the same
    firsts = [tuple(map(tuple, d[0])) for d in draws]
    assert len(set(firsts)) == w  # every rank its own


# ------------------------------------------------------------- grounding step
def test_grounding_step_matches_jax(ranks2):
    spec, res = ranks2
    kw = spec["grounding"][1]
    jm = JaxExo(**GND_MODEL, attn_impl="xla")
    mesh = make_mesh(2)
    params = _gnd_params()
    jtx = JaxFusedAdamWEMA(params, eps=1e-3, **OPT)
    jstep = jax_make_gnd_step(jm, jgnd.GroundingLossConfig(**kw["loss"]), jtx, mesh)
    jp = replicate(jax.tree_util.tree_map(jnp.copy, params), mesh)
    jo = replicate(jtx.init(params), mesh)
    for i, b in enumerate(kw["batches"]):
        jp, jo, jmet = jstep(jp, jo, shard_batch(b, mesh), jax.random.PRNGKey(i))
        if i in (0, 2):
            jtrees = {"params": grounding_state_dict_from_jax({"params": jax.device_get(jp)}),
                      "mu": grounding_state_dict_from_jax({"params": jax.device_get(jo.mu)})}
            _hold(res[0]["grounding"][i + 1], {k: float(v) for k, v in jmet.items()}, jtrees,
                  [r["grounding"][i + 1] for r in res[1:]])


# ------------------------------------------------------------- eval steps
@pytest.mark.parametrize("mode", ["wrap", "zeros"])
@pytest.mark.parametrize("w", [2, 4])
def test_pad_rows_matches_jax(w, mode):
    batch = _gbatch(31, "joint", b=2 * w + 1)
    want = _padded(batch, w, mode)
    got = BaseTrainer._pad_rows(types.SimpleNamespace(mesh=Mesh(world=w)), batch, mode)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("w", [2, 4])
def test_tan_eval_step_with_a_ragged_tail_matches_jax(request, w):
    spec, res = _ranks(request, w)
    kw = spec["tan_eval"][1]
    jm = JaxAligner(**TINY, attn_impl="xla")
    mesh = make_mesh(w)
    want = jax_make_tan_eval(jm, JaxLossConfig(**LOSS), mesh, is_cotrain=True)(
        _tan_params(), _tan_params(), shard_batch(kw["batch"], mesh))
    for r in res:
        got = r["tan_eval"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert res[0]["tan_eval"]["_rows"] == float(want["_rows"]) == kw["batch"]["video"].shape[0]


def test_grounding_eval_step_with_a_ragged_tail_matches_jax(ranks2):
    spec, res = ranks2
    kw = spec["grounding_eval"][1]
    jm = JaxExo(**GND_MODEL, attn_impl="xla")
    mesh = make_mesh(2)
    scalars, ious = jax_make_gnd_eval(jm, jgnd.GroundingLossConfig(**kw["loss"]), mesh)(
        _gnd_params(), shard_batch(kw["batch"], mesh))
    for r in res:
        got = r["grounding_eval"]
        assert set(got["scalars"]) == set(scalars)
        for k in scalars:
            np.testing.assert_allclose(got["scalars"][k], float(scalars[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["ious"], np.asarray(ious), rtol=0, atol=1e-5)
    assert res[0]["grounding_eval"]["scalars"]["_rows"] == 2 * B_LOCAL + 1


# ------------------------------------------------------------- multihost
def test_multihost_check_matches_the_jax_trainer(tmp_path, monkeypatch):
    """The real TANTrainer and the sharded grounding eval over 2 gloo
    processes against the JAX trainer over a 2-device mesh."""
    # the chief's log as JSONL: the ranks keep this block (importing
    # torch.utils.tensorboard here pulls in TensorFlow)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from exoground_tpu.train import ExperimentConfig as JaxConfig
    from exoground_tpu.train import TANTrainer as JaxTANTrainer

    mc = multihost_check
    tan_model = {k: v for k, v in mc.TAN_MODEL.items() if k != "input_dim"}
    jm = JaxAligner(**tan_model, attn_impl="xla")
    batches = mc.global_batches()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batches[0]["video"][:1],
                            batches[0]["text"][:1], batches[0]["video_padding_mask"][:1],
                            batches[0]["text_padding_mask"][:1])
    tan = _numpy_params_of(shapes, 1)["params"]
    gb = mc.grounding_batch()
    gm = JaxExo(**mc.GROUNDING_MODEL, attn_impl="xla")
    gnd = jax_params(gm, gb["video_features"][:2], gb["narration_features"][:2],
                     gb["video_padding_mask"][:2], gb["narration_padding_mask"][:2], seed=2)
    res = mc.launch_check(str(tmp_path), 2, params={"tan": tan, "grounding": gnd})
    mc.assert_chief_only(res)

    mesh = make_mesh(2)
    cfg = JaxConfig(model="init", epochs=1, lr=1e-3, batch_size=16, seed=0,
                    runtime_save_iter=2, fused_steps=1)
    tr = JaxTANTrainer(jm, cfg, batches[0], iters_per_epoch=2, mesh=mesh)
    tr.params = replicate(jax.tree_util.tree_map(jnp.asarray, tan), mesh)
    tr.target_params = replicate(jax_ema_init(tan), mesh)
    tr.opt_state = replicate(tr.tx.init(tan), mesh)
    train_loss = tr.train_epoch(batches, epoch=0)
    val_loss = tr.evaluate(batches[:1], epoch=0)
    gb["row_valid"] = np.ones((16,), np.float32)
    scalars, ious = jax_make_gnd_eval(gm, jgnd.GroundingLossConfig(model="grounding"), mesh)(
        gnd, shard_batch(gb, mesh))
    for rec in res["multi"]:
        np.testing.assert_allclose(rec["train_loss"], train_loss, rtol=1e-4)
        np.testing.assert_allclose(rec["val_loss"], val_loss, rtol=1e-4)
        assert rec["iteration"] == 2 and rec["row_range"] == [0, 16]
        for k, v in scalars.items():
            np.testing.assert_allclose(rec["grounding_scalars"][k], float(v), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(np.asarray(rec["host_ious"]), np.asarray(ious), rtol=0,
                                   atol=1e-5)


def _numpy_params_of(shapes, seed):
    rng = np.random.RandomState(seed)

    def draw(path, sd):
        name = jax.tree_util.keystr(path)
        a = rng.standard_normal(sd.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.05 * a
        return a * (0.02 if len(sd.shape) == 1 or "pos_embed" in name
                    else sd.shape[0] ** -0.5)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_dryrun_multichip():
    out = multihost_check.dryrun_multichip(2)
    assert out["world"] == 2 and np.isfinite(out["loss"]) and np.isfinite(out["param_sum"])
