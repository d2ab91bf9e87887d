"""The optax chain of TAN training (``make_optimizer``) against the JAX
package's, on the CPU.

* ``make_optimizer`` against the JAX ``make_optimizer`` over 2k + 1 steps
  of seeded numpy grads: no clip, the per-parameter clip, the global-norm
  clip once triggered and once not, ``policy='bce'``, warmup, k = 1, 2 and
  3 (``optax.MultiSteps``), with and without the EMA twin (the JAX step's
  optax branch: ``t * m + p * (1 - m)`` after every update). Parameters,
  twin, mu, nu and the accumulator at ``rtol=2e-6, atol=1e-7``, the
  tolerance of tests/test_torch_train.py::test_fused_adamw_ema_matches_jax;
  counts (inner and mini step) equal.
* ``TanTrainStep`` with the chain (k = 2, global-norm clip) against the JAX
  ``make_tan_train_step`` with ``make_optimizer`` over 4 steps (1 + 1
  layers, width 64), eagerly and
  through ``ScanStep`` (on the CPU its plain loop): the tolerances of
  tests/test_torch_train.py::test_train_step_matches_jax (metrics 1e-4
  relative, first moments 1e-4 of their largest entry, parameters and EMA
  twin 2e-6 absolute; Adam eps 1e-3 on both sides, optax's ``adamw``
  patched for it in the JAX package, for the reason given there).
* ``TANTrainer``: ``backprop_freq=2`` at ``fused_steps=4`` equals
  ``fused_steps=1`` bit for bit; ``fused_optimizer=False`` against ``True``
  at the JAX package's chain-vs-fused tolerance (tests/test_optim_fused.py:
  rtol 1e-5, atol 1e-6); the chain's checkpoint round trip and the state
  carried across the two layouts (``adapt_optimizer_state``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from exoground_tpu.losses.milnce import TANLossConfig as JaxLossConfig
from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.models import ema_init as jax_ema_init
from exoground_tpu.parallel import make_mesh, replicate, shard_batch
from exoground_tpu.parallel import make_tan_train_step as jax_make_step
from exoground_tpu.train.optim import make_optimizer as jax_make_optimizer
from exoground_tpu_torch.losses.milnce import TANLossConfig
from exoground_tpu_torch.models import TemporalAligner, ema_init
from exoground_tpu_torch.parallel import make_tan_train_step
from exoground_tpu_torch.parallel.train_step import ScanStep
from exoground_tpu_torch.train import (
    ChainState,
    ExperimentConfig,
    FusedAdamWEMA,
    OptaxChain,
    TANTrainer,
    adapt_optimizer_state,
    make_optimizer,
    optimizer_state_dict,
)
from exoground_tpu_torch.utils.convert import find_adam, load_tan_params, tan_state_dict_from_jax
from tests.test_torch_train import LOSS, SMALL, _batch, _flat, _numpy_params, _tree, _unflat
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

OPT = dict(lr=1e-3, weight_decay=1e-2, total_iterations=50, warmup_iterations=2)
# the step and trainer cases' aligner: tests/test_torch_train.py's SMALL at 1 + 1
# layers and width 64, which keeps them short on a loaded CPU
TINY = dict(SMALL, num_encoder_layers=1, num_joint_layers=1, width=64)

CHAIN_CASES = {  # name: (make_optimizer kwargs, EMA momentum)
    "k1": (dict(), None),
    "k1_ema": (dict(), 0.9),
    "k1_per_param_clip": (dict(grad_clip=0.5), 0.9),
    "k1_global_clip": (dict(grad_clip=0.5, grad_clip_mode="global"), 0.9),
    "k1_global_clip_idle": (dict(grad_clip=1e3, grad_clip_mode="global"), None),
    "k1_bce": (dict(policy="bce"), 0.9),
    "k2": (dict(accumulate_steps=2), 0.9),
    "k2_global_clip": (dict(accumulate_steps=2, grad_clip=0.5, grad_clip_mode="global"), 0.9),
    "k2_global_clip_idle": (dict(accumulate_steps=2, grad_clip=1e3, grad_clip_mode="global"),
                            None),
    "k2_warmup": (dict(accumulate_steps=2, warmup_iterations=6), 0.9),
    "k3_per_param_clip": (dict(accumulate_steps=3, grad_clip=0.5), 0.9),
    "k3_bce": (dict(accumulate_steps=3, policy="bce"), None),
}


def _grads(flat, seed):
    rng = np.random.RandomState(seed)
    return {k: np.asarray(rng.randn(*v.shape), np.float32) for k, v in sorted(flat.items())}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_make_optimizer_matches_the_jax_chain(case):
    kw, mom = CHAIN_CASES[case]
    kw = {**OPT, **kw}
    k = kw.get("accumulate_steps", 1)
    tree = _tree()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jtx = jax_make_optimizer(jp, **kw)
    jo, jt = jtx.init(jp), jax.tree_util.tree_map(jnp.copy, jp)

    @jax.jit
    def jax_step(g, jo, jp, jt):
        upd, jo = jtx.update(g, jo, jp)
        jp = optax.apply_updates(jp, upd)
        if mom is not None:
            jt = jax.tree_util.tree_map(lambda a, b: a * mom + b * (1.0 - mom), jt, jp)
        return jo, jp, jt

    flat = _flat(tree)
    p = {name: torch.from_numpy(v.copy()) for name, v in flat.items()}
    tx = make_optimizer(p, **kw)
    assert isinstance(tx, OptaxChain) and tx.every_k == k
    o, t = tx.init(p), ema_init(p)
    norms = []
    for i in range(2 * k + 1):
        g = _grads(flat, 100 + i)
        norms.append(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values())))
        jo, jp, jt = jax_step(jax.tree_util.tree_map(jnp.asarray, _unflat(g)), jo, jp, jt)
        p, o, t = tx.step(p, o, {name: torch.from_numpy(v) for name, v in g.items()}, t, mom)
    if kw.get("grad_clip_mode") == "global":  # the mini-batch grads' norms bracket the mean's
        assert (max(norms) < kw["grad_clip"]) == case.endswith("_idle")
    state = serialization.to_state_dict(jo)
    adam = find_adam(state)
    want = {"params": jp, "target": jt if mom is not None else jp, "mu": adam["mu"],
            "nu": adam["nu"]}
    got = {"params": p, "target": t if mom is not None else p, "mu": o.mu, "nu": o.nu}
    if k > 1:
        want["acc"], got["acc"] = state["acc_grads"], o.acc_grads
    for name, w in want.items():
        for key, a in _flat(jax.tree_util.tree_map(np.asarray, w)).items():
            np.testing.assert_allclose(got[name][key].numpy(), a, rtol=2e-6, atol=1e-7,
                                       err_msg=f"{name} {key}")
    assert o.count == 2 * k + 1
    assert optimizer_state_dict(o)["count"] == int(adam["count"]) == (2 * k + 1) // k
    if k > 1:
        assert optimizer_state_dict(o)["mini_step"] == int(state["mini_step"]) == 1
        assert int(state["gradient_step"]) == 2
    if kw.get("policy") == "bce":
        np.testing.assert_array_equal(p["proj.kernel"].numpy(), flat["proj.kernel"])


def test_chain_scalars_and_schedule_of_inner_steps():
    p = {"w": torch.zeros(3, 2)}
    tx = make_optimizer(p, **dict(OPT, warmup_iterations=6), accumulate_steps=3)
    fused = FusedAdamWEMA(p, lr=1e-3, total_iterations=50 // 3, warmup_iterations=2)
    for count in range(7):
        inner, mini = divmod(count, 3)
        s = tx.scalars(count)
        assert s.dtype == np.float32 and s.shape == (5,)
        np.testing.assert_array_equal(s[:3], fused.scalars(inner))
        assert (s[3], s[4]) == (float(mini == 2), mini + 1)
    assert make_optimizer(p).scalars(4).shape == (3,)
    # --lr_backbone: the s3d leaves' steps scaled by backbone_lr / lr
    # (tests/test_torch_s3d.py holds the update against the JAX chain)
    two = {"s3d.w": torch.zeros(2), "text.w": torch.zeros(2)}
    groups = make_optimizer(two, lr=1e-3, backbone_lr=1e-4)._groups
    assert {k: scale for names, *_, scale in groups for k in names} == pytest.approx(
        {"s3d.w": 0.1, "text.w": None})


# ------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def chain_steps():
    """4 steps (k = 2, global-norm clip 0.5) of the JAX step with its
    ``make_optimizer``, of the port's eager step and of its
    ``ScanStep(scan_steps=2)``, from the same weights and batches."""
    opt_kw = dict(lr=1e-3, weight_decay=1e-2, total_iterations=20, warmup_iterations=0,
                  accumulate_steps=2, grad_clip=0.5, grad_clip_mode="global")
    jm = JaxAligner(**TINY, attn_impl="xla")
    jparams = _numpy_params(jm, 4)["params"]
    mesh = make_mesh(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "adamw", functools.partial(optax.adamw, eps=1e-3))
        jtx = jax_make_optimizer(jparams, **opt_kw)
    jstep = jax_make_step(jm, JaxLossConfig(**LOSS), jtx, mesh, ema_momentum=0.9)
    jp = replicate(jax.tree_util.tree_map(jnp.copy, jparams), mesh)
    jt, jo = replicate(jax_ema_init(jparams), mesh), replicate(jtx.init(jparams), mesh)
    batches = [_batch(70 + i) for i in range(4)]
    for i, b in enumerate(batches):
        jp, jt, jo, _ = jstep(jp, jt, jo, shard_batch(b, mesh), jax.random.PRNGKey(i))
    jax_state = serialization.to_state_dict(jax.device_get(jo))

    out = {}
    for name, scan in (("eager", None), ("scan", 2)):
        torch.manual_seed(0)
        tm = TemporalAligner(**TINY, device="cpu")
        load_tan_params(tm, {"params": jparams})
        p = {k: v.detach() for k, v in tm.named_parameters()}
        tx = make_optimizer(p, **opt_kw)
        tx.eps = 1e-3
        step = make_tan_train_step(tm, TANLossConfig(**LOSS), tx, ema_momentum=0.9,
                                   scan_steps=scan)
        t, o = ema_init(p), tx.init(p)
        metrics = []
        if scan is None:
            for b in batches:
                p, t, o, m = step(p, t, o, {k: torch.from_numpy(v) for k, v in b.items()})
                metrics.append(m)
        else:
            assert isinstance(step, ScanStep)
            for g in (batches[:2], batches[2:]):
                stacked = {k: torch.from_numpy(np.stack([b[k] for b in g])) for k in g[0]}
                p, t, o, ms = step(p, t, o, stacked)
                metrics += [{k: v[i] for k, v in ms.items()} for i in range(2)]
        out[name] = (p, t, o, metrics)
    return jax.device_get(jp), jax.device_get(jt), jax_state, out


@pytest.mark.parametrize("route", ["eager", "scan"])
def test_chain_train_step_matches_jax(chain_steps, route):
    jp, jt, jstate, out = chain_steps
    p, t, o, _ = out[route]
    assert o.count == 4 and optimizer_state_dict(o)["count"] == int(find_adam(jstate)["count"])
    assert optimizer_state_dict(o)["mini_step"] == int(jstate["mini_step"]) == 0
    jmu = tan_state_dict_from_jax(find_adam(jstate)["mu"])
    for k, want in jmu.items():
        scale = max(want.abs().max().item(), 1e-12)
        np.testing.assert_allclose(o.mu[k].numpy(), want.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=f"first moment {k}")
    for name, want, got in (("params", jp, p), ("ema", jt, t)):
        for k, w in tan_state_dict_from_jax({"params": want}).items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=2e-6,
                                       err_msg=f"{name} {k}")


def test_chain_scan_steps_equal_eager_steps_bit_for_bit(chain_steps):
    (p, t, o, ms), (p2, t2, o2, ms2) = chain_steps[3]["eager"], chain_steps[3]["scan"]
    for a, b in zip(ms, ms2):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in ((p, p2), (t, t2), (o.mu, o2.mu), (o.nu, o2.nu), (o.acc_grads, o2.acc_grads)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


# ----------------------------------------------------------------- trainer
def _raw(seed):
    b = _batch(seed)
    return ({k: b[k] for k in ("video", "text", "video_padding_mask", "text_padding_mask")}
            | {"start": [list(r[r < 1e3]) for r in b["start"]],
               "end": [list(r[r > -1e3]) for r in b["end"]]})


@functools.lru_cache(maxsize=1)
def _trainer_params():
    """The trainers' starting weights, initialised once by the JAX model."""
    return _numpy_params(JaxAligner(**TINY), 5)["params"]


def _trainer(**kw):
    torch.manual_seed(0)
    tm = TemporalAligner(**dict(TINY, random_pos_start=1), device="cpu")
    load_tan_params(tm, {"params": _trainer_params()})
    cfg = ExperimentConfig(model="cotrain", learn_agreement=1, loss_threshold=0.7,
                           use_alignability_head=1, epochs=1, lr=1e-3, momentum_m=0.9,
                           print_freq=10, **kw)
    return TANTrainer(tm, cfg, iters_per_epoch=4, device="cpu")


def _states(tr):
    return (tr.params, tr.target_params, tr.opt_state.mu, tr.opt_state.nu,
            getattr(tr.opt_state, "acc_grads", {}))


@pytest.fixture(scope="module")
def trained():
    """4 steps of each trainer on the same batches."""
    raw = [_raw(80 + i) for i in range(4)]
    runs = {"k2_f4": dict(backprop_freq=2, fused_steps=4), "k2_f1": dict(backprop_freq=2),
            "chain": dict(fused_optimizer=False), "fused": dict()}
    out = {}
    for name, kw in runs.items():
        tr = _trainer(**kw)
        tr.train_epoch(raw, 0)
        out[name] = tr
    return out


def test_trainer_backprop_freq_fused_steps_equal_single_steps(trained):
    a, b = trained["k2_f4"], trained["k2_f1"]
    assert isinstance(a.tx, OptaxChain) and a.tx.every_k == 2 and a.fused_step is not None
    assert isinstance(a.opt_state, ChainState)
    assert a.iteration == b.iteration == 4 == a.opt_state.count == b.opt_state.count
    assert optimizer_state_dict(a.opt_state)["count"] == 2
    for x, y in zip(_states(a), _states(b)):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert not any(torch.equal(a.params[k], trained["fused"].params[k])
                   for k in ("binary_head.weight", "text_pre_proj.weight"))


def test_no_fused_optimizer_takes_the_chain_within_the_fused_tolerance(trained):
    chain, fused = trained["chain"], trained["fused"]
    assert isinstance(chain.tx, OptaxChain) and chain.tx.every_k == 1
    assert type(fused.tx) is FusedAdamWEMA
    for x, y in zip(_states(chain)[:4], _states(fused)[:4]):
        for k in y:
            np.testing.assert_allclose(x[k].numpy(), y[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    assert chain.opt_state.count == fused.opt_state.count == 4


def test_chain_checkpoint_resumes_exactly_and_adapts_across_layouts(trained, tmp_path):
    src = trained["k2_f1"]
    src.cfg.model_path = str(tmp_path)
    src.save_epoch(0)
    blob = torch.load(tmp_path / "epoch0.pth.tar", weights_only=True)
    assert set(blob["optimizer"]) == {"count", "mu", "nu", "mini_step", "acc_grads"}
    assert (blob["optimizer"]["count"], blob["optimizer"]["mini_step"]) == (2, 0)
    b = _trainer(backprop_freq=2)
    b.load_checkpoint(str(tmp_path / "epoch0.pth.tar"))
    assert b.opt_state.count == 4
    for x, y in zip(_states(src), _states(b)):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    # the layouts both ways: the inner count carried as it is (as the JAX
    # adapt_optimizer_state carries it), the accumulator dropped or fresh
    fused = trained["fused"].tx.init(src.params)
    assert adapt_optimizer_state(fused, optimizer_state_dict(src.opt_state)) is fused
    assert fused.count == 2 and torch.equal(fused.mu["binary_head.weight"],
                                            src.opt_state.mu["binary_head.weight"])
    k3 = make_optimizer(src.params, accumulate_steps=3).init(src.params)
    adapt_optimizer_state(k3, {"count": 5, "mu": src.opt_state.mu, "nu": src.opt_state.nu})
    assert (k3.count, optimizer_state_dict(k3)["count"], optimizer_state_dict(k3)["mini_step"]) \
        == (15, 5, 0)
    assert all(not v.any() for v in k3.acc_grads.values())
    partial = dict(optimizer_state_dict(src.opt_state), mini_step=1)
    adapt_optimizer_state(k3, partial)
    assert k3.count == 2 * 3 + 1
    assert torch.equal(k3.acc_grads["binary_head.weight"],
                       src.opt_state.acc_grads["binary_head.weight"])
    assert adapt_optimizer_state(k3, {"step": 3}) is None
