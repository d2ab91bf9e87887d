"""The port's train slice against the JAX package: optimizer, EMA, the TAN
train step and the trainer, on the CPU.

Weights and batches are drawn from numpy seeds in the JAX layout and reach
the port through its weight bridge. The JAX step runs on a one-device mesh
as its own tests run it. Tolerances: optimizer trajectories at 2e-6
relative (the JAX package's own fused-vs-optax test); train steps:
metrics at 1e-4 relative, first moments (the grads) at 1e-4 of their
largest entry, updated parameters and EMA twin at 2e-6 absolute (one
hundredth of the learning-rate step). The step comparison runs Adam with
eps = 1e-3: entries whose exact grad is zero (the key bias of softmax
attention) carry float-noise grads of ~1e-9 in both frameworks, which
eps = 1e-8 would turn into lr-sized, noise-signed updates.
"""

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
from exoground_tpu.train.optim import FusedAdamWEMA as JaxFusedAdamWEMA
from exoground_tpu.train.optim import make_fused_optimizer as jax_make_fused
from exoground_tpu.train.optim import warmup_cosine_schedule as jax_schedule
from exoground_tpu_torch.losses.milnce import TANLossConfig
from exoground_tpu_torch.models import TemporalAligner, ema_init, ema_update
from exoground_tpu_torch.ops import _kernels
from exoground_tpu_torch.ops import attention as attn_mod
from exoground_tpu_torch.ops import blocks
from exoground_tpu_torch.ops.fused_mlp import disable_fused_kernels, fused_kernels_disabled
from exoground_tpu_torch.parallel import make_tan_train_step
from exoground_tpu_torch.train import (
    ExperimentConfig,
    FusedAdamWEMA,
    TANTrainer,
    make_fused_optimizer,
    warmup_cosine_schedule,
    weight_decay_mask,
)
from exoground_tpu_torch.utils.convert import (
    UNUSED_REFERENCE_KEYS,
    load_tan_params,
    tan_state_dict_from_jax,
)

SMALL = dict(num_encoder_layers=2, num_joint_layers=2, width=128, heads=4, input_dim=48,
             max_pos=256, use_alignability_head=1, random_pos_start=0)


# ---------------------------------------------------------------- optimizer
def _tree(seed=0):
    r = np.random.RandomState(seed)
    return {
        "proj": {"kernel": r.randn(8, 16).astype(np.float32),
                 "bias": r.randn(16).astype(np.float32)},
        "ln_1": {"scale": r.randn(16).astype(np.float32)},
        "binary_head": {"kernel": r.randn(16, 2).astype(np.float32)},
        "s3d": {"conv": {"kernel": r.randn(3, 3, 4).astype(np.float32)}},
        "logit_scale": np.float32(r.randn()),
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        *parents, leaf = k.split(".")
        node = out
        for q in parents:
            node = node.setdefault(q, {})
        node[leaf] = v
    return out


OPT_CASES = {
    "default": (dict(), None),
    "ema": (dict(), 0.9),
    "bce_policy": (dict(policy="bce"), None),
    "per_param_clip": (dict(grad_clip=0.5), 0.9),
    "no_weight_decay": (dict(weight_decay=0.0), 0.9),
    "bf16_moments": (dict(moment_dtype="bfloat16"), 0.9),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_fused_adamw_ema_matches_jax(case):
    kw, mom = OPT_CASES[case]
    opt_kw = {**dict(lr=1e-3, weight_decay=1e-2, total_iterations=50, warmup_iterations=2),
              **kw}
    tree = _tree()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jopt = jax_make_fused(jp, **opt_kw)
    jo, jt = jopt.init(jp), jax.tree_util.tree_map(jnp.copy, jp)
    flat = _flat(tree)
    p = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    opt = make_fused_optimizer(p, **opt_kw)
    o, t = opt.init(p), ema_init(p)
    for i in range(3):
        rng = np.random.RandomState(100 + i)
        g = {k: np.asarray(rng.randn(*v.shape), np.float32) for k, v in sorted(flat.items())}
        jg = _unflat(g)
        jp, jo, jt = jopt.step(jp, jo, jax.tree_util.tree_map(jnp.asarray, jg), jt, mom)
        p, o, t = opt.step(p, o, {k: torch.from_numpy(v) for k, v in g.items()}, t, mom)
    for name, want in (("params", jp), ("target", jt), ("mu", jo.mu), ("nu", jo.nu)):
        got = {"params": p, "target": t, "mu": o.mu, "nu": o.nu}[name]
        for k, w in _flat(jax.tree_util.tree_map(np.asarray, want)).items():
            np.testing.assert_allclose(got[k].float().numpy(), w, rtol=2e-6, atol=1e-7,
                                       err_msg=f"{name} {k}")
    assert o.count == int(jo.count) == 3
    if kw.get("moment_dtype") == "bfloat16":
        assert all(v.dtype == torch.bfloat16 for v in o.mu.values())
    if kw.get("policy") == "bce":
        np.testing.assert_array_equal(p["proj.kernel"].numpy(), flat["proj.kernel"])


def test_warmup_first_step_is_zero_lr_and_schedule_matches_jax():
    p = {k: torch.from_numpy(v.copy()) for k, v in _flat(_tree()).items()}
    before = {k: v.clone() for k, v in p.items()}
    opt = make_fused_optimizer(p, lr=1e-3, total_iterations=50, warmup_iterations=10)
    g = {k: torch.ones_like(v) for k, v in p.items()}
    p, o, _ = opt.step(p, opt.init(p), g)
    for k in p:
        torch.testing.assert_close(p[k], before[k], rtol=0, atol=0)
    assert o.count == 1
    ours, theirs = warmup_cosine_schedule(1e-3, 50, 10), jax_schedule(1e-3, 50, 10)
    for step in (0, 1, 9, 10, 11, 30, 49, 50):
        np.testing.assert_allclose(ours(step), float(theirs(jnp.int32(step))), rtol=1e-6)


def test_weight_decay_mask_on_the_port_names():
    m = TemporalAligner(**SMALL, device="cpu")
    mask = weight_decay_mask(dict(m.named_parameters()))
    assert mask["video_temporal_encoder.resblocks.0.attn.in_proj_weight"]
    assert mask["temporal_pos_embed"] and mask["binary_head.weight"]
    assert not mask["video_temporal_encoder.resblocks.0.attn.in_proj_bias"]
    assert not mask["joint_temporal_encoder.resblocks.1.ln_2.weight"]
    assert not mask["ln_text_init.bias"] and not mask["binary_head.bias"]


def test_ema_update_in_place():
    rng = np.random.RandomState(0)
    online = {"a": torch.from_numpy(rng.randn(4, 3).astype(np.float32))}
    target = ema_init(online)
    assert target["a"].data_ptr() != online["a"].data_ptr()
    online["a"] += 1.0
    ptr = target["a"].data_ptr()
    ema_update(target, online, 0.9)
    assert target["a"].data_ptr() == ptr
    np.testing.assert_allclose(target["a"].numpy(), online["a"].numpy() - 0.9, rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------------- train step
def _numpy_params(model, seed):
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 48)), jnp.zeros((1, 2, 48)),
        jnp.zeros((1, 8), bool), jnp.zeros((1, 2), bool))
    rng = np.random.RandomState(seed)

    def draw(path, sd):
        name = jax.tree_util.keystr(path)
        a = rng.standard_normal(sd.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.05 * a
        return a * (0.02 if len(sd.shape) == 1 or "pos_embed" in name
                    else sd.shape[0] ** -0.5)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(seed, b=4, t=16, n=5, dim=48):
    rng = np.random.RandomState(seed)
    start = rng.randint(0, t - 4, (b, n)).astype(np.float32)
    end = start + rng.randint(2, 5, (b, n))
    tp = np.zeros((b, n), bool)
    tp[0, -1] = True
    start[tp], end[tp] = 1e4, -1e4
    vp = np.zeros((b, t), bool)
    vp[1, -3:] = True
    return {"video": rng.randn(b, t, dim).astype(np.float32),
            "text": rng.randn(b, n, dim).astype(np.float32),
            "video_padding_mask": vp, "text_padding_mask": tp, "start": start, "end": end,
            "abs_text_pos": np.stack([start / t, end / t], -1).astype(np.float32)}


LOSS = dict(model="cotrain", learn_agreement=True, temporal_agreement_type="keep",
            loss_threshold=0.5, use_alignability_head=True)


@pytest.fixture(scope="module")
def three_steps():
    """The JAX step and the port's, 3 steps from the same weights and
    batches; the metrics, parameters and EMA twin after steps 1 and 3."""
    jm = JaxAligner(**SMALL, attn_impl="xla")
    jparams = _numpy_params(jm, 0)["params"]
    opt_kw = dict(lr=1e-3, weight_decay=1e-2, total_iterations=20, warmup_iterations=0)
    mesh = make_mesh(1)
    jtx = JaxFusedAdamWEMA(jparams, eps=1e-3, **opt_kw)
    jstep = jax_make_step(jm, JaxLossConfig(**LOSS), jtx, mesh, ema_momentum=0.9)
    jp = replicate(jax.tree_util.tree_map(jnp.copy, jparams), mesh)
    jt = replicate(jax_ema_init(jparams), mesh)
    jo = replicate(jtx.init(jparams), mesh)

    tm = TemporalAligner(**SMALL, device="cpu")
    load_tan_params(tm, {"params": jparams})
    p = {k: v.detach() for k, v in tm.named_parameters()}
    tx = FusedAdamWEMA(p, eps=1e-3, **opt_kw)
    step = make_tan_train_step(tm, TANLossConfig(**LOSS), tx, ema_momentum=0.9)
    t, o = ema_init(p), tx.init(p)
    gen = torch.Generator().manual_seed(0)
    record = {}
    for i in range(3):
        b = _batch(10 + i)
        jp, jt, jo, jmet = jstep(jp, jt, jo, shard_batch(b, mesh), jax.random.PRNGKey(i))
        p, t, o, met = step(p, t, o, {k: torch.from_numpy(v) for k, v in b.items()}, gen)
        if i in (0, 2):
            record[i + 1] = dict(
                jax=({k: float(v) for k, v in jmet.items()},
                     tan_state_dict_from_jax({"params": jax.device_get(jp)}),
                     tan_state_dict_from_jax({"params": jax.device_get(jt)}),
                     tan_state_dict_from_jax({"params": jax.device_get(jo.mu)})),
                port=({k: float(v) for k, v in met.items()},
                      {k: v.clone() for k, v in p.items()},
                      {k: v.clone() for k, v in t.items()},
                      {k: v.clone() for k, v in o.mu.items()}))
    return record


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_jax(three_steps, n_steps):
    (jmet, jp, jt, jmu), (met, p, t, mu) = (three_steps[n_steps]["jax"],
                                            three_steps[n_steps]["port"])
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


def test_train_step_bf16_compute_keeps_f32_masters():
    tm = TemporalAligner(**SMALL, device="cpu")
    load_tan_params(tm, {"params": _numpy_params(JaxAligner(**SMALL), 1)["params"]})
    p = {k: v.detach() for k, v in tm.named_parameters()}
    tx = make_fused_optimizer(p, lr=1e-3, total_iterations=10, warmup_iterations=0)
    step = make_tan_train_step(tm, TANLossConfig(**LOSS), tx, ema_momentum=0.9,
                               compute_dtype="bfloat16")
    b = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    before = {k: v.clone() for k, v in p.items()}
    met, grads = step.loss_and_grads(p, ema_init(p), b)
    assert np.isfinite(float(met["loss"]))
    assert all(g.dtype == torch.float32 for g in grads.values() if g is not None)
    p, t, o, met = step(p, ema_init(p), tx.init(p), b)
    assert all(v.dtype == torch.float32 for v in p.values())
    assert not torch.equal(p["binary_head.weight"], before["binary_head.weight"])
    f32 = make_tan_train_step(tm, TANLossConfig(**LOSS), tx, ema_momentum=0.9)
    met32, _ = f32.loss_and_grads(before, ema_init(before), b)
    np.testing.assert_allclose(float(step.loss_and_grads(before, ema_init(before), b)[0]["loss"]),
                               float(met32["loss"]), rtol=5e-2)


def test_volume_mode_step_matches_feature_mode():
    tm = TemporalAligner(**SMALL, device="cpu")
    load_tan_params(tm, {"params": _numpy_params(JaxAligner(**SMALL), 2)["params"]})
    p = {k: v.detach() for k, v in tm.named_parameters()}
    tx = make_fused_optimizer(p, lr=1e-3, total_iterations=10)
    b = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    out = {}
    for fused in (True, False):
        step = make_tan_train_step(tm, TANLossConfig(**LOSS), tx, ema_momentum=0.9,
                                   fused_grid=fused)
        out[fused] = step.loss_and_grads(p, ema_init(p), b)
    for k in out[True][0]:
        np.testing.assert_allclose(float(out[False][0][k]), float(out[True][0][k]),
                                   rtol=3e-5, atol=1e-6, err_msg=k)
    for k, g in out[True][1].items():
        if g is not None:
            np.testing.assert_allclose(out[False][1][k].numpy(), g.numpy(), rtol=1e-3,
                                       atol=1e-6 * max(1.0, g.abs().max().item()), err_msg=k)


def test_step_options_of_later_slices_raise():
    tm = TemporalAligner(**SMALL, device="cpu")
    p = {k: v.detach() for k, v in tm.named_parameters()}
    tx = make_fused_optimizer(p)
    with pytest.raises(NotImplementedError, match="later slice"):
        make_tan_train_step(tm, TANLossConfig(), tx, gather_negatives=True)


# ------------------------------------------------------------------ model
def test_training_forward_outputs_and_autograd():
    tm = TemporalAligner(**dict(SMALL, random_pos_start=1), device="cpu")
    b = _batch(5)
    arrays = [torch.from_numpy(b[k]) for k in ("video", "text", "video_padding_mask",
                                                "text_padding_mask")]
    gen = torch.Generator().manual_seed(3)
    out = tm(*arrays, deterministic=False, return_sim_volumes=False, generator=gen)
    keys = {"dual_feature_video", "dual_feature_text", "joint_feature_video",
            "joint_feature_text", "dual_logits_alignability", "joint_logits_alignability"}
    assert set(out) == keys
    sum(v.float().sum() for v in out.values()).backward()
    assert tm.binary_head.weight.grad is not None
    assert tm.video_temporal_encoder.resblocks[0].mlp.c_fc.weight.grad is not None


def test_random_pos_start_draws_once_per_slice(monkeypatch):
    from exoground_tpu_torch.models import aligner

    draws = []
    real = aligner.random_pos_start

    def counting(generator, seq_len):
        s = real(generator, seq_len)
        draws.append((s, seq_len))
        return s

    monkeypatch.setattr(aligner, "random_pos_start", counting)
    tm = TemporalAligner(**dict(SMALL, random_pos_start=1, use_text_pos_enc=1), device="cpu")
    b = _batch(6, t=16, n=5)
    arrays = [torch.from_numpy(b[k]) for k in ("video", "text", "video_padding_mask",
                                                "text_padding_mask")]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for _ in range(20):
            tm(*arrays, deterministic=False, return_sim_volumes=False, generator=gen)
        tm(*arrays, deterministic=True, return_sim_volumes=False)
    # video (dual), text, video (joint): one draw each, none when deterministic
    assert len(draws) == 60
    assert all(0 <= s < n // 2 for s, n in draws)
    assert {n for _, n in draws} == {16, 5}
    assert len({s for s, n in draws if n == 16}) > 1


def test_bridge_carries_the_binary_head():
    params = _numpy_params(JaxAligner(**SMALL), 3)["params"]
    sd = tan_state_dict_from_jax({"params": params})
    np.testing.assert_array_equal(sd["binary_head.weight"].numpy(),
                                  np.asarray(params["binary_head"]["kernel"]).T)
    np.testing.assert_array_equal(sd["binary_head.bias"].numpy(),
                                  np.asarray(params["binary_head"]["bias"]))


# ------------------------------------------------- fused-kernel off switch
def test_disable_fused_kernels_routes_to_plain(monkeypatch):
    calls = []
    monkeypatch.setattr(blocks, "fused_mlp", lambda *a: calls.append("mlp") or blocks.mlp_plain(*a))
    monkeypatch.setattr(attn_mod, "fused_mha",
                        lambda *a: calls.append("mha") or attn_mod.mha_plain(*a))
    block = blocks.ResidualAttentionBlock(128, 4)
    x = torch.randn(2, 8, 128)
    with torch.no_grad():
        block(x)
        assert sorted(calls) == ["mha", "mlp"]
        calls.clear()
        assert not fused_kernels_disabled()
        with disable_fused_kernels():
            assert fused_kernels_disabled()
            with disable_fused_kernels():
                pass
            assert fused_kernels_disabled()  # nested exit restores the outer state
            block(x)
        assert not fused_kernels_disabled()
    assert calls == []
    # the switch leaves an explicit impl='flash' on the flash route, as in JAX
    real_flash = attn_mod.flash_attention
    monkeypatch.setattr(attn_mod, "flash_attention",
                        lambda *a: calls.append("flash") or real_flash(*a))
    with torch.no_grad(), disable_fused_kernels():
        block(x, impl="flash")
    assert calls == ["flash"]


def test_cuda_guard_still_applies_outside_the_context():
    """Outside the context a CUDA input that requires grad raises in the
    kernel wrappers (there is no card here: the guard's predicate)."""
    w = torch.randn(4, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        _kernels.check_inference("fused_mlp", torch.randn(4, 4), w)
    with torch.no_grad():
        _kernels.check_inference("fused_mlp", torch.randn(4, 4), w)
    with disable_fused_kernels():
        with pytest.raises(RuntimeError, match="disable_fused_kernels"):
            _kernels.check_inference("fused_mha", w)


# ---------------------------------------------------------------- trainer
def test_tan_trainer_train_epoch_end_to_end():
    tm = TemporalAligner(**dict(SMALL, random_pos_start=1), device="cpu")
    cfg = ExperimentConfig(model="cotrain", learn_agreement=1, loss_threshold=0.7,
                           use_alignability_head=1, epochs=2, lr=1e-3, momentum_m=0.9,
                           print_freq=10)
    trainer = TANTrainer(tm, cfg, iters_per_epoch=3, device="cpu")
    t0 = trainer.target_params["binary_head.weight"].clone()
    p0 = tm.binary_head.weight.detach().clone()
    raw = []
    for i in range(3):
        b = _batch(20 + i)
        raw.append({k: b[k] for k in ("video", "text", "video_padding_mask",
                                      "text_padding_mask")}
                   | {"start": [list(r[r < 1e3]) for r in b["start"]],
                      "end": [list(r[r > -1e3]) for r in b["end"]]})
    loss = trainer.fit(raw)
    assert np.isfinite(loss)
    assert trainer.iteration == 6
    assert not torch.equal(tm.binary_head.weight, p0)  # the module's own weights moved
    assert not torch.equal(trainer.target_params["binary_head.weight"], t0)  # EMA moved
    with pytest.raises(NotImplementedError):  # gradient accumulation: a later slice
        TANTrainer(tm, ExperimentConfig(model="init", backprop_freq=2), device="cpu")
