"""``--fused_steps``: the N-step train runner and what it rests on, on the CPU.

* The pos rows of a tensor start (``ops/pos_embed.py::pos_rows``) against
  the JAX ``slice_or_interpolate_pos_embed`` (``dynamic_slice_in_dim``) at
  the first, a middle and the last start, and one past the end (clamped),
  forward and the table's gradient: equal, each row picked or taking its
  gradient once.
* ``TemporalAligner`` with ``pos_starts`` from ``draw_pos_starts`` equals
  the forward that draws from the same generator, outputs and gradients.
* ``FusedAdamWEMA.scalars`` against the JAX step's lr and bias corrections
  (one float32 rounding); ``apply`` with them equals ``step``.
* ``make_tan_train_step(scan_steps=3)``: on the CPU the plain version,
  equal bit for bit to 3 single steps from the same generator, and against
  the JAX ``make_tan_train_step(scan_steps=3)`` at
  tests/test_torch_train.py's tolerances (metrics 1e-4 relative, first
  moments 1e-4 of their largest entry, parameters and EMA twin 2e-6).
* ``TANTrainer(fused_steps=2)``: a group and a tail step, a ragged group
  taking single steps; the parameters equal ``fused_steps=1``'s.
* ``_kernels.captured_launches`` / ``add_launches``: a capture's launches
  leave ``LAUNCHES`` as it was and count once a replay.

The CUDA graph itself runs only on the card: chip_smoke.py phase 5b holds
the replayed steps against eager ones there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exoground_tpu.losses.milnce import TANLossConfig as JaxLossConfig
from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.models import ema_init as jax_ema_init
from exoground_tpu.ops import pos_embed as jpos
from exoground_tpu.parallel import make_mesh, replicate, shard_batch
from exoground_tpu.parallel import make_tan_train_step as jax_make_step
from exoground_tpu.train.optim import FusedAdamWEMA as JaxFusedAdamWEMA
from exoground_tpu_torch.losses.milnce import TANLossConfig
from exoground_tpu_torch.models import TemporalAligner, ema_init
from exoground_tpu_torch.ops import _kernels
from exoground_tpu_torch.ops import pos_embed as tpos
from exoground_tpu_torch.parallel import make_tan_train_step
from exoground_tpu_torch.parallel.train_step import TanScanStep, TanTrainStep
from exoground_tpu_torch.train import ExperimentConfig, FusedAdamWEMA, TANTrainer
from exoground_tpu_torch.utils.convert import load_tan_params, tan_state_dict_from_jax
from tests.test_torch_train import LOSS, SMALL, _batch, _numpy_params

OPT = dict(lr=1e-3, weight_decay=1e-2, total_iterations=20, warmup_iterations=2)


# ------------------------------------------------------------- pos starts
@pytest.mark.parametrize("start", ["first", "middle", "last", "past_end"])
def test_pos_rows_match_jax_dynamic_slice(start):
    rng = np.random.RandomState(0)
    table = rng.randn(96, 16).astype(np.float32)
    ct = rng.randn(40, 16).astype(np.float32)
    s = {"first": 0, "middle": 23, "last": 56, "past_end": 80}[start]

    def jax_rows(t):
        return jpos.slice_or_interpolate_pos_embed(t, 40, start_idx=s)

    want = np.asarray(jax_rows(jnp.asarray(table)))
    want_grad = np.asarray(jax.grad(lambda t: (jax_rows(t) * ct).sum())(jnp.asarray(table)))
    t = torch.tensor(table, requires_grad=True)
    got = tpos.slice_or_interpolate_pos_embed(t, 40, start_idx=torch.tensor(s))
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(t.grad.numpy(), want_grad)
    if start != "past_end":  # the int slice (which does not clamp) gives the same rows
        np.testing.assert_array_equal(
            tpos.slice_or_interpolate_pos_embed(torch.from_numpy(table), 40, start_idx=s)
            .numpy(), want)


@pytest.mark.parametrize("text_pos", [0, 1])
def test_forward_with_drawn_starts_equals_generator_draws(text_pos):
    tm = TemporalAligner(**dict(SMALL, random_pos_start=1, use_text_pos_enc=text_pos),
                         device="cpu")
    b = _batch(7)
    args = [torch.from_numpy(b[k]) for k in ("video", "text", "video_padding_mask",
                                              "text_padding_mask")]
    starts = tm.draw_pos_starts(torch.Generator().manual_seed(5), 16, 5)
    assert starts.shape == (3 if text_pos else 2,) and starts.dtype == torch.int64
    outs, grads = [], []
    for kw in (dict(generator=torch.Generator().manual_seed(5)), dict(pos_starts=starts)):
        tm.zero_grad()
        out = tm(*args, deterministic=False, return_sim_volumes=False, **kw)
        sum(v.float().sum() for v in out.values()).backward()
        outs.append(out)
        grads.append({k: p.grad.clone() for k, p in tm.named_parameters()
                      if p.grad is not None})
    for k in outs[0]:
        torch.testing.assert_close(outs[1][k], outs[0][k], rtol=0, atol=0)
    assert set(grads[0]) == set(grads[1]) and "temporal_pos_embed" in grads[0]
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="draws"):
        tm(*args, deterministic=False, pos_starts=starts[:1])


# -------------------------------------------------------------- optimizer
def test_optimizer_scalars_match_jax_and_apply_equals_step():
    p = {"w": torch.randn(6, 4), "ln_1.bias": torch.randn(4)}
    opt = FusedAdamWEMA(p, **OPT)
    jopt = JaxFusedAdamWEMA({"w": jnp.zeros((6, 4)), "ln_1": {"bias": jnp.zeros(4)}}, **OPT)
    for count in range(6):
        c = jnp.asarray(count + 1, jnp.int32).astype(jnp.float32)
        want = [np.float32(jopt.schedule(jnp.asarray(count))),
                np.float32(1.0 - jopt.b1 ** c), np.float32(1.0 - jopt.b2 ** c)]
        np.testing.assert_allclose(opt.scalars(count), want, rtol=2e-7, atol=0)
    q = {k: v.clone() for k, v in p.items()}
    s1, s2 = opt.init(p), opt.init(q)
    t1, t2 = ema_init(p), ema_init(q)
    for i in range(3):
        g = {k: torch.randn_like(v) for k, v in p.items()}
        opt.step(p, s1, g, t1, 0.9)
        opt.apply(q, s2, g, torch.from_numpy(opt.scalars(s2.count)), t2, 0.9)
        s2.count += 1
    for a, b in ((p, q), (t1, t2), (s1.mu, s2.mu), (s1.nu, s2.nu)):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert s1.count == s2.count == 3


# ------------------------------------------------------------- the runner
def _port(seed, random_pos_start, scan_steps=None):
    torch.manual_seed(seed)  # the reference's unused `mlp` is not in the JAX params
    tm = TemporalAligner(**dict(SMALL, random_pos_start=random_pos_start), device="cpu")
    load_tan_params(tm, {"params": _numpy_params(JaxAligner(**SMALL), seed)["params"]})
    p = {k: v.detach() for k, v in tm.named_parameters()}
    tx = FusedAdamWEMA(p, eps=1e-3, **OPT)
    step = make_tan_train_step(tm, TANLossConfig(**LOSS), tx, ema_momentum=0.9,
                               scan_steps=scan_steps)
    return p, ema_init(p), tx.init(p), step


def _stack(batches):
    return {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}


def test_scan_steps_equals_single_steps_bit_for_bit():
    batches = [_batch(30 + i) for i in range(3)]
    p, t, o, step = _port(0, 1)
    gen = torch.Generator().manual_seed(11)
    singles = []
    for b in batches:
        p, t, o, m = step(p, t, o, {k: torch.from_numpy(v) for k, v in b.items()}, gen)
        singles.append(m)
    p2, t2, o2, scan = _port(0, 1, scan_steps=3)
    assert isinstance(scan, TanScanStep) and isinstance(scan.single, TanTrainStep)
    p2, t2, o2, ms = scan(p2, t2, o2, _stack(batches), torch.Generator().manual_seed(11))
    assert o2.count == o.count == 3
    assert set(ms) == set(singles[0]) and all(v.shape == (3,) for v in ms.values())
    for k in ms:
        assert torch.equal(ms[k], torch.stack([m[k] for m in singles])), k
    for a, b in ((p, p2), (t, t2), (o.mu, o2.mu), (o.nu, o2.nu)):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="leading axis"):
        scan(p2, t2, o2, _stack(batches[:2]))


def test_scan_steps_matches_the_jax_scan_step():
    batches = [_batch(40 + i) for i in range(3)]
    jm = JaxAligner(**SMALL, attn_impl="xla")
    jparams = _numpy_params(jm, 1)["params"]
    mesh = make_mesh(1)
    jtx = JaxFusedAdamWEMA(jparams, eps=1e-3, **OPT)
    jstep = jax_make_step(jm, JaxLossConfig(**LOSS), jtx, mesh, ema_momentum=0.9,
                          scan_steps=3)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    jp, jt, jo, jms = jstep(replicate(jax.tree_util.tree_map(jnp.copy, jparams), mesh),
                            replicate(jax_ema_init(jparams), mesh),
                            replicate(jtx.init(jparams), mesh),
                            shard_batch(stacked, mesh, dim=1), jax.random.PRNGKey(0))
    p, t, o, scan = _port(1, 0, scan_steps=3)
    p, t, o, ms = scan(p, t, o, _stack(batches))
    assert set(ms) == set(jms)
    for k in jms:
        np.testing.assert_allclose(ms[k].numpy(), np.asarray(jms[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    jmu = tan_state_dict_from_jax({"params": jax.device_get(jo.mu)})
    for k, want in jmu.items():
        scale = max(want.abs().max().item(), 1e-12)
        np.testing.assert_allclose(o.mu[k].numpy(), want.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=f"first moment {k}")
    for name, want, got in (("params", jp, p), ("ema", jt, t)):
        for k, w in tan_state_dict_from_jax({"params": jax.device_get(want)}).items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=2e-6,
                                       err_msg=f"{name} {k}")
    assert o.count == int(jo.count) == 3


# ------------------------------------------------------------- the trainer
def _raw(seed, n=5):
    b = _batch(seed, n=n)
    return ({k: b[k] for k in ("video", "text", "video_padding_mask", "text_padding_mask")}
            | {"start": [list(r[r < 1e3]) for r in b["start"]],
               "end": [list(r[r > -1e3]) for r in b["end"]]})


def _trainer(fused_steps):
    torch.manual_seed(0)
    tm = TemporalAligner(**dict(SMALL, random_pos_start=1), device="cpu")
    load_tan_params(tm, {"params": _numpy_params(JaxAligner(**SMALL), 2)["params"]})
    cfg = ExperimentConfig(model="cotrain", learn_agreement=1, loss_threshold=0.7,
                           use_alignability_head=1, epochs=1, lr=1e-3, momentum_m=0.9,
                           print_freq=10, fused_steps=fused_steps)
    return TANTrainer(tm, cfg, iters_per_epoch=3, device="cpu")


def test_trainer_fused_steps_groups_tails_and_ragged_groups(monkeypatch):
    """3 batches at fused_steps 2: one group of 2 and a single tail step;
    then a group whose text buckets differ (it does not stack) takes single
    steps, and so does the tail (the JAX tests/test_train.py:277-300). The
    parameters follow fused_steps 1's exactly."""
    calls = []
    real = TanScanStep.__call__
    monkeypatch.setattr(TanScanStep, "__call__",
                        lambda self, *a: calls.append(a[3]["video"].shape[0]) or real(self, *a))
    fused, plain = _trainer(2), _trainer(1)
    assert fused.fused_step is not None and fused.step is fused.fused_step.single
    assert plain.fused_step is None
    epochs = ([_raw(50 + i) for i in range(3)],
              [_raw(60, n=6), _raw(61)] + [_raw(62 + i) for i in range(3)])
    for epoch, raw in enumerate(epochs):
        losses = [tr.train_epoch(raw, epoch) for tr in (fused, plain)]
        assert np.isfinite(losses[0]) and losses[0] == losses[1]
    assert calls == [2, 2]  # the first epoch's group, the second epoch's stacking pair
    assert fused.iteration == plain.iteration == 8 == fused.opt_state.count
    assert [s["steps"] for s in fused.epoch_stats] == [3, 5]
    assert len(fused.epoch_stats[0]["data_s"]) == 3
    for a, b in ((fused.params, plain.params), (fused.target_params, plain.target_params),
                 (fused.opt_state.mu, plain.opt_state.mu)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_captured_launches_count_once_per_replay():
    _kernels.reset_launches()
    _kernels.LAUNCHES["milnce_grid_fwd"] = 3
    with _kernels.captured_launches() as counts:
        _kernels.LAUNCHES["milnce_grid_fwd"] += 2  # what wrappers do while capturing
        _kernels.LAUNCHES["flash_fwd"] += 24
    assert counts == {"milnce_grid_fwd": 2, "flash_fwd": 24}
    assert _kernels.LAUNCHES["milnce_grid_fwd"] == 3 and _kernels.LAUNCHES["flash_fwd"] == 0
    for _ in range(2):
        _kernels.add_launches(counts)
    assert _kernels.LAUNCHES["milnce_grid_fwd"] == 7 and _kernels.LAUNCHES["flash_fwd"] == 48
    _kernels.reset_launches()
