"""The carried compute-dtype casts of a replayed group, on the CPU.

Mirrors tests/test_optim_fused.py:324,406 (the JAX step with its
``CARRY_CAST`` on). A bfloat16 group of 2 steps (``scan_steps=2``) carries
the casts of the parameters (and of the EMA twin for TAN) from step to
step, written by the optimizer's pass (``parallel/train_step.py::
_CarriedCasts``); it must equal 2 eager single steps (``scan_steps=None``,
which cast the float32 masters each step) bit for bit (metrics, parameters,
twin, moments, accumulator), for the TAN step with an EMA twin that moves
(momentum 0.99) and one that stays (None), for the grounding step, and for
the TAN step under the optax chain with accumulation over 2 mini-batches.
The runner carries where the step casts: a float32 runner carries nothing.
Against the JAX step built with its switch on (TAN with the moving twin,
and grounding), on the same numpy-seeded weights and batches (Adam eps
1e-3, ``random_pos_start=0``, as tests/test_torch_train.py): the losses
within 1e-2 relative (bf16 products round apart in XLA and PyTorch;
readings 5e-3), the parameters within 1e-3 absolute (two lr-sized Adam
steps: a rounding may flip a gradient's sign; readings 5e-4).
"""

import jax
import numpy as np
import pytest
import torch

from exoground_tpu.losses.grounding import GroundingLossConfig as JaxGndLoss
from exoground_tpu.losses.milnce import TANLossConfig as JaxTanLoss
from exoground_tpu.models import TemporalAligner as JaxAligner
from exoground_tpu.models import ema_init as jax_ema_init
from exoground_tpu.models.grounding import ExoGroundingTransformer as JaxExo
from exoground_tpu.parallel import make_mesh, replicate, shard_batch
from exoground_tpu.parallel import train_step as jax_ts
from exoground_tpu.train.optim import FusedAdamWEMA as JaxFusedAdamWEMA
from exoground_tpu_torch.losses.grounding import GroundingLossConfig
from exoground_tpu_torch.losses.milnce import TANLossConfig
from exoground_tpu_torch.models import ExoGroundingTransformer, TemporalAligner, ema_init
from exoground_tpu_torch.parallel import make_grounding_train_step, make_tan_train_step
from exoground_tpu_torch.train import FusedAdamWEMA
from exoground_tpu_torch.train.optim import make_optimizer
from exoground_tpu_torch.utils.convert import (
    grounding_state_dict_from_jax,
    load_grounding_params,
    load_tan_params,
    tan_state_dict_from_jax,
)
from tests.test_torch_small import jax_params
from tests.torch_s3d_common import few_threads  # noqa: F401 (an autouse fixture)

B, T, N, D = 4, 16, 4, 32
C = 24
OPT = dict(lr=1e-3, weight_decay=1e-2, total_iterations=100, warmup_iterations=1, eps=1e-3)
TAN_MODEL = dict(num_encoder_layers=2, num_joint_layers=2, width=64, heads=4, max_pos=32,
                 random_pos_start=0)
GND_MODEL = dict(num_encoder_layers=1, num_decoder_layers=1, video_embed_dim=C,
                 text_embed_dim=C, feature_dim=32, random_pos_start=0)


def _tan_batch(seed):
    r = np.random.RandomState(seed)
    start = r.randint(0, T - 4, (B, N)).astype(np.float32)
    return {"video": r.randn(B, T, D).astype(np.float32),
            "text": r.randn(B, N, D).astype(np.float32),
            "video_padding_mask": np.zeros((B, T), bool),
            "text_padding_mask": np.zeros((B, N), bool),
            "start": start, "end": start + 3.0}


def _gnd_batch(seed):
    r = np.random.RandomState(seed)
    starts = r.rand(B, N).astype(np.float32) * 0.5
    return {"video_features": r.randn(B, 12, C).astype(np.float32),
            "narration_features": r.randn(B, N, C).astype(np.float32),
            "video_padding_mask": np.zeros((B, 12), bool),
            "narration_padding_mask": np.zeros((B, N), bool),
            "starts": starts, "ends": starts + 0.3, "mean": starts + 0.15,
            "duration": np.full((B, N), 0.3, np.float32)}


def _stack(batches):
    return {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}


def _tan_params():
    jm = JaxAligner(**TAN_MODEL, attn_impl="xla")
    b = _tan_batch(0)
    return jm, jax_params(jm, b["video"], b["text"], b["video_padding_mask"],
                          b["text_padding_mask"], seed=2)


def _gnd_params():
    jm = JaxExo(**GND_MODEL, attn_impl="xla")
    b = _gnd_batch(0)
    return jm, jax_params(jm, b["video_features"], b["narration_features"],
                          b["video_padding_mask"], b["narration_padding_mask"], seed=3)


def _build(kind, jparams, ema_momentum=0.99, compute_dtype="bfloat16", scan_steps=2,
           chain=False):
    """The port's step (the 2-step runner by default) with its parameters
    and optimizer (``FusedAdamWEMA``, or with ``chain`` the optax chain
    accumulating over 2 mini-batches)."""
    torch.manual_seed(0)
    if kind == "tan":
        tm = TemporalAligner(**TAN_MODEL, input_dim=D, device="cpu")
        load_tan_params(tm, {"params": jparams})
    else:
        tm = ExoGroundingTransformer(**GND_MODEL, device="cpu")
        load_grounding_params(tm, {"params": jparams})
    tm.train()
    p = {k: v.detach() for k, v in tm.named_parameters()}
    if chain:
        tx = make_optimizer(p, **{k: v for k, v in OPT.items() if k != "eps"},
                            accumulate_steps=2)
    else:
        tx = FusedAdamWEMA(p, **OPT)
    if kind == "tan":
        step = make_tan_train_step(tm, TANLossConfig(model="cotrain"), tx,
                                   ema_momentum=ema_momentum, compute_dtype=compute_dtype,
                                   scan_steps=scan_steps)
    else:
        step = make_grounding_train_step(tm, GroundingLossConfig(model="grounding"), tx,
                                         compute_dtype=compute_dtype, scan_steps=scan_steps)
    return step, p, tx


def _batches(kind):
    return [_tan_batch(31), _tan_batch(32)] if kind == "tan" else [_gnd_batch(41), _gnd_batch(42)]


def _port_group(kind, jparams, ema_momentum=0.99, grouped=True, chain=False):
    """The 2 bf16 steps of the port: one call of the 2-step runner
    (``grouped``) or 2 eager single steps; (step, metrics, params, twin,
    optimizer state)."""
    step, p, tx = _build(kind, jparams, ema_momentum, scan_steps=2 if grouped else None,
                         chain=chain)
    batches = _batches(kind)
    target = ema_init(p) if kind == "tan" else None
    o = tx.init(p)
    if grouped:
        p, target, o, ms = step(p, target, o, _stack(batches))
        return step, ms, p, target, o
    ms = []
    for b in batches:
        p, target, o, m = step(p, target, o, {k: torch.from_numpy(v) for k, v in b.items()})
        ms.append(m)
    return step, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}, p, target, o


def _jax_group(kind, jm, jparams, ema_momentum=0.99):
    """The JAX 2-step scan built with its ``CARRY_CAST`` on: (losses, params,
    twin)."""
    mesh = make_mesh(1)
    tx = JaxFusedAdamWEMA(jparams, **OPT)
    jax_ts.CARRY_CAST = True
    try:
        if kind == "tan":
            step = jax_ts.make_tan_train_step(jm, JaxTanLoss(model="cotrain"), tx, mesh,
                                              ema_momentum=ema_momentum,
                                              compute_dtype="bfloat16", scan_steps=2)
        else:
            step = jax_ts.make_grounding_train_step(jm, JaxGndLoss(model="grounding"), tx,
                                                    mesh, compute_dtype="bfloat16",
                                                    scan_steps=2)
    finally:
        jax_ts.CARRY_CAST = False
    if kind == "tan":
        batches = [_tan_batch(31), _tan_batch(32)]
        stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        p, t, _, ms = step(replicate(jparams, mesh), replicate(jax_ema_init(jparams), mesh),
                           replicate(tx.init(jparams), mesh),
                           shard_batch(stacked, mesh, dim=1), jax.random.PRNGKey(5))
        return np.asarray(ms["loss"]), jax.device_get(p), jax.device_get(t)
    batches = [_gnd_batch(41), _gnd_batch(42)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    p, _, ms = step(replicate(jparams, mesh), replicate(tx.init(jparams), mesh),
                    shard_batch(stacked, mesh, dim=1), jax.random.PRNGKey(7))
    return np.asarray(ms["loss"]), jax.device_get(p), None


# (kind, EMA momentum, held against the JAX step too, the optax chain)
CASES = {"tan_ema": ("tan", 0.99, True, False), "tan_frozen_twin": ("tan", None, False, False),
         "grounding": ("grounding", None, True, False),
         "tan_chain_accumulated": ("tan", 0.99, False, True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_carried_group_equals_eager_steps_and_the_jax_step(case):
    kind, ema, against_jax, chain = CASES[case]
    jm, jparams = _tan_params() if kind == "tan" else _gnd_params()
    on = _port_group(kind, jparams, ema, chain=chain)
    eager = _port_group(kind, jparams, ema, grouped=False, chain=chain)
    assert on[0].carry_casts and on[0].single._casts is not None
    for k in eager[1]:
        assert torch.equal(on[1][k], eager[1][k]), k
    trees = [(on[2], eager[2]), (on[4].mu, eager[4].mu), (on[4].nu, eager[4].nu)]
    if kind == "tan":
        trees.append((on[3], eager[3]))
    if chain:
        trees.append((on[4].acc_grads, eager[4].acc_grads))
    for a, b in trees:
        assert all(torch.equal(a[k], b[k]) for k in b)

    if not against_jax:
        return
    losses, jp, jt = _jax_group(kind, jm, jparams, ema)
    np.testing.assert_allclose(on[1]["loss"].numpy(), losses, rtol=1e-2)
    bridge = tan_state_dict_from_jax if kind == "tan" else grounding_state_dict_from_jax
    for name, want, got in (("params", jp, on[2]), ("twin", jt, on[3])):
        if want is None:
            continue
        for k, w in bridge({"params": want}).items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=1e-3,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("kind", ["tan", "grounding"])
def test_the_runner_carries_where_the_step_casts(kind):
    _, jparams = _tan_params() if kind == "tan" else _gnd_params()
    assert _build(kind, jparams)[0].carry_casts
    # float32 casts nothing
    assert not _build(kind, jparams, compute_dtype="float32")[0].carry_casts
