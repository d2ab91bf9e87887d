"""The JAX side of the S3D finetune tests (tests/test_torch_s3d.py,
tests/test_torch_s3d_train.py): the JAX trees by the port's names and
layout, the JAX step run once (in float32, or in float64 throughout), and
the holds of a train_bn step."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exoground_tpu.parallel.train_step as jax_train_step

from exoground_tpu.models.s3d import S3D as JaxS3D
from exoground_tpu.parallel import make_mesh, replicate, shard_batch
from exoground_tpu.parallel.train_step import make_s3d_nce_step as jax_make_step
from exoground_tpu.train.optim import FusedAdamWEMA as JaxFused
from exoground_tpu.train.optim import make_optimizer as jax_chain
from exoground_tpu_torch.models.s3d import EARLY
from tests.torch_s3d_common import D, EPS, OPT


def _leaf_name(k: str) -> str:
    return {"kernel": "weight", "scale": "weight", "mean": "running_mean",
            "var": "running_var", "word_embd": "word_embd.weight"}.get(k, k)


def named(tree, prefix=""):
    """A JAX tree's leaves by the port's names, as they are (no transpose)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(named(v, f"{prefix}{k}."))
        else:
            out[prefix + _leaf_name(k)] = v
    return out


def torch_layout(name: str, a) -> torch.Tensor:
    """A JAX leaf in the port's layout, by numpy (conv kernels (kT, kH, kW,
    I, O) -> (O, I, kT, kH, kW), Dense kernels transposed)."""
    a = np.asarray(a, np.float64 if np.asarray(a).dtype == np.float64 else np.float32)
    if a.ndim == 5:
        a = np.transpose(a, (4, 3, 0, 1, 2))
    elif a.ndim == 2 and not name.endswith("word_embd.weight"):
        a = a.T
    return torch.from_numpy(np.array(a))


def port_tree(tree):
    return {k: torch_layout(k, v) for k, v in named(jax.device_get(tree)).items()}


def rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


class _Float64Step:
    """The JAX step module's ``jnp`` with ``float32`` read as ``float64``:
    under ``jax.enable_x64`` the step's embeddings, loss and new stats stay
    float64 (the package casts them to float32 for its float32 and bfloat16
    routes)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def _precision(x64: bool):
    if not x64:
        yield
        return
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train_step, "jnp", _Float64Step())
        yield


def jax_run(jv, jt, batch, fused, train_bn, scan=None, world=1, gather=False, x64=False):
    """The JAX step (fused optimizer with Adam eps ``EPS``, or the optax
    chain; the backbone LR group) from the converted weights over a
    ``world``-device mesh: metrics, parameters, first moments and stats by
    the port's names, and the raw trees. ``x64``: the weights, clips and
    the whole step in float64 (the fused optimizer's moments stay
    float32)."""
    with _precision(x64):
        if x64:
            jv, jt = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), (jv, jt))
        jp = {"s3d": jv["params"], "text": jt}
        tx = JaxFused(jp, eps=EPS, **OPT) if fused else jax_chain(jp, **OPT)
        mesh = make_mesh(world)
        step = jax_make_step(JaxS3D(num_classes=D), tx, mesh, freeze_early=True,
                             train_bn=train_bn, gather_negatives=gather, scan_steps=scan,
                             compute_dtype="float64" if x64 else "float32")
        p, bs, o, m = step(replicate(jp, mesh), replicate(jv["batch_stats"], mesh),
                           replicate(tx.init(jp), mesh),
                           shard_batch(batch, mesh, dim=0 if scan is None else 1),
                           jax.random.PRNGKey(0))
    adam = o if fused else o[0][0]
    return dict(metrics={k: np.asarray(v) for k, v in m.items()}, params=port_tree(p),
                mu=port_tree(adam.mu), stats=port_tree(bs), opt=jax.device_get(o),
                tree=jax.device_get(p), bs=jax.device_get(bs))


def heads(k: str) -> bool:
    return k.startswith(("text.", "s3d.fc."))


def _zero_grads(got_mu, want):
    """The frozen early blocks' and the word embedding's grads exactly 0 on
    both sides; the names of the rest."""
    zero = [k for k in want["mu"] if k.split(".")[1] in EARLY or k == "text.word_embd.weight"]
    assert len(zero) > 50
    for k in zero:
        assert float(got_mu[k].abs().max()) == 0.0 and float(want["mu"][k].abs().max()) == 0.0
    return [k for k in want["mu"] if k not in zero]


def hold_float64_step(got_m, got_params, got_mu, got_stats, want):
    """A train_bn step in float64 on both sides, the semantics: the stats
    1e-9 of each tensor's max; the metrics 3e-7 relative, the grads (first
    moments) and the parameters after the step 3e-7 of the largest, a few
    float32 roundings (the port's grads and metrics and either fused
    optimizer's moments are float32); the zero grads exactly 0."""
    for k, w in want["metrics"].items():
        assert abs(float(got_m[k]) - float(w)) <= 3e-7 * max(abs(float(w)), 1e-3), k
    for k, w in want["stats"].items():
        assert w.dtype == got_stats[k].dtype == torch.float64
        assert rel(got_stats[k], w) <= 1e-9, k
    for name, got in (("mu", got_mu), ("params", got_params)):
        top = max(float(w.abs().max()) for w in want[name].values())
        err = max(float((got[k].double() - w.double()).abs().max()) for k, w in want[name].items())
        assert err <= 3e-7 * top, (name, err / top)
    assert len(_zero_grads(got_mu, want)) > 100


def hold_train_bn_step(got_m, got_mu, got_stats, want):
    """A train_bn step in float32, the rounding check (the semantics are
    held in float64, ``hold_float64_step``): loss and metrics 1e-5
    relative, stats 1e-4 of each tensor's max, the heads' grads (text
    module, fc) 1e-3 of their max (the embeddings they read carry the
    trunk's float32 spread, ~2e-4 at these sizes), the frozen early blocks'
    and the word embedding's grads exactly 0 on both sides, the trunk's
    grads in the same direction (cosine 0.999)."""
    for k, w in want["metrics"].items():
        assert abs(float(got_m[k]) - float(w)) <= 1e-5 * max(abs(float(w)), 1e-3), k
    for k, w in want["stats"].items():
        assert rel(got_stats[k], w) <= 1e-4, k
    hk = [k for k in want["mu"] if heads(k)]
    hmax = max(float(want["mu"][k].abs().max()) for k in hk)
    assert max(float((got_mu[k] - want["mu"][k]).abs().max()) for k in hk) <= 1e-3 * hmax
    trunk = [k for k in _zero_grads(got_mu, want) if not heads(k)]
    a = torch.cat([got_mu[k].reshape(-1).double() for k in trunk])
    b = torch.cat([want["mu"][k].reshape(-1).double() for k in trunk])
    assert float(a @ b / (a.norm() * b.norm())) >= 0.999
