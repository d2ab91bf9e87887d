"""Shared weights, clips and rank side of the S3D finetune tests
(tests/test_torch_s3d.py, tests/test_torch_s3d_train.py).

The S3D-G trunk's widths are fixed by its architecture, so the tests shrink
the clips instead (4-8 frames of 40-48 px) and the joint embedding (``D``).
Weights are the seeded MIL-NCE-layout state of ``tools/synth_htm_aa.py``,
which reaches the JAX package through its own ``convert_s3d_state_dict``
and the port through the port's. Clips are uint8 with a brightness of their
own each: under ``train_bn`` a BN channel normalizes over a handful of
positions at these sizes, and clips that differ keep its batch moments from
being a common offset, whose float32 cancellation both packages amplify
(the tests say where they compare in float64 instead).

This module imports no JAX: the spawned gloo ranks import it.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from exoground_tpu_torch.models.s3d import S3D
from exoground_tpu_torch.parallel import make_mesh, make_s3d_nce_step, shard_batch
from exoground_tpu_torch.parallel.mesh import launch_env
from exoground_tpu_torch.tools.synth_htm_aa import s3d_reference_state, text_module_state
from exoground_tpu_torch.train import FusedAdamWEMA, make_optimizer
from exoground_tpu_torch.utils.convert import (
    convert_s3d_state_dict,
    convert_sentence_embedding_from_s3d,
)

D = 32  # the joint embedding's width here (MIL-NCE's is 512)
TEXT = dict(vocab=50, embed_dim=12, hidden=24, out_dim=D)
# the optimizer of the step comparisons: a backbone LR group, no warmup
# (step 0 moves the parameters), Adam's eps 1e-3 where parameters are
# compared (entries whose exact grad is 0 carry float-noise grads that eps
# 1e-8 would turn into lr-sized updates of either sign)
OPT = dict(lr=1e-3, weight_decay=1e-2, total_iterations=20, warmup_iterations=0,
           backbone_lr=3e-4)
EPS = 1e-3


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while a module of these tests runs: the suite
    runs several workers on the host's cores, and S3D's 3-D convolutions on
    every core of every worker oversubscribe them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def reference_states(seed: int = 0):
    """(trunk, text module) in the MIL-NCE layout, numpy float32."""
    return s3d_reference_state(D, seed), text_module_state(**TEXT, seed=seed)


def port_state(seed: int = 0):
    """(model, params, batch_stats) of the port on the CPU: parameters
    ``s3d.*`` (the model's own) and ``text.*``."""
    trunk, text = reference_states(seed)
    conv = convert_s3d_state_dict(trunk)
    model = S3D(D, device="cpu")
    model.load_state_dict(conv["params"])
    params = {f"s3d.{k}": p.detach() for k, p in model.named_parameters()}
    params.update({f"text.{k}": v.clone() for k, v in
                   convert_sentence_embedding_from_s3d(text).items()})
    return model, params, {k: v.clone() for k, v in conv["batch_stats"].items()}


def clips(seed: int, shape, dtype=np.uint8) -> np.ndarray:
    """(B, n, T, H, W, 3) clips, each at a brightness of its own; uint8, or
    float32 in [0, 1] (the same values / 255)."""
    rng = np.random.RandomState(seed)
    scale = rng.uniform(0.2, 1.0, shape[:2] + (1,) * (len(shape) - 2))
    u8 = (rng.randint(0, 256, shape) * scale).astype(np.uint8)
    return u8 if dtype == np.uint8 else u8.astype(np.float32) / np.float32(255)


def tokens(seed: int, b: int, length: int = 6) -> np.ndarray:
    """(B, L) ids with some padding (0) and out-of-vocabulary zeros."""
    return np.random.RandomState(seed).randint(0, TEXT["vocab"] + 1, (b, length)).astype(
        np.int32)


def port_optimizer(params, fused: bool):
    if fused:
        return FusedAdamWEMA(params, eps=EPS, **OPT)
    return make_optimizer(params, **OPT)


def rank_step(rank, world, port, batch, fused, out_dir, dtypes=("float32",)):
    """Rank ``rank`` of a ``world``-rank gloo group: one S3D step (train_bn,
    freeze_early, gathered negatives; the fused optimizer or the chain) on
    its block of the global ``batch`` for each of ``dtypes`` (the weights,
    stats, clips and compute in it), from the same state each time; its
    metrics, parameters, moments and stats saved to
    ``out_dir/rank<r>_<dtype>.pt``."""
    os.environ.update(launch_env(rank, world, port))
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    try:
        mesh = make_mesh(world)
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            model, params, stats = port_state()
            model.to(dt)
            params = {k: v.to(dt) for k, v in params.items()}
            params.update({f"s3d.{k}": p.detach() for k, p in model.named_parameters()})
            stats = {k: v.to(dt) for k, v in stats.items()}
            tx = port_optimizer(params, fused)
            o = tx.init(params)
            step = make_s3d_nce_step(model, tx, mesh=mesh, freeze_early=True,
                                     gather_negatives=True, train_bn=True, compute_dtype=dtype)
            local = {k: torch.from_numpy(v) for k, v in shard_batch(batch, mesh).items()}
            local["video"] = local["video"].to(dt)
            _, _, o, m = step(params, stats, o, local)
            torch.save({"metrics": {k: float(v) for k, v in m.items()}, "params": params,
                        "mu": o.mu, "stats": stats},
                       os.path.join(out_dir, f"rank{rank}_{dtype}.pt"))
    finally:
        dist.destroy_process_group()
