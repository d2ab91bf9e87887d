"""The rank side of tests/test_torch_dp.py: the cases each gloo rank runs.

The test spawns W ranks of ``run`` (one pool a world size) with a spec of
cases whose weights and batches it drew with numpy; each rank runs every
case on its block of each global batch and saves its results under
``out_dir``; the test holds them against the JAX package over a W-device
mesh. This module imports no JAX: the spawned ranks import it.
"""

import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

from exoground_tpu_torch.losses import grounding as tgnd
from exoground_tpu_torch.losses.milnce import TANLossConfig
from exoground_tpu_torch.models import ExoGroundingTransformer, TemporalAligner, ema_init
from exoground_tpu_torch.parallel import (
    collectives,
    make_grounding_eval_step,
    make_grounding_train_step,
    make_mesh,
    make_tan_eval_step,
    make_tan_train_step,
    shard_batch,
)
from exoground_tpu_torch.parallel.mesh import launch_env
from exoground_tpu_torch.train import (
    ExperimentConfig,
    FusedAdamWEMA,
    TANTrainer,
    make_optimizer,
)
from exoground_tpu_torch.utils.convert import load_grounding_params, load_tan_params


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _digest(tree) -> str:
    h = hashlib.sha1()
    for k in sorted(tree):
        h.update(k.encode())
        h.update(tree[k].detach().float().contiguous().numpy().tobytes())
    return h.hexdigest()


def _record(mesh, metrics, trees):
    """Metrics as floats; the trees in full on rank 0, their digest on every
    rank (the replicas must agree bit for bit)."""
    rec = {"metrics": {k: float(v) for k, v in metrics.items()},
           "digest": {name: _digest(t) for name, t in trees.items()}}
    if mesh.rank == 0:
        rec["trees"] = {name: {k: v.detach().clone() for k, v in t.items()}
                        for name, t in trees.items()}
    return rec


def gather_case(mesh, x, g):
    """``all_gather_tiled`` of this rank's block of ``x`` (W x b, d) and its
    gradient under this rank's cotangent ``g[rank]``."""
    b = x.shape[0] // mesh.world
    xr = torch.from_numpy(x[mesh.rank * b:(mesh.rank + 1) * b].copy()).requires_grad_()
    before = dict(collectives.COLLECTIVES)
    y = collectives.all_gather_tiled(xr, mesh)
    (grad,) = torch.autograd.grad(y, xr, torch.from_numpy(g[mesh.rank]))
    issued = {k: collectives.COLLECTIVES[k] - before[k] for k in before}
    return {"y": y.detach().numpy(), "grad": grad.numpy(), "issued": issued}


def tan_case(mesh, params, model, loss, opt, batches, gather, fused_grid, chain=False,
             compute_dtype="float32", scan=None):
    """Steps of the TAN step over ``batches`` (global), recorded after the
    first and the last: metrics, parameters, EMA twin and first moments."""
    tm = TemporalAligner(**model, device="cpu")
    load_tan_params(tm, {"params": params})
    p = {k: v.detach() for k, v in tm.named_parameters()}
    if chain:
        tx = make_optimizer(p, **opt)
        tx.eps = 1e-3
    else:
        tx = FusedAdamWEMA(p, eps=1e-3, **opt)
    step = make_tan_train_step(tm, TANLossConfig(**loss), tx, ema_momentum=0.9,
                               gather_negatives=gather, fused_grid=fused_grid,
                               compute_dtype=compute_dtype, scan_steps=scan, mesh=mesh)
    t, o = ema_init(p), tx.init(p)
    gen = torch.Generator().manual_seed(mesh.rank)
    out = {}
    if scan is not None:
        stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        p, t, o, ms = step(p, t, o, _torch(shard_batch(stacked, mesh, dim=1)), gen)
        return {"losses": ms["loss"].tolist(),
                "dtypes": sorted({str(v.dtype) for v in p.values()}),
                "digest": _digest(p)}
    for i, b in enumerate(batches):
        p, t, o, met = step(p, t, o, _torch(shard_batch(b, mesh)), gen)
        if i in (0, len(batches) - 1):
            out[i + 1] = _record(mesh, met, {"params": p, "ema": t, "mu": o.mu})
    return out


def grounding_case(mesh, params, model, loss, opt, batches):
    """Steps of the joint grounding step (``ExoGroundingTransformer``)."""
    tm = ExoGroundingTransformer(**model, device="cpu")
    load_grounding_params(tm, {"params": params})
    p = {k: v.detach() for k, v in tm.named_parameters()}
    tx = FusedAdamWEMA(p, eps=1e-3, **opt)
    step = make_grounding_train_step(tm, tgnd.GroundingLossConfig(**loss), tx, mesh=mesh)
    o = tx.init(p)
    tm.train()
    out = {}
    for i, b in enumerate(batches):
        p, _, o, met = step(p, None, o, _torch(shard_batch(b, mesh)),
                            torch.Generator().manual_seed(i))
        if i in (0, len(batches) - 1):
            out[i + 1] = _record(mesh, met, {"params": p, "mu": o.mu})
    return out


def tan_eval_case(mesh, params, model, loss, batch):
    """The TAN eval step on this rank's block of a padded host batch."""
    tm = TemporalAligner(**model, device="cpu")
    load_tan_params(tm, {"params": params})
    p = {k: v.detach() for k, v in tm.named_parameters()}
    step = make_tan_eval_step(tm, TANLossConfig(**loss), is_cotrain=True, mesh=mesh)
    return {k: float(v) for k, v in step(p, p, _torch(shard_batch(batch, mesh))).items()}


def grounding_eval_case(mesh, params, model, loss, batch):
    """The grounding eval step on this rank's block of a padded host batch;
    the IoU map of every rank gathered in row order."""
    tm = ExoGroundingTransformer(**model, device="cpu")
    load_grounding_params(tm, {"params": params})
    step = make_grounding_eval_step(tm, tgnd.GroundingLossConfig(**loss), mesh=mesh)
    scalars, ious = step({k: v.detach() for k, v in tm.named_parameters()},
                         _torch(shard_batch(batch, mesh)))
    return {"scalars": {k: float(v) for k, v in scalars.items()},
            "ious": collectives.all_gather_rows(ious.contiguous(), mesh).numpy()}


def pos_case(mesh, model, batch):
    """The first two steps' pos-start draws of a fresh ``TANTrainer``, twice."""
    draws = []
    for _ in range(2):
        tm = TemporalAligner(**model, device="cpu")
        tr = TANTrainer(tm, ExperimentConfig(model="init", epochs=1, seed=3), device="cpu",
                        mesh=mesh)
        block = _torch(shard_batch(batch, mesh))
        draws.append([tr.step.draw(block, tr.generator, i)[0].tolist() for i in range(2)])
    return draws


CASES = {"gather": gather_case, "tan": tan_case, "grounding": grounding_case,
         "tan_eval": tan_eval_case, "grounding_eval": grounding_eval_case, "pos": pos_case}


def run(rank, world, port, spec, out_dir):
    """Rank ``rank`` of a ``world``-rank gloo group: every case of ``spec``
    ({name: (kind, kwargs)}), its results saved to ``out_dir/rank<r>.pt``."""
    os.environ.update(launch_env(rank, world, port))
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    try:
        mesh = make_mesh(world)
        res = {}
        for name, (kind, kw) in spec.items():
            torch.manual_seed(0)  # the weights no JAX tree holds, alike on every rank
            res[name] = CASES[kind](mesh, **kw)
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


# ------------------------------------------------------------ command line
CLI_EPS = 1e-3  # Adam's eps in the runs held against the JAX command line


def deterministic_cli():
    """Patch the port's command line in this process so that a run can be
    held against the JAX command line's: the model's random pos start off
    (the two packages draw from generators of their own) and Adam's eps
    ``CLI_EPS`` (at 1e-8 grads that differ by rounding alone become updates
    of +-lr). ``tests/test_torch_dp_cli.py`` patches the JAX command line
    alike."""
    from exoground_tpu_torch.train import main as cli
    from exoground_tpu_torch.train import trainer

    build, fused = cli.build_model, trainer.make_fused_optimizer

    def build_model(*a, **k):
        model = build(*a, **k)
        for m in model.modules():
            if hasattr(m, "random_pos_start"):
                m.random_pos_start = 0
        return model

    def make_fused_optimizer(*a, **k):
        tx = fused(*a, **k)
        tx.eps = CLI_EPS
        return tx

    cli.build_model, trainer.make_fused_optimizer = build_model, make_fused_optimizer


def deterministic_rank_main(*args):
    """A spawned rank of ``main --dp_devices N`` (``main._rank_main``) under
    ``deterministic_cli``."""
    from exoground_tpu_torch.train import main as cli

    deterministic_cli()
    cli._rank_main(*args)
