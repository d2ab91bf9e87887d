"""A real multi-process data-parallel check of the port, over gloo on the CPU.

Counterpart of ``exoground_tpu/parallel/multihost_check.py``. The port's
steps are tested rank by rank against the JAX package; this module runs the
process-boundary logic as a user's run has it: W processes in one
``torch.distributed`` group, the real ``TANTrainer`` (each rank's block of
the host batch, grads averaged over the ranks, the state broadcast from rank
0, chief-only checkpoints and log) and a sharded grounding eval whose IoU
map the trainer gathers back into the host's rows (``_host_rows``).

    python -m exoground_tpu_torch.parallel.multihost_check --world 2 --workdir DIR

spawns the W ranks (one host) and prints their records as JSON;
``launch_check`` does the same from Python and also lists each rank's
directories (a rank other than 0 must have written nothing).
``tests/test_torch_dp.py`` holds the records against the JAX trainer over a
W-device mesh on the same global batches, with the same weights (``params``:
the JAX layout's numpy trees; without them the port seeds its own).
``dryrun_multichip(n)`` runs one full data-parallel train step over n gloo
ranks (the counterpart of ``__graft_entry__.dryrun_multichip``).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from exoground_tpu_torch.parallel.mesh import free_port, launch_env

_B, _T, _N, _D = 16, 12, 3, 24  # the global batch's geometry (the JAX module's)
TAN_MODEL = dict(num_encoder_layers=1, num_joint_layers=1, width=32, heads=4, max_pos=32,
                 input_dim=_D, random_pos_start=0)
GROUNDING_MODEL = dict(num_encoder_layers=1, num_decoder_layers=1, video_embed_dim=_D,
                       text_embed_dim=_D, feature_dim=32, random_pos_start=0)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# --------------------------------------------------------------------- data
def global_batches(num: int = 2, seed: int = 0) -> List[Dict]:
    """Seeded global raw TAN batches (the JAX module's ``_global_batches``);
    every process builds the same list and takes its host's rows."""
    out = []
    for i in range(num):
        rng = np.random.RandomState(seed + i)
        start = rng.randint(0, _T - 4, (_B, _N)).astype(np.float32)
        out.append({
            "video": rng.randn(_B, _T, _D).astype(np.float32),
            "text": rng.randn(_B, _N, _D).astype(np.float32),
            "video_padding_mask": np.zeros((_B, _T), bool),
            "text_padding_mask": np.zeros((_B, _N), bool),
            "start": start,
            "end": start + 3.0,
        })
    return out


def grounding_batch(seed: int = 7) -> Dict:
    """The seeded global grounding batch (the JAX module's
    ``_grounding_world``)."""
    rng = np.random.RandomState(seed)
    starts = (rng.rand(_B, _N) * 0.5).astype(np.float32)
    ends = starts + 0.3
    return {
        "video_features": rng.randn(_B, _T, _D).astype(np.float32),
        "narration_features": rng.randn(_B, _N, _D).astype(np.float32),
        "video_padding_mask": np.zeros((_B, _T), bool),
        "narration_padding_mask": np.zeros((_B, _N), bool),
        "starts": starts, "ends": ends,
        "mean": (starts + ends) / 2,
        "duration": np.abs(ends - starts).astype(np.float32),
    }


def _rows(batch: Dict, lo: int, hi: int) -> Dict:
    return {k: v[lo:hi] for k, v in batch.items()}


# ------------------------------------------------------------------- worker
def run_check(workdir: str, mesh, params: Optional[Dict] = None) -> Dict:
    """This rank's record: the real ``TANTrainer`` over two global batches
    (one epoch, a validation pass, an epoch checkpoint) and the sharded
    grounding eval with its IoU map gathered into the host's rows.
    ``params``: {'tan': ..., 'grounding': ...} numpy trees in the JAX
    layout, or None for the port's seeded initial weights."""
    from exoground_tpu_torch.losses.grounding import GroundingLossConfig
    from exoground_tpu_torch.models import ExoGroundingTransformer, TemporalAligner
    from exoground_tpu_torch.parallel import make_grounding_eval_step, shard_batch
    from exoground_tpu_torch.train import ExperimentConfig, TANTrainer
    from exoground_tpu_torch.utils.convert import load_grounding_params, load_tan_params

    rows = _B // mesh.hosts  # the host's rows, split over its ranks by the trainer
    lo, hi = mesh.host * rows, (mesh.host + 1) * rows
    batches = [_rows(b, lo, hi) for b in global_batches()]
    cfg = ExperimentConfig(model="init", epochs=1, lr=1e-3, batch_size=rows, seed=0,
                           runtime_save_iter=2, fused_steps=1)
    # a directory a rank: a write by a rank other than 0 lands in its own
    cfg.model_path = os.path.join(workdir, f"proc{mesh.rank}", "model")
    cfg.log_path = os.path.join(workdir, f"proc{mesh.rank}", "log")
    os.makedirs(cfg.model_path, exist_ok=True)
    os.makedirs(cfg.log_path, exist_ok=True)

    torch.manual_seed(0)
    model = TemporalAligner(**TAN_MODEL, device="cpu")
    if params is not None:
        load_tan_params(model, {"params": params["tan"]})
    trainer = TANTrainer(model, cfg, iters_per_epoch=2, device=mesh.device, mesh=mesh)
    train_loss = trainer.train_epoch(batches, epoch=0)
    val_loss = trainer.evaluate(batches[:1], epoch=0)
    trainer.save_epoch(0)

    gmodel = ExoGroundingTransformer(**GROUNDING_MODEL, device="cpu")
    if params is not None:
        load_grounding_params(gmodel, {"params": params["grounding"]})
    gstep = make_grounding_eval_step(gmodel, GroundingLossConfig(model="grounding"), mesh)
    gb = _rows(grounding_batch(), lo, hi)
    gb["row_valid"] = np.ones((rows,), np.float32)
    block = {k: torch.from_numpy(v) for k, v in shard_batch(gb, mesh).items()}
    scalars, ious = gstep({k: v.detach() for k, v in gmodel.named_parameters()}, block)
    host_ious = trainer._host_rows(ious)
    trainer.close()
    return {
        "rank": mesh.rank, "world": mesh.world, "backend": mesh.backend,
        "row_range": [lo, hi],
        "train_loss": float(train_loss), "val_loss": float(val_loss),
        "iteration": trainer.iteration,
        "grounding_scalars": {k: float(v) for k, v in scalars.items()},
        "host_ious": host_ious.tolist(),
        "is_chief": trainer.is_chief,
    }


def _worker_entry(argv: Optional[List[str]] = None) -> None:
    import torch.distributed as dist

    from exoground_tpu_torch.parallel.mesh import make_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--params", default="")
    ap.add_argument("--block", action="append", default=[],
                    help="a module this process must not import (set to None)")
    args = ap.parse_args(argv)
    sys.modules.update(dict.fromkeys(args.block))
    torch.set_num_threads(1)
    params = None
    if args.params:
        with open(args.params, "rb") as f:
            params = pickle.load(f)
    dist.init_process_group("gloo")  # from the launch environment
    try:
        res = run_check(args.workdir, make_mesh(), params)
    finally:
        dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(res, f)


# ----------------------------------------------------------------- launcher
def launch_check(workdir: str, world: int = 2, params: Optional[Dict] = None,
                 timeout: float = 600.0) -> Dict:
    """Run ``run_check`` on ``world`` gloo ranks (one process each); returns
    {'multi': the records by rank, 'files': each rank's directories}."""
    os.makedirs(workdir, exist_ok=True)
    port = free_port()
    extra = []
    if params is not None:
        path = os.path.join(workdir, "params.pkl")
        with open(path, "wb") as f:
            pickle.dump(params, f)
        extra = ["--params", path]
    for name, mod in sys.modules.items():  # the ranks keep this process's blocked imports
        if mod is None and "." in name and name.startswith("torch."):
            extra += ["--block", name]
    outs = [os.path.join(workdir, f"out{r}.json") for r in range(world)]
    run_dir = os.path.join(workdir, "run")
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "exoground_tpu_torch.parallel.multihost_check", "--worker",
         "--workdir", run_dir, "--out", outs[r]] + extra,
        env=dict(env, **launch_env(r, world, port)), cwd=_REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=max(5.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            errors.append(f"rank {r} timed out:\n{err[-2000:]}")
            continue
        if p.returncode != 0:
            errors.append(f"rank {r} failed (rc={p.returncode}):\n{err[-4000:]}")
    if errors:
        raise RuntimeError("multihost_check: " + "\n".join(errors))

    def listing(d):
        return sorted(os.listdir(d)) if os.path.isdir(d) else []

    files = {f"proc{r}_{kind}": listing(os.path.join(run_dir, f"proc{r}", kind))
             for r in range(world) for kind in ("model", "log")}
    multi = []
    for o in outs:
        with open(o) as f:
            multi.append(json.load(f))
    return {"multi": multi, "files": files}


def assert_chief_only(res: Dict) -> None:
    """Rank 0 wrote its epoch and runtime checkpoints and its log; no other
    rank wrote anything (the reference's rank == 0 guards)."""
    files, world = res["files"], len(res["multi"])
    assert any(f.startswith("epoch0") for f in files["proc0_model"]), files
    assert any("runtime" in f for f in files["proc0_model"]), files
    assert files["proc0_log"], files
    for r in range(1, world):
        assert files[f"proc{r}_model"] == [] and files[f"proc{r}_log"] == [], files
    assert [m["is_chief"] for m in sorted(res["multi"], key=lambda m: m["rank"])] == (
        [True] + [False] * (world - 1))


# ------------------------------------------------------------------ dry run
def _dryrun_rank(rank: int, world: int, port: int, results) -> None:
    import torch.distributed as dist

    from exoground_tpu_torch.losses.milnce import TANLossConfig
    from exoground_tpu_torch.models import TemporalAligner, ema_init
    from exoground_tpu_torch.parallel import make_mesh, make_tan_train_step, shard_batch
    from exoground_tpu_torch.train import make_fused_optimizer
    from exoground_tpu_torch.train.trainer import rank_seed

    os.environ.update(launch_env(rank, world, port))
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    try:
        mesh = make_mesh(world)
        torch.manual_seed(0)
        model = TemporalAligner(**dict(TAN_MODEL, use_alignability_head=1, random_pos_start=1),
                                device="cpu")
        params = {k: v.detach() for k, v in model.named_parameters()}
        tx = make_fused_optimizer(params, lr=1e-3, weight_decay=1e-2, total_iterations=10,
                                  warmup_iterations=2)
        cfg = TANLossConfig(model="cotrain", learn_agreement=True, loss_threshold=0.5,
                            use_alignability_head=True)
        step = make_tan_train_step(model, cfg, tx, ema_momentum=0.99, gather_negatives=True,
                                   mesh=mesh)
        raw = global_batches(1)[0]
        batch = shard_batch({k: torch.from_numpy(v) for k, v in raw.items()}, mesh)
        t = ema_init(params)
        gen = torch.Generator().manual_seed(rank_seed(0, mesh.rank))
        params, t, o, metrics = step(params, t, tx.init(params), batch, gen)
        flat = torch.cat([v.reshape(-1) for v in params.values()])
        results.put((rank, float(metrics["loss"]), flat.double().sum().item(),
                     float(flat.abs().max())))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> Dict:
    """One full data-parallel TAN step (cotrain with the EMA twin, the whole
    loss with agreement, threshold and alignability, gathered negatives,
    fused AdamW with warmup-cosine) over ``n_devices`` gloo ranks on the
    CPU; every rank must finish with a finite loss and the same
    parameters. Returns rank 0's record."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    mp.start_processes(_dryrun_rank, args=(n_devices, free_port(), results),
                       nprocs=n_devices, start_method="spawn")
    recs = sorted(results.get() for _ in range(n_devices))
    losses = {r[1] for r in recs}
    if len(losses) != 1 or not np.isfinite(recs[0][1]) or len({r[2:] for r in recs}) != 1:
        raise RuntimeError(f"dryrun_multichip({n_devices}): ranks disagree: {recs}")
    out = dict(world=n_devices, loss=recs[0][1], param_sum=recs[0][2], param_absmax=recs[0][3])
    print("dryrun_multichip", json.dumps(out), flush=True)
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--workdir", required=True)
    args = ap.parse_args(argv)
    res = launch_check(args.workdir, args.world)
    assert_chief_only(res)
    print(json.dumps(res["multi"]))


if __name__ == "__main__":
    if "--worker" in sys.argv:
        _worker_entry([a for a in sys.argv[1:] if a != "--worker"])
    else:
        main()
