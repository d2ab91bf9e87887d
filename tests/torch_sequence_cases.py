"""The rank side of tests/test_torch_sequence.py: the cases each gloo rank
runs.

The test spawns W ranks of ``run`` (one pool a world size) with a spec of
cases whose weights and inputs it drew with numpy; each rank runs every
case through the port's sequence-parallel functions on the global inputs
and saves the global results, with the collectives each case issued, under
``out_dir``. ``run_case`` runs one case in the calling process (no group:
world 1). This module imports no JAX: the spawned ranks import it.
"""

import os

import torch
import torch.distributed as dist

from exoground_tpu_torch.models import TemporalAligner
from exoground_tpu_torch.parallel import (
    collectives,
    make_mesh,
    sequence_parallel_dual_sim,
    sequence_parallel_sim,
    sequence_sharded_self_attention,
)
from exoground_tpu_torch.parallel.mesh import launch_env
from exoground_tpu_torch.utils.convert import load_tan_params


def _t(a):
    return None if a is None else torch.from_numpy(a.copy())


def attn_case(mesh, q, k, v, mask=None):
    return {"out": sequence_sharded_self_attention(_t(q), _t(k), _t(v), mesh,
                                                   key_padding_mask=_t(mask)).numpy()}


def sim_case(mesh, params, model, video, text, dual_only=False, **kw):
    tm = TemporalAligner(**model, device="cpu")
    load_tan_params(tm, {"params": params})
    kw = {k: _t(v) if hasattr(v, "shape") else v for k, v in kw.items()}
    if dual_only:
        sim = sequence_parallel_dual_sim(tm, _t(video), _t(text), mesh, **kw)
        return {"dual-sim": sim.numpy()}
    out = sequence_parallel_sim(tm, _t(video), _t(text), mesh, **kw)
    return {k: v.numpy() for k, v in out.items()}


CASES = {"attn": attn_case, "sim": sim_case}


def run_case(mesh, kind, kw):
    """One case on ``mesh``: its results and the collectives it issued."""
    before = dict(collectives.COLLECTIVES)
    res = CASES[kind](mesh, **kw)
    res["issued"] = {k: collectives.COLLECTIVES[k] - before[k] for k in before}
    return res


def run(rank, world, port, spec, out_dir):
    """Rank ``rank`` of a ``world``-rank gloo group: every case of ``spec``
    ({name: (kind, kwargs)}), its results saved to ``out_dir/rank<r>.pt``."""
    os.environ.update(launch_env(rank, world, port))
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    try:
        mesh = make_mesh(world)
        res = {name: run_case(mesh, kind, kw) for name, (kind, kw) in spec.items()}
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
