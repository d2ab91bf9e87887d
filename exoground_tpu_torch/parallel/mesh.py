"""The data-parallel group of the port: one process per card.

Counterpart of ``exoground_tpu/parallel/mesh.py`` (:25-62). JAX runs one
process per host, and ``shard_map`` splits a host's batch over that host's
devices. The port runs one process per card in a ``torch.distributed``
process group and reduces explicitly where the JAX steps call ``pmean``,
``psum``, ``all_gather`` or ``axis_index`` (``parallel/collectives.py``).
The backend is NCCL on cards and gloo on the CPU, never one in place of the
other.

``make_mesh`` describes the group: world, rank, the rank's place among the
ranks of its host (``local_rank`` of ``local_world``, from torchrun's
``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``), the device and the backend. Without
an initialised group it is world 1 with no backend, and the steps issue no
collective. ``shard_batch`` takes this rank's block of a host batch: the
rows JAX device r of the same mesh receives. ``replicate`` broadcasts
tensors from rank 0 in place. ``launch_env`` is the environment a
``torch.distributed.run`` launch gives a rank (``LAUNCH_ENV`` its names),
over ``free_port``: what ``--dp_devices`` and the CPU checks set up.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from exoground_tpu_torch.parallel import collectives

# what a torch.distributed.run launch sets in each process's environment
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel group: ``world`` ranks, this one ``rank``, the
    ``local_rank``-th of its host's ``local_world``; ``backend`` is None
    without a process group."""

    world: int = 1
    rank: int = 0
    local_rank: int = 0
    local_world: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None

    @property
    def grouped(self) -> bool:
        """Whether a process group exists (then every collective runs, at
        world 1 too)."""
        return self.backend is not None

    @property
    def host(self) -> int:
        return self.rank // self.local_world

    @property
    def hosts(self) -> int:
        return self.world // self.local_world


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The group this process belongs to (world 1 without one). With
    ``n_devices`` the group must have that many ranks. ``device`` defaults
    to ``cuda:<local rank>`` under NCCL and the CPU otherwise."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh({n_devices}) needs a process group of {n_devices} "
                             "ranks; none is initialised")
        return Mesh(device=torch.device(device or "cpu"))
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}) in a process group of {world} ranks")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank % local_world))
    if world % local_world:
        raise ValueError(f"{world} ranks do not split into hosts of {local_world}")
    backend = dist.get_backend()
    if device is None:
        device = f"cuda:{local_rank}" if backend == "nccl" else "cpu"
    return Mesh(world, rank, local_rank, local_world, torch.device(device), backend)


def _block(x, dim: int, i: int, n: int):
    if x.ndim <= dim:  # scalars and low-rank entries have no batch axis
        return x
    rows = x.shape[dim]
    if rows % n:
        raise ValueError(f"{rows} rows on axis {dim} do not split over {n} local ranks")
    k = rows // n
    index = (slice(None),) * dim + (slice(i * k, (i + 1) * k),)
    if isinstance(x, torch.Tensor):
        return x[index].contiguous()
    return np.ascontiguousarray(x[index])


def shard_batch(batch: Dict, mesh: Mesh, dim: int = 0) -> Dict:
    """This rank's block of the host batch ``batch`` (numpy arrays or
    tensors): rows ``local_rank`` of ``local_world`` equal blocks along
    ``dim`` (1 for the stacked (N, B, ...) batches of ``--fused_steps``).
    Each host passes its own rows, as the JAX ``shard_batch`` takes each
    process's rows as its shard of the global batch."""
    return {k: _block(v, dim, mesh.local_rank, mesh.local_world) for k, v in batch.items()}


def replicate(tree: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Rank 0's values in every rank's tensors of ``tree``, in place (one
    broadcast a dtype); the tree as it is without a group."""
    if mesh.grouped:
        collectives.broadcast_([t for t in tree.values()], mesh)
    return tree


def free_port() -> int:
    """A free TCP port on localhost, for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_env(rank: int, world: int, port: int) -> Dict[str, str]:
    """The environment a torch.distributed.run launch gives rank ``rank`` of
    ``world`` on one host, over ``tcp://localhost:port``."""
    return dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
