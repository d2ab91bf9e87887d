"""The collectives of the port's data-parallel steps, counted.

The JAX package calls ``jax.lax.pmean`` / ``psum`` / ``all_gather`` inline
inside ``shard_map``; the port issues them on the ``torch.distributed``
process group of a ``Mesh`` (``parallel/mesh.py``): NCCL on cards, gloo on
the CPU. Each function here runs its collectives whenever the mesh has a
group, at world 1 too (a world-1 sum is a copy, so such a run equals the run
without a group bit for bit), and returns its input as it is without one.
Control values (``any_rank``'s vote, ``broadcast_object``) travel on the
host: under NCCL over a gloo group of the same ranks, so that a vote before
a replay does not wait for the card to finish the previous one.

``all_gather_tiled`` is the tiled ``jax.lax.all_gather`` with its transpose
as the backward: the sum over ranks of each rank's slice of the gradient, a
reduce-scatter on NCCL and on gloo an all-reduce of which each rank keeps
its slice.

``ring_shift`` is ``jax.lax.ppermute`` with ``perm = [(i, (i + 1) % n)]``:
each rank sends its tensors to the next rank and receives the previous
rank's, in one ``batch_isend_irecv`` (``send_recv``); at world 1, whatever
the backend, it is the identity, as ``ppermute`` is on a one-device axis.
The sequence-parallel ring (``parallel/sequence.py``) starts it before it
folds the block it holds and waits for it after.

``COLLECTIVES`` counts the collectives issued by kind, one where each is
issued and nowhere else, as ``ops/_kernels.py`` counts kernel launches; a
collective issued during a CUDA graph capture runs only at replay, so
``captured`` takes the capture's counts back out and ``add`` adds them once
a replay (``parallel/train_step.py::ScanStep``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

COLLECTIVES: Dict[str, int] = {name: 0 for name in (
    "all_reduce", "all_gather", "reduce_scatter", "broadcast", "ppermute")}
_lock = threading.Lock()
# (the default group it was made for, a gloo group over the same ranks)
_host = [None, None]


def count(name: str) -> None:
    with _lock:
        COLLECTIVES[name] += 1


def reset() -> None:
    with _lock:
        for name in COLLECTIVES:
            COLLECTIVES[name] = 0


@contextlib.contextmanager
def captured():
    """Around a graph capture: yields a dict that holds, at exit, the
    collectives the capture recorded by kind; ``COLLECTIVES`` is left as it
    was before the capture."""
    with _lock:
        before = dict(COLLECTIVES)
    counts: Dict[str, int] = {}
    try:
        yield counts
    finally:
        with _lock:
            for name, n in before.items():
                if COLLECTIVES[name] != n:
                    counts[name] = COLLECTIVES[name] - n
                    COLLECTIVES[name] = n


def add(counts: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture recorded ``counts``."""
    with _lock:
        for name, n in counts.items():
            COLLECTIVES[name] += n


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [p.view(t.shape) for p, t in zip(torch.split(buf, [t.numel() for t in like]), like)]


def psum(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """The sum over ranks of each tensor (one dtype), as one all-reduce of a
    flat buffer laid out in the order given (the same on every rank)."""
    if not mesh.grouped or not tensors:
        return list(tensors)
    buf = _flat(tensors)
    dist.all_reduce(buf)
    count("all_reduce")
    return _unflat(buf, tensors)


def pmean(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """The unweighted mean over ranks: ``psum`` / world."""
    if not mesh.grouped:
        return list(tensors)
    return [t / mesh.world for t in psum(tensors, mesh)]


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` stacked along axis 0 in rank order (no gradient);
    bool tensors travel as uint8."""
    if not mesh.grouped:
        return x
    src = x.contiguous()
    if src.dtype == torch.bool:
        return all_gather_rows(src.to(torch.uint8), mesh).to(torch.bool)
    out = torch.empty((mesh.world * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src)
    count("all_gather")
    return out


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        grad = grad.contiguous()
        b = grad.shape[0] // mesh.world
        if mesh.backend == "nccl":
            out = torch.empty((b,) + tuple(grad.shape[1:]), dtype=grad.dtype,
                              device=grad.device)
            dist.reduce_scatter_tensor(out, grad)
            count("reduce_scatter")
            return out, None
        total = grad.clone()
        dist.all_reduce(total)
        count("all_reduce")
        return total[mesh.rank * b:(mesh.rank + 1) * b], None


def all_gather_tiled(x: torch.Tensor, mesh) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, tiled=True)`` with its transpose as the
    gradient; ``x`` as it is without a group."""
    if not mesh.grouped:
        return x
    return _AllGatherTiled.apply(x, mesh)


def ring_shift(tensors: Sequence[torch.Tensor], mesh) -> Callable[[], List[torch.Tensor]]:
    """Start sending ``tensors`` to rank ``(rank + 1) % world`` and receiving
    the same shapes from ``(rank - 1) % world`` (``send_recv``); returns
    ``finish``, which waits and gives the received tensors. The tensors must
    stay as they are until then. At world 1 ``finish`` gives ``tensors`` as
    they are, and nothing is sent."""
    if mesh.world == 1:
        return lambda: list(tensors)
    return send_recv(tensors, mesh, (mesh.rank + 1) % mesh.world,
                     (mesh.rank - 1) % mesh.world)


def send_recv(tensors: Sequence[torch.Tensor], mesh, dst: int,
              src: int) -> Callable[[], List[torch.Tensor]]:
    """Start sending ``tensors`` to rank ``dst`` and receiving the same
    shapes from rank ``src``, in one ``batch_isend_irecv`` over ``mesh``'s
    group (counted as one ``ppermute``); returns ``finish``, which waits and
    gives the received tensors."""
    out = [torch.empty_like(t) for t in tensors]
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, dst) for t in tensors]
                                   + [dist.P2POp(dist.irecv, t, src) for t in out])
    count("ppermute")

    def finish() -> List[torch.Tensor]:
        for w in works:
            w.wait()
        return out

    return finish


def broadcast_(tensors: Sequence[torch.Tensor], mesh, src: int = 0) -> None:
    """Rank ``src``'s values into every rank's ``tensors``, in place: one
    broadcast of a flat buffer a dtype."""
    if not mesh.grouped:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            buf = _flat(group)
            dist.broadcast(buf, src)
            count("broadcast")
            for t, v in zip(group, _unflat(buf, group)):
                t.copy_(v)


def _host_group(mesh):
    """The group for control values decided on the host: under NCCL a gloo
    group over the same ranks (made once a process group, by every rank at
    the same call), so that a vote does not wait on the card's stream; the
    default group (None) otherwise."""
    if mesh.backend != "nccl":
        return None
    world = dist.group.WORLD
    if _host[0] is not world:
        _host[:] = [world, dist.new_group(backend="gloo")]
    return _host[1]


def any_rank(flag: bool, mesh) -> bool:
    """Whether ``flag`` holds on any rank (one all-reduce of an int on the
    host): the ranks decide together what must happen on all of them, such
    as a graph capture."""
    if not mesh.grouped:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group(mesh))
    count("all_reduce")
    return bool(t.item())


def broadcast_object(obj, mesh, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank (a control value, such
    as the experiment's launch time), sent on the host."""
    if not mesh.grouped:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_host_group(mesh))
    count("broadcast")
    return box[0]
