"""Process groups and the collectives of multi-device rendering and training.

The torch counterpart of ``fypraytracer_tpu/parallel/distributed.py``:
``init_distributed`` joins the processes through ``torch.distributed``
(JAX: ``jax.distributed``), ``pixel_mesh_hosts_outer`` orders the pixel
shards by node first, and ``local_batch_slice`` is this process's part of a
globally sharded axis.  One process a device: each process renders its
shard of the pixels on its own device, and the collectives below join the
shards (JAX: ``ppermute`` and ``psum`` over the device mesh).

The collectives are NCCL's on CUDA devices and gloo's on the CPU.  Gloo
carries CUDA tensors only for some collectives, so on a gloo group a CUDA
tensor is staged through host memory explicitly (copied to the CPU, joined,
copied back): two processes that share one card can run the sharded paths
under gloo (NCCL refuses two ranks on one device), at host speed.
"""

from __future__ import annotations

import dataclasses
import socket

import torch
import torch.distributed as dist


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None) -> None:
    """Join the default process group, as JAX ``init_distributed`` (:18-34)
    joins ``jax.distributed``; a no-op for a single process and once the
    group exists.

    ``coordinator_address`` is the rendezvous, an ``init_method`` URL:
    ``file:///path`` (a ``FileStore`` in a directory every process sees,
    no port) or ``tcp://host:port``; ``None`` reads the ``env://``
    variables.  ``backend``: ``"nccl"`` (the default where torch sees a
    CUDA card) or ``"gloo"`` (the default on the CPU).
    """
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {} if num_processes is None else dict(world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, init_method=coordinator_address, **kw)


@dataclasses.dataclass(frozen=True)
class PixelMesh:
    """A 1-D mesh over the pixel axis, seen from one process: its shard
    ``index`` of ``size`` shards, the ``device`` it renders on, and the
    process ``group`` whose collectives join the shards, in which shard
    ``i`` is group rank ``order[i]`` (None: one process, no collectives)."""

    group: object
    index: int
    size: int
    device: torch.device
    order: tuple

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)


def make_pixel_mesh(group=None, device="cuda", order=None) -> PixelMesh:
    """The 1-D mesh over the pixel axis (JAX shard.py:31-34): this process's
    shard of ``group`` (by default the default group once
    ``init_distributed`` has run, else one process), shard ``i`` being
    group rank ``order[i]`` (by default rank ``i``), on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if group is None and not dist.is_initialized():
        return PixelMesh(None, 0, 1, device, (0,))
    group = group or dist.group.WORLD
    size = dist.get_world_size(group)
    order = tuple(range(size)) if order is None else tuple(order)
    return PixelMesh(group, order.index(dist.get_rank(group)), size, device, order)


def pixel_mesh_hosts_outer(device="cuda") -> PixelMesh:
    """The pixel mesh of the default group with the shards ordered by
    (node, local rank), so that neighbouring shards share a node first and
    nodes come outermost (JAX :37-41: ICI before DCN; here NVLink before
    the network).  A process's local rank is its place among the ranks of
    its node."""
    if not dist.is_initialized():
        return make_pixel_mesh(None, device)
    rank = dist.get_rank()
    seen: list = [None] * dist.get_world_size()
    dist.all_gather_object(seen, (socket.gethostname(), rank))
    order = [r for _, r in sorted(seen)]
    return make_pixel_mesh(None, device, order)


def local_batch_slice(global_size: int) -> slice:
    """This process's contiguous slice of a globally sharded axis, the last
    process taking the rest (JAX :44-49)."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    per = global_size // n_proc
    return slice(pid * per, (pid + 1) * per if pid < n_proc - 1 else global_size)


def _staged(mesh: PixelMesh, t: torch.Tensor) -> bool:
    """Whether ``t`` crosses this mesh's collectives through host memory: a
    CUDA tensor on a gloo group."""
    return t.is_cuda and mesh.backend == "gloo"


def all_gather_shards(mesh: PixelMesh, t: torch.Tensor) -> list[torch.Tensor]:
    """Every shard's ``t`` (one shape on every shard), in shard order, on
    ``t``'s device."""
    if mesh.group is None:
        return [t]
    src = t.contiguous().cpu() if _staged(mesh, t) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return [parts[r].to(t.device) for r in mesh.order]


def all_reduce_sum(mesh: PixelMesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of every shard's ``t``, in place; returns ``t``."""
    if mesh.group is None:
        return t
    if _staged(mesh, t):
        host = t.cpu()
        dist.all_reduce(host, group=mesh.group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=mesh.group)
    return t


def broadcast_from_first(mesh: PixelMesh, t: torch.Tensor) -> torch.Tensor:
    """Shard 0's ``t`` on every shard, in place; returns ``t``."""
    if mesh.group is None:
        return t
    src = dist.get_global_rank(mesh.group, mesh.order[0])
    if _staged(mesh, t):
        host = t.cpu()
        dist.broadcast(host, src, group=mesh.group)
        t.copy_(host)
    else:
        dist.broadcast(t, src, group=mesh.group)
    return t
