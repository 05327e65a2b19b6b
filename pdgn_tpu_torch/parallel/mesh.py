"""The data axis of a multi-process run (port of pdgn_tpu/parallel/mesh.py).

The JAX package shards the batch over a 1-D ``data`` mesh axis and lets XLA
insert the collectives. The port's counterpart is a small record of this
process's place on that axis: its rank, the world size, its device and the
process group. Parameters are replicated once (a broadcast from rank 0 after
build or load) and stay equal because every rank applies the same summed
gradients; a batch is sharded by rows (:func:`shard_batch`, uneven shards
allowed, see :func:`~pdgn_tpu_torch.parallel.distributed.shard_rows`).

Gathers are sums: each rank writes its part into a zeroed buffer and one
``all_reduce`` adds them, which is exact (every other rank adds zeros) and
works on both backends (gloo takes CUDA tensors for ``all_reduce`` and
``broadcast`` only).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from pdgn_tpu_torch.parallel.distributed import coalesced_sum, shard_rows


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the data axis."""

    rank: int
    world: int
    device: torch.device
    group: "dist.ProcessGroup"

    def rows(self, batch: int) -> slice:
        """This rank's rows of a ``batch``-row global batch."""
        return shard_rows(batch, self.rank, self.world)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def sum_tensors(self, tensors: Sequence[torch.Tensor]):
        """The tensors (one dtype) summed over the ranks in one coalesced
        call; returns views of one buffer, shaped as the inputs."""
        return coalesced_sum(tensors, self.group)

    def sum_grads(self, module: nn.Module) -> None:
        """Sum ``module``'s gradients over the ranks in one coalesced
        call; each ``grad`` becomes a view of the summed buffer."""
        params = [p for p in module.parameters() if p.grad is not None]
        for p, g in zip(params, self.sum_tensors([p.grad for p in params])):
            p.grad = g

    def broadcast_int(self, value: int) -> int:
        """Rank 0's ``value`` on every rank."""
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.broadcast(t, 0, group=self.group)
        return int(t.item())


def make_mesh(device="cuda", group: Optional["dist.ProcessGroup"] = None
              ) -> Mesh:
    """The data axis over ``group`` (default: every rank of the initialised
    group). A ``"cuda"`` device without an index becomes the card of the
    node-local rank (``LOCAL_RANK``, which ``torchrun`` sets; else the rank
    modulo the visible cards) and the current device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.initialize_distributed first")
    group = dist.group.WORLD if group is None else group
    rank = dist.get_rank(group)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", dist.get_node_local_rank(
                fallback_rank=rank % torch.cuda.device_count()))
        torch.cuda.set_device(dev)
    return Mesh(rank, dist.get_world_size(group), dev, group)


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every element of a tuple or list of arrays,
    tensors or per-row tuples (a batch's category names)."""
    return type(tree)(x[mesh.rows(len(x))] for x in tree)


def replicate(mesh: Mesh, *modules: nn.Module) -> None:
    """Broadcast every parameter and buffer of ``modules`` from rank 0, in
    place (once, after build or load)."""
    with torch.no_grad():
        for m in modules:
            for t in list(m.parameters()) + list(m.buffers()):
                dist.broadcast(t.data, 0, group=mesh.group)

