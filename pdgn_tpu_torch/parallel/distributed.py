"""Process-group initialisation (port of pdgn_tpu/parallel/distributed.py).

The JAX package scales out with one ``jax.distributed.initialize`` and a
mesh over every device. The port runs one process per device instead
(``torchrun --nproc_per_node=W -m pdgn_tpu_torch ...``), joined in a
``torch.distributed`` group: NCCL on the card, gloo on the CPU. A process
that ``torchrun`` (torch's elastic launcher) did not start, and that is
given no ``num_processes``, initialises nothing: every entry point runs its
one-process path.

A global batch of ``B`` rows is split as ``B // W`` rows a rank and one
more on the first ``B % W`` ranks, in rank order, so no rank holds a padded
row (the JAX package pads and masks because an SPMD shard must be even).
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def shard_rows(batch: int, rank: int, world: int) -> slice:
    """The rows of a ``batch``-row global batch that rank ``rank`` of
    ``world`` holds: ``batch // world`` rows, plus one on the first
    ``batch % world`` ranks. Raises when a rank would hold none."""
    if batch < world:
        raise ValueError(f"global batch {batch} is smaller than the "
                         f"{world} ranks: every rank needs a row")
    per, extra = divmod(batch, world)
    start = rank * per + min(rank, extra)
    return slice(start, start + per + (rank < extra))


def coalesced_sum(tensors: Sequence[torch.Tensor], group
                  ) -> List[torch.Tensor]:
    """``tensors`` (one dtype) summed over the ranks of ``group`` in one
    ``all_reduce``; returns views of one buffer, shaped as the inputs."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cuda", backend: Optional[str] = None,
                           timeout_s: Optional[float] = None) -> int:
    """Join the process group; returns its world size (1 when nothing is
    initialised).

    Under ``torchrun`` the rank, world size and address come from the
    environment it sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, read by ``torch.distributed``'s ``env://``);
    ``num_processes``/``process_id`` set them by hand, and
    ``coordinator_address`` (``host:port``, or a full ``tcp://`` or
    ``file://`` URL) replaces the environment's address. With neither a
    launcher nor a ``num_processes``, no group is made. A failed
    initialisation raises: nothing drops to one process.
    """
    if num_processes is None and not dist.is_torchelastic_launched():
        return 1
    if num_processes is not None and process_id is None:
        raise ValueError("process_id is needed with num_processes")
    if dist.is_initialized():
        world = dist.get_world_size()
        if num_processes not in (None, world):
            raise RuntimeError(f"a process group of {world} ranks exists, "
                               f"{num_processes} asked for")
        return world
    url = "env://"
    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if num_processes is not None:
        kw.update(world_size=num_processes, rank=process_id)
    dist.init_process_group(backend or default_backend(device),
                            init_method=url, **kw)
    return dist.get_world_size()


def local_batch_slice(global_batch: int) -> slice:
    """This process's rows of a global batch (:func:`shard_rows`); all of
    them when no group is initialised."""
    if not dist.is_initialized():
        return slice(0, global_batch)
    return shard_rows(global_batch, dist.get_rank(), dist.get_world_size())
