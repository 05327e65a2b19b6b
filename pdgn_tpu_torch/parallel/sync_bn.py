"""Cross-rank batch-norm statistics (port of pdgn_tpu/parallel/sync_bn.py).

In the JAX package a batch sharded over the mesh normalises with the global
batch's statistics (XLA inserts the collectives), and a module's
``axis_name=None`` inside a mapped axis gives each shard its own (the
reference's ``nn.DataParallel`` behaviour). The port does the same with one
differentiable ``all_reduce``: a layer sums its moments over its rows, the
sums are added over the ranks, and the mean and variance divide them by the
global row count. The backward adds the cotangents of the sums over the
ranks, which is exactly synchronised batch norm's gradient. Sums and counts
are reduced, never means, so uneven shards give the statistics of the
unsharded batch.

A model takes part through a :class:`DataAxis` (the counterpart of
``axis_name``) that :func:`set_group` gives every batch-norm site of it;
``group=None`` keeps each rank's statistics its own.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from pdgn_tpu_torch.parallel.distributed import coalesced_sum, shard_rows


class _AllReduceSum(torch.autograd.Function):
    """Sum tensors over the ranks in one coalesced call; the backward sums
    their cotangents the same way."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(coalesced_sum(tensors, group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *coalesced_sum(grads, ctx.group))


def all_reduce_sum(tensors: Sequence[torch.Tensor], group
                   ) -> List[torch.Tensor]:
    """``tensors`` (one dtype) summed over the ranks of ``group``,
    differentiable; a cotangent that is ``None`` counts as zeros, so every
    rank joins the backward's collective."""
    return list(_AllReduceSum.apply(group, *tensors))


class DataAxis:
    """The ranks whose rows make one global batch, as a model's batch-norm
    sites see it: the process group, and for the forward in flight this
    rank's rows and the global batch (set by the model's ``forward``
    through :meth:`begin`), from which a local row count scales to the
    global one. The counts stay host integers, so the means divide exactly
    as the one-process path does."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.rows: Optional[int] = None
        self.batch: Optional[int] = None

    def begin(self, rows: int, batch: Optional[int]) -> None:
        """Start a forward over ``rows`` local rows of a ``batch``-row
        global batch, which must shard into ``rows`` here
        (``shard_rows``)."""
        if batch is None:
            raise ValueError("a model with a process group needs the global "
                             "batch: forward(..., batch=B)")
        want = shard_rows(batch, self.rank, self.world)
        if rows != want.stop - want.start:
            raise ValueError(f"rank {self.rank} of {self.world} holds {rows} "
                             f"rows; a global batch of {batch} gives it "
                             f"{want.stop - want.start}")
        self.rows, self.batch = rows, batch

    def count(self, n: int) -> int:
        """The global count of a statistic counted ``n`` times over this
        rank's rows (``n`` is rows times a per-row factor)."""
        if self.rows is None:
            raise RuntimeError("DataAxis: the model's forward did not begin "
                               "a batch")
        if n % self.rows:
            raise ValueError(f"count {n} is not a multiple of the "
                             f"{self.rows} local rows")
        return n // self.rows * self.batch

    def sum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Moment sums over this rank's rows -> over the global batch."""
        return all_reduce_sum(tensors, self.group)


def global_moments(axis: Optional[DataAxis], sums: Sequence[torch.Tensor],
                   n: int):
    """``(sums, n)`` over the global batch: as given without an axis."""
    if axis is None:
        return list(sums), n
    return axis.sum(sums), axis.count(n)


def set_group(model: nn.Module, group) -> Optional[DataAxis]:
    """Give every batch-norm site of ``model`` (each submodule with an
    ``axis`` attribute) one shared :class:`DataAxis` over ``group``, or
    none (``group=None``: each rank's own statistics). Returns the axis."""
    axis = None if group is None else DataAxis(group)
    for m in model.modules():
        if hasattr(m, "axis"):
            m.axis = axis
    return axis


@contextlib.contextmanager
def replica_local(model: nn.Module):
    """Run ``model`` with each rank's own statistics (whole batches on each
    rank, as generation hands them out), restoring its axis after."""
    axis = getattr(model, "axis", None)
    if axis is None:
        yield model
        return
    set_group(model, None)
    try:
        yield model
    finally:
        for m in model.modules():
            if hasattr(m, "axis"):
                m.axis = axis


def cross_replica_moments(x: torch.Tensor,
                          axis: Optional[DataAxis] = None):
    """Mean and biased variance over all axes but the last, over the global
    batch of ``axis`` (``None``: this rank's rows): the sums of ``x`` and
    ``x * x`` are reduced in one call, differentiably, and divided by the
    global row count (:func:`global_moments`, as every batch-norm site of
    the models reduces)."""
    dims = tuple(range(x.dim() - 1))
    (s1, s2), n = global_moments(
        axis, (torch.sum(x, dim=dims), torch.sum(x * x, dim=dims)),
        x.numel() // x.shape[-1])
    mean = s1 / n
    return mean, s2 / n - mean * mean


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               axis: Optional[DataAxis] = None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """Functional batch norm on ``axis``'s global statistics (``None``:
    this rank's rows only)."""
    mean, var = cross_replica_moments(x, axis)
    return (x - mean) * torch.rsqrt(var + epsilon) * scale + bias


def per_replica_batch_norm(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, *,
                           epsilon: float = 1e-5) -> torch.Tensor:
    """Local-statistics batch norm (the reference's ``DataParallel``
    behaviour): each rank normalises over its own rows."""
    return batch_norm(x, scale, bias, axis=None, epsilon=epsilon)
