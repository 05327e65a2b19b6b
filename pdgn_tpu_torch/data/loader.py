"""Host batching and the device-feeding loader (port of
pdgn_tpu/data/loader.py; reference utils/data.py and the
``DataLoader(num_workers=4)`` of models/PDGNet_v2.py:78).

``prefetch_to_device`` runs the host iterator in a producer thread and
keeps ``size`` batches in flight. For a CUDA device the producer stacks
each batch into pinned host buffers and copies them ``non_blocking`` on a
side stream; the consumer's stream waits on the copy's event before the
batch is used, and each tensor is recorded on the consumer's stream so
that its memory is not handed out again while the consumer's kernels may
still read it. A pinned buffer is written again only after the copy that
read it has completed (its event is synchronised first). The device
defaults to the card, as every entry point's does, and raises when none
is visible; with ``device="cpu"`` the same code yields CPU tensors, with
no pinning and no stream.

As in the JAX package, the producer thread draws from numpy's global
stream (the epoch's shuffle, the items' sub-resolutions), a consumer that
leaves an epoch early releases the thread, and an error in the producer
is raised in the consumer.
"""

from __future__ import annotations

import threading
from queue import Full, Queue
from typing import Iterator, List, Optional

import numpy as np
import torch

from pdgn_tpu_torch.data.shapenet import batch_iterator
from pdgn_tpu_torch.utils.misc import resolve_device

_POLL = 0.1       # seconds between the producer's checks for a stop


def split_sizes(dataset_len: int, train_ratio: float, val_ratio: float):
    """Train/val/test sizes (reference utils/data.py:5-13)."""
    train = int(dataset_len * train_ratio)
    val = int(dataset_len * val_ratio)
    return train, val, dataset_len - train - val


class Subset:
    """Index-view of a dataset (``torch.utils.data.Subset``'s protocol)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def random_split(dataset, lengths, seed: Optional[int] = None):
    """Random split by a numpy permutation (``RandomState(seed)``, or
    numpy's global stream)."""
    if sum(lengths) != len(dataset):
        raise ValueError(f"lengths {lengths} do not sum to {len(dataset)}")
    rng = np.random.RandomState(seed) if seed is not None else np.random
    perm = rng.permutation(len(dataset))
    out, start = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[start:start + n]))
        start += n
    return out


def get_train_val_test_datasets(dataset, train_ratio: float,
                                val_ratio: float, seed: Optional[int] = None):
    """Three-way random split (reference utils/data.py:5-13)."""
    sizes = split_sizes(len(dataset), train_ratio, val_ratio)
    return random_split(dataset, list(sizes), seed=seed)


def get_data_iterator(iterable) -> Iterator:
    """Infinite iterator over an epoch iterable (reference
    utils/data.py:25-34)."""
    while True:
        for item in iterable:
            yield item


class _PinnedCopies:
    """The producer's side of a CUDA prefetch: a ring of pinned host
    buffers, one side stream, and an event per slot marking its copy."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.slots: List[Optional[tuple]] = [None] * slots
        self.next = 0

    def copy(self, batch) -> tuple:
        """``(device batch, event)``: arrays copied through the next slot's
        pinned buffers, other elements passed through."""
        bufs, event = self.slots[self.next] or ({}, None)
        if event is not None:
            event.synchronize()       # the slot's last copy has read it
        out, used = [], {}
        with torch.cuda.stream(self.stream):
            for i, x in enumerate(batch):
                if not isinstance(x, np.ndarray):
                    out.append(x)
                    continue
                buf = bufs.get(i)
                if buf is None or buf.numpy().shape != x.shape \
                        or buf.numpy().dtype != x.dtype:
                    buf = torch.empty(x.shape, dtype=_torch_dtype(x.dtype),
                                      pin_memory=True)
                buf.numpy()[...] = x
                used[i] = buf
                out.append(buf.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        self.slots[self.next] = (used, event)
        self.next = (self.next + 1) % len(self.slots)
        return tuple(out), event


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _on_consumer(item, device: torch.device):
    """The consumer's side: wait for the copy, claim the tensors for the
    current stream."""
    batch, event = item
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    for x in batch:
        if isinstance(x, torch.Tensor):
            x.record_stream(stream)
    return batch


def prefetch_to_device(iterator, size: int = 2, device="cuda"):
    """Run the host iterator in a thread and keep ``size`` batches in
    flight on ``device``.

    Args:
      iterator: yields tuples of numpy arrays; other elements (category
        strings) pass through untouched.
      device: a CUDA device (pinned buffers, a side stream; the default,
        which raises here when no card is visible) or ``"cpu"``.
    """
    return _prefetch(iterator, size, resolve_device(device))


def _prefetch(iterator, size: int, device: torch.device):
    cuda = device.type == "cuda"
    q: Queue = Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL)
                return True
            except Full:
                continue
        return False

    def producer():
        try:
            copies = _PinnedCopies(device, size + 2) if cuda else None
            for batch in iterator:
                if cuda:
                    item = copies.copy(batch)
                else:
                    item = tuple(torch.from_numpy(x)
                                 if isinstance(x, np.ndarray) else x
                                 for x in batch)
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 - raised in the consumer
            put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield _on_consumer(item, device) if cuda else item
    finally:
        # the consumer left the epoch (break, exception, close): release
        # the producer, which may be parked on a full queue, and wait for
        # it, so that its draws from numpy's stream end here
        stop.set()
        thread.join()


def train_loader(dataset, batch_size: int, seed: Optional[int] = None,
                 device="cuda", prefetch: int = 2,
                 rows: Optional[slice] = None):
    """One epoch of 4-resolution batches on ``device``, shuffled (by
    ``RandomState(seed)`` or numpy's global stream), the trailing partial
    batch dropped. ``rows`` (a data-parallel rank's rows,
    ``Mesh.rows(batch_size)``) keeps those rows of each global batch: the
    whole batch is still drawn on the host, so every rank's shuffle and
    draws follow the one-process run's, and only the rows are copied."""
    it = batch_iterator(dataset, batch_size, shuffle=True, drop_last=True,
                        seed=seed)
    if rows is not None:
        it = (tuple(x[rows] for x in batch) for batch in it)
    return prefetch_to_device(it, size=prefetch, device=device)
