"""Decode in worker processes — the counterpart of
``posetpu/data/grain_pipeline.py:GrainLoader``.

:class:`WorkerLoader` is a :class:`posetpu_torch.data.loader.HostLoader`
whose Pillow decode runs in ``torch.utils.data.DataLoader`` worker
processes, one sample a task, so every worker decodes a share of each
batch.  A worker calls :func:`posetpu_torch.data.loader.load_sample` and
nothing on CUDA.  It decodes straight into its batch's slot of a ring of
batch buffers in shared memory and sends back only the sample's metadata;
the prefetch thread then copies the slot once, into the placer's pinned
buffer.  (A tensor per sample sent through the queue costs the consuming
thread a fresh shared-memory mapping and its page faults for every image:
one core's worth for a batch of 32 MPII frames, more than 7 workers decode.)
The batch
contract is ``HostLoader``'s: the same fields, ``__len__``, ``drop_last``,
``shuffle``, ``epoch``, ``place`` (the pinned copy on the placer's stream),
``ready``, ``group``, ``pad`` and ``shard``.

The epoch order is ``HostLoader._order``'s (``RandomState(seed +
epoch)``), not grain's ``IndexSampler`` order, so ``WorkerLoader(
num_workers=N)`` and ``HostLoader(backend="pil")`` give the same batches
bit for bit and one can replace the other.

Workers start with each epoch, from the prefetch thread, after CUDA is up,
by ``forkserver``: a server process started once (by exec, so it holds no
CUDA context and no copy of the parent's threads) forks them.  ``fork``
from a process with live threads (the prefetch thread, CUDA's) can copy a
lock that another thread holds; ``spawn`` would import torch afresh in
every worker each epoch.  The dataset is pickled to each worker.  As with
any ``forkserver`` or ``spawn`` start, the server imports the main module,
so a script that iterates a ``WorkerLoader`` keeps its work under
``if __name__ == "__main__":``.  An epoch
cut short (a ``steps_per_epoch`` cap, a ``break``) shuts its workers down
before the loop goes on (:func:`posetpu_torch.data.loader.threaded_place_iter`
closes the source, and the source's ``finally`` stops them).  The server
and multiprocessing's resource tracker outlive the epochs; left alone they
exit a moment after this process does, and :func:`stop_worker_server`
stops both and waits for them.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.forkserver
import multiprocessing.resource_tracker

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

from posetpu_torch.data.loader import HostLoader, _collate, load_sample

START_METHOD = "forkserver"
# seconds the prefetch thread waits for one decoded sample before it
# raises: a worker that hangs or dies ends the epoch with an error, and an
# early exit never waits on it for longer (the server's first start took
# 7.5-13.2 s on an H100 host under gVisor, a sample well under 1 s)
WORKER_TIMEOUT = 120.0


class _SampleDecode(Dataset):
    """One decoded, padded sample a task (runs in the workers).  A task is
    (slot, row, dataset index): the image goes into ``slots[slot, row]``
    (shared memory), the rest of the sample comes back."""

    def __init__(self, dataset, pad_hw, slots):
        self.dataset = dataset
        self.pad_hw = tuple(pad_hw)
        self.slots = slots

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, task):
        slot, row, i = task
        item = load_sample(self.dataset, i, self.pad_hw, out=self.slots[slot, row].numpy())
        del item["image"]
        return item


def _as_is(item):
    """The DataLoader's collate: the sample as the worker made it."""
    return item


def stop_worker_server():
    """Stop the ``forkserver`` process that forks the workers, then the
    resource tracker it started, and wait for both to exit, so a process
    that is done with its loaders leaves nothing running when it ends.
    Call it only after every epoch has ended or been closed (its workers
    are gone then); the next ``WorkerLoader`` epoch starts a new server.
    Without a server this does nothing.  (The standard library stops both
    only through these methods, which its own tests use.)"""
    multiprocessing.forkserver._forkserver._stop()
    multiprocessing.resource_tracker._resource_tracker._stop()


class WorkerLoader(HostLoader):
    """:class:`HostLoader` with the decode in ``num_workers`` processes
    (0: in the prefetch thread, as ``HostLoader(backend="pil")``)."""

    def __init__(self, dataset, batch_size, pad_hw=(512, 512), shuffle=True, seed=0,
                 drop_last=True, prefetch=2, place=None, group=None, pad=False,
                 shard=None, num_workers=0):
        super().__init__(dataset, batch_size, pad_hw=pad_hw, shuffle=shuffle,
                         seed=seed, drop_last=drop_last, prefetch=prefetch,
                         backend="pil", place=place, group=group, pad=pad, shard=shard)
        if num_workers < 0:
            raise ValueError(f"num_workers must be >= 0, got {num_workers}")
        self.num_workers = num_workers
        self._slots = None

    def _prefetch_factor(self):
        # a batch's worth of samples in flight across the workers
        return max(2, -(-self.rows // self.num_workers)) if self.num_workers else None

    def _slot_buffers(self):
        """The ring of batch buffers the workers decode into, made once.
        The DataLoader hands out a new task only as it returns a sample, so
        at most ``ahead = prefetch_factor * num_workers`` samples are out
        beyond the last one returned: while batch b's slot is copied out,
        the workers write batches b+1 .. b+ceil(ahead / rows), and a
        ring of 1 + ceil(ahead / rows) slots never gives them b's (``rows``
        is the batch this process decodes: its rank's share).
        Without workers nothing runs ahead: one slot."""
        ahead = self._prefetch_factor() * self.num_workers if self.num_workers else 0
        if self._slots is None:
            n = 1 + -(-ahead // self.rows)
            self._slots = torch.empty((n, self.rows, *self.pad_hw, 3),
                                      dtype=torch.uint8)
            if self.num_workers:
                self._slots.share_memory_()
        return self._slots

    def _data_loader(self, tasks, slots):
        kw = {}
        if self.num_workers:
            ctx = multiprocessing.get_context(START_METHOD)
            # the server imports the main module (its default) and this
            # loader (and torch) once; the workers it forks start with both
            ctx.set_forkserver_preload(["__main__", __name__])
            kw = dict(multiprocessing_context=ctx, prefetch_factor=self._prefetch_factor(),
                      timeout=WORKER_TIMEOUT)
        return DataLoader(_SampleDecode(self.dataset, self.pad_hw, slots), batch_size=None,
                          sampler=tasks, num_workers=self.num_workers,
                          collate_fn=_as_is, **kw)

    def _batches(self, order):
        """The epoch's batches in ``order``, collated here from the
        workers' samples and their slot (copied into the placer's pinned
        buffer when it has one).  The workers stop when the epoch ends or
        is closed early."""
        slots = self._slot_buffers()
        sels = list(self._selections(order))
        tasks = [(b % len(slots), j, int(i)) for b, (sel, _) in enumerate(sels)
                 for j, i in enumerate(sel)]
        samples = iter(self._data_loader(tasks, slots))
        try:
            for b, (sel, mask) in enumerate(sels):
                n = len(sel)
                items = [next(samples) for _ in range(n)]
                arr, image = self._image_buffer(n)
                np.copyto(arr, slots[b % len(slots), :n].numpy())
                out = {"image": image, **_collate(items)}
                if mask is not None:
                    out["mask"] = mask
                yield out
        finally:
            shutdown = getattr(samples, "_shutdown_workers", None)
            if shutdown is not None:
                shutdown()
