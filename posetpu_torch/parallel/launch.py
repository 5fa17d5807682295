"""Start W ranks and run functions on them.

:class:`RankPool` spawns one process a rank, joins them into a process
group (:func:`posetpu_torch.parallel.dp.init_process_group`) and runs the
functions handed to :meth:`RankPool.run` on every rank, in order, each as
``fn(ctx, *args)`` with a :class:`RankContext`.  The train command line
(``--num-devices N``) runs its ranks through it; so do the tests and the
card's smoke script, which keep one pool for many steps.

Processes start by ``spawn``: a rank imports torch afresh and holds no
copy of the parent's threads or CUDA context.  A function and its
arguments are pickled to every rank, so the function lives at the top of an
importable module.  What a rank returns comes back with every tensor as a
numpy array (bfloat16 as float32).
"""

from __future__ import annotations

import multiprocessing
import queue
import traceback
from dataclasses import dataclass

import numpy as np
import torch

from posetpu_torch.parallel.dp import free_port, init_process_group
from posetpu_torch.utils.device import resolve_device

# seconds run() waits for every rank's answer by default, and close() for
# each rank to exit before it kills it
JOIN_TIMEOUT = 120.0


@dataclass
class RankContext:
    """What a function run on a rank gets: its rank, the world size, the
    process group and its device."""

    rank: int
    world: int
    group: object
    device: torch.device


def to_numpy(tree):
    """Tensors in nested dicts, lists and tuples as numpy arrays."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a named tuple
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def _serve(rank, world, port, device, backend, threads, tasks, results):
    if threads:
        torch.set_num_threads(threads)
    try:
        group = init_process_group(rank, world, device, backend=backend, port=port)
        ctx = RankContext(rank, world, group, torch.device(device))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    import torch.distributed as dist

    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, to_numpy(fn(ctx, *args))))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` ranks, each a spawned process in one process group.

    ``devices``: one device per rank (``"cpu"``, ``"cuda:0"``, ...), or one
    for all; by default rank r runs on ``cuda:r``, and without CUDA the
    pool raises unless the caller asks for ``"cpu"``.  ``backend`` as :func:`init_process_group`'s (gloo on the CPU,
    NCCL on CUDA, unless given).  ``threads`` sets each rank's torch
    threads.  ``timeout`` bounds each :meth:`run` (None: no bound).  Use it
    as a context manager: leaving it stops every rank, and kills one that
    does not exit within ``JOIN_TIMEOUT``.
    """

    def __init__(self, world, devices=None, backend=None, threads=None,
                 timeout=JOIN_TIMEOUT):
        if devices is None:
            devices = [f"cuda:{r}" for r in range(world)]
        elif isinstance(devices, str):
            devices = [devices] * world
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        devices = [str(resolve_device(d)) for d in devices]
        self.world, self.timeout = world, timeout
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._procs = [
            ctx.Process(target=_serve, daemon=True,
                        args=(r, world, port, devices[r], backend, threads,
                              self._tasks[r], self._results))
            for r in range(world)
        ]
        self._closed = False
        for p in self._procs:
            p.start()

    def run(self, fn, *args):
        """``fn(ctx, *args)`` on every rank; the list of what each rank
        returned, by rank.  A rank that raises or exits, or no answer from
        every rank within ``timeout`` (None: no limit), stops every rank
        and raises."""
        for q in self._tasks:
            q.put((fn, args))
        out, answered = [None] * self.world, set()
        waited = 0.0
        while len(answered) < self.world:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(self._procs)
                        if r not in answered and not p.is_alive()]
                late = self.timeout is not None and waited > self.timeout
                if dead or late:
                    self.close(kill=True)
                    raise RuntimeError(
                        f"{fn.__name__}: " + (f"ranks {dead} exited without an answer"
                                              if dead else f"no answer within "
                                              f"{self.timeout:.0f} s")) from None
                continue
            answered.add(rank)
            if ok:
                out[rank] = value
            else:
                # the others may wait in a collective for it: stop them all
                self.close(kill=True)
                raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n{value}")
        return out

    def close(self, kill=False):
        """Stop every rank: let each finish and exit (killed after
        ``JOIN_TIMEOUT``), or with ``kill`` at once."""
        if self._closed:
            return
        self._closed = True
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive() and not kill:
                q.put(None)
        for p in self._procs:
            if not kill:
                p.join(JOIN_TIMEOUT)
            if p.is_alive():
                p.kill()
            p.join()
        for q in (*self._tasks, self._results):
            q.close()
            q.join_thread()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def ranks_equal(values):
    """Whether every rank returned equal arrays (bit for bit), for a tree of
    numpy arrays from :meth:`RankPool.run`."""
    first = values[0]

    def eq(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(eq(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
        return a == b

    return all(eq(first, v) for v in values[1:])
