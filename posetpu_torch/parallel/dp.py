"""Data parallelism over ``torch.distributed`` — the counterpart of
``posetpu/parallel/dp.py`` (``make_mesh``, the ``P(axis)`` and
``P(None, axis)`` batch shardings, ``pmean``/``psum``).

One process a device.  A global batch of B rows is cut into W equal
slices, rank r taking rows ``[r*B/W, (r+1)*B/W)`` (:func:`shard_slice`);
parameters, buffers and optimizer state are replicated, and the steps
(:mod:`posetpu_torch.train.step`, :mod:`posetpu_torch.train.adversarial`)
average gradients and metrics over one flat bucket each
(:func:`all_reduce_mean_`, :func:`all_reduce_sum_`).  BatchNorm takes its
statistics across the ranks (:func:`posetpu_torch.models.batchnorm.convert_cross_replica_`),
so a W-rank step computes what one process computes at batch B.

The collectives are plain ``torch.distributed`` calls on a group, not the
``DistributedDataParallel`` wrapper: the graphed train step captures them
inside its CUDA graph (NCCL), and the joint step runs two backward passes.
NCCL is the backend on CUDA and gloo on the CPU; gloo also takes CUDA
tensors for ``all_reduce`` and ``broadcast`` (not ``all_gather``, which is
why :func:`gather_rows` is an ``all_reduce``).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from posetpu_torch.utils.device import resolve_device

DEFAULT_ADDR = "127.0.0.1"


def free_port():
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((DEFAULT_ADDR, 0))
        return s.getsockname()[1]


def init_process_group(rank, world, device, *, backend=None, port=None,
                       init_method=None):
    """Join rank ``rank`` of ``world`` and return the default group.

    ``backend`` defaults to NCCL for a CUDA ``device`` and gloo for the
    CPU; gloo over CUDA tensors is allowed (two ranks sharing one card).
    The rendezvous is ``init_method`` when given (``"env://"`` under
    ``torchrun``), else ``tcp://$MASTER_ADDR:port`` with ``port`` or
    ``$MASTER_PORT`` (``MASTER_ADDR`` defaults to 127.0.0.1).  On CUDA the
    process's current device becomes ``device`` first."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", DEFAULT_ADDR)
        port = port if port is not None else os.environ.get("MASTER_PORT")
        if port is None:
            raise ValueError("no rendezvous: pass port= or set MASTER_PORT")
        init_method = f"tcp://{addr}:{int(port)}"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return dist.group.WORLD


def group_size(group):
    """Ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group):
    """This process's rank in ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def barrier(group):
    """Wait for every rank of ``group``; nothing without a group."""
    if group is not None:
        dist.barrier(group)


def is_gloo(group):
    return group is not None and dist.get_backend(group) == "gloo"


def resolve_num_devices(requested, device_type):
    """The reference's device-count rule (``posetpu/train/loop.py:92-103``):
    ``None`` takes every visible GPU on CUDA and one process on the CPU; a
    request beyond what is visible (the GPUs; on the CPU, where a rank is a
    gloo process, the cores) raises rather than run a DP config on fewer
    devices.  Raises without CUDA for ``"cuda"``."""
    if device_type == "cuda":
        resolve_device("cuda")
        avail = torch.cuda.device_count()
    else:
        avail = os.cpu_count() or 1
    if requested is None:
        n = avail if device_type == "cuda" else 1
    else:
        n = int(requested)
    if n < 1:
        raise ValueError(f"num_devices must be >= 1, got {n}")
    if n > avail:
        raise RuntimeError(
            f"config requests num_devices={n} but only {avail} device(s) are "
            f"visible — pass --num-devices {avail} to run on this host deliberately"
        )
    return n


def check_batch(batch_size, world):
    """A global batch must cut into ``world`` equal slices."""
    if batch_size % world:
        raise ValueError(f"batch {batch_size} not divisible by {world} devices")
    return batch_size // world


def shard_slice(batch, rank, world):
    """Rank ``rank``'s rows ``[rank*B/W, (rank+1)*B/W)`` of every field of
    a global ``batch`` of B rows (the reference's ``P(axis)``)."""
    out = {}
    for k, v in batch.items():
        per = check_batch(v.shape[0], world)
        out[k] = v[rank * per:(rank + 1) * per]
    return out


def _all_reduce_bucket_(tensors, group, divide):
    """Sum ``tensors`` over the ranks of ``group`` in place, as one flat
    bucket (one collective), divided by the number of ranks if ``divide``."""
    tensors = list(tensors)
    flat = torch._utils._flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    if divide:
        flat.div_(group_size(group))
    for t, r in zip(tensors, torch._utils._unflatten_dense_tensors(flat, tensors)):
        t.copy_(r)
    return tensors


def all_reduce_sum_(tensors, group):
    """``jax.lax.psum`` of each of ``tensors``, in place, in one bucket."""
    return _all_reduce_bucket_(tensors, group, divide=False)


def all_reduce_mean_(tensors, group):
    """``jax.lax.pmean`` of each of ``tensors``, in place, in one bucket:
    the sum over the ranks divided by their number (exact for a power of
    two, and for one rank)."""
    return _all_reduce_bucket_(tensors, group, divide=True)


def mean_grads_(params, group):
    """Average the gradients of ``params`` over the ranks (the reference's
    ``pmean(grads)``), in one bucket.  A parameter without a gradient has
    none on every rank (the same graph) and is skipped."""
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        all_reduce_mean_(grads, group)


class _AllReduceSum(torch.autograd.Function):
    """Differentiable all-reduce sum (the transpose of a sum over ranks is
    the sum over ranks of the cotangents), as
    ``torch.distributed.nn.functional.all_reduce`` without its deprecation."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x, group):
    """The sum of ``x`` over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def gather_rows(x, group):
    """Every rank's rows of ``x`` (n, ...), in rank order: (W*n, ...).

    Built from an ``all_reduce`` of a zero buffer in which each rank writes
    its own rows, so it runs on gloo with CUDA tensors (no ``all_gather``
    there).  Exact: every element is one rank's value plus zeros."""
    world = group_size(group)
    if world == 1:
        return x
    n = x.shape[0]
    buf = torch.zeros((world * n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    r = group_rank(group)
    buf[r * n:(r + 1) * n] = x
    dist.all_reduce(buf, group=group)
    return buf


@torch.no_grad()
def broadcast_state_(module, group):
    """Give every rank rank 0's parameters and buffers, in place."""
    if group is None:
        return module
    src = dist.get_global_rank(group, 0)
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
    return module


def reduce_metrics(group, means=(), sums=()):
    """Metrics over the ranks in one collective: each of ``means`` averaged
    (``pmean``), each of ``sums`` summed (``psum``).  Returns two lists of
    new float32 tensors; the inputs are left as they are."""
    ts = [t.detach().float().clone() for t in (*means, *sums)]
    all_reduce_sum_(ts, group)
    w = group_size(group)
    return [t / w for t in ts[:len(means)]], ts[len(means):]
