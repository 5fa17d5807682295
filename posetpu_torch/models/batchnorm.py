"""flax's train-mode BatchNorm statistics on torch's ``BatchNorm2d``, on
one process or across the ranks of a data-parallel group.

flax (``momentum=0.9``, eps 1e-5) averages the *biased* batch variance into
its running variance; torch (``momentum=0.1``) takes the unbiased one.
:class:`BatchNorm2d` records how many values each channel's statistics were
taken over, and :func:`flax_train_forward` corrects torch's update after a
train-mode forward.  Every network of the port that mirrors a flax
BatchNorm in train mode runs its forward through it.

Across ranks (:func:`convert_cross_replica_`, the reference's
``nn.BatchNorm(axis_name=...)``) a norm computes flax 0.12's
``_compute_stats`` with ``use_fast_variance=True`` itself: each rank's
float32 mean and mean of squares per channel, averaged over the ranks in
one differentiable all-reduce of a (2, C) stack, ``var = max(mu2 - mu²,
0)``, and the running statistics ``0.9 r + 0.1 stat`` with that biased
global variance.  It updates its running statistics itself, so
:func:`flax_train_forward` leaves it out and the correction is applied
exactly once.  It is written in plain torch ops, which run on the CPU as
on the card (torch's ``SyncBatchNorm`` refuses CPU tensors).

Remat (:func:`remat`, the reference's ``nn.remat``) runs a checkpointed
forward a second time in the backward pass.  flax drops the batch
statistics of that recompute; so do the norms here: inside
:func:`recomputing` a train-mode norm normalizes with the batch's
statistics as before and leaves ``running_mean``, ``running_var`` and
``num_batches_tracked`` alone.  A cross-replica norm still all-reduces its
moments there (one more all-reduce a norm a step), since the recomputed
values must be the first forward's.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from posetpu_torch.parallel.dp import all_reduce_sum, group_size

# flax's BatchNorm momentum (torch's ``momentum`` is 1 minus it)
FLAX_MOMENTUM = 0.9

# whether this thread runs the recompute of a checkpointed forward (the
# autograd engine runs a CUDA backward on a thread of its own)
_recompute = threading.local()


@contextlib.contextmanager
def recomputing():
    """The norms called inside leave their running statistics alone."""
    prev = getattr(_recompute, "on", False)
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = prev


def is_recomputing():
    """Whether this thread runs inside :func:`recomputing`."""
    return getattr(_recompute, "on", False)


def _recompute_context():
    return contextlib.nullcontext(), recomputing()


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    instead of kept (``torch.utils.checkpoint``, non-reentrant), with the
    norms' statistics left alone in the recompute (:func:`recomputing`).
    Autocast is restored for the recompute; the RNG state is not (the
    networks draw nothing), which also keeps it capturable in a CUDA
    graph.  Without autograd it is ``fn(*args)``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=_recompute_context)


class BatchNorm2d(nn.BatchNorm2d):
    """torch's BatchNorm2d that records, in train mode, how many values
    each channel's batch statistics were taken over (B*H*W of its last
    input), for :func:`flax_train_forward`.  With ``group`` set
    (:func:`convert_cross_replica_`) its train-mode statistics are taken
    across that group's ranks.  Parameters, buffers and state-dict names
    are torch's."""

    batch_count = None
    group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            return self._cross_replica(x)
        if x.device.type == "cpu" and x.dtype != torch.bfloat16:
            # torch's CPU batch_norm takes the statistics of a channels-last
            # input (the layout an NHWC network input carries) far less
            # accurately: 1.3e-4 from float64 against 6.1e-7 contiguous at
            # (6, 64, 32, 32); a bfloat16 input's own rounding is far wider
            x = x.contiguous()
        if is_recomputing():
            # the first forward's op on copies of the running statistics:
            # the same values, and the same tensors saved for the backward
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, self.momentum, self.eps)
        self.batch_count = x.numel() // x.shape[1]
        return super().forward(x)

    def _cross_replica(self, x):
        """flax's ``_compute_stats`` (fast variance, pmean of the (2, C)
        moments) and ``_normalize``, in float32 (or wider), cast to ``x``'s
        dtype."""
        # at least float32, as flax promotes (a float64 reference stays so)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3)
        moments = torch.stack([xf.mean(dims), (xf * xf).mean(dims)])
        moments = all_reduce_sum(moments, self.group) / group_size(self.group)
        mu, mu2 = moments[0], moments[1]
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        if not is_recomputing():
            self._update_running(mu, var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mu[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mu, var):
        """flax's running statistics, with the batch's biased variance."""
        m = FLAX_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mu)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        self.num_batches_tracked.add_(1)


def convert_cross_replica_(model, group):
    """Make every :class:`BatchNorm2d` of ``model`` take its train-mode
    statistics across the ranks of ``group``, in place (as
    ``SyncBatchNorm.convert_sync_batchnorm`` does, without new modules: the
    parameters, buffers and state-dict names stay).  A group of one rank
    (or None) leaves the norms as they are: their statistics are the
    local batch's already.  Returns ``model``."""
    g = group if group_size(group) > 1 else None
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.group = g
    return model


def flax_train_forward(norms, forward, x):
    """``forward(x)`` in train mode, after which each of ``norms``' running
    variance is flax's ``m*rv + (1-m)*var_biased`` (m = 0.9), without a
    second pass over the activations.

    torch leaves ``rv_t = m*rv + (1-m)*var*n/(n-1)`` with n = B*H*W values
    per channel, so ``rv_t*(1-1/n) + m*rv/n`` is flax's value: one copy of
    each C-sized ``rv`` before the forward and three ``_foreach`` calls over
    all BatchNorms after it.  Each norm must see exactly one input in
    ``forward``.  A cross-replica norm (``group`` set) takes flax's
    update itself and is left out.
    """
    norms = [bn for bn in norms if bn.group is None]
    if not norms:
        return forward(x)
    # ``.data``: autograd saved the buffers with the forward (a train-mode
    # backward reads the saved batch statistics, never these), and an
    # update it tracked would fail that check
    running = [bn.running_var.data for bn in norms]
    with torch.no_grad():
        kept = torch._foreach_mul(running, [1.0 - bn.momentum for bn in norms])
    out = forward(x)
    with torch.no_grad():
        counts = [bn.batch_count for bn in norms]
        torch._foreach_mul_(running, [1.0 - 1.0 / n for n in counts])
        torch._foreach_mul_(kept, [1.0 / n for n in counts])
        torch._foreach_add_(running, kept)
    return out
