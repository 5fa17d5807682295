"""flax's train-mode BatchNorm statistics on torch's ``BatchNorm2d``.

flax (``momentum=0.9``, eps 1e-5) averages the *biased* batch variance into
its running variance; torch (``momentum=0.1``) takes the unbiased one.
:class:`BatchNorm2d` records how many values each channel's statistics were
taken over, and :func:`flax_train_forward` corrects torch's update after a
train-mode forward.  Every network of the port that mirrors a flax
BatchNorm in train mode runs its forward through it.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class BatchNorm2d(nn.BatchNorm2d):
    """torch's BatchNorm2d that records, in train mode, how many values
    each channel's batch statistics were taken over (B*H*W of its last
    input), for :func:`flax_train_forward`.  Parameters, buffers and
    state-dict names are torch's."""

    batch_count = None

    def forward(self, x):
        if self.training:
            self.batch_count = x.numel() // x.shape[1]
        return super().forward(x)


def flax_train_forward(norms, forward, x):
    """``forward(x)`` in train mode, after which each of ``norms``' running
    variance is flax's ``m*rv + (1-m)*var_biased`` (m = 0.9), without a
    second pass over the activations.

    torch leaves ``rv_t = m*rv + (1-m)*var*n/(n-1)`` with n = B*H*W values
    per channel, so ``rv_t*(1-1/n) + m*rv/n`` is flax's value: one copy of
    each C-sized ``rv`` before the forward and three ``_foreach`` calls over
    all BatchNorms after it.  Each norm must see exactly one input in
    ``forward``.
    """
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
