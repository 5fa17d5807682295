"""The pose training step in plain float32 PyTorch: the keyed draws, the
crops and targets (``augment.py``), the network in train mode
(``hourglass.py``), the loss summed over stacks of each stack's mean
squared error, the gradients, and optax's RMSprop (``nu = d nu + (1 - d)
g^2``, ``p -= lr g / sqrt(nu + eps)``, no momentum, no weight decay; the
learning rate constant over the few steps followed).

:func:`follow` runs ``len(batches)`` steps from the benchmark's weights and
returns each step's loss, the parameters after and the optimizer's ``nu``
after, for :func:`benchmark.compare.train_numbers`.
"""

from __future__ import annotations

import torch

from benchmark.frozen.keyed import aug_params, jitter_scales
from benchmark.reference.augment import train_crops
from benchmark.reference.hourglass import Net


def loss_of(outs, target):
    return sum(((o - target) ** 2).mean() for o in outs)


def follow(weights, params, batches, *, first, seed, model, aug, optim, mean,
           quant=False, rows=None):
    """``weights``: every named tensor the network reads (copied here);
    ``params``: the names of those that train, from zero second moments.
    ``batches``: a list of one batch a step.  ``rows`` keeps only the first
    ``rows`` rows of each batch (a planted fault of the checks: half the
    batch left out).  Returns (each step's loss, {name: parameter after the
    last step}, {name: second moment after the first ``first`` steps, in
    float64})."""
    w = {n: t.detach().float().clone() for n, t in weights.items()}
    nu = {n: torch.zeros_like(w[n]) for n in params}
    added = {n: torch.zeros_like(w[n], dtype=torch.float64) for n in params}
    early = None
    d, eps, lr = optim["rms_decay"], optim["rms_eps"], optim["lr"]
    losses = []
    for step, b in enumerate(batches):
        if rows is not None:
            b = {k: v[:rows] for k, v in b.items()}
        scale_f, rot, flip = aug_params(seed, step, b["index"], aug)
        jitter = jitter_scales(seed, step, b["index"]) if aug["color_jitter"] else None
        with torch.no_grad():
            x, target = train_crops(b, scale_f, rot, flip, jitter, aug, mean)
        leaves = [w[n].requires_grad_(True) for n in params]
        loss = loss_of(Net(w, model, train=True, quant=quant)(x), target)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for n, g in zip(params, grads):
                nu[n].mul_(d).add_((1.0 - d) * g * g)
                added[n].mul_(d).add_((1.0 - d) * g.double() ** 2)
                w[n].sub_(lr * g * torch.rsqrt(nu[n] + eps))
        for leaf in leaves:
            leaf.requires_grad_(False)
        losses.append(float(loss.detach()))
        if step + 1 == first:
            early = {n: v.clone() for n, v in added.items()}
        del loss, grads, x, target
    return torch.tensor(losses, dtype=torch.float64), {n: w[n] for n in params}, early
