"""Train state and optimizer — counterpart of ``posetpu/train/state.py``.

The JAX package trains with optax's ``rmsprop`` (decay 0.99, eps 1e-8)
over a ``piecewise_constant_schedule``, behind ``add_decayed_weights`` when
``weight_decay`` is set.  Its docstring calls that chain torch's RMSprop;
it is not, and :class:`OptaxRMSprop` follows optax:

- eps sits inside the root, ``g * rsqrt(nu + eps)``; torch divides by
  ``sqrt(nu) + eps``.  With eps 1e-8 the first update of a gradient of
  1e-5 is 1/100 of torch's, and the gap grows as the gradient shrinks.
- The learning rate scales the update *before* the momentum trace, so the
  trace accumulates lr-scaled updates; torch applies lr after its buffer.
  The two differ from the first drop of the schedule on.
- The schedule is read at the optimizer's update count *before* the
  update, and a drop applies once ``count >= boundary``.  There is one
  update count, as optax holds it, and no torch ``LRScheduler``.

A ViT config (:class:`posetpu_torch.configs.AdamWConfig`) trains with
:class:`LayerDecayAdamW`, torch's fused AdamW as ViTPose's mmcv runner
drives it: over the network's groups
(:meth:`posetpu_torch.models.ViTPose.param_groups`: one a layer and weight
decay or none), each group's learning rate the schedule's times its
``lr_scale``, and the warm-up-then-step schedule
(:func:`warmup_step_schedule`) read at the same single update count, on
the card inside a CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from posetpu_torch.utils import profiling
from posetpu_torch.utils.graphs import state_slots


@dataclass
class TrainState:
    """What a train step reads and advances: the model (parameters and
    BatchNorm statistics), its optimizer (RMSprop's or AdamW's moments and
    the update count) and the number of train steps taken, which keys the
    augmentation draws.  ``step`` and the optimizer's ``count`` are Python
    ints, the record that checkpoints save; a graphed dispatch
    (:func:`posetpu_torch.train.step.make_dispatch_step`) mirrors them in
    device tensors and advances the ints by the steps each replay ran."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def holders(self):
        """(modules, optimizers): what holds :meth:`tensors`."""
        return (self.model,), (self.optimizer,)

    def tensors(self):
        """Every tensor a train step updates in place, in a fixed order:
        parameters, buffers (BatchNorm statistics) and the optimizer's
        moments, which are made first (zero) where no update has made them
        yet, so the list is the same before and after a step
        (:func:`posetpu_torch.utils.graphs.state_slots`)."""
        return [d[k] for d, k in zip(*state_slots(*self.holders()))]

    def snapshot(self):
        """(clones of :meth:`tensors`, the optimizer's count, ``step``)."""
        with torch.no_grad():
            saved = [t.detach().clone() for t in self.tensors()]
        return saved, self.optimizer.count, self.step

    def restore_(self, snap):
        """Put a :meth:`snapshot` back *in place* (``copy_``): a captured
        CUDA graph holds the addresses of these tensors."""
        saved, count, step = snap
        with torch.no_grad():
            for t, v in zip(self.tensors(), saved, strict=True):
                t.copy_(v)
        self.optimizer.count, self.step = count, step


def lr_schedule(optim_cfg, steps_per_epoch):
    """Step-decay schedule matching the reference's manual
    ``adjust_learning_rate``: ``optim_cfg.lr`` dropped by ``gamma`` at each
    epoch in ``schedule``, over optimizer updates
    (``int(e) * steps_per_epoch``).

    Returns ``count -> lr``, the float32 value optax's
    ``piecewise_constant_schedule`` computes, rounding for rounding:
    ``v = v*ind + (1-ind)*scale*v`` with ``ind = max(0, sign(b - count))``.
    For a Python int ``count`` the value is a Python float; for a 0-d int64
    tensor it is a 0-d float32 tensor on the count's device, computed there
    by the same float32 operations (a train step inside a CUDA graph reads
    its count on the device).
    """
    boundaries = sorted(
        {int(e) * steps_per_epoch: optim_cfg.gamma for e in optim_cfg.schedule}.items()
    )
    f32 = np.float32

    def on_device(count):
        v = torch.full((), float(f32(optim_cfg.lr)), dtype=torch.float32,
                       device=count.device)
        for threshold, scale in boundaries:
            ind = torch.clamp(torch.sign(threshold - count), min=0).to(torch.float32)
            v = v * ind + ((1.0 - ind) * float(f32(scale))) * v
        return v

    def schedule(count):
        if isinstance(count, torch.Tensor):
            return on_device(count)
        v = f32(optim_cfg.lr)
        for threshold, scale in boundaries:
            ind = f32(max(0.0, float(np.sign(threshold - int(count)))))
            v = f32(v * ind) + f32(f32(f32(1.0) - ind) * f32(scale)) * v
        return float(v)

    return schedule


class OptaxRMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop`` chain as a torch optimizer, written with
    ``torch._foreach_*`` ops (one pass per op over all parameters).

    Per update, in optax's order: ``g += weight_decay * p`` (when set);
    ``nu = (1 - decay) * g**2 + decay * nu``; ``u = g * rsqrt(nu + eps)``;
    ``u = -lr(count) * u``; ``m = u + momentum * m`` and ``u = m`` (when
    momentum is set); ``p += u``; ``count += 1``.  ``nu`` and ``m`` start
    at zero.  A parameter without a gradient takes a zero one, as optax
    updates every leaf with the gradient ``jax.grad`` gives it (zero where
    the loss does not reach): its ``nu`` and trace decay, and with
    ``weight_decay`` the parameter does (the scanned hourglass's unused last
    remap, :class:`posetpu_torch.models.HourglassNet`).
    """

    def __init__(self, params, schedule, *, decay=0.99, eps=1e-8, momentum=0.0,
                 weight_decay=0.0):
        super().__init__(params, dict(decay=decay, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay))
        self.schedule = schedule
        self.count = 0  # optax's ScaleByScheduleState.count

    def _moments(self, p, momentum):
        st = self.state[p]
        if "nu" not in st:
            st["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        if momentum and "trace" not in st:
            st["trace"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return st

    def init_moments(self):
        """Make every parameter's zero moments now (they are otherwise made
        at its first update): a CUDA graph's capture needs them to exist
        at fixed addresses before it starts."""
        for group in self.param_groups:
            for p in group["params"]:
                self._moments(p, group["momentum"])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxRMSprop takes no closure")
        self._update(-self.schedule(self.count))
        self.count += 1

    @torch.no_grad()
    def step_at(self, count):
        """One update with the schedule read at ``count``, a 0-d int64
        tensor on the parameters' device, which then advances by one in
        place: the update a CUDA graph can replay.  ``self.count``, the
        host's record, is the caller's to advance."""
        self._update(-self.schedule(count))
        count.add_(1)

    def _update(self, neg_lr):
        """optax's update with ``neg_lr`` = -lr (a float, or a 0-d float32
        tensor on the parameters' device)."""
        for group in self.param_groups:
            d, mu, wd = group["decay"], group["momentum"], group["weight_decay"]
            params = group["params"]
            states = [self._moments(p, mu) for p in params]
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            if wd:
                grads = torch._foreach_add(grads, params, alpha=wd)
            nus = [st["nu"] for st in states]
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - d)
            torch._foreach_mul_(nus, d)
            torch._foreach_add_(nus, sq)
            upd = torch._foreach_add(nus, group["eps"])
            torch._foreach_rsqrt_(upd)
            torch._foreach_mul_(upd, grads)
            torch._foreach_mul_(upd, neg_lr)
            if mu:
                traces = [st["trace"] for st in states]
                torch._foreach_mul_(traces, mu)
                torch._foreach_add_(traces, upd)
                upd = traces
            torch._foreach_add_(params, upd)

    def load_carried(self, model, carried):
        """Take optimizer state carried from optax
        (:func:`posetpu_torch.ckpt.from_optax_state`): ``nu`` and ``trace``
        by the model's parameter names, and the update count."""
        named = dict(model.named_parameters())
        mine = {p for g in self.param_groups for p in g["params"]}
        for key in ("nu", "trace"):
            tree = carried.get(key)
            if tree is None:
                continue
            if set(tree) != set(named):
                missing = sorted(set(named) ^ set(tree))[:5]
                raise KeyError(f"carried {key} does not match the model: {missing}")
            for name, arr in tree.items():
                p = named[name]
                if p not in mine:
                    raise KeyError(f"{name} is not a parameter of this optimizer")
                self.state[p][key] = arr.to(device=p.device, dtype=p.dtype).clone()
        self.count = int(carried["count"])


# AdamW's constants as ViTPose trains with it, and the warm-up's first
# share of the rate
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
WARMUP_RATIO = 0.001


def warmup_step_schedule(optim_cfg, steps_per_epoch):
    """mmcv's step policy behind a linear warm-up, as ViTPose configures
    it: ``count -> lr``, where the step-decayed rate is ``optim_cfg.lr``
    times ``gamma`` for each epoch of ``schedule`` reached (update
    ``int(e) * steps_per_epoch`` on), and while ``count <
    warmup_iters`` it is scaled by ``1 - (1 - count / warmup_iters) (1 -
    WARMUP_RATIO)``.  ``count`` is a 0-d int64 tensor, read on its device
    (a train step inside a CUDA graph reads it there) in float64, as mmcv
    computes in Python floats (in float32, ``1 - 0.999`` alone is 1.3e-5
    off); the result is a 0-d float32 tensor."""
    boundaries = sorted({int(e) * steps_per_epoch for e in optim_cfg.schedule})
    warm, ratio = int(optim_cfg.warmup_iters), WARMUP_RATIO

    def schedule(count):
        v = torch.full((), float(optim_cfg.lr), dtype=torch.float64, device=count.device)
        for b in boundaries:
            v = torch.where(count >= b, v * float(optim_cfg.gamma), v)
        if warm > 0:
            k = (1.0 - count.to(torch.float64) / warm) * (1.0 - ratio)
            v = torch.where(count < warm, v * (1.0 - k), v)
        return v.to(torch.float32)

    return schedule


class LayerDecayAdamW(torch.optim.AdamW):
    """torch's fused ``AdamW`` with ViTPose's betas and eps, over groups
    that each carry an ``lr_scale`` (1 where a group gives none): an
    update's rate in a group is the schedule's at the update count before
    it times ``lr_scale``, written on the card into the group's own 0-d
    ``lr`` tensor, which the fused kernel reads there, so an update inside
    a CUDA graph reads its count on the device as an eager one does.
    ``count`` (the host's record, which the schedule reads) starts at 0, as
    each parameter's ``step`` (which torch's bias corrections read) does;
    an update advances both, and leaves a parameter without a gradient as
    it is (torch's rule: ViTPose's every parameter has one).  Build it
    after the parameters are on their device; it is capturable there on
    the card."""

    def __init__(self, params, schedule, *, weight_decay=0.0):
        super().__init__(params, lr=0.0, betas=ADAMW_BETAS, eps=ADAMW_EPS,
                         weight_decay=weight_decay, fused=True)
        for group in self.param_groups:
            group.setdefault("lr_scale", 1.0)
        self._own_lrs()
        self.schedule = schedule
        self.count = 0

    def _own_lrs(self):
        """A 0-d ``lr`` tensor for each group on its parameters' device,
        and ``capturable`` there where that is the card."""
        for group in self.param_groups:
            dev = group["params"][0].device
            group["lr"] = torch.zeros((), device=dev)
            group["capturable"] = dev.type == "cuda"

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        self._own_lrs()

    def init_moments(self):
        """Make every parameter's state now as torch's first update would
        (``step`` 0, zero moments): a CUDA graph's capture needs them at
        fixed addresses before it starts."""
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LayerDecayAdamW takes no closure")
        dev = self.param_groups[0]["lr"].device
        # a fill on the device, not a copy from the host: no sync
        self.step_at(torch.full((), self.count, dtype=torch.int64, device=dev))
        self.count += 1

    @torch.no_grad()
    def step_at(self, count):
        """One update at ``count``, a 0-d int64 tensor on the parameters'
        device, which then advances by one in place (the update a CUDA
        graph can replay); ``self.count`` is the caller's to advance."""
        lrs = [group["lr"] for group in self.param_groups]
        torch._foreach_copy_(lrs, [self.schedule(count)] * len(lrs))
        torch._foreach_mul_(lrs, [group["lr_scale"] for group in self.param_groups])
        super().step()
        count.add_(1)


def make_optimizer(params, optim_cfg, steps_per_epoch=1):
    """The optimizer of ``optim_cfg`` over ``params`` (parameters, or
    groups of them as torch takes them: a network's ``param_groups``): the
    JAX package's (``make_optimizer``), optax-exact RMSprop with the
    step-decay schedule; or for an
    :class:`posetpu_torch.configs.AdamWConfig`, :class:`LayerDecayAdamW`
    with :func:`warmup_step_schedule`.  Sets the registry's counters
    ``optim.param_groups`` and ``optim.params``."""
    if optim_cfg.optimizer == "adamw":
        opt = LayerDecayAdamW(params, warmup_step_schedule(optim_cfg, steps_per_epoch),
                              weight_decay=optim_cfg.weight_decay)
    elif optim_cfg.optimizer == "rmsprop":
        opt = OptaxRMSprop(
            params,
            lr_schedule(optim_cfg, steps_per_epoch),
            decay=optim_cfg.rms_decay,
            eps=optim_cfg.rms_eps,
            momentum=optim_cfg.momentum,
            weight_decay=optim_cfg.weight_decay,
        )
    else:
        raise ValueError(f"unknown optimizer {optim_cfg.optimizer!r} "
                         "(expected 'rmsprop' or 'adamw')")
    profiling.set_counter("optim.param_groups", len(opt.param_groups))
    profiling.set_counter("optim.params", sum(len(g["params"]) for g in opt.param_groups))
    return opt
