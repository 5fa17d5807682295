"""Stacked hourglass network — counterpart of
``posetpu/models/hourglass.py``.

Module names follow ``tools/torch_baseline.py:build_torch_hourglass`` so
the weight carry (:mod:`posetpu_torch.ckpt.transplant`) maps the JAX
package's parameters one to one.  With ``num_blocks`` > 1 each residual
site (every ``up1``, ``low1``, ``low2`` and ``low3`` of an hourglass, and
each stack's ``res``) is an ``nn.Sequential`` of that many bottlenecks,
named ``<site>.<j>``; the stem keeps its three.  A ``num_blocks=1`` network
has one bottleneck at each site under the site's own name.

``remat`` recomputes activations in the backward pass instead of keeping
them (:func:`posetpu_torch.models.batchnorm.remat`), by the reference's
units: each hourglass, or with ``scan_stacks`` each whole stack (hourglass,
``res``, ``fc``, ``score`` and the remap).  ``scan_stacks`` is the
reference's ``nn.scan`` layout: the same computation, with the last stack's
remap (``fc_`` and ``score_``) held too, as the reference's checkpoint
holds it.  The reference computes that remap and throws it away; here it is
not computed, and autograd gives its parameters no gradient (the optimizer
takes that as zero, as optax does).

The network takes NHWC input like the reference and runs NCHW inside; it
returns each stack's heatmaps as (B, K, H, W) float32.

With ``dtype=torch.bfloat16`` the forward runs under bf16 autocast with
float32 parameters and BatchNorm statistics, as the reference computes in
bf16 over f32 params; the ``score`` head stays float32 either way.
BatchNorm: eps 1e-5; flax ``momentum=0.9`` is torch ``momentum=0.1``.

In train mode the running variances follow flax, which averages in the
*biased* batch variance where torch takes the unbiased one
(:mod:`posetpu_torch.models.batchnorm`).  Eval mode is torch's BatchNorm
as it is.  Under data parallelism the network takes its process group
through :func:`posetpu_torch.models.batchnorm.convert_cross_replica_`, as
the reference's modules take ``axis_name``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from posetpu_torch.models.batchnorm import BatchNorm2d, flax_train_forward, remat


class Bottleneck(nn.Module):
    """Pre-activation bottleneck residual, expansion 2: BN-ReLU-1x1(planes)
    -> BN-ReLU-3x3(planes) -> BN-ReLU-1x1(2*planes), identity or 1x1
    ``proj`` skip."""

    def __init__(self, cin, planes):
        super().__init__()
        cout = 2 * planes
        self.bn1 = BatchNorm2d(cin)
        self.conv1 = nn.Conv2d(cin, planes, 1)
        self.bn2 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.bn3 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1)
        self.proj = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        y = self.conv3(F.relu(self.bn3(y)))
        return y + (x if self.proj is None else self.proj(x))


def residual(planes, num_blocks):
    """One residual site at width 2 * ``planes``: a bottleneck, or an
    ``nn.Sequential`` of ``num_blocks`` of them."""
    if num_blocks == 1:
        return Bottleneck(2 * planes, planes)
    return nn.Sequential(*[Bottleneck(2 * planes, planes) for _ in range(num_blocks)])


class Hourglass(nn.Module):
    """One recursive hourglass: at each of ``depth`` levels a skip residual
    plus a max-pooled branch that recurses, then a nearest 2x upsample."""

    def __init__(self, planes, depth=4, num_blocks=1):
        super().__init__()
        self.depth = depth
        self.mods = nn.ModuleDict()
        for d in range(1, depth + 1):
            self.mods[f"up1_{d}"] = residual(planes, num_blocks)
            self.mods[f"low1_{d}"] = residual(planes, num_blocks)
            self.mods[f"low3_{d}"] = residual(planes, num_blocks)
        self.low2 = residual(planes, num_blocks)

    def _level(self, d, x):
        up1 = self.mods[f"up1_{d}"](x)
        low1 = self.mods[f"low1_{d}"](F.max_pool2d(x, 2))
        low2 = self._level(d - 1, low1) if d > 1 else self.low2(low1)
        low3 = self.mods[f"low3_{d}"](low2)
        # in the activations' own dtype: CUDA autocast runs the nearest
        # upsample in float32, which would promote the residual stream
        # behind it to float32 (the reference keeps it in bf16)
        with torch.autocast(low3.device.type, enabled=False):
            up2 = F.interpolate(low3, scale_factor=2, mode="nearest")
        return up1 + up2

    def forward(self, x):
        return self._level(self.depth, x)


class HourglassNet(nn.Module):
    """Full stacked network (reference factory defaults: 8 stacks, 1 block,
    16 classes, 128 features)."""

    # the training recipe the train loop takes from the network, as from
    # ViTPose: no draws of its own, the reference's unweighted loss, and
    # the JAX package's initialisation (``seeded_init_``'s own rule)
    keyed = False
    masked_loss = False

    def __init__(
        self,
        num_stacks=8,
        num_blocks=1,
        num_classes=16,
        num_feats=128,
        depth=4,
        dtype=torch.bfloat16,
        remat=False,
        scan_stacks=False,
    ):
        super().__init__()
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.dtype = dtype
        self.remat = remat
        self.scan_stacks = scan_stacks
        ch = 2 * num_feats
        self.stem = nn.Sequential(
            nn.Conv2d(3, 64, 7, 2, 3),
            BatchNorm2d(64),
            nn.ReLU(inplace=True),
            Bottleneck(64, 64),
            nn.MaxPool2d(2),
            Bottleneck(128, num_feats),
            Bottleneck(ch, num_feats),
        )
        self.hgs = nn.ModuleList(
            [Hourglass(num_feats, depth, num_blocks) for _ in range(num_stacks)]
        )
        self.res = nn.ModuleList(
            [residual(num_feats, num_blocks) for _ in range(num_stacks)]
        )
        self.fc = nn.ModuleList(
            [
                nn.Sequential(
                    nn.Conv2d(ch, ch, 1), BatchNorm2d(ch), nn.ReLU(inplace=True)
                )
                for _ in range(num_stacks)
            ]
        )
        self.score = nn.ModuleList(
            [nn.Conv2d(ch, num_classes, 1) for _ in range(num_stacks)]
        )
        # no remap after the last stack; the scanned layout holds one
        remaps = num_stacks if scan_stacks else num_stacks - 1
        self.fc_ = nn.ModuleList([nn.Conv2d(ch, ch, 1) for _ in range(remaps)])
        self.score_ = nn.ModuleList(
            [nn.Conv2d(num_classes, ch, 1) for _ in range(remaps)]
        )
        # a plain list: the modules are registered above already
        self._norms = [m for m in self.modules() if isinstance(m, BatchNorm2d)]

    def param_groups(self, optim_cfg):
        """The parameters as ``optim_cfg``'s optimizer takes them: one
        group of them all."""
        return list(self.parameters())

    def forward(self, x):
        """x (B, H, W, 3) NHWC float -> list of ``num_stacks`` (B, K, H/4,
        W/4) float32 heatmaps.  In train mode each BatchNorm's running
        variance ends as flax's
        (:func:`posetpu_torch.models.batchnorm.flax_train_forward`)."""
        if not self.training:
            return self._forward(x)
        return flax_train_forward(self._norms, self._forward, x)

    def _forward(self, x):
        x = x.permute(0, 3, 1, 2)
        with torch.autocast(
            x.device.type, dtype=torch.bfloat16, enabled=self.dtype == torch.bfloat16
        ):
            x = self.stem(x)
            outs = []
            for i in range(len(self.hgs)):
                if self.remat and self.scan_stacks:
                    s, x = remat(self._stack, i, x)
                else:
                    s, x = self._stack(i, x)
                outs.append(s)
        return outs

    def _stack(self, i, x):
        """Stack ``i`` on its input ``x``: (its heatmaps, the next stack's
        input, or None after the last stack)."""
        hg = self.hgs[i]
        y = remat(hg, x) if self.remat and not self.scan_stacks else hg(x)
        y = self.fc[i](self.res[i](y))
        # in the parameters' own type: float32, or float64 for a model
        # taken to .double() as a reference
        with torch.autocast(x.device.type, enabled=False):
            s = self.score[i](y.to(self.score[i].weight.dtype))
        if i == len(self.hgs) - 1:
            return s, None
        return s, x + self.fc_[i](y) + self.score_[i](s)


def hg(num_stacks=8, num_blocks=1, num_classes=16, **kw):
    """Factory matching the reference entry point ``hg(...)``."""
    return HourglassNet(
        num_stacks=num_stacks, num_blocks=num_blocks, num_classes=num_classes, **kw
    )
