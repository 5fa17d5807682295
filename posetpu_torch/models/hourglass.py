"""Stacked hourglass network — counterpart of
``posetpu/models/hourglass.py`` (unrolled layout, ``num_blocks=1``).

Module names follow ``tools/torch_baseline.py:build_torch_hourglass`` so
the weight carry (:mod:`posetpu_torch.ckpt.transplant`) maps the JAX
package's parameters one to one.  The network takes NHWC input like the
reference and runs NCHW inside; it returns each stack's heatmaps as
(B, K, H, W) float32.

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

from posetpu_torch.models.batchnorm import BatchNorm2d, flax_train_forward


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


class Hourglass(nn.Module):
    """One recursive hourglass: at each of ``depth`` levels a skip residual
    plus a max-pooled branch that recurses, then a nearest 2x upsample."""

    def __init__(self, planes, depth=4):
        super().__init__()
        self.depth = depth
        c = 2 * planes
        self.mods = nn.ModuleDict()
        for d in range(1, depth + 1):
            self.mods[f"up1_{d}"] = Bottleneck(c, planes)
            self.mods[f"low1_{d}"] = Bottleneck(c, planes)
            self.mods[f"low3_{d}"] = Bottleneck(c, planes)
        self.low2 = Bottleneck(c, planes)

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

    def __init__(
        self,
        num_stacks=8,
        num_blocks=1,
        num_classes=16,
        num_feats=128,
        depth=4,
        dtype=torch.bfloat16,
    ):
        super().__init__()
        if num_blocks != 1:
            raise ValueError("the port's hourglass has num_blocks=1 only")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.dtype = dtype
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
            [Hourglass(num_feats, depth) for _ in range(num_stacks)]
        )
        self.res = nn.ModuleList(
            [Bottleneck(ch, num_feats) for _ in range(num_stacks)]
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
        # no remap after the last stack
        self.fc_ = nn.ModuleList(
            [nn.Conv2d(ch, ch, 1) for _ in range(num_stacks - 1)]
        )
        self.score_ = nn.ModuleList(
            [nn.Conv2d(num_classes, ch, 1) for _ in range(num_stacks - 1)]
        )
        # a plain list: the modules are registered above already
        self._norms = [m for m in self.modules() if isinstance(m, BatchNorm2d)]

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
        dev = x.device.type
        with torch.autocast(
            dev, dtype=torch.bfloat16, enabled=self.dtype == torch.bfloat16
        ):
            x = self.stem(x)
            outs = []
            for i, hg in enumerate(self.hgs):
                y = self.fc[i](self.res[i](hg(x)))
                # in the parameters' own type: float32, or float64 for a
                # model taken to .double() as a reference
                with torch.autocast(dev, enabled=False):
                    s = self.score[i](y.to(self.score[i].weight.dtype))
                outs.append(s)
                if i < len(self.hgs) - 1:
                    x = x + self.fc_[i](y) + self.score_[i](s)
        return outs


def hg(num_stacks=8, num_blocks=1, num_classes=16, **kw):
    """Factory matching the reference entry point ``hg(...)``."""
    return HourglassNet(
        num_stacks=num_stacks, num_blocks=num_blocks, num_classes=num_classes, **kw
    )
