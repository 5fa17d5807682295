"""The stacked hourglass network (Newell et al. 2016, as bearpaw's
pytorch-pose builds it: ``hg(num_stacks, num_blocks)``) in plain float32
PyTorch, as a function of a dict of named weights.

The weights are the benchmark's own (``benchmark/weights.py``), named as
the program's state dict names them, so both sides read one dict.  The
network: a 7x7 stride-2 conv, a norm and ReLU, a bottleneck, a 2x2 max
pool, two bottlenecks; then per stack a recursive hourglass of ``depth``
levels (a skip bottleneck, and a max-pooled branch through bottlenecks
with a nearest 2x upsample), a bottleneck, a 1x1 conv with norm and ReLU,
the 1x1 score; between stacks the input plus two 1x1 remaps of the
features and the scores.  The bottleneck is pre-activation, expansion 2:
norm-ReLU-1x1, norm-ReLU-3x3, norm-ReLU-1x1, plus the input or its 1x1
projection.

``quant`` computes in the next precision below the configuration's bf16,
for the control of ``correct``: where the program computes and keeps
bf16 (every layer but the score heads), each convolution's operands and
every activation are rounded to fp8 (e4m3, a scale a tensor) in the
forward pass, and every gradient flowing back through them to fp8 (e5m2).
Without it every operation is float32 (the caller turns TF32 off).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-5


def fake_fp8(x, dtype):
    """``x`` rounded to the fp8 ``dtype`` under a per-tensor scale that
    maps its largest magnitude to the format's largest, and back."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = torch.finfo(dtype).max / amax
    return (x * s).to(dtype).to(x.dtype) / s


class _Fp8(torch.autograd.Function):
    """Round to e4m3 in the forward pass and the gradient to e5m2 in the
    backward pass."""

    @staticmethod
    def forward(ctx, x):
        return fake_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return fake_fp8(g, torch.float8_e5m2)


def fp8(x, on=True):
    """``x`` through :class:`_Fp8` where ``on``, else ``x``."""
    return _Fp8.apply(x) if on else x


def norm(x, w, name, train, stats=None):
    """Batch norm ``name`` of ``w``: with the batch's statistics in train
    mode, else the running ones.  ``stats`` (a dict of running statistics,
    updated in place) takes flax's update in train mode: 0.9 r + 0.1 of
    the batch's mean and biased variance."""
    if not train:
        return F.batch_norm(x, w[name + ".running_mean"], w[name + ".running_var"],
                            w[name + ".weight"], w[name + ".bias"], False, 0.0, EPS)
    if stats is not None:
        with torch.no_grad():
            xf = x.detach().double()
            for key, v in ((".running_mean", xf.mean((0, 2, 3))),
                           (".running_var", xf.var((0, 2, 3), unbiased=False))):
                stats[name + key].mul_(0.9).add_(0.1 * v.to(stats[name + key].dtype))
    return F.batch_norm(x, None, None, w[name + ".weight"], w[name + ".bias"], True, 0.0,
                        EPS)


class Net:
    """``Net(weights, model, train, quant, stats)(x)``: the list of each
    stack's (B, K, H/4, W/4) heatmaps of NHWC input ``x``.  ``train``
    normalizes with the batch's statistics (and updates ``stats``, where
    given, as :func:`norm` does), else with the running ones."""

    def __init__(self, weights, model, train, quant=False, stats=None):
        self.w, self.m, self.train, self.quant = weights, model, train, quant
        self.stats = stats

    def q(self, x):
        return fp8(x, self.quant)

    def conv(self, x, name, stride=1, padding=0):
        w, b = self.w[name + ".weight"], self.w.get(name + ".bias")
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride, padding))

    def norm(self, x, name):
        return self.q(norm(x, self.w, name, self.train, self.stats))

    def bottleneck(self, x, p):
        y = self.conv(F.relu(self.norm(x, p + ".bn1")), p + ".conv1")
        y = self.conv(F.relu(self.norm(y, p + ".bn2")), p + ".conv2", padding=1)
        y = self.conv(F.relu(self.norm(y, p + ".bn3")), p + ".conv3")
        skip = self.conv(x, p + ".proj") if p + ".proj.weight" in self.w else x
        return self.q(y + skip)

    def residual(self, x, p):
        if p + ".bn1.weight" in self.w:
            return self.bottleneck(x, p)
        for j in range(self.m["blocks"]):
            x = self.bottleneck(x, f"{p}.{j}")
        return x

    def hourglass(self, x, p, d):
        up1 = self.residual(x, f"{p}.mods.up1_{d}")
        low = self.residual(F.max_pool2d(x, 2), f"{p}.mods.low1_{d}")
        low = self.hourglass(low, p, d - 1) if d > 1 else self.residual(low, f"{p}.low2")
        low = self.residual(low, f"{p}.mods.low3_{d}")
        return self.q(up1 + F.interpolate(low, scale_factor=2, mode="nearest"))

    def __call__(self, x):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.norm(self.conv(x, "stem.0", 2, 3), "stem.1"))
        x = self.bottleneck(x, "stem.3")
        x = F.max_pool2d(x, 2)
        x = self.bottleneck(self.bottleneck(x, "stem.5"), "stem.6")
        outs = []
        stacks = self.m["stacks"]
        for i in range(stacks):
            y = self.hourglass(x, f"hgs.{i}", self.m["depth"])
            y = self.residual(y, f"res.{i}")
            y = F.relu(self.norm(self.conv(y, f"fc.{i}.0"), f"fc.{i}.1"))
            # the score head computes in float32 in the program too
            s = F.conv2d(y, self.w[f"score.{i}.weight"], self.w[f"score.{i}.bias"])
            outs.append(s)
            if i < stacks - 1:
                x = self.q(x + self.conv(y, f"fc_.{i}") + self.conv(s, f"score_.{i}"))
        return outs
