"""The benchmark's weights, drawn from the run's seed on the device.

Both sides read the same weights: the program gets them copied into its
model, the plain reference reads the same named tensors.  They are drawn
in one call over a flat buffer (a ``torch.Generator`` on the device), then
each tensor takes its slice:

- a conv or dense weight: uniform with variance 1 / fan_in;
- a conv or dense bias: uniform on +-1 / sqrt(fan_in), PyTorch's default;
- a norm's scale: uniform on [0.8, 1.2]; its shift: uniform on +-0.1;
- a norm's running mean: uniform on +-0.1; its running variance: uniform
  on [0.8, 1.2]; its count of batches: 0.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.frozen.synthetic import generator


def _spans(module):
    """(name, shape, low, high) of every tensor of ``module``'s state dict
    that is drawn, and the names of those set to 0."""
    draws, zeros = [], []
    for mname, m in module.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            a = (3.0 / fan_in) ** 0.5
            draws.append((pre + "weight", m.weight.shape, -a, a))
            if m.bias is not None:
                b = fan_in ** -0.5
                draws.append((pre + "bias", m.bias.shape, -b, b))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            c = m.num_features
            draws += [(pre + "weight", (c,), 0.8, 1.2), (pre + "bias", (c,), -0.1, 0.1),
                      (pre + "running_mean", (c,), -0.1, 0.1),
                      (pre + "running_var", (c,), 0.8, 1.2)]
            zeros.append(pre + "num_batches_tracked")
    return draws, zeros


def make_weights(module, seed, device):
    """{name: tensor} on ``device`` for every entry of ``module``'s state
    dict, drawn from ``seed``."""
    draws, zeros = _spans(module)
    sizes = [torch.Size(s).numel() for _, s, _, _ in draws]
    flat = torch.rand(sum(sizes), generator=generator(seed, device), device=device)
    out = {}
    for (name, shape, lo, hi), piece in zip(draws, torch.split(flat, sizes)):
        out[name] = piece.view(shape) * (hi - lo) + lo
    for name in zeros:
        out[name] = torch.zeros((), dtype=torch.int64, device=device)
    missing = set(module.state_dict()) ^ set(out)
    if missing:
        raise KeyError(f"weights not drawn for {sorted(missing)[:5]}")
    return out


def load_(module, weights):
    """Copy ``weights`` into ``module``'s tensors in place."""
    with torch.no_grad():
        for name, t in module.state_dict().items():
            t.copy_(weights[name])

