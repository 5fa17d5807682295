"""The benchmark's weights of a ViTPose network, drawn from the run's seed
on the device, as ``weights.py`` draws the hourglass's: one uniform draw
over a flat buffer (``frozen.synthetic.generator``), each tensor its slice.

``weights.py``'s rules take the convolutions, the linear layers and the
head's batch norms (a weight of variance 1 / fan_in, a bias uniform on
+-1 / sqrt(fan_in), a norm's scale on [0.8, 1.2], shift +-0.1, running
mean +-0.1, running variance [0.8, 1.2]); this file adds what they do not
draw:

- a LayerNorm's scale: uniform on [0.8, 1.2]; its shift: uniform on +-0.1;
- a transposed convolution's weight (C_in, C_out, k, k) at stride s:
  variance 1 / (C_in k^2 / s^2), the inputs that reach each output pixel;
- the position embedding: variance 0.02^2 (ViTPose's initial scale).

It raises on any entry of the state dict that it does not draw.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from benchmark.frozen.synthetic import generator
from benchmark.weights import _spans

POS_STD = 0.02


def _vit_spans(module):
    """(name, shape, low, high) of every tensor ``weights.py`` leaves out,
    by this file's rules."""
    draws = []
    for mname, m in module.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, nn.LayerNorm):
            c = m.normalized_shape
            draws += [(pre + "weight", c, 0.8, 1.2), (pre + "bias", c, -0.1, 0.1)]
        elif isinstance(m, nn.ConvTranspose2d):
            cin, _, kh, kw = m.weight.shape
            fan_in = cin * kh * kw // (m.stride[0] * m.stride[1])
            a = (3.0 / fan_in) ** 0.5
            draws.append((pre + "weight", m.weight.shape, -a, a))
    a = 3.0 ** 0.5 * POS_STD
    draws.append(("pos_embed", module.pos_embed.shape, -a, a))
    return draws


def make_weights(module, seed, device):
    """{name: tensor} on ``device`` for every entry of ``module``'s state
    dict, drawn from ``seed``."""
    draws, zeros = _spans(module)
    draws += _vit_spans(module)
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
