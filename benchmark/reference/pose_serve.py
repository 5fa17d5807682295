"""The serving path in plain float32 PyTorch: the neutral crop (no scale
change, rotation or flip), the dataset mean subtracted, the network in
eval mode (``hourglass.py``), the last stack's heatmaps; and, for the
control of ``correct``, bearpaw's decode of them (``final_preds``: the
first maximum, a quarter pixel toward the larger neighbour, +0.5, the
crop transform's inverse, truncated).
"""

from __future__ import annotations

import torch

from benchmark.reference.augment import crop, map_points, transform
from benchmark.reference.hourglass import Net


def heatmaps(weights, images, center, scale, *, model, inp_res, mean, quant=False):
    """(B, K, H, W) float32 heatmaps of the last stack."""
    inp_res = tuple(inp_res)
    t = transform(center, scale, inp_res, torch.zeros_like(scale))
    x = crop(images, t, inp_res)
    x = x - torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    with torch.no_grad():
        return Net(weights, model, train=False, quant=quant)(x)[-1]


def decode(heat, center, scale, out_res):
    """``pred``, ``conf`` and ``heatmap_coords`` of ``heat`` as the serving
    path returns them."""
    B, K, H, W = heat.shape
    flat = heat.reshape(B, K, H * W)
    conf, idx = flat.max(-1)
    x, y = idx % W, idx // W
    hmc = torch.stack([x + 1, y + 1], -1).to(torch.float64)
    hmc = hmc * (conf > 0)[..., None]
    px, py = hmc[..., 0].long(), hmc[..., 1].long()
    inb = (px > 1) & (px < W) & (py > 1) & (py < H)
    pxc, pyc = px.clamp(2, W - 1), py.clamp(2, H - 1)

    def at(yy, xx):
        return flat.gather(-1, ((yy - 1) * W + (xx - 1))[..., None])[..., 0]

    off = torch.stack([torch.sign(at(pyc, pxc + 1) - at(pyc, pxc - 1)),
                       torch.sign(at(pyc + 1, pxc) - at(pyc - 1, pxc))], -1) * 0.25
    hmc = hmc + off * inb[..., None]
    t = transform(center, scale, tuple(out_res), torch.zeros_like(scale))
    pred = torch.trunc(map_points(hmc + 0.5, torch.linalg.inv(t.double()))) + 1.0
    return {"pred": pred, "conf": conf, "heatmap_coords": hmc}
