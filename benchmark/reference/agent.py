"""The adversarial augmentation agent (Peng et al. 2018, arXiv:1805.09707:
a small network that looks at the neutral crop and picks scale and
rotation bins) in plain float32 PyTorch, as a function of the benchmark's
named weights.

The crop, average-pooled by ``input_downscale``, goes through four stride-2
convs (7x7, then 3x3; ``padding="SAME"`` as XLA pads a strided conv: the
output has ceil(n/2) positions, the padding split low-first), each with a
norm and a ReLU, a global mean, a 256-wide dense layer with a ReLU, and
two dense heads: the logits of the scale bins and of the rotation bins.
"""

from __future__ import annotations

import torch.nn.functional as F

from benchmark.reference.hourglass import fp8, norm


def _pad_same(x, k, stride=2):
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def logits(w, x, *, convs, input_downscale, train=True, quant=False):
    """{"scale": (B, S), "rot": (B, R)} of NHWC crops ``x``; ``quant`` as
    the pose network's (``hourglass.py``), the heads in float32."""
    x = fp8(x.permute(0, 3, 1, 2), quant)
    if input_downscale > 1:
        x = fp8(F.avg_pool2d(x, input_downscale), quant)
    for i in range(convs):
        k = w[f"conv{i}.weight"].shape[-1]
        x = F.conv2d(_pad_same(x, k), fp8(w[f"conv{i}.weight"], quant), w[f"conv{i}.bias"],
                     stride=2)
        x = F.relu(fp8(norm(fp8(x, quant), w, f"bn{i}", train), quant))
    x = fp8(x.mean((2, 3)), quant)
    x = F.relu(fp8(F.linear(x, fp8(w["hidden.weight"], quant), w["hidden.bias"]), quant))
    return {"scale": F.linear(x, w["head_scale.weight"], w["head_scale.bias"]),
            "rot": F.linear(x, w["head_rot.weight"], w["head_rot.bias"])}
