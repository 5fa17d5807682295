"""ViTPose (Xu et al. 2022, arXiv:2204.12484; ViTPose's code,
``ViTPose_huge_coco_256x192``) in plain float32 PyTorch, as a function of a
dict of named weights (the program's state-dict names), importing nothing
of the program.

The network: ``Conv2d(3, D, 16, stride 16, padding 2)``; ``x + pos[:, 1:]
+ pos[:, :1]`` (the class position added to every token, as ViTPose
does); ``depth`` pre-norm blocks, ``x + DropPath(Attn(LN(x)))`` then ``x +
DropPath(MLP(LN(x)))``, LayerNorm eps 1e-6, attention ``softmax(q k^T /
sqrt d) v`` over ``heads`` heads with a biased qkv projection and an
output projection, the MLP D -> r D -> D with exact GELU; the last
LayerNorm; two ``ConvTranspose2d(., 256, 4, stride 2, padding 1)`` without
bias, each with batch norm (torch's running statistics) and ReLU; the
final 1x1 conv.

Departures from ViTPose's code: drop path draws its masks from the keyed
hash (``benchmark/frozen/keyed.py``, stream 6: draw ``2 i`` block ``i``'s
attention branch, ``2 i + 1`` its MLP's; keep where the uniform is below
``1 - rate``, the kept branch scaled by ``1 / (1 - rate)`` in float32),
where timm draws from the framework's generator; the input is NHWC.

``remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``), which leaves the arithmetic as it is and
fits the published widths at a batch of 64 in float32.  ``quant`` is the
control of ``correct``: where the program computes and keeps bf16 (every
linear layer's and convolution's operands and outputs, the attention's
queries, keys, values and output, the MLP's activation, the head's norms;
not the LayerNorms, the residual stream and the final conv, which the
program keeps float32), each is rounded to fp8 (e4m3, a scale a tensor) in
the forward pass and each gradient flowing back through them to e5m2
(``hourglass.fp8``).  The caller turns TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.frozen.keyed import bits_to_uniform, keyed_bits
from benchmark.reference.hourglass import fp8

LN_EPS, BN_EPS, BN_MOMENTUM = 1e-6, 1e-5, 0.1
STREAM_DROP_PATH = 6


def drop_rates(depth, rate):
    """timm's rising drop-path rates, ``torch.linspace`` in float32."""
    return torch.linspace(0, rate, depth).tolist()


def keep_scales(seed, step, index, depth, rate):
    """(depth, B, 2) float32: each block's attention and MLP branch scale,
    0 where dropped, else 1 / (1 - the block's rate)."""
    B = index.shape[0]
    u = bits_to_uniform(keyed_bits(seed, step, index, STREAM_DROP_PATH, 2 * depth))
    u = u.reshape(B, depth, 2).transpose(0, 1)
    r = torch.tensor(drop_rates(depth, rate), dtype=torch.float32,
                     device=index.device)[:, None, None]
    return torch.where(u < 1.0 - r, 1.0 / (1.0 - r), 0.0)


class Net:
    """``Net(weights, model, train, quant, remat, stats)(x, keep)``: the
    (B, K, H/4, W/4) heatmaps of NHWC input ``x``; ``model``: a
    configuration's ``model`` group (``vit_depth``, ``num_heads``,
    ``patch_size``, ``patch_padding``, ``drop_path_rate``); ``keep``: the
    drop-path scales of :func:`keep_scales` in train mode.  ``train``
    normalizes the head with the batch's statistics (and updates
    ``stats``, where given, as torch's BatchNorm2d does), else with the
    running ones."""

    def __init__(self, weights, model, train, quant=False, remat=False, stats=None):
        self.w, self.m, self.train, self.quant = weights, model, train, quant
        self.remat, self.stats = remat, stats

    def q(self, x):
        return fp8(x, self.quant)

    def linear(self, x, name):
        return self.q(F.linear(self.q(x), self.q(self.w[name + ".weight"]),
                               self.w[name + ".bias"]))

    def ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.w[name + ".weight"],
                            self.w[name + ".bias"], LN_EPS)

    def block(self, t, keep, i):
        p, heads = f"blocks.{i}", self.m["num_heads"]
        B, N, D = t.shape
        d = D // heads
        q, k, v = self.linear(self.ln(t, p + ".norm1"), p + ".attn.qkv").reshape(
            B, N, 3, heads, d).permute(2, 0, 3, 1, 4)
        att = torch.softmax((q * d ** -0.5) @ k.transpose(-2, -1), dim=-1)
        y = self.q(att @ v).transpose(1, 2).reshape(B, N, D)
        a = self.linear(y, p + ".attn.proj")
        t = t + (a if keep is None else a * keep[:, 0, None, None])
        h = self.q(F.gelu(self.linear(self.ln(t, p + ".norm2"), p + ".mlp.fc1")))
        m = self.linear(h, p + ".mlp.fc2")
        return t + (m if keep is None else m * keep[:, 1, None, None])

    def head(self, f):
        j = 0
        while f"keypoint_head.deconv_layers.{j}.weight" in self.w:
            pre, bn = f"keypoint_head.deconv_layers.{j}", f"keypoint_head.deconv_layers.{j + 1}"
            f = self.q(F.conv_transpose2d(self.q(f), self.q(self.w[pre + ".weight"]), stride=2,
                                          padding=1))
            w, b = self.w[bn + ".weight"], self.w[bn + ".bias"]
            if self.train:
                mean = var = None
                if self.stats is not None:
                    mean, var = self.stats[bn + ".running_mean"], self.stats[bn + ".running_var"]
                f = F.batch_norm(f, mean, var, w, b, True, BN_MOMENTUM, BN_EPS)
            else:
                f = F.batch_norm(f, self.w[bn + ".running_mean"], self.w[bn + ".running_var"],
                                 w, b, False, 0.0, BN_EPS)
            f = F.relu(self.q(f))
            j += 3
        # the final conv computes in float32 in the program too
        return F.conv2d(f, self.w["keypoint_head.final_layer.weight"],
                        self.w["keypoint_head.final_layer.bias"])

    def __call__(self, x, keep=None):
        x = x.permute(0, 3, 1, 2)
        t = self.q(F.conv2d(self.q(x), self.q(self.w["patch_embed.proj.weight"]),
                            self.w["patch_embed.proj.bias"], stride=self.m["patch_size"],
                            padding=self.m["patch_padding"]))
        B, D, gh, gw = t.shape
        t = t.flatten(2).transpose(1, 2)
        t = t + self.w["pos_embed"][:, 1:] + self.w["pos_embed"][:, :1]
        for i in range(self.m["vit_depth"]):
            k = None if keep is None else keep[i]
            if self.remat and torch.is_grad_enabled():
                t = checkpoint(self.block, t, k, i, use_reentrant=False)
            else:
                t = self.block(t, k, i)
        t = self.ln(t, "last_norm")
        return self.head(t.transpose(1, 2).reshape(B, D, gh, gw))
