"""ViTPose-H's training step in plain float32 PyTorch, the reference that
tests/test_torch_vitpose.py holds ``posetpu_torch.models.ViTPose`` and
its optimizer to.  It imports neither JAX nor ``posetpu_torch``, and turns
TF32 off (:func:`no_tf32`) wherever it computes.

Its pieces, after ViTPose's code (``mmpose/models/backbones/vit.py``,
``topdown_heatmap_simple_head.py``, ``JointsMSELoss``, mmcv's AdamW with
``LayerDecayOptimizerConstructor``, ``grad_clip`` and the step policy
with a linear warm-up):

- :func:`forward`: a function of a dict of named weights (the program's
  state-dict names): the patch convolution, ``x + pos[:, 1:] + pos[:,
  :1]``, pre-norm blocks with explicit ``softmax(q k^T / sqrt d) v``
  attention, exact GELU, drop path, the last norm, two transposed
  convolutions with batch norm (torch's running statistics) and ReLU, the
  final 1x1 conv;
- :func:`loss_of`: the MSE of heatmaps and targets each times its joint's
  weight;
- :func:`clip_`: the gradients scaled by ``min(1, c / (||g|| + 1e-6))``,
  ``||g||`` the norm of every tensor's norm (torch's ``clip_grad_norm_``);
- :func:`lr_at`: the step-decayed rate behind the linear warm-up;
- :func:`adamw_`: torch's AdamW with each parameter's rate scaled by
  ``decay ** (last layer - layer)`` and no weight decay on 1-D tensors,
  biases and ``pos_embed``.

Departures from ViTPose's code:

- drop path draws its masks from a counter hash keyed on (seed, step, the
  sample's index), :func:`drop_path_keep`, where timm draws from the
  framework's generator, so that the program and this reference draw the
  same masks; the distribution is the same (keep where a uniform is below
  ``1 - rate``, the kept branch scaled by ``1 / (1 - rate)``);
- the loss weighs each squared error by the joint's weight, where
  ``JointsMSELoss`` squares the weighted difference: the same for the
  port's weights, which are 0 or 1;
- the input is NHWC (the port's batch layout), turned to NCHW first.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
_M32 = 0xFFFFFFFF
_U24 = 2.0**-24
# the drop-path masks' stream of the keyed hash
STREAM_DROP_PATH = 6


def no_tf32():
    """float32 matrix products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def pcg_hash(x):
    """PCG's RXS-M-XS output permutation over an LCG step, of 32-bit words
    held in int64 tensors or Python ints."""
    state = (x * 747796405 + 2891336453) & _M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _M32
    return (word >> 22) ^ word


def keyed_uniforms(seed, step, index, stream, count):
    """(B, count) float32 uniforms on [0, 1): the top 24 bits of
    ``pcg(draw + pcg(stream + pcg(index + pcg(step + pcg(seed)))))``."""
    if not isinstance(step, torch.Tensor):
        step = int(step)
    head = pcg_hash((step + pcg_hash(int(seed) & _M32)) & _M32)
    index = torch.as_tensor(index).to(torch.int64)
    per_stream = pcg_hash((pcg_hash((index + head) & _M32) + int(stream)) & _M32)
    draws = torch.arange(count, dtype=torch.int64, device=index.device)
    bits = pcg_hash((per_stream[:, None] + draws[None, :]) & _M32)
    return (bits >> 8).to(torch.float32) * _U24


def drop_rates(depth, rate):
    """timm's rising drop-path rates, ``torch.linspace`` in float32."""
    return torch.linspace(0, rate, depth).tolist()


def drop_path_keep(keys, depth, rate, device):
    """(depth, B, 2) float32 scales of each block's attention and MLP
    branch: 0 where dropped, else 1 / (1 - the block's rate)."""
    seed, step, index = keys
    B = index.shape[0]
    u = keyed_uniforms(seed, step, index.to(device), STREAM_DROP_PATH, 2 * depth)
    u = u.reshape(B, depth, 2).transpose(0, 1)
    r = torch.tensor(drop_rates(depth, rate), dtype=torch.float32, device=device)[:, None, None]
    return torch.where(u < 1.0 - r, 1.0 / (1.0 - r), 0.0)


def _linear(x, w, pre, bias=True):
    y = x @ w[pre + ".weight"].t()
    return y + w[pre + ".bias"] if bias else y


def _norm(x, w, pre, eps=LN_EPS):
    return F.layer_norm(x, (x.shape[-1],), w[pre + ".weight"], w[pre + ".bias"], eps)


def forward(w, x, *, depth, heads, patch, padding, rate, train, keys=None, stats=None):
    """(B, K, H/4, W/4) heatmaps of NHWC ``x`` through the network of
    weights ``w``.  ``train``: drop path from ``keys`` = (seed, step,
    index) and the head's norms on the batch's statistics (and, with
    ``stats``, a dict of running statistics, updated there as torch's
    BatchNorm2d updates them); else the running statistics of ``w``."""
    no_tf32()
    x = x.permute(0, 3, 1, 2)
    t = F.conv2d(x, w["patch_embed.proj.weight"], w["patch_embed.proj.bias"], stride=patch,
                 padding=padding)
    B, D, gh, gw = t.shape
    t = t.flatten(2).transpose(1, 2)
    t = t + w["pos_embed"][:, 1:] + w["pos_embed"][:, :1]
    keep = drop_path_keep(keys, depth, rate, x.device) if train else None
    d = D // heads
    for i in range(depth):
        pre = f"blocks.{i}"
        qkv = _linear(_norm(t, w, pre + ".norm1"), w, pre + ".attn.qkv")
        q, k, v = qkv.reshape(B, -1, 3, heads, d).permute(2, 0, 3, 1, 4)
        att = torch.softmax((q * d ** -0.5) @ k.transpose(-2, -1), dim=-1)
        a = _linear((att @ v).transpose(1, 2).reshape(B, -1, D), w, pre + ".attn.proj")
        t = t + (a * keep[i, :, 0, None, None] if train else a)
        h = F.gelu(_linear(_norm(t, w, pre + ".norm2"), w, pre + ".mlp.fc1"))
        m = _linear(h, w, pre + ".mlp.fc2")
        t = t + (m * keep[i, :, 1, None, None] if train else m)
    t = _norm(t, w, "last_norm")
    f = t.transpose(1, 2).reshape(B, D, gh, gw)
    j = 0
    while f"keypoint_head.deconv_layers.{j}.weight" in w:
        pre = f"keypoint_head.deconv_layers.{j}"
        f = F.conv_transpose2d(f, w[pre + ".weight"], stride=2, padding=1)
        bn = f"keypoint_head.deconv_layers.{j + 1}"
        if train:
            mean, var = (stats[bn + ".running_mean"], stats[bn + ".running_var"]) \
                if stats is not None else (None, None)
            f = F.batch_norm(f, mean, var, w[bn + ".weight"], w[bn + ".bias"], True,
                             BN_MOMENTUM, BN_EPS)
        else:
            f = F.batch_norm(f, w[bn + ".running_mean"], w[bn + ".running_var"],
                             w[bn + ".weight"], w[bn + ".bias"], False, 0.0, BN_EPS)
        f = F.relu(f)
        j += 3
    return F.conv2d(f, w["keypoint_head.final_layer.weight"], w["keypoint_head.final_layer.bias"])


def loss_of(heat, target, weight):
    """The mean over every element of ``weight * (heat - target)^2``."""
    return (((heat - target) ** 2) * weight[:, :, None, None]).mean()


def clip_(grads, max_norm):
    """Scale ``grads`` (a list) in place to a global L2 norm of at most
    ``max_norm``; returns the norm before."""
    total = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)
    return float(total)


def lr_at(count, *, lr, schedule, gamma, steps_per_epoch, warmup_iters, warmup_ratio):
    """The learning rate of update ``count`` (0 first)."""
    regular = lr * gamma ** sum(count >= int(e) * steps_per_epoch for e in schedule)
    if count < warmup_iters:
        return regular * (1.0 - (1.0 - count / warmup_iters) * (1.0 - warmup_ratio))
    return regular


def layer_of(name, depth):
    """ViTPose's layer of parameter ``name``: 0 for the embeddings,
    ``i + 1`` for block ``i``, ``depth + 1`` for the rest."""
    if name in ("pos_embed", "cls_token") or name.startswith("patch_embed"):
        return 0
    if name.startswith("blocks."):
        return int(name.split(".")[1]) + 1
    return depth + 1


def decays(name, shape):
    """Whether parameter ``name`` of ``shape`` takes weight decay."""
    return not (len(shape) == 1 or name.endswith(".bias") or name == "pos_embed")


def adamw_(w, grads, moments, count, *, lr, depth, layer_decay, weight_decay,
           betas=(0.9, 0.999), eps=1e-8):
    """One AdamW update of the parameters named in ``grads`` (a dict) in
    ``w``, at the schedule's rate ``lr``; ``moments`` {name: [m, v]}
    (zero to start); ``count`` the updates before this one."""
    b1, b2 = betas
    t = count + 1
    with torch.no_grad():
        for n, g in grads.items():
            m, v = moments[n]
            lr_n = lr * layer_decay ** (depth + 1 - layer_of(n, depth))
            p = w[n]
            if decays(n, p.shape):
                p.mul_(1.0 - lr_n * weight_decay)
            m.lerp_(g, 1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = v.sqrt() / math.sqrt(1.0 - b2 ** t) + eps
            p.addcdiv_(m, denom, value=-lr_n / (1.0 - b1 ** t))


def train_step(w, names, x, target, weight, moments, count, keys, *, model, optim,
               steps_per_epoch):
    """One training step of the parameters ``names`` of ``w`` (updated in
    place, with ``moments``) on crops ``x`` and ``target`` heatmaps:
    forward in train mode, the masked loss, the gradients, the clip, AdamW
    at ``count``.  ``model``, ``optim``: dicts of the config's fields
    (``vit_depth``, ``num_heads``, ``patch_size``, ``patch_padding``,
    ``drop_path_rate``; ``lr``, ``schedule``, ``gamma``, ``warmup_iters``,
    ``warmup_ratio``, ``layer_decay``, ``weight_decay``, ``betas``,
    ``adam_eps``, ``clip_norm``).  Returns (loss, the gradients' norm
    before the clip)."""
    leaves = [w[n].requires_grad_(True) for n in names]
    stats = {k: v for k, v in w.items() if "running_" in k}
    heat = forward(w, x, depth=model["vit_depth"], heads=model["num_heads"],
                   patch=model["patch_size"], padding=model["patch_padding"],
                   rate=model["drop_path_rate"], train=True, keys=keys, stats=stats)
    loss = loss_of(heat, target, weight)
    grads = list(torch.autograd.grad(loss, leaves))
    for leaf in leaves:
        leaf.requires_grad_(False)
    norm = clip_(grads, optim["clip_norm"]) if optim["clip_norm"] else None
    lr = lr_at(count, lr=optim["lr"], schedule=optim["schedule"], gamma=optim["gamma"],
               steps_per_epoch=steps_per_epoch, warmup_iters=optim["warmup_iters"],
               warmup_ratio=optim["warmup_ratio"])
    adamw_(w, dict(zip(names, grads)), moments, count, lr=lr, depth=model["vit_depth"],
           layer_decay=optim["layer_decay"], weight_decay=optim["weight_decay"],
           betas=optim["betas"], eps=optim["adam_eps"])
    return float(loss.detach()), norm
