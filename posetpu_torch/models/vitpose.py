"""ViTPose (Xu, Zhang, Zhang and Tao, "ViTPose: Simple Vision Transformer
Baselines for Human Pose Estimation", NeurIPS 2022, arXiv:2204.12484), as
its code builds ``ViTPose_huge_coco_256x192``: a plain vision transformer
backbone and the classic deconvolution head.

- Patch embedding: ``Conv2d(3, D, 16, stride 16, padding 2)``; a learned
  position embedding of N + 1 positions, added as ``x + pos[:, 1:] +
  pos[:, :1]`` (the class position is added to every token, as ViTPose
  does; there is no class token).
- Blocks: pre-norm, ``x + DropPath(Attn(LN(x)))`` then ``x +
  DropPath(MLP(LN(x)))``; LayerNorm eps 1e-6; attention with a biased qkv
  projection, scale d**-0.5 and an output projection, through
  ``scaled_dot_product_attention``; the MLP D -> 4 D -> D with exact GELU.
  Drop-path rates rise linearly from 0 to ``drop_path_rate`` over the
  blocks (``torch.linspace``, as timm's ``dpr``).
- A last LayerNorm, the tokens back to a (B, D, h, w) map.
- Head: two ``ConvTranspose2d(., 256, 4, stride 2, padding 1, bias=False)``
  each with a norm and ReLU, then a 1x1 conv to the joints.

The widths that vary are the constructor's; the patch, its padding, the
MLP's ratio and the head's are ViTPose-H's constants below.

Drop path draws its masks from the counter hash of
:mod:`posetpu_torch.aug.keyed` on its own stream (``STREAM_DROP_PATH``),
keyed on (seed, step, each sample's global index): the forward takes
``keys=(seed, step, index)`` in train mode, ``step`` a Python int or a
0-d int64 tensor on the card (a CUDA graph replays it), and a plain
reference can draw the same masks.  Draw ``2 i`` is block ``i``'s
attention branch, ``2 i + 1`` its MLP branch; a sample keeps a branch
where its uniform is below ``1 - rate``, and the kept branch is scaled by
``1 / (1 - rate)`` in float32.

Like the hourglass, the network takes NHWC input and returns a list of
(B, K, H/4, W/4) float32 heatmaps (of one element), so the losses, the
PCK and serving take its last entry as they take the last stack's.  With
``dtype=torch.bfloat16`` the forward runs under bf16 autocast over float32
parameters (LayerNorm and the residual stream stay float32 there); the
final 1x1 conv runs in the parameters' own type either way.  The head's
norms are :class:`posetpu_torch.models.batchnorm.BatchNorm2d` with torch's
running statistics (ViTPose's), and take a data-parallel group through
:func:`posetpu_torch.models.batchnorm.convert_cross_replica_`.

Each attention call adds one to the registry's ``launches.attention``
(:data:`ATTENTION_LAUNCHES`), counted once a replay inside a CUDA graph.

The class carries ViTPose's training recipe, which the train loop takes
from the network: its drop path draws (``keyed``), its loss weighs the
joints by their target weights (``masked_loss``, ``JointsMSELoss``), its
initialisation (:meth:`ViTPose.init_weights_`) and its optimizer's
parameter groups (:meth:`ViTPose.param_groups`: layer-wise learning-rate
decay by ViTPose's ``get_num_layer_for_vit``, 0 for the patch and
position embeddings, ``i + 1`` for block ``i``, ``depth + 1`` for the last
norm and the head; no weight decay on 1-D tensors, biases and the
position embedding).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from posetpu_torch.aug.keyed import STREAM_DROP_PATH, bits_to_uniform, keyed_bits
from posetpu_torch.models.batchnorm import BatchNorm2d
from posetpu_torch.utils import profiling

LN_EPS = 1e-6
# ViTPose-H's patch embedding, MLP ratio and head
PATCH_SIZE = 16
PATCH_PADDING = 2
MLP_RATIO = 4
DECONV_FILTERS = 256
NUM_DECONV = 2

ATTENTION_LAUNCHES = profiling.launch_counter("launches.attention")


def _autocast(device_type, **kw):
    """``torch.autocast`` where the device has it; the ``meta`` device,
    on which the benchmark counts a forward's operations, has none."""
    if torch.amp.is_autocast_available(device_type):
        return torch.autocast(device_type, **kw)
    return contextlib.nullcontext()


class Attention(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"{num_heads} heads do not divide the width {dim}")
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        y = F.scaled_dot_product_attention(q, k, v)  # scale: head_dim ** -0.5
        profiling.count(ATTENTION_LAUNCHES)
        return self.proj(y.transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * MLP_RATIO)

    def forward(self, x, keep=None):
        """``keep``: (B, 2) float32 scales of the two branches (0, or
        1 / (1 - rate)), or None without drop path."""
        a = self.attn(self.norm1(x))
        x = x + (a if keep is None else a * keep[:, 0, None, None])
        m = self.mlp(self.norm2(x))
        return x + (m if keep is None else m * keep[:, 1, None, None])


class Head(nn.Module):
    """ViTPose's ``TopdownHeatmapSimpleHead``: deconvolutions (each with a
    norm and ReLU) and the final 1x1 conv."""

    def __init__(self, cin, num_classes):
        super().__init__()
        layers = []
        for _ in range(NUM_DECONV):
            layers += [nn.ConvTranspose2d(cin, DECONV_FILTERS, 4, stride=2, padding=1,
                                          bias=False),
                       BatchNorm2d(DECONV_FILTERS), nn.ReLU(inplace=True)]
            cin = DECONV_FILTERS
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(DECONV_FILTERS, num_classes, 1)

    def forward(self, x):
        y = self.deconv_layers(x)
        # in the parameters' own type: float32, or float64 for a model
        # taken to .double() as a reference
        with _autocast(x.device.type, enabled=False):
            return self.final_layer(y.to(self.final_layer.weight.dtype))


class ViTPose(nn.Module):
    """ViTPose-H's widths by default (module docstring)."""

    # the train step passes the drop-path keys (seed, step, index)
    keyed = True
    # the loss weighs each joint by its target weight
    masked_loss = True

    def __init__(self, num_classes=16, img_size=256, embed_dim=1280, depth=32,
                 num_heads=16, drop_path_rate=0.55, dtype=torch.bfloat16):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.dtype = dtype
        self.img_size = img_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, embed_dim, PATCH_SIZE, stride=PATCH_SIZE,
                                          padding=PATCH_PADDING)
        self.grid = (img_size + 2 * PATCH_PADDING - PATCH_SIZE) // PATCH_SIZE + 1
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid * self.grid + 1, embed_dim))
        self.rates = torch.linspace(0, drop_path_rate, depth, device="cpu").tolist()
        # on the network's device: a capture refuses a copy from the host
        self.register_buffer("drop_rates", torch.tensor(self.rates), persistent=False)
        self.blocks = nn.ModuleList([Block(embed_dim, num_heads) for _ in range(depth)])
        self.last_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.keypoint_head = Head(embed_dim, num_classes)

    @property
    def num_layers(self):
        """The layers of the learning-rate decay: the embeddings, each
        block, the last norm with the head."""
        return len(self.blocks) + 2

    def layer_id(self, name):
        """The layer of parameter ``name`` (module docstring)."""
        if name == "pos_embed" or name.startswith("patch_embed."):
            return 0
        if name.startswith("blocks."):
            return int(name.split(".")[1]) + 1
        return self.num_layers - 1

    def param_groups(self, optim_cfg):
        """The parameters as ``optim_cfg``'s AdamW takes them
        (:class:`posetpu_torch.train.state.LayerDecayAdamW`): one group a
        (layer, decayed or not) pair, in order of first appearance, each
        with ``lr_scale`` ``layer_decay ** (num_layers - 1 - layer)``, its
        ``weight_decay`` (``optim_cfg``'s, or 0 on 1-D tensors, biases and
        ``pos_embed``) and its parameters' ``names``."""
        groups = {}
        for name, p in self.named_parameters():
            layer = self.layer_id(name)
            decays = not (p.ndim == 1 or name.endswith(".bias") or name == "pos_embed")
            wd = optim_cfg.weight_decay if decays else 0.0
            g = groups.setdefault((layer, wd), {
                "params": [], "names": [], "weight_decay": wd,
                "lr_scale": optim_cfg.layer_decay ** (self.num_layers - 1 - layer)})
            g["params"].append(p)
            g["names"].append(name)
        return list(groups.values())

    def _keep(self, keys, B):
        """(depth, B, 2) float32 branch scales of the drop-path draws, or a
        list of None where no branch drops."""
        if not any(self.rates):
            return [None] * len(self.blocks)
        if keys is None:
            raise ValueError("a train-mode ViTPose forward with drop path takes "
                             "keys=(seed, step, index)")
        seed, step, index = keys
        if index.shape[0] != B:
            raise ValueError(f"{index.shape[0]} keys for a batch of {B}")
        u = bits_to_uniform(keyed_bits(seed, step, index, STREAM_DROP_PATH,
                                       2 * len(self.blocks)))
        u = u.reshape(B, len(self.blocks), 2).transpose(0, 1)
        rate = self.drop_rates[:, None, None]
        return torch.where(u < 1.0 - rate, 1.0 / (1.0 - rate), 0.0)

    def forward(self, x, keys=None):
        """x (B, H, W, 3) NHWC float -> [(B, K, H/4, W/4) float32].  In
        train mode ``keys`` = (seed, step, index) key the drop-path masks;
        eval mode drops nothing."""
        B, H, W, _ = x.shape
        if (H, W) != (self.img_size, self.img_size):
            raise ValueError(f"an input of {H}x{W} for a network of {self.img_size}^2")
        keep = self._keep(keys, B) if self.training else [None] * len(self.blocks)
        x = x.permute(0, 3, 1, 2)
        with _autocast(x.device.type, dtype=torch.bfloat16,
                       enabled=self.dtype == torch.bfloat16):
            t = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
            t = t + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
            for block, k in zip(self.blocks, keep):
                t = block(t, k)
            t = self.last_norm(t)
            fmap = t.transpose(1, 2).reshape(B, -1, self.grid, self.grid)
            return [self.keypoint_head(fmap)]

    def init_weights_(self, generator):
        """ViTPose's initialisation, drawn from ``generator`` in module
        order: every linear layer and the position embedding truncated
        normal of std 0.02 (cut at +-2, as timm's), biases zero; LayerNorm
        1 and 0; the patch convolution torch's default (Kaiming uniform, a
        = sqrt 5, and its bias uniform on +-1/sqrt fan_in); the
        deconvolutions and the final conv normal of std 0.001, the final
        conv's bias zero; the head's norms 1 and 0."""
        g = generator
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    nn.init.trunc_normal_(m.weight, std=0.02, a=-2.0, b=2.0, generator=g)
                    nn.init.zeros_(m.bias)
                elif isinstance(m, nn.LayerNorm):
                    nn.init.ones_(m.weight)
                    nn.init.zeros_(m.bias)
                elif isinstance(m, nn.ConvTranspose2d):
                    nn.init.normal_(m.weight, std=0.001, generator=g)
            proj = self.patch_embed.proj
            nn.init.kaiming_uniform_(proj.weight, a=5 ** 0.5, generator=g)
            bound = proj.weight[0].numel() ** -0.5
            nn.init.uniform_(proj.bias, -bound, bound, generator=g)
            nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-2.0, b=2.0, generator=g)
            final = self.keypoint_head.final_layer
            nn.init.normal_(final.weight, std=0.001, generator=g)
            nn.init.zeros_(final.bias)
            for m in self.modules():
                if isinstance(m, BatchNorm2d):
                    nn.init.ones_(m.weight)
                    nn.init.zeros_(m.bias)
        return self
