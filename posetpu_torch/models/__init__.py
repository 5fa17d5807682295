"""Pose networks and the adversarial augmentation agent, and
:func:`build_model`, which every path of the port builds its pose network
through."""

import torch

from posetpu_torch.models.agent import AugAgent
from posetpu_torch.models.hourglass import Bottleneck, Hourglass, HourglassNet, hg
from posetpu_torch.models.vitpose import ViTPose


def build_model(model_cfg):
    """The pose network of ``model_cfg`` (a
    :class:`posetpu_torch.configs.ModelConfig`): by its ``arch``, the
    stacked hourglass (its stacks, blocks, features, depth, remat and
    scanned layout) or ViTPose (:class:`posetpu_torch.configs.ViTConfig`'s
    widths, at the config's input side ``img_size``), with default weights
    on the current device; bf16 autocast over float32 parameters where
    ``model_cfg.bf16`` is set, else float32."""
    dtype = torch.bfloat16 if model_cfg.bf16 else torch.float32
    m = model_cfg
    if m.arch == "hourglass":
        # the scanned layout implies remat, as in the reference
        return hg(num_stacks=m.stacks, num_blocks=m.blocks, num_classes=m.classes,
                  num_feats=m.feats, depth=m.depth, dtype=dtype,
                  remat=m.remat or m.scan_stacks, scan_stacks=m.scan_stacks)
    if m.arch == "vit":
        return ViTPose(num_classes=m.classes, img_size=m.img_size, embed_dim=m.embed_dim,
                       depth=m.vit_depth, num_heads=m.num_heads,
                       drop_path_rate=m.drop_path_rate, dtype=dtype)
    raise ValueError(f"unknown model arch {m.arch!r} (expected 'hourglass' or 'vit')")


__all__ = ["AugAgent", "Bottleneck", "Hourglass", "HourglassNet", "ViTPose", "build_model",
           "hg"]
