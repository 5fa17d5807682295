"""Adversarial augmentation agent — counterpart of
``posetpu/models/agent.py``: the bin tables, the occlusion hierarchies
(spatial grid and body parts), the :class:`AugAgent` CNN and its tree
sampler.

The agent looks at the neutral crop and emits categorical logits over
scale bins, rotation bins and optionally occlusion nodes (ASR and AHO
after Peng et al., CVPR'18).  Module and head names follow the flax
module's, so :func:`posetpu_torch.ckpt.from_flax_agent_variables` maps
them one to one (its ``Dense_0`` is :attr:`AugAgent.hidden` here).

The draws are keyed like every draw of the port
(:func:`posetpu_torch.aug.keyed.sample_categorical`, the counterpart of
``sample_bins_ps``), not by JAX's threefry.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from posetpu_torch.aug.keyed import sample_categorical
from posetpu_torch.models.batchnorm import BatchNorm2d, flax_train_forward
from posetpu_torch.utils.device import resolve_device

_F32 = torch.float32


def scale_bin_table(num_bins=7, lo_log2=-0.4, hi_log2=0.4):
    """Multiplicative scale factors 2^linspace(lo, hi), centered on 1."""
    return np.exp2(np.linspace(lo_log2, hi_log2, num_bins)).astype(np.float32)


def rotation_bin_table(num_bins=7, lo_deg=-30.0, hi_deg=30.0):
    """Rotation angles in degrees, linear bins, centered on 0."""
    return np.linspace(lo_deg, hi_deg, num_bins).astype(np.float32)


def occlusion_hierarchy(res=(256, 256), levels=(1, 2, 4)):
    """(N, 4) int32 (y0, x0, h, w) boxes of the spatial occlusion tree:
    node 0 is "no occlusion", then for each level g a g x g grid of square
    occluders of side H//(g+1) x W//(g+1) centered on the grid's cells, row
    major, in ``levels`` order."""
    H, W = res
    boxes = [(0, 0, 0, 0)]
    for g in levels:
        ch, cw = H // (g + 1), W // (g + 1)
        for i in range(g):
            for j in range(g):
                cy = int((i + 1) * H / (g + 1))
                cx = int((j + 1) * W / (g + 1))
                boxes.append((cy - ch // 2, cx - cw // 2, ch, cw))
    return np.asarray(boxes, np.int32)


def occ_level_offsets(levels):
    """Start index of each level's cells in the node layout of
    :func:`occlusion_hierarchy`."""
    return _offsets_from_sizes([g * g for g in levels])


def _offsets_from_sizes(sizes):
    """Start index of each level's cells where node 0 is "no occlusion" and
    levels of ``sizes[i]`` cells follow in order."""
    offs, n = [], 1
    for s in sizes:
        offs.append(n)
        n += s
    return np.asarray(offs, np.int32)


# Body-part hierarchy, the port's copy of the JAX package's: joint groups in
# the datasets' index conventions (MPII 16 joints, LSP 14), coarse -> fine:
# [upper body, lower body] then [head, torso, r-arm, l-arm, r-leg, l-leg].
PART_GROUPS = {
    "mpii": (
        ((6, 7, 8, 9, 10, 11, 12, 13, 14, 15), (0, 1, 2, 3, 4, 5)),
        ((8, 9), (2, 3, 6, 7, 12, 13), (10, 11, 12), (13, 14, 15),
         (0, 1, 2), (3, 4, 5)),
    ),
    "lsp": (
        ((6, 7, 8, 9, 10, 11, 12, 13), (0, 1, 2, 3, 4, 5)),
        ((12, 13), (2, 3, 8, 9), (6, 7, 8), (9, 10, 11),
         (0, 1, 2), (3, 4, 5)),
    ),
}


def part_level_sizes(dataset="mpii"):
    """Cells per level of the body-part hierarchy (e.g. (2, 6))."""
    return tuple(len(level) for level in PART_GROUPS[dataset])


def part_occlusion_boxes(pts, vis, dataset="mpii", margin=0.15, min_px=8):
    """Per-sample occluder boxes from each sample's own keypoints.

    pts (B, K, 2) crop-pixel (x, y); vis (B, K).  Returns (B, N, 4) int32
    (y0, x0, h, w): node 0 "no occlusion", then each part of
    :data:`PART_GROUPS` in order.  A part's box is the bounding box of its
    visible joints grown on each side by ``margin`` of its larger side plus
    ``min_px``; a part with no visible joint gets a zero box.  The float32
    corners are cast to int32 by truncation toward zero, as the reference's
    ``astype`` does, so negative corners round up.
    """
    pts = torch.as_tensor(pts, dtype=_F32)
    v = torch.as_tensor(vis, device=pts.device) > 0
    boxes = [torch.zeros((pts.shape[0], 4), dtype=_F32, device=pts.device)]
    big = 1e9  # exact in float32
    for level in PART_GROUPS[dataset]:
        for group in level:
            # columns by Python ints: a list index would be copied to the
            # card, a host copy that a CUDA graph's capture refuses
            m = torch.stack([v[:, j] for j in group], dim=1)
            x = torch.stack([pts[:, j, 0] for j in group], dim=1)
            y = torch.stack([pts[:, j, 1] for j in group], dim=1)
            x0 = torch.where(m, x, big).amin(dim=1)
            x1 = torch.where(m, x, -big).amax(dim=1)
            y0 = torch.where(m, y, big).amin(dim=1)
            y1 = torch.where(m, y, -big).amax(dim=1)
            pad = margin * torch.maximum(x1 - x0, y1 - y0) + min_px
            box = torch.stack(
                [y0 - pad, x0 - pad, (y1 - y0) + 2 * pad, (x1 - x0) + 2 * pad],
                dim=-1,
            )
            boxes.append(torch.where(m.any(dim=1)[:, None], box, 0.0))
    return torch.stack(boxes, dim=1).to(torch.int32)


def _pad_same(x, k, stride=2):
    """flax/XLA ``padding="SAME"`` for a strided conv: the output has
    ceil(n/stride) positions and the padding is split low-first, (2, 3) for
    a 7x7 over 128 and (0, 1) for a 3x3 over 64 — not torch's symmetric
    ``padding=k//2``, which gives the same shape on a shifted grid."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: W, then H
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class AugAgent(nn.Module):
    """Small CNN: neutral crop -> categorical logits over augmentation bins.

    ``len(widths)`` stride-2 convs (7x7, then 3x3) with BatchNorm and ReLU,
    a global mean, ``hidden`` (the flax ``Dense_0``, 256 wide) with ReLU,
    then float32 heads: ``head_scale``, ``head_rot`` and, with
    ``num_occ_nodes > 0``, the occlusion heads of ``occ_mode``: "tree" (a
    level head over [none, *occ_levels] and one ``head_occ_cell{g}`` per
    level of g x g cells), "parts" (the same over :data:`PART_GROUPS`,
    ``head_occ_part{i}``) or "flat" (``head_occ`` over every node).

    With ``dtype=torch.bfloat16`` the input is cast to bf16 and pooled in
    bf16, and the convs, BatchNorms and ``hidden`` run under bf16 autocast
    with float32 parameters and statistics, as the reference computes; the
    heads are float32 either way.  BatchNorm in train mode follows flax
    (:func:`posetpu_torch.models.batchnorm.flax_train_forward`); under data
    parallelism it takes the process group through
    :func:`posetpu_torch.models.batchnorm.convert_cross_replica_`.

    The agent is made on ``device`` (default CUDA; raises without it unless
    ``device="cpu"``).
    """

    def __init__(self, num_scale_bins=7, num_rot_bins=7, num_occ_nodes=0,
                 occ_mode="tree", occ_levels=(1, 2, 4), occ_dataset="mpii",
                 widths=(32, 64, 128, 256), input_downscale=1,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.dtype = dtype
        self.num_occ_nodes = num_occ_nodes
        self.occ_mode = occ_mode
        self.occ_levels = tuple(occ_levels)
        self.occ_dataset = occ_dataset
        self.input_downscale = input_downscale
        self.widths = tuple(widths)
        cin = 3
        for i, w in enumerate(self.widths):
            setattr(self, f"conv{i}", nn.Conv2d(cin, w, 3 if i else 7, stride=2))
            setattr(self, f"bn{i}", BatchNorm2d(w))
            cin = w
        self.hidden = nn.Linear(cin, 256)
        self.head_scale = nn.Linear(256, num_scale_bins)
        self.head_rot = nn.Linear(256, num_rot_bins)
        self.occ_cell_heads = ()
        if num_occ_nodes > 0:
            if occ_mode in ("tree", "parts"):
                if occ_mode == "tree":
                    sizes = [g * g for g in self.occ_levels]
                    names = [f"head_occ_cell{g}" for g in self.occ_levels]
                    what = f"occ_levels={self.occ_levels}"
                else:
                    sizes = list(part_level_sizes(occ_dataset))
                    names = [f"head_occ_part{i}" for i in range(len(sizes))]
                    what = f"PART_GROUPS[{occ_dataset!r}]"
                expect = 1 + sum(sizes)
                if num_occ_nodes != expect:
                    raise ValueError(
                        f"num_occ_nodes={num_occ_nodes} does not match "
                        f"{what} (expected {expect})"
                    )
                self.head_occ_level = nn.Linear(256, len(sizes) + 1)
                for s, n in zip(sizes, names):
                    setattr(self, n, nn.Linear(256, s))
                self.occ_cell_heads = tuple(names)
            elif occ_mode == "flat":
                self.head_occ = nn.Linear(256, num_occ_nodes)
            else:
                raise ValueError(f"unknown occ_mode {occ_mode!r}")
        # a plain list: the modules are registered above already
        self._norms = [getattr(self, f"bn{i}") for i in range(len(self.widths))]
        self.to(resolve_device(device))

    def forward(self, x):
        """x (B, H, W, 3) neutral crop -> dict of float32 logits:
        ``scale`` (B, S), ``rot`` (B, R), and with occlusion heads either
        ``occ_level`` (B, L+1) and ``occ_cells`` (a tuple of (B, n_i)), or
        ``occ`` (B, N)."""
        if not self.training:
            return self._forward(x)
        return flax_train_forward(self._norms, self._forward, x)

    def _forward(self, x):
        bf16 = self.dtype == torch.bfloat16
        dev = x.device.type
        x = x.permute(0, 3, 1, 2)
        x = x.to(torch.bfloat16 if bf16 else self.conv0.weight.dtype)
        if self.input_downscale > 1:
            x = F.avg_pool2d(x, self.input_downscale)
        with torch.autocast(dev, dtype=torch.bfloat16, enabled=bf16):
            for i in range(len(self.widths)):
                conv = getattr(self, f"conv{i}")
                x = conv(_pad_same(x, conv.kernel_size[0]))
                x = F.relu(getattr(self, f"bn{i}")(x))
            # global mean accumulated in float32, back in the activations'
            # type, as jnp.mean of a bf16 array
            x = x.float().mean(dim=(2, 3)).to(x.dtype)
            x = F.relu(self.hidden(x))
        with torch.autocast(dev, enabled=False):
            x = x.to(self.head_scale.weight.dtype)
            out = {"scale": self.head_scale(x), "rot": self.head_rot(x)}
            if self.occ_cell_heads:
                out["occ_level"] = self.head_occ_level(x)
                out["occ_cells"] = tuple(getattr(self, n)(x)
                                         for n in self.occ_cell_heads)
            elif self.num_occ_nodes > 0:
                out["occ"] = self.head_occ(x)
        return out


def sample_occlusion_tree(seed, step, index, stream, level_logits, cell_logits):
    """Tree-structured occlusion draw: the level (0 = none), then a cell at
    *every* level, of which the sampled level's is kept; the log-prob sums
    along the path.  Draws come from one ``stream``: the level head takes
    draws 0 .. L, each cell head the next n_i.

    level_logits (B, L+1); cell_logits a tuple of L (B, n_i).  Returns
    (node, lvl, cell, logp), all (B,): ``node`` indexes the flat box table
    (:func:`occlusion_hierarchy` or :func:`part_occlusion_boxes`), ``(lvl,
    cell)`` is the path :func:`occlusion_tree_logp` re-evaluates.
    """
    lvl, logp_lvl = sample_categorical(seed, step, index, stream, level_logits)
    first = level_logits.shape[1]
    cells, logps = [], []
    for cl in cell_logits:
        c, lp = sample_categorical(seed, step, index, stream, cl, first)
        first += cl.shape[1]
        cells.append(c)
        logps.append(lp)
    cells = torch.stack(cells, dim=1)
    logps = torch.stack(logps, dim=1)
    b = torch.arange(lvl.shape[0], device=lvl.device)
    li = torch.clamp(lvl - 1, min=0)
    cell = cells[b, li]
    # node = offset of the level + cell, the offsets as Python ints: a
    # table copied to the card is a host copy, which a CUDA graph's
    # capture refuses
    node = torch.zeros_like(lvl)
    offsets = _offsets_from_sizes([cl.shape[1] for cl in cell_logits])
    for level, off in enumerate(offsets.tolist(), start=1):
        node = torch.where(lvl == level, off + cell, node)
    logp = logp_lvl + torch.where(lvl == 0, 0.0, logps[b, li])
    return node, lvl, cell, logp


def occlusion_tree_logp(level_logits, cell_logits, lvl, cell):
    """log p of a (level, cell) path under the tree policy, differentiable
    in the logits.  ``cell`` indexes the sampled level's cells and may
    exceed a smaller level's width, so it is clamped per level; only the
    sampled level's column is kept."""
    lp_lvl = torch.log_softmax(level_logits, dim=-1).gather(1, lvl[:, None])[:, 0]
    b = torch.arange(level_logits.shape[0], device=level_logits.device)
    li = torch.clamp(lvl - 1, min=0)
    lp_cells = torch.stack(
        [torch.log_softmax(cl, dim=-1)[b, torch.clamp(cell, max=cl.shape[1] - 1)]
         for cl in cell_logits],
        dim=1,
    )
    return lp_lvl + torch.where(lvl == 0, 0.0, lp_cells[b, li])
