"""Weight carry: the JAX package's flax hourglass variables -> a state dict
of :class:`posetpu_torch.models.HourglassNet`.

The port's own copy of the mapping in ``posetpu/ckpt/transplant.py``:
flax module paths map onto the port's module names (those of
``tools/torch_baseline.py``), conv kernels go HWIO -> OIHW, BatchNorm
``scale`` -> ``weight`` and ``mean``/``var`` -> ``running_mean``/
``running_var``.  It reads nested dicts of numpy arrays and needs no JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

# flax Bottleneck child -> port Bottleneck child
_BOTTLENECK = {
    "BatchNorm_0": "bn1",
    "Conv_0": "conv1",
    "BatchNorm_1": "bn2",
    "Conv_1": "conv2",
    "BatchNorm_2": "bn3",
    "Conv_2": "conv3",
    "proj": "proj",
}


def _module_map(num_stacks, num_blocks, depth):
    """flax module path prefix -> port module path prefix (unrolled
    ``num_blocks=1`` layout only)."""
    if num_blocks != 1:
        raise ValueError("the weight carry covers the num_blocks=1 model")
    m = {
        "stem_conv": "stem.0",
        "stem_bn": "stem.1",
        "stem_res1": "stem.3",
        "stem_res2": "stem.5",
        "stem_res3": "stem.6",
    }
    for i in range(num_stacks):
        for d in range(1, depth + 1):
            m[f"hg{i}/up1_d{d}_0"] = f"hgs.{i}.mods.up1_{d}"
            m[f"hg{i}/low1_d{d}_0"] = f"hgs.{i}.mods.low1_{d}"
            m[f"hg{i}/low3_d{d}_0"] = f"hgs.{i}.mods.low3_{d}"
        m[f"hg{i}/low2_d1_0"] = f"hgs.{i}.low2"
        m[f"res{i}_0"] = f"res.{i}"
        m[f"fc{i}_conv"] = f"fc.{i}.0"
        m[f"fc{i}_bn"] = f"fc.{i}.1"
        m[f"score{i}"] = f"score.{i}"
        if i < num_stacks - 1:
            m[f"fc_{i}"] = f"fc_.{i}"
            m[f"score_{i}"] = f"score_.{i}"
    return m


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _convert_leaf(leaf, arr):
    """flax leaf name + array -> port leaf name + array."""
    if leaf == "kernel":
        if arr.ndim == 4:  # HWIO -> OIHW
            return "weight", np.transpose(arr, (3, 2, 0, 1))
        return "weight", np.transpose(arr)
    if leaf == "scale":
        return "weight", arr
    if leaf == "mean":
        return "running_mean", arr
    if leaf == "var":
        return "running_var", arr
    return leaf, arr  # bias


def from_flax_variables(
    params, batch_stats=None, *, num_stacks, num_blocks=1, depth=4
):
    """Flax HourglassNet ``params`` (and ``batch_stats``) -> a state dict of
    float32 CPU tensors for ``HourglassNet.load_state_dict``."""
    mmap = _module_map(num_stacks, num_blocks, depth)
    out = {}
    trees = [params] + ([batch_stats] if batch_stats is not None else [])
    for tree in trees:
        for path, arr in _flatten(tree).items():
            mod, _, leaf = path.rpartition("/")
            # Bottleneck children sit one level below the mapped module
            if mod in mmap:
                tname = mmap[mod]
            else:
                parent, _, child = mod.rpartition("/")
                if parent not in mmap or child not in _BOTTLENECK:
                    raise KeyError(f"unmapped flax module path: {mod}")
                tname = f"{mmap[parent]}.{_BOTTLENECK[child]}"
            tleaf, tarr = _convert_leaf(leaf, arr)
            out[f"{tname}.{tleaf}"] = torch.from_numpy(
                np.array(tarr, dtype=np.float32, order="C")
            )
    return out
