"""Weight carry: the JAX package's flax hourglass variables -> a state dict
of :class:`posetpu_torch.models.HourglassNet`, its flax ``AugAgent``
variables -> a state dict of :class:`posetpu_torch.models.agent.AugAgent`,
and either network's optax RMSprop state -> the port's optimizer state
(:func:`from_optax_state`, :func:`from_optax_agent_state`).

The port's own copy of the mapping in ``posetpu/ckpt/transplant.py``:
flax module paths map onto the port's module names (those of
``tools/torch_baseline.py``), conv kernels go HWIO -> OIHW, BatchNorm
``scale`` -> ``weight`` and ``mean``/``var`` -> ``running_mean``/
``running_var``.  It reads nested dicts of numpy arrays and needs no JAX.
"""

from __future__ import annotations

import re
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


# the agent's flax modules keep their names in the port, but for Dense_0
_AGENT_MODULE = re.compile(
    r"(conv|bn)\d+|head_(scale|rot|occ|occ_level|occ_cell\d+|occ_part\d+)"
)


def _agent_module_map(names):
    """flax AugAgent module name -> port module name."""
    m = {}
    for n in names:
        if n == "Dense_0":
            m[n] = "hidden"
        elif _AGENT_MODULE.fullmatch(n):
            m[n] = n
        else:
            raise KeyError(f"unmapped flax agent module: {n}")
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


def _carry_tree(tree, mmap):
    """One flax-shaped tree (params, batch_stats, or an optimizer moment
    shaped like params) -> {port name: float32 CPU tensor}."""
    out = {}
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


def from_flax_variables(
    params, batch_stats=None, *, num_stacks, num_blocks=1, depth=4
):
    """Flax HourglassNet ``params`` (and ``batch_stats``) -> a state dict of
    float32 CPU tensors for ``HourglassNet.load_state_dict``."""
    mmap = _module_map(num_stacks, num_blocks, depth)
    out = _carry_tree(params, mmap)
    if batch_stats is not None:
        out.update(_carry_tree(batch_stats, mmap))
    return out


def _optax_fields(state, found):
    """Collect the ``nu``, ``trace`` and ``count`` fields of optax's state
    namedtuples, walking the nested tuples of a ``chain``."""
    fields = getattr(state, "_fields", None)
    if fields is not None:
        for name in ("nu", "trace", "count"):
            if name in fields:
                if name in found:
                    raise ValueError(f"optimizer state holds two {name!r} fields")
                found[name] = getattr(state, name)
        return found
    if isinstance(state, (tuple, list)):
        for s in state:
            _optax_fields(s, found)
    return found


def from_flax_agent_variables(params, batch_stats=None):
    """Flax AugAgent ``params`` (and ``batch_stats``) -> a state dict of
    float32 CPU tensors for ``AugAgent.load_state_dict``: conv kernels
    HWIO -> OIHW, dense kernels transposed, ``Dense_0`` -> ``hidden``."""
    out = _carry_tree(params, _agent_module_map(params))
    if batch_stats is not None:
        out.update(_carry_tree(batch_stats, _agent_module_map(batch_stats)))
    return out


def _carry_optax(opt_state, module_map):
    """optax rmsprop state -> ``{"count", "nu", "trace"}`` by port names;
    ``module_map(tree)`` gives the flax -> port module map of a moment."""
    found = _optax_fields(opt_state, {})
    if "nu" not in found or "count" not in found:
        raise ValueError("not an rmsprop state: no nu or no update count")
    trace = found.get("trace")
    return {
        "count": int(np.asarray(found["count"])),
        "nu": _carry_tree(found["nu"], module_map(found["nu"])),
        "trace": None if trace is None else _carry_tree(trace, module_map(trace)),
    }


def from_optax_state(opt_state, *, num_stacks, num_blocks=1, depth=4):
    """The JAX package's optimizer state (optax ``rmsprop``, optionally
    chained behind ``add_decayed_weights``) -> ``{"count": int, "nu":
    {name: tensor}, "trace": {name: tensor} or None}`` by the port's
    parameter names, for :meth:`OptaxRMSprop.load_carried
    <posetpu_torch.train.state.OptaxRMSprop.load_carried>`.

    ``nu`` and ``trace`` map like ``params`` (conv kernels HWIO -> OIHW);
    ``count`` is the schedule's update count.  Reads the state's
    namedtuples by their field names and needs no JAX.
    """
    mmap = _module_map(num_stacks, num_blocks, depth)
    return _carry_optax(opt_state, lambda tree: mmap)


def from_optax_agent_state(opt_state):
    """The agent's optax state -> the port's, as :func:`from_optax_state`
    maps the hourglass's, by :class:`AugAgent
    <posetpu_torch.models.agent.AugAgent>` parameter names."""
    return _carry_optax(opt_state, _agent_module_map)
