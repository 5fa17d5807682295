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

The map covers every layout the JAX package trains (the reference's own
transplant stops at ``num_blocks=1``): ``num_blocks`` > 1, where the
residual sites ``up1_d{d}_{j}``, ``low1_d{d}_{j}``, ``low2_d1_{j}``,
``low3_d{d}_{j}`` and ``res{i}_{j}`` map onto ``<site>.<j>`` of the port's
``nn.Sequential``, and the scanned layout (``scan_stacks``), where every
leaf under ``stacks/`` carries a leading ``num_stacks`` axis that the carry
splits stack by stack (``stacks/hg/...`` -> ``hgs.<i>...``,
``stacks/res_{j}`` -> ``res.<i>``, ``stacks/fc_conv``, ``stacks/fc_bn``,
``stacks/score``, ``stacks/fc_`` and ``stacks/score_``, the last two for
every stack).  :func:`to_flax_variables` maps a state dict (or optimizer
moments by parameter name) back into flax's trees.
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


# a stack's head modules: the port's name -> the unrolled flax name
_HEADS = {"fc.{i}.0": "fc{i}_conv", "fc.{i}.1": "fc{i}_bn", "score.{i}": "score{i}",
          "fc_.{i}": "fc_{i}", "score_.{i}": "score_{i}"}
# ... and the scanned one, under stacks/
_SCANNED_HEADS = {"fc.{i}.0": "fc_conv", "fc.{i}.1": "fc_bn", "score.{i}": "score",
                  "fc_.{i}": "fc_", "score_.{i}": "score_"}


def _stack_map(num_blocks, depth, hg, res, heads):
    """One stack's flax module paths -> port module names with ``{i}`` for
    the stack.  ``hg`` is the flax prefix of the hourglass's modules,
    ``res`` that of the post-hourglass residuals (``_{j}`` appended), and
    ``heads`` the flax names of the fc, score and remap modules
    (``_HEADS``' keys)."""
    def blocks(flax, port):
        return {f"{flax}_{j}": port if num_blocks == 1 else f"{port}.{j}"
                for j in range(num_blocks)}

    m = {}
    for d in range(1, depth + 1):
        for site in ("up1", "low1", "low3"):
            m.update(blocks(f"{hg}/{site}_d{d}", f"hgs.{{i}}.mods.{site}_{d}"))
    m.update(blocks(f"{hg}/low2_d1", "hgs.{i}.low2"))
    m.update(blocks(res, "res.{i}"))
    m.update({flax: port for port, flax in heads.items()})
    return m


def _module_map(num_stacks, num_blocks, depth, scan_stacks=False):
    """flax module path prefix -> port module path prefix, or, in the
    scanned layout, the list of the ``num_stacks`` port prefixes that the
    leading axis of its leaves splits into."""
    if num_blocks < 1:
        raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
    m = {
        "stem_conv": "stem.0",
        "stem_bn": "stem.1",
        "stem_res1": "stem.3",
        "stem_res2": "stem.5",
        "stem_res3": "stem.6",
    }
    if scan_stacks:
        heads = {port: f"stacks/{flax}" for port, flax in _SCANNED_HEADS.items()}
        stack = _stack_map(num_blocks, depth, "stacks/hg", "stacks/res", heads)
        m.update({flax: [port.format(i=i) for i in range(num_stacks)]
                  for flax, port in stack.items()})
        return m
    for i in range(num_stacks):
        heads = {port: flax.format(i=i) for port, flax in _HEADS.items()}
        if i == num_stacks - 1:  # no remap after the last stack
            del heads["fc_.{i}"], heads["score_.{i}"]
        stack = _stack_map(num_blocks, depth, f"hg{i}", f"res{i}", heads)
        m.update({flax: port.format(i=i) for flax, port in stack.items()})
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
            tname, child = mmap[mod], None
        else:
            parent, _, child = mod.rpartition("/")
            if parent not in mmap or child not in _BOTTLENECK:
                raise KeyError(f"unmapped flax module path: {mod}")
            tname = mmap[parent]
        if isinstance(tname, list):  # scanned: one slice of the leading axis a stack
            if arr.shape[:1] != (len(tname),):
                raise ValueError(f"{path}: {arr.shape} has no leading axis of "
                                 f"{len(tname)} stacks")
            pieces = list(zip(tname, arr))
        else:
            pieces = [(tname, arr)]
        for name, a in pieces:
            if child is not None:
                name = f"{name}.{_BOTTLENECK[child]}"
            tleaf, tarr = _convert_leaf(leaf, a)
            out[f"{name}.{tleaf}"] = torch.from_numpy(
                np.array(tarr, dtype=np.float32, order="C")
            )
    return out


def from_flax_variables(
    params, batch_stats=None, *, num_stacks, num_blocks=1, depth=4, scan_stacks=False
):
    """Flax HourglassNet ``params`` (and ``batch_stats``) -> a state dict of
    float32 CPU tensors for ``HourglassNet.load_state_dict`` of a network
    built with the same ``num_blocks`` and ``scan_stacks``."""
    mmap = _module_map(num_stacks, num_blocks, depth, scan_stacks)
    out = _carry_tree(params, mmap)
    if batch_stats is not None:
        out.update(_carry_tree(batch_stats, mmap))
    return out


_BOTTLENECK_FLAX = {port: flax for flax, port in _BOTTLENECK.items()}


def _flax_leaf(leaf, arr):
    """port leaf name + array -> (flax collection, flax leaf, array): the
    inverse of :func:`_convert_leaf`."""
    if leaf == "weight":
        if arr.ndim == 4:  # OIHW -> HWIO
            return "params", "kernel", np.transpose(arr, (2, 3, 1, 0))
        if arr.ndim == 2:
            return "params", "kernel", np.transpose(arr)
        return "params", "scale", arr
    if leaf == "running_mean":
        return "batch_stats", "mean", arr
    if leaf == "running_var":
        return "batch_stats", "var", arr
    return "params", leaf, arr  # bias


def to_flax_variables(
    state_dict, *, num_stacks, num_blocks=1, depth=4, scan_stacks=False
):
    """The inverse of :func:`from_flax_variables`: a state dict of
    :class:`HourglassNet <posetpu_torch.models.HourglassNet>` (or a moment
    of its optimizer by parameter name) -> flax's ``(params,
    batch_stats)``, nested dicts of float32 numpy arrays (``batch_stats``
    empty for a moment).  In the scanned layout each stack's slices are
    stacked on a leading axis again; ``num_batches_tracked``, which flax
    does not keep, is dropped."""
    mmap = _module_map(num_stacks, num_blocks, depth, scan_stacks)
    inverse = {}
    for flax, port in mmap.items():
        for i, p in (enumerate(port) if isinstance(port, list) else [(None, port)]):
            inverse[p] = (flax, i)
    pieces = {}  # (collection, flax path) -> {stack or None: array}
    for name, t in state_dict.items():
        mod, _, leaf = name.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        if mod in inverse:
            fmod, i = inverse[mod]
        else:
            parent, _, child = mod.rpartition(".")
            if parent not in inverse or child not in _BOTTLENECK_FLAX:
                raise KeyError(f"unmapped port module: {mod}")
            fmod, i = inverse[parent]
            fmod = f"{fmod}/{_BOTTLENECK_FLAX[child]}"
        coll, fleaf, arr = _flax_leaf(leaf, t.detach().cpu().numpy())
        pieces.setdefault((coll, f"{fmod}/{fleaf}"), {})[i] = arr
    trees = {"params": {}, "batch_stats": {}}
    for (coll, path), by_stack in pieces.items():
        if None in by_stack:
            arr = by_stack[None]
        else:
            if sorted(by_stack) != list(range(num_stacks)):
                raise KeyError(f"{path}: stacks {sorted(by_stack)} of {num_stacks}")
            arr = np.stack([by_stack[i] for i in range(num_stacks)])
        node = trees[coll]
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = np.ascontiguousarray(arr, dtype=np.float32)
    return trees["params"], trees["batch_stats"]


def _optax_fields(state, found):
    """Collect the ``nu``, ``trace`` and ``count`` fields of optax's state
    namedtuples, walking the nested tuples of a ``chain`` (or take them
    from a dict that holds them by name)."""
    if isinstance(state, Mapping):
        found.update({k: state[k] for k in ("nu", "trace", "count") if k in state})
        return found
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


def from_optax_state(opt_state, *, num_stacks, num_blocks=1, depth=4,
                     scan_stacks=False):
    """The JAX package's optimizer state (optax ``rmsprop``, optionally
    chained behind ``add_decayed_weights``) -> ``{"count": int, "nu":
    {name: tensor}, "trace": {name: tensor} or None}`` by the port's
    parameter names, for :meth:`OptaxRMSprop.load_carried
    <posetpu_torch.train.state.OptaxRMSprop.load_carried>`.

    ``nu`` and ``trace`` map like ``params`` (conv kernels HWIO -> OIHW);
    ``count`` is the schedule's update count.  Reads the state's
    namedtuples by their field names, or a dict of those fields (the JAX
    package's torch container, :mod:`posetpu_torch.ckpt.torch_export`), and
    needs no JAX.  ``num_blocks`` and
    ``scan_stacks`` select the layout, as for :func:`from_flax_variables`.
    """
    mmap = _module_map(num_stacks, num_blocks, depth, scan_stacks)
    return _carry_optax(opt_state, lambda tree: mmap)


def from_optax_agent_state(opt_state):
    """The agent's optax state -> the port's, as :func:`from_optax_state`
    maps the hourglass's, by :class:`AugAgent
    <posetpu_torch.models.agent.AugAgent>` parameter names."""
    return _carry_optax(opt_state, _agent_module_map)
