"""The JAX package's torch-layout container, read and written — the
counterpart of ``posetpu/ckpt/torch_export.py`` (``save_torch_checkpoint``,
``load_torch_checkpoint``), the one checkpoint format the JAX side hands
over without orbax.

The container is ``torch.save({"epoch", "state_dict", "optimizer",
"best_acc"})``:

- ``state_dict``: flax module paths joined by "." (``hg0.up1_d4_0.Conv_1``,
  ``stacks.hg.up1_d2_0.Conv_1``), leaves renamed (``kernel`` and ``scale``
  -> ``weight``, ``mean``/``var`` -> ``running_*``), float32 tensors.  A 4-D
  conv kernel is OIHW; a scanned one stays 5-D HWIO, ``(stacks, H, W, I,
  O)``, since the JAX side transposes only 4-D kernels.
- ``optimizer``: the optax state as ``{jax keystr: ndarray}`` in flax's own
  layout (HWIO kernels, ``scale``): ``nu``, ``count`` and, with momentum,
  ``trace``, under ``[1]`` when ``add_decayed_weights`` is chained first
  (``[1][0].nu['stacks']['fc_']['kernel']``, ``[1][1].count``); empty when
  no optimizer state was saved.

Both sides map through :mod:`posetpu_torch.ckpt.transplant`'s module map,
so the unrolled, ``num_blocks`` > 1 and scanned layouts round-trip.  The
reader needs neither JAX nor the JAX package: it loads with
``weights_only=True`` and allows numpy's array globals only.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from posetpu_torch.ckpt.transplant import (
    _flatten,
    from_flax_variables,
    from_optax_state,
    to_flax_variables,
)

# what a pickled numpy array needs: its reconstructor, ndarray, dtype, and
# (numpy >= 1.25) the dtype classes of the container's arrays
_NUMPY_GLOBALS = [np.zeros(0).__reduce__()[0], np.ndarray, np.dtype] + [
    type(np.dtype(t)) for t in (np.float32, np.float64, np.int32, np.int64)
]

# an optax keystr: the state field and the dict keys of the leaf below it
_OPTAX_LEAF = re.compile(r"\.(nu|trace|count)((?:\['[^']*'\])*)$")
_DICT_KEY = re.compile(r"\['([^']*)'\]")


def _from_container(state_dict):
    """The container's ``state_dict`` -> flax's (params, batch_stats) as
    nested dicts of numpy arrays: a 4-D ``weight`` is an OIHW conv kernel,
    a 5-D one a scanned HWIO kernel, a lower one a BatchNorm scale."""
    params, stats = {}, {}
    for key, t in state_dict.items():
        *mods, leaf = key.split(".")
        arr = t.numpy()
        tree = params
        if leaf == "weight":
            if arr.ndim == 4:
                leaf, arr = "kernel", np.transpose(arr, (2, 3, 1, 0))
            else:
                leaf = "kernel" if arr.ndim == 5 else "scale"
        elif leaf in ("running_mean", "running_var"):
            tree, leaf = stats, leaf[len("running_"):]
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = arr
    return params, stats


def _to_container(params, batch_stats):
    """flax's (params, batch_stats) -> the container's ``state_dict``, as
    the JAX package's ``to_torch_state_dict`` writes it: only 4-D kernels
    are transposed to OIHW."""
    out = {}
    for path, arr in _flatten(params).items():
        head, _, leaf = path.replace("/", ".").rpartition(".")
        if leaf == "kernel" and arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))
        out[f"{head}.{'weight' if leaf in ('kernel', 'scale') else leaf}"] = arr
    for path, arr in _flatten(batch_stats).items():
        head, _, leaf = path.replace("/", ".").rpartition(".")
        out[f"{head}.running_{leaf}"] = arr
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in out.items()}


def _optimizer_fields(blob):
    """``{keystr: ndarray}`` -> ``{"nu": tree, "trace": tree, "count":
    array}`` by field name, whatever the index prefix of the chain."""
    found = {}
    for key, arr in blob.items():
        m = _OPTAX_LEAF.search(key)
        if m is None:
            raise KeyError(f"not an rmsprop state leaf: {key}")
        field, path = m.group(1), _DICT_KEY.findall(m.group(2))
        if field == "count":
            if "count" in found:
                raise ValueError("optimizer state holds two update counts")
            found["count"] = arr
            continue
        node = found.setdefault(field, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(arr)
    return found


def load_reference_checkpoint(path, *, num_stacks, num_blocks=1, depth=4,
                              scan_stacks=False):
    """Read the JAX package's container at ``path`` for a
    :class:`HourglassNet <posetpu_torch.models.HourglassNet>` of that
    layout.  Returns ``(state_dict, optimizer, epoch, best_acc)``:

    - ``state_dict`` for ``HourglassNet.load_state_dict`` (float32 CPU
      tensors); its ``num_batches_tracked``, which flax does not keep, are
      the optimizer's update count (one train-mode forward an update), or
      left out without an optimizer state;
    - ``optimizer``, ``{"count", "nu", "trace"}`` by the port's parameter
      names for :meth:`OptaxRMSprop.load_carried
      <posetpu_torch.train.state.OptaxRMSprop.load_carried>`, or None when
      the container holds none.

    The container has no ``step``, the count that keys the port's
    augmentation draws: a resumed state takes the update count for it
    (:func:`restore_reference_checkpoint`), as the JAX train step advances
    both together."""
    with torch.serialization.safe_globals(_NUMPY_GLOBALS):
        blob = torch.load(path, map_location="cpu", weights_only=True)
    layout = dict(num_stacks=num_stacks, num_blocks=num_blocks, depth=depth,
                  scan_stacks=scan_stacks)
    params, stats = _from_container(blob["state_dict"])
    state_dict = from_flax_variables(params, stats, **layout)
    optimizer = None
    if blob.get("optimizer"):
        optimizer = from_optax_state(_optimizer_fields(blob["optimizer"]), **layout)
        n = torch.tensor(optimizer["count"], dtype=torch.int64)
        for key in list(state_dict):
            if key.endswith(".running_mean"):
                state_dict[key[: -len("running_mean")] + "num_batches_tracked"] = n.clone()
    return state_dict, optimizer, int(blob["epoch"]), float(blob["best_acc"])


def restore_reference_checkpoint(state, path, *, cfg):
    """Load the container at ``path`` into ``state``
    (:class:`posetpu_torch.train.state.TrainState` of a network built from
    ``cfg.model``) in place: parameters and statistics, the RMSprop moments
    and update count when the container holds them, and ``state.step`` =
    the update count.  Returns (epoch, best_acc)."""
    m = cfg.model
    sd, opt, epoch, best_acc = load_reference_checkpoint(
        path, num_stacks=m.stacks, num_blocks=m.blocks, depth=m.depth,
        scan_stacks=m.scan_stacks)
    state.model.load_state_dict(sd)
    if opt is not None:
        state.optimizer.load_carried(state.model, opt)
        state.step = opt["count"]
    return epoch, best_acc


def _keystr(field, path=()):
    return f".{field}" + "".join(f"['{p}']" for p in path)


def save_reference_checkpoint(path, state, epoch, best_acc, *, cfg):
    """Write ``state`` (a :class:`posetpu_torch.train.state.TrainState` of
    a network built from ``cfg.model``) as the JAX package's container, which
    its ``load_torch_checkpoint`` reads into flax templates.  The optimizer
    state is written under the keys of the optax chain that
    ``cfg.optim`` builds there: ``add_decayed_weights`` first when
    ``weight_decay`` is set, then rmsprop's ``nu``, the schedule's
    ``count`` and, with momentum, ``trace``."""
    m, o = cfg.model, cfg.optim
    layout = dict(num_stacks=m.stacks, num_blocks=m.blocks, depth=m.depth,
                  scan_stacks=m.scan_stacks)
    params, stats = to_flax_variables(state.model.state_dict(), **layout)
    chain = "[1]" if o.weight_decay else ""
    fields = [("nu", 0)] + ([("trace", 2)] if o.momentum else [])
    named = dict(state.model.named_parameters())
    opt = state.optimizer
    blob = {f"{chain}[1]{_keystr('count')}": np.asarray(opt.count, np.int32)}
    for field, index in fields:
        # a moment no update has made yet is zero, as optax's init
        moment = {n: opt.state[p][field] if field in opt.state[p] else torch.zeros_like(p)
                  for n, p in named.items()}
        tree, _ = to_flax_variables(moment, **layout)
        for leaf_path, arr in _flatten(tree).items():
            blob[f"{chain}[{index}]{_keystr(field, leaf_path.split('/'))}"] = arr
    torch.save({"epoch": int(epoch), "state_dict": _to_container(params, stats),
                "optimizer": blob, "best_acc": float(best_acc)}, path)
