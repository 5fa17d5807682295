"""Checkpoints of a training run — the counterpart of
``posetpu/ckpt/orbax_io.py`` (``CheckpointManager``).

Layout, as the JAX package's::

  <dir>/ckpt/<epoch:05d>/state.pt   one per saved epoch, the last 3 kept
  <dir>/best/state.pt               a copy of the best-so-far checkpoint

Each holds the train state (:class:`posetpu_torch.train.state.TrainState`
or :class:`posetpu_torch.train.adversarial.JointState`), the epoch and the
best accuracy.  A train state is its model's ``state_dict`` (parameters and
BatchNorm statistics), its optimizer's ``state_dict`` (its moments),
and two counters that neither ``state_dict`` holds: the optimizer's update
count, which the learning-rate schedule reads, and ``step``, which keys the
augmentation draws.  Both are saved and restored, so a resumed run neither
restarts the schedule nor repeats the draws of step 0.

Writes go to a directory of the process's own and are moved into place
with ``os.replace``: a crash mid-save leaves the last good checkpoint
readable.  Loading the JAX package's orbax checkpoints is not covered here.

Under data parallelism every rank holds the same state: rank 0 alone
writes, and every rank of the group waits for it at a barrier, so a rank
that loads next reads a finished file.  Every rank loads.
"""

from __future__ import annotations

import os
import shutil

import torch

from posetpu_torch.parallel.dp import barrier, group_rank

_FILE = "state.pt"


def _train_state_dict(ts):
    return {
        "model": ts.model.state_dict(),
        "optimizer": ts.optimizer.state_dict(),
        "count": int(ts.optimizer.count),
        "step": int(ts.step),
    }


def state_dict(state):
    """A train or joint state -> nested dict of tensors and ints."""
    if hasattr(state, "pose"):  # JointState
        return {"pose": _train_state_dict(state.pose),
                "agent": _train_state_dict(state.agent),
                "step": int(state.step)}
    return _train_state_dict(state)


def _load_train_state(ts, sd):
    ts.model.load_state_dict(sd["model"])
    ts.optimizer.load_state_dict(sd["optimizer"])
    ts.optimizer.count = int(sd["count"])
    ts.step = int(sd["step"])


def load_state_dict(state, sd):
    """Restore ``sd`` (from :func:`state_dict`) into ``state`` in place."""
    if hasattr(state, "pose"):
        if "pose" not in sd:
            raise KeyError("a joint state needs a joint checkpoint")
        _load_train_state(state.pose, sd["pose"])
        _load_train_state(state.agent, sd["agent"])
        state.step = int(sd["step"])
    else:
        if "pose" in sd:
            raise KeyError("a plain train state cannot restore a joint checkpoint")
        _load_train_state(state, sd)
    return state


def _write(payload, final):
    """``torch.save`` into a directory of this process's own, then move it
    to ``final`` (replacing what was there)."""
    parent = os.path.dirname(final)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{os.path.basename(final)}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, _FILE))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


class CheckpointManager:
    """Save and restore with the reference's ``checkpoint`` +
    ``model_best`` behaviour.  With a data-parallel ``group`` only its
    rank 0 writes (the directory too); :meth:`save` ends at a barrier."""

    def __init__(self, directory, max_to_keep=3, group=None):
        self.directory = os.path.abspath(directory)
        self.group = group
        self.writes = group_rank(group) == 0
        if self.writes:
            os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, epoch):
        return os.path.join(self.directory, "ckpt", f"{epoch:05d}")

    @property
    def best_path(self):
        return os.path.join(self.directory, "best")

    def save(self, state, epoch, best_acc, is_best=False):
        """Write epoch ``epoch``'s checkpoint, copy it to ``best/`` when
        ``is_best``, and keep the newest ``max_to_keep`` (never the one just
        written).  Under a group, rank 0 writes and every rank returns once
        it has."""
        path = self._path(epoch)
        if self.writes:
            payload = {"state": state_dict(state), "epoch": int(epoch),
                       "best_acc": float(best_acc)}
            _write(payload, path)
            if is_best:
                _write(payload, self.best_path)
            self._gc(keep=os.path.basename(path))
        barrier(self.group)
        return path

    def _finished(self, root):
        return sorted(n for n in os.listdir(root) if not n.startswith("."))

    def _gc(self, keep=None):
        root = os.path.join(self.directory, "ckpt")
        if not os.path.isdir(root):
            return
        for name in self._finished(root)[: -self.max_to_keep]:
            if name != keep:
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)

    def latest_path(self):
        root = os.path.join(self.directory, "ckpt")
        if not os.path.isdir(root):
            return None
        done = self._finished(root)
        return os.path.join(root, done[-1]) if done else None

    def load(self, path=None):
        """The raw payload ``{"state", "epoch", "best_acc"}`` of ``path``
        (default: the latest checkpoint), on the CPU."""
        path = path or self.latest_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(os.path.join(path, _FILE), map_location="cpu",
                          weights_only=True)

    def restore(self, state, path=None):
        """Restore ``path`` (default: the latest) into ``state`` in place:
        parameters, statistics, optimizer moments, update counts and steps.
        Returns (state, epoch, best_acc)."""
        payload = self.load(path)
        load_state_dict(state, payload["state"])
        return state, int(payload["epoch"]), float(payload["best_acc"])
