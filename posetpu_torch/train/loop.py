"""Experiment driver — the counterpart of ``posetpu/train/loop.py``
(``build_dataset``, ``Experiment``), on one device or as one rank of a
data-parallel run.

It builds the data, the network (and the agent), the optimizers and the
steps from an ExperimentConfig, then runs epochs of train and validate,
logs the reference's txt columns (and, with ``cfg.tensorboard``, the
reference's TensorBoard scalars), checkpoints (best on validation
improvement), resumes, and writes the validation predictions
(``preds.mat``).  ``cfg.loader_backend`` picks the loader ("host":
:class:`HostLoader`, which decodes on the card on CUDA; "grain":
:class:`WorkerLoader`, Pillow in ``cfg.loader_workers`` processes).  The
train step, pose-only or joint (with the agent), runs ``cfg.steps_per_dispatch`` = K steps a dispatch
(:func:`posetpu_torch.train.step.make_dispatch_step`,
:func:`posetpu_torch.train.adversarial.make_joint_dispatch_step`), on CUDA
as one CUDA graph, K = 1 included; the validation step
(:func:`posetpu_torch.train.step.make_graphed_eval_step`) as one CUDA graph
per batch signature.

Data parallelism: ``Experiment(cfg, rank=r, world=W)`` is rank r of W
processes already joined in the default process group
(:func:`posetpu_torch.parallel.init_process_group`; the train command line
starts them).  ``cfg.batch_size`` is the global batch, which W must
divide.  Each rank's loaders decode its rows of every global batch, its
networks take their BatchNorm statistics across the ranks, and its steps
reduce gradients and metrics over them; so the run computes what one
process computes at the global batch.  Rank 0 alone writes the run
directory (``config.json``, ``log.txt``, TensorBoard, checkpoints,
``preds.mat``); every rank loads.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn as nn

from posetpu_torch.ckpt.manager import CheckpointManager
from posetpu_torch.data.datasets import LspDataset, MpiiDataset
from posetpu_torch.data.loader import HostLoader, make_batch_placer
from posetpu_torch.data.synthetic import make_synthetic_dataset
from posetpu_torch.data.worker_loader import WorkerLoader
from posetpu_torch.eval.decode import pck_from_counts
from posetpu_torch.eval.export import save_preds
from posetpu_torch.models import hg
from posetpu_torch.models.batchnorm import convert_cross_replica_
from posetpu_torch.parallel.dp import (
    barrier,
    broadcast_state_,
    check_batch,
    gather_rows,
    resolve_num_devices,
)
from posetpu_torch.train.adversarial import (
    JointState,
    agent_from_config,
    make_joint_dispatch_step,
)
from posetpu_torch.train.state import TrainState, make_optimizer
from posetpu_torch.train.step import make_dispatch_step, make_graphed_eval_step
from posetpu_torch.utils.device import resolve_device
from posetpu_torch.utils.logger import AverageMeter, Logger

SYNTH_TRAIN, SYNTH_VAL = 64, 16


def build_dataset(cfg, split="train"):
    """The config's dataset split.  With ``cfg.synthetic`` and no
    annotations, a synthetic mini-split (64 train, 16 validation images) is
    made once in the temp directory, keyed by dataset and seed, and
    ``cfg.annotations``/``cfg.images_dir`` point at it."""
    if cfg.synthetic and not cfg.annotations:
        # the port's own name: the JAX package keeps its own cache, which
        # the two packages could otherwise write differently
        root = os.path.join(
            tempfile.gettempdir(), f"posetpu_torch_synth_{cfg.aug.dataset}_s{cfg.seed}"
        )
        json_path = os.path.join(root, "annotations.json")
        if not os.path.exists(json_path):
            # made aside and moved into place whole: processes that start
            # at once never read a half-written split
            tmp = f"{root}.{os.getpid()}.tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            make_synthetic_dataset(tmp, num_train=SYNTH_TRAIN, num_val=SYNTH_VAL,
                                   dataset=cfg.aug.dataset, seed=cfg.seed)
            try:
                os.rename(tmp, root)
            except OSError:  # another process moved its copy first
                shutil.rmtree(tmp, ignore_errors=True)
        cfg.annotations = json_path
        cfg.images_dir = os.path.join(root, "images")
    cls = LspDataset if cfg.aug.dataset == "lsp" else MpiiDataset
    return cls(cfg.annotations, cfg.images_dir, split=split)


# the standard deviation of a unit normal truncated to [-2, 2], by which
# jax.nn.initializers.variance_scaling divides its std
_TRUNC_STD = 0.87962566103423978


def seeded_init_(module, seed):
    """Draw every conv and linear layer's weights afresh from an explicit
    ``torch.Generator`` seeded with ``seed``, by flax's default rule
    (``jax.nn.initializers.lecun_normal()``: a normal of variance
    1/fan_in truncated at two standard deviations, its std divided by
    ``_TRUNC_STD`` so the cut keeps the variance), in module order.
    ``fan_in`` is in_channels/groups * kh * kw for a conv and in_features
    for a linear layer.  Every bias is zero; BatchNorm keeps its unit scale
    and zero shift."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
    return module


def loader_class(cfg, device):
    """(loader class, its extra arguments) for ``cfg.loader_backend``: the
    reference's values, "host" or "grain".  The host loader decodes on
    ``device`` (the card's route on CUDA); the worker loader's processes use Pillow."""
    if cfg.loader_backend == "grain":
        return WorkerLoader, {"num_workers": cfg.loader_workers}
    if cfg.loader_backend == "host":
        return HostLoader, {"device": device}
    raise ValueError(f"unknown loader_backend {cfg.loader_backend!r} "
                     "(expected 'host' or 'grain')")


def _process_group(rank, world):
    """The default group for rank ``rank`` of ``world`` (None for one
    process), checked against the group this process joined."""
    if world == 1:
        return None
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(f"rank {rank} of {world}: join the process group first "
                           "(posetpu_torch.parallel.init_process_group)")
    if (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise ValueError(f"rank {rank} of {world}, but this process is rank "
                         f"{dist.get_rank()} of {dist.get_world_size()}")
    return dist.group.WORLD


class Experiment:
    """Everything needed to run or resume one config on one device, or
    as one rank of a data-parallel run."""

    def __init__(self, cfg, eval_only=False, device="cuda", rank=0, world=1):
        """``eval_only``: built for offline evaluation; the run directory's
        files are not changed (log.txt opens in resume mode, config.json is
        not rewritten).  ``device`` defaults to CUDA and raises without it
        unless ``"cpu"``; a rank passes its own (``cuda:<local rank>``).
        ``rank``/``world``: this process's place in the default process
        group (module docstring).  ``cfg.num_devices``, when set, must be
        ``world``, and no more than the visible devices."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.eval_only = eval_only
        if cfg.num_devices is not None:
            n_dev = resolve_num_devices(cfg.num_devices, self.device.type)
            if n_dev != world:
                raise ValueError(
                    f"config requests num_devices={n_dev}, but this process is "
                    f"rank {rank} of {world}: start the ranks with "
                    f"posetpu-torch-train --num-devices {n_dev}")
        check_batch(cfg.batch_size, world)
        self.rank, self.world = rank, world
        self.group = _process_group(rank, world)
        self.is_main = rank == 0
        self.K = max(1, int(cfg.steps_per_dispatch))
        loader_cls, loader_kw = loader_class(cfg, self.device)
        if self.group is not None:
            loader_kw["shard"] = (rank, world)
        self.train_ds = build_dataset(cfg, "train")
        self.val_ds = build_dataset(cfg, "valid")
        self.mean, self.std = self.train_ds.mean_std()
        self.std = None  # the reference normalizes by mean subtraction only
        self._check_pad_hw()

        self.loader = loader_cls(
            self.train_ds, cfg.batch_size, pad_hw=tuple(cfg.pad_hw), seed=cfg.seed,
            # decode while the previous step runs, on the card into a tensor
            # there (the card's decode route), else into pinned memory copied on a stream of
            # its own; K batches a superbatch per dispatch
            place=make_batch_placer(self.device), group=self.K, **loader_kw,
        )
        # validation batches stay on the host until the eval step copies
        # them; the loader pads the ragged last batch to the global batch
        # (before it takes the rank's rows) and gives each batch its mask
        self.val_loader = loader_cls(
            self.val_ds, cfg.batch_size, pad_hw=tuple(cfg.pad_hw), shuffle=False,
            drop_last=False, pad=True, **loader_kw,
        )
        self.steps_per_epoch = cfg.steps_per_epoch or len(self.loader)

        m = cfg.model
        self.model = seeded_init_(
            hg(num_stacks=m.stacks, num_blocks=m.blocks, num_classes=m.classes,
               num_feats=m.feats, depth=m.depth,
               dtype=torch.bfloat16 if m.bf16 else torch.float32,
               # the scanned layout implies remat, as in the reference
               remat=m.remat or m.scan_stacks, scan_stacks=m.scan_stacks),
            cfg.seed,
        )
        # every rank draws the same weights; the broadcast makes it so
        broadcast_state_(convert_cross_replica_(self.model.to(self.device), self.group),
                         self.group)
        opt = make_optimizer(self.model.parameters(), cfg.optim, self.steps_per_epoch)
        pose_state = TrainState(self.model, opt)
        if cfg.agent.enabled:
            agent, agent_opt, joint_kw = agent_from_config(
                cfg, steps_per_epoch=self.steps_per_epoch, device="cpu"
            )
            seeded_init_(agent, cfg.seed + 1)
            broadcast_state_(convert_cross_replica_(agent.to(self.device), self.group),
                             self.group)
            self.state = JointState(pose_state, TrainState(agent, agent_opt))
            self.train_step = make_joint_dispatch_step(
                self.model, agent, opt, agent_opt, cfg.aug, self.mean, self.std,
                seed=cfg.seed, steps=self.K, group=self.group, device=self.device,
                **joint_kw,
            )
        else:
            self.state = pose_state
            self.train_step = make_dispatch_step(
                self.model, opt, cfg.aug, self.mean, self.std, seed=cfg.seed,
                steps=self.K, group=self.group, device=self.device,
            )
        # on CUDA one CUDA graph per batch signature (the padded batches
        # of the validation loader share one)
        self.eval_step = make_graphed_eval_step(self.model, cfg.aug, self.mean, self.std,
                                                group=self.group, device=self.device)

        run_dir = os.path.join(cfg.checkpoint_dir, cfg.name)
        self.ckpt = CheckpointManager(run_dir, group=self.group)
        self.logger = None
        self.tb = None
        if self.is_main:
            self._open_run_dir(run_dir)
        barrier(self.group)
        self.start_epoch = 0
        self.best_acc = 0.0
        if cfg.init_pose_from:
            self._init_pose_from(cfg.init_pose_from)
        if cfg.resume:
            self._resume(cfg.resume)

    def _open_run_dir(self, run_dir):
        """The log, ``config.json`` and TensorBoard writer (rank 0)."""
        cfg, eval_only = self.cfg, self.eval_only
        self.logger = Logger(os.path.join(run_dir, "log.txt"),
                             resume=bool(cfg.resume) or eval_only)
        self.logger.set_names(Logger.DEFAULT_NAMES)
        if not eval_only:
            # reproducibility: the exact resolved config next to the log
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
        if cfg.tensorboard and not eval_only:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError("--tensorboard writes through "
                                  "torch.utils.tensorboard, which needs the "
                                  "tensorboard package; it is not installed") from e
            self.tb = SummaryWriter(os.path.join(run_dir, "tb"))

    def close(self):
        """Close the log file and the TensorBoard writer."""
        if self.logger is not None:
            self.logger.close()
        if self.tb is not None:
            self.tb.close()

    def _worst_case_box(self):
        """Side of the largest person's worst-case crop-source footprint:
        200*scale box x the largest aug scale-up (the sampler clips exp mode
        at 2^(2*scale_factor)) x the rotation bounding-box expansion
        (|cos|+|sin| over the clipped rotation range, <= sqrt(2)).  One pass
        over the annotation scales, no decode.  0.0 without metadata."""
        cfg = self.cfg
        try:
            max_scale = max(
                (self.train_ds.meta(i)[1] for i in range(len(self.train_ds))),
                default=0.0,
            )
        except Exception:
            return 0.0
        aug_up = (
            2.0 ** (2 * cfg.aug.scale_factor)
            if cfg.aug.scale_mode == "exp"
            else 1.0 + cfg.aug.scale_factor
        )
        rot_max = 2.0 * cfg.aug.rot_factor if cfg.aug.rot_prob > 0 else 0.0
        theta = math.radians(min(abs(rot_max), 45.0))
        rot_expand = math.cos(theta) + math.sin(theta)
        return 200.0 * max_scale * aug_up * rot_expand

    def _check_pad_hw(self):
        """Resolve or check the pre-pad host window.  ``cfg.pad_hw=None``
        auto-sizes it to the worst-case box (:meth:`_worst_case_box`), capped
        per axis at the largest image (the device warp reads zero beyond
        ``valid_wh``), rounded up to a multiple of 64, at least 256; the
        value lands in config.json.  An explicit ``pad_hw`` is kept, with a
        warning when too small: such crops read zero padding where the
        reference's host crop reads real pixels."""
        cfg = self.cfg
        box = self._worst_case_box()
        if cfg.pad_hw is None:
            try:
                max_h, max_w = self.train_ds.max_image_hw()
            except Exception:
                max_h = max_w = 1 << 30
            side = int(box) if box else 512
            rnd = lambda v: max(256, -(-int(v) // 64) * 64)  # noqa: E731
            cfg.pad_hw = (rnd(min(side, max_h)), rnd(min(side, max_w)))
            return
        if box > min(cfg.pad_hw):
            warnings.warn(
                f"largest person's worst-case crop footprint (~{box:.0f}px, "
                f"incl. aug scale-up and rotation expansion) exceeds "
                f"pad_hw={tuple(cfg.pad_hw)}; such crops read zero padding "
                f"where the reference reads image pixels — raise pad_hw or "
                f"leave pad_hw=None to auto-size it from the dataset",
                stacklevel=2,
            )

    def _init_pose_from(self, path):
        """Load a baseline run's pose network (parameters and statistics;
        its ``best/`` checkpoint, else its latest) into this run's pose
        network.  The optimizer starts fresh, as the reference's does."""
        src = CheckpointManager(path, group=self.group)
        best = src.best_path
        sd = src.load(best if os.path.isdir(best) else None)["state"]
        self.model.load_state_dict(sd.get("pose", sd)["model"])

    def _resume(self, path):
        path = None if path == "auto" else path
        self.state, last_epoch, self.best_acc = self.ckpt.restore(self.state, path)
        # checkpoints record the last completed epoch; resume at the next.
        # The loader's epoch counter is not rewound, as the reference's is
        # not: a resumed run shuffles as epoch 0 did.  The draws continue
        # from the restored step.
        self.start_epoch = last_epoch + 1

    def snapshot(self):
        """A copy of everything a train epoch changes: the train state's
        (:meth:`TrainState.snapshot`, :meth:`JointState.snapshot`) and the
        loader's epoch."""
        return self.state.snapshot(), self.loader.epoch

    def restore(self, snap):
        """Put a :meth:`snapshot` back, the tensors *in place*."""
        state, epoch = snap
        self.state.restore_(state)
        self.loader.epoch = epoch

    # ---- epoch loops ----

    def train_epoch(self, epoch):
        """One epoch (at most ``steps_per_epoch`` steps).  Each loader item
        is a (k, B, ...) superbatch of k <= K steps, the last one trimmed
        where it would cross the cap, and its metrics come back as (k,)
        tensors.  Every step's metrics stay device tensors and are read
        once at the end: a read per step would wait for the device and
        stall the enqueue."""
        device_metrics = []
        t0 = time.time()
        seen = steps = 0
        for batch in self.loader:
            k = batch["index"].shape[0]
            if steps + k > self.steps_per_epoch:
                k = self.steps_per_epoch - steps
                batch = {n: v[:k] for n, v in batch.items()}
            device_metrics.append(self.train_step(self.state, batch))
            seen += k * batch["index"].shape[-1] * self.world
            steps += k
            if steps >= self.steps_per_epoch:
                break
        out = {}
        if device_metrics:
            # one read of every metric: also the honest end-of-epoch barrier
            stacked = {k: torch.cat([m[k].float().reshape(-1) for m in device_metrics]).cpu()
                       for k in device_metrics[0]}
            for k, v in stacked.items():
                meter = AverageMeter()
                for x in v.tolist():
                    meter.update(x)
                out[k] = meter.avg
        dt = time.time() - t0
        out["images_per_sec"] = seen / dt if dt > 0 else 0.0
        out["steps"] = steps
        return out

    @torch.no_grad()
    def validate(self, epoch):
        """Loss and acc over the validation split, every batch padded to
        the batch size (one shape: on CUDA, one graph), PCK from the
        split's global hit/count sums (returned too, as ``pck_hit`` and
        ``pck_cnt``), predictions trimmed to the real rows.  Under data
        parallelism the metrics are global already and each batch's
        predictions and mask are gathered from the ranks in global order,
        so every rank returns the whole split's."""
        sums, preds, masks, hits, cnts = {}, [], [], [], []
        for batch in self.val_loader:
            metrics, p = self.eval_step(batch)
            mask = torch.as_tensor(batch["mask"], device=p.device)
            p, mask = gather_rows(p, self.group), gather_rows(mask, self.group)
            hits.append(metrics["pck_hit"])
            cnts.append(metrics["pck_cnt"])
            for k, v in metrics.items():
                if k not in ("pck_hit", "pck_cnt"):
                    sums.setdefault(k, []).append(v)
            preds.append(p)
            masks.append(mask)
        out = {}
        ns = torch.stack([m.sum() for m in masks]).cpu().tolist() if masks else []
        for k, vs in sums.items():
            vals = torch.stack([v.float() for v in vs]).cpu().tolist()
            meter = AverageMeter()
            for x, n in zip(vals, ns):
                meter.update(x, n=int(n))
            out[k] = meter.avg
        if cnts:
            hit = torch.stack(hits).double().sum(0).cpu()
            cnt = torch.stack(cnts).double().sum(0).cpu()
            out["acc"] = float(pck_from_counts(hit, cnt)[0])
            out["pck_hit"], out["pck_cnt"] = hit.numpy(), cnt.numpy()
        if preds:
            real = torch.cat(masks).cpu() > 0  # padding trails each batch
            preds = torch.cat(preds).cpu()[real].numpy()
        else:
            preds = np.zeros((0, 0, 2), np.float32)
        return out, preds

    def current_lr(self, epoch):
        lr = self.cfg.optim.lr
        for e in self.cfg.optim.schedule:
            if epoch >= e:
                lr *= self.cfg.optim.gamma
        return lr

    def fit(self, progress=print):
        """Train from ``start_epoch`` to ``optim.epochs``: validate every
        ``eval_every`` epochs and on the last; log a row; checkpoint, to
        ``best/`` on improvement; ``preds.mat`` with the best predictions.
        Returns (state, best_acc)."""
        cfg = self.cfg
        run_dir = os.path.join(cfg.checkpoint_dir, cfg.name)
        for epoch in range(self.start_epoch, cfg.optim.epochs):
            tr = self.train_epoch(epoch)
            if (epoch + 1) % cfg.eval_every == 0 or epoch == cfg.optim.epochs - 1:
                va, preds = self.validate(epoch)
            else:
                va, preds = {"loss": float("nan"), "acc": 0.0}, None
            is_best = va["acc"] > self.best_acc
            self.best_acc = max(self.best_acc, va["acc"])
            self.ckpt.save(self.state, epoch, self.best_acc, is_best=is_best)
            if not self.is_main:
                continue
            self.logger.append([epoch, self.current_lr(epoch), tr["loss"], va["loss"],
                                tr["acc"], va["acc"]])
            if self.tb is not None:
                self._write_scalars(epoch, tr, va if preds is not None else None)
            if is_best and preds is not None:
                save_preds(preds, os.path.join(run_dir, "preds.mat"))
            progress(
                f"epoch {epoch}: train loss {tr['loss']:.5f} acc {tr['acc']:.3f} "
                f"| val loss {va['loss']:.5f} acc {va['acc']:.3f} "
                f"| {tr['images_per_sec']:.1f} img/s"
                + (f" | agent {tr['agent_loss']:+.4f}" if "agent_loss" in tr else "")
            )
        barrier(self.group)  # rank 0's last log row and preds are written
        if not self.is_main:
            return self.state, self.best_acc
        # the reference leaves curve plots next to log.txt
        try:
            self.logger.plot()
        except Exception as e:  # plotting must never kill a finished run
            progress(f"[posetpu_torch] log plot failed: {e}")
        if self.tb is not None:
            self.tb.flush()
        return self.state, self.best_acc

    def _write_scalars(self, epoch, tr, va):
        """The reference's TensorBoard scalars of one epoch, at step
        ``epoch``; ``va`` None when no validation ran."""
        scalars = {"train/loss": tr["loss"], "train/acc": tr["acc"],
                   "train/images_per_sec": tr["images_per_sec"],
                   "lr": self.current_lr(epoch)}
        for k in ("agent_loss", "advantage", "entropy"):
            if k in tr:
                scalars[f"train/{k}"] = tr[k]
        if va is not None:
            scalars["val/loss"] = va["loss"]
            scalars["val/acc"] = va["acc"]
        for name, v in scalars.items():
            self.tb.add_scalar(name, v, epoch)
