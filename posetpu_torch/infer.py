"""Inference / serving API — counterpart of ``posetpu/infer.py``.

One forward per batch: neutral crop warp -> mean subtraction -> hourglass
-> argmax decode with the quarter-pixel offset -> inverse affine.  Inputs
follow the loader's batch contract: uint8 images zero-padded to a common
shape plus each sample's true (w, h), center and scale, so a serving front
end only decodes JPEGs.

Usage:
    from posetpu_torch.configs import named_config
    from posetpu_torch.infer import PosePredictor
    p = PosePredictor.from_config(named_config("hg8_mpii"), "checkpoints/hg8_mpii")
    out = p(images_u8, valid_wh, centers, scales)
    out["pred"]   # (B, K, 2) keypoints in source-image coords (1-indexed)
    out["conf"]   # (B, K) peak heatmap activation per joint

``from_config`` reads a run directory of the port's train command (its
``best/`` or its latest ``ckpt/<epoch>``), one checkpoint directory, or a
state dict.  The JAX package's checkpoints come over through its torch
container (:func:`posetpu_torch.ckpt.torch_export.load_reference_checkpoint`)
or from restored flax variables
(:func:`posetpu_torch.ckpt.from_flax_variables`), either of which gives the
state dict taken here.
"""

from __future__ import annotations

import os
from collections import deque
from collections.abc import Mapping

import numpy as np
import torch

from posetpu_torch.aug.affine import make_transform
from posetpu_torch.aug.color import color_normalize
from posetpu_torch.aug.warp import affine_warp
from posetpu_torch.ckpt.manager import CheckpointManager
from posetpu_torch.eval.decode import final_preds, get_preds, quarter_offset
from posetpu_torch.models import hg
from posetpu_torch.utils import profiling
from posetpu_torch.utils.device import resolve_device
from posetpu_torch.utils.graphs import ShapeGraphs

# The reference normalizes by the dataset mean; MPII's is the default when
# serving without the training dataset on disk.
MPII_MEAN = (0.4404, 0.4440, 0.4327)


def load_checkpoint_model(checkpoint, *, best=True):
    """The pose network's state dict from a checkpoint of the port's train
    command, by the JAX package's rules (``posetpu/infer.py``):
    ``checkpoint`` is a run directory, whose ``best/`` is read when ``best``
    is set and it exists, or when it is the only layout there; else its
    latest finished ``ckpt/<epoch>`` (:class:`CheckpointManager
    <posetpu_torch.ckpt.manager.CheckpointManager>`); or one checkpoint
    directory itself.  A joint checkpoint gives its pose network."""
    if not os.path.isdir(checkpoint):
        raise FileNotFoundError(f"no checkpoint directory at {checkpoint}")
    manager = CheckpointManager(checkpoint)
    has_best = os.path.isdir(manager.best_path)
    has_ckpt = os.path.isdir(os.path.join(checkpoint, "ckpt"))
    path = checkpoint
    if has_best and (best or not has_ckpt):
        path = manager.best_path
    elif has_ckpt:
        path = manager.latest_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint}")
    state = manager.load(path)["state"]
    return state.get("pose", state)["model"]


class PosePredictor:
    """Fixed-shape pose inference on one device.

    On CUDA every input signature (B, Hp, Wp) is served by one CUDA graph
    of :meth:`_forward`, captured at its first batch and replayed after —
    the counterpart of the JAX package's ``jax.jit(self._forward)`` and its
    per-shape cache (:class:`posetpu_torch.utils.graphs.ShapeGraphs`,
    whose docstring holds the rules).  A batch is copied into the graph's
    static buffers through pinned staging buffers without blocking, and
    each replay's outputs are copied without blocking into pinned host
    buffers of their own before the next replay can write them, so the
    host only waits where it reads a result.  The graphs of all shapes
    share one memory pool: the forward's temporaries and outputs at the
    largest shape served.  ``predict_single`` pads to multiples of 64, so
    each image size it meets captures a graph of batch 1.  After the
    weights' storage moves (a ``.to()``, a replaced parameter), the graphs
    are captured again; ``load_state_dict`` copies in place and keeps them.
    ``graphs.captures``, ``graphs.pool_bytes`` and
    ``graphs.capture_seconds`` report the captures.  On the CPU every call
    runs :meth:`_forward` eagerly.  Each batch's spans
    (:mod:`posetpu_torch.utils.profiling`), ``serve.stage``,
    ``serve.replay`` and ``serve.fetch`` (the wait for its results on the
    host), share the unit ("serve", its sequence number).
    """

    def __init__(
        self,
        model,
        *,
        mean=MPII_MEAN,
        std=None,
        inp_res=(256, 256),
        out_res=(64, 64),
        device="cuda",
    ):
        """``mean``/``std`` must match what training normalized with
        (MPII_MEAN for MPII-trained weights)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mean = tuple(mean)
        self.std = std
        self.inp_res = tuple(inp_res)
        self.out_res = tuple(out_res)
        # normalization constants live on the device: a host copy made
        # inside the forward would sync the stream and stall the batches
        # in flight
        self._mean_t = torch.tensor(self.mean, device=self.device)
        self._std_t = None if std is None else torch.tensor(std, device=self.device)
        self.graphs = None
        if self.device.type == "cuda":
            self.graphs = ShapeGraphs(
                self._graph_body,
                lambda: (self.model,),
                self.device,
                name="serve",
            )
        self._seq = 0  # batches launched

    @classmethod
    def from_config(cls, cfg, checkpoint, *, best=True, mean=MPII_MEAN, device="cuda"):
        """Build from an ExperimentConfig and ``checkpoint``: a state dict of
        :class:`posetpu_torch.models.HourglassNet`, or a path
        (:func:`load_checkpoint_model`, with ``best``).  The network is
        built from ``cfg.model``, ``blocks`` and ``scan_stacks`` included
        (the checkpoint's layout); remat does not matter in eval."""
        device = resolve_device(device)
        model = hg(
            num_stacks=cfg.model.stacks,
            num_blocks=cfg.model.blocks,
            num_classes=cfg.model.classes,
            num_feats=cfg.model.feats,
            depth=cfg.model.depth,
            dtype=torch.bfloat16 if cfg.model.bf16 else torch.float32,
            scan_stacks=cfg.model.scan_stacks,
        )
        if not isinstance(checkpoint, Mapping):
            checkpoint = load_checkpoint_model(checkpoint, best=best)
        model.load_state_dict(checkpoint)
        return cls(
            model,
            mean=mean,
            inp_res=tuple(cfg.aug.inp_res),
            out_res=tuple(cfg.aug.out_res),
            device=device,
        )

    def _forward(self, images, valid_wh, center, scale):
        B = images.shape[0]
        t = make_transform(
            center, scale, self.inp_res,
            torch.zeros((B,), dtype=torch.float32, device=self.device),
        )
        crop = affine_warp(images, t, self.inp_res, valid_wh=valid_wh)
        crop = color_normalize(crop, self._mean_t, self._std_t)
        scores = self.model(crop)[-1].float()
        pred = final_preds(scores, center, scale, self.out_res)
        conf = torch.amax(scores.reshape(B, scores.shape[1], -1), dim=-1)
        # heatmap-space coords too (visualization / custom post-processing)
        hm = quarter_offset(get_preds(scores), scores)
        return {"pred": pred, "conf": conf, "heatmap_coords": hm}

    def _graph_body(self, b):
        with torch.no_grad():
            return self._forward(b["images"], b["valid_wh"], b["center"], b["scale"])

    def _launch(self, images, valid_wh, center, scale):
        """Enqueue one batch; returns its pending result."""
        seq, self._seq = self._seq, self._seq + 1
        batch = {
            "images": torch.as_tensor(np.asarray(images)),
            "valid_wh": torch.as_tensor(np.asarray(valid_wh), dtype=torch.int32),
            "center": torch.as_tensor(np.asarray(center), dtype=torch.float32),
            "scale": torch.as_tensor(np.asarray(scale), dtype=torch.float32),
        }
        if self.device.type != "cuda":
            return self._graph_body(batch), None, seq
        # the replay's static outputs, copied out before the next replay
        out = self.graphs(batch, unit=("serve", seq))
        host = {
            k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(
                v, non_blocking=True
            )
            for k, v in out.items()
        }
        done = torch.cuda.Event()
        done.record()
        return host, done, seq

    @staticmethod
    def _fetch(pending):
        host, done, seq = pending
        with profiling.span("serve.fetch", ("serve", seq)):
            if done is not None:
                done.synchronize()
            return {k: v.numpy() for k, v in host.items()}

    def __call__(self, images, valid_wh, center, scale):
        """images (B, Hp, Wp, 3) uint8 zero-padded; valid_wh (B, 2) int;
        center (B, 2); scale (B,).  Returns numpy arrays."""
        return self._fetch(self._launch(images, valid_wh, center, scale))

    def predict_iter(self, batches, depth=2):
        """Pipelined prediction: keep up to ``depth`` batches in flight
        before waiting for the oldest, so the host's staging and enqueueing
        of later batches overlaps the device's work on earlier ones.  Same
        numerics and order as per-batch calls; ``depth=0`` is sequential.

        ``batches`` yields ``(images, valid_wh, center, scale)`` tuples with
        the ``__call__`` contract; yields the ``__call__`` result dicts."""
        inflight = deque()
        for images, valid_wh, center, scale in batches:
            inflight.append(self._launch(images, valid_wh, center, scale))
            if len(inflight) > depth:
                yield self._fetch(inflight.popleft())
        while inflight:
            yield self._fetch(inflight.popleft())

    def predict_single(self, image, center, scale):
        """One image (H, W, 3) uint8 -> (K, 2) keypoints and (K,)
        confidences.  Pads to the image's shape rounded up to a multiple of
        64."""
        image = np.asarray(image)
        H, W = image.shape[:2]
        Hp = -(-H // 64) * 64
        Wp = -(-W // 64) * 64
        padded = np.zeros((1, Hp, Wp, 3), image.dtype)
        padded[0, :H, :W] = image
        out = self(
            padded,
            np.array([[W, H]], np.int32),
            np.asarray([center], np.float32),
            np.asarray([scale], np.float32),
        )
        return out["pred"][0], out["conf"][0]
