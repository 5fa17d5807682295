"""Loss, train step and validation step — counterpart of
``posetpu/train/step.py`` (``stacked_mse``, ``per_sample_stacked_mse``,
``make_train_step``, ``make_eval_step``).

The port's network returns (B, K, H, W) heatmaps, so the losses take
targets in that layout (the reference's take NHWC).

:func:`make_dispatch_step` is the counterpart of ``fuse_steps``: K train
steps in one dispatch, on CUDA as one captured ``torch.cuda.CUDAGraph``
(the joint step's counterpart,
:func:`posetpu_torch.train.adversarial.make_joint_dispatch_step`, runs on
the same :class:`GraphedSteps`).
Its body (:func:`make_train_body`) is ``make_train_step``'s math with the
train step's ``step`` and the optimizer's update ``count`` held in device
tensors (:class:`DeviceCounters`), since a capture would bake Python values
in.  The rules of the graph:

- the Python ints in ``TrainState.step`` and ``OptaxRMSprop.count`` stay
  the record (checkpoints save them); the device counters are set from
  them before every dispatch and advance inside the graph, and the host
  advances the ints by K after each replay, without a sync;
- a step whose work depends on the step count (the joint step updates its
  agent every ``update_every`` steps) takes that branch as a Python bool:
  the host reads the K steps' flags from its own int before the dispatch
  and replays the graph captured for that pattern (:class:`GraphedSteps`);
- the capture is made at the first full dispatch, after any state load
  (``--resume``, ``--init-pose-from``), and again whenever a parameter,
  buffer or moment tensor has moved or been replaced since
  (``load_state_dict`` of an optimizer replaces its moments); the check
  is :class:`posetpu_torch.utils.graphs.GraphCache`'s, which walks the
  state's modules and optimizers (its ``holders()``) only when they may
  hold other tensors than at its last walk;
- the side-stream warm-up before a capture applies real updates, so the
  parameters, buffers and moments are saved first and put back *in place*
  after it (:meth:`TrainState.snapshot
  <posetpu_torch.train.state.TrainState.snapshot>`, ``restore_``; the
  graph holds their addresses); its kernel launches ran and count, while
  the capture's count once per replay;
- anything that loads state into a captured step's tensors loads it in
  place (``copy_``).

Data parallelism (the reference's ``axis_name``): every step takes
``group``, a ``torch.distributed`` process group whose ranks each hold
their slice of the global batch (:mod:`posetpu_torch.parallel`).  The train
math averages the gradients over the ranks in one flat bucket before the
update (``pmean``), averages the loss and sums the PCK hits and counts
before their ratio; the eval step sums its masked sums and counts.  The
collectives are plain calls, so the graphed step captures them: under NCCL
the all-reduce runs inside the CUDA graph.  A gloo collective cannot be
captured, so :func:`make_dispatch_step` on CUDA refuses a gloo group.
The models' BatchNorms take the same group
(:func:`posetpu_torch.models.batchnorm.convert_cross_replica_`).

A network built with ``remat`` recomputes its checkpointed forward in the
backward pass (:func:`posetpu_torch.models.batchnorm.remat`): the steps,
eager or graphed, are the same calls; the recompute runs under the
forward's autocast, leaves the norms' statistics alone and, with a group,
all-reduces each cross-replica norm's moments once more.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from posetpu_torch.aug.color import sample_jitter_scales
from posetpu_torch.aug.pipeline import (
    augment_batch,
    neutral_params,
    sample_aug_params_ps,
)
from posetpu_torch.eval.decode import final_preds, pck_counts, pck_from_counts
from posetpu_torch.parallel.dp import is_gloo, mean_grads_, reduce_metrics
from posetpu_torch.utils import profiling
from posetpu_torch.utils.device import resolve_device
from posetpu_torch.utils.graphs import GraphCache, ShapeGraphs, record


def stacked_mse(outputs, target, weight=None):
    """Reference loss: MSE averaged over elements, summed over stacks.
    ``weight`` (B, K) optionally masks invisible joints."""
    loss = 0.0
    for o in outputs:
        err = (o.float() - target) ** 2
        if weight is not None:
            err = err * weight[:, :, None, None]
        loss = loss + err.mean()
    return loss


def per_sample_stacked_mse(outputs, target):
    """Reference loss per sample: MSE over elements summed over stacks,
    keeping the batch dim -> (B,)."""
    loss = 0.0
    for o in outputs:
        loss = loss + ((o.float() - target) ** 2).mean(dim=(1, 2, 3))
    return loss


def _to_device(batch, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _normalization(mean, std, dev):
    # normalization constants live on the device: a host copy made inside
    # the step would wait for the batches already queued
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=dev)
    std_t = None if std is None else torch.as_tensor(
        std, dtype=torch.float32, device=dev
    )
    return mean_t, std_t


def _train_math(model, optimizer, aug_cfg, mean, std, seed, mask_loss, dev, group,
                clip_norm=0.0):
    """``run(step, batch, update) -> metrics``: one train step's math with
    the draws keyed on ``step`` (an int or a 0-d device tensor) and
    ``update()`` applying the optimizer; with a ``group``, the gradients
    and metrics reduced over its ranks; with ``clip_norm``, the gradients
    clipped to that global L2 norm before the update, on the device
    without a sync (``clip_grad_norm_``'s foreach route).  A network that
    draws (``keyed``: ViTPose's drop path) takes ``keys=(seed, step,
    index)`` with its input."""
    model.to(dev)
    mean_t, std_t = _normalization(mean, std, dev)
    keyed = getattr(model, "keyed", False)

    def run(step, batch, update):
        b = _to_device(batch, dev)
        # module-level names: tests substitute the reference's draws
        params = sample_aug_params_ps(
            seed, step, b["index"],
            scale_factor=aug_cfg.scale_factor, rot_factor=aug_cfg.rot_factor,
            rot_prob=aug_cfg.rot_prob, flip_prob=aug_cfg.flip_prob,
            scale_mode=aug_cfg.scale_mode,
        )
        jitter = (sample_jitter_scales(seed, step, b["index"])
                  if aug_cfg.color_jitter else None)
        with torch.no_grad():
            aug = augment_batch(
                b["image"], b["valid_wh"], b["center"], b["scale"],
                b["pts"], b["vis"], params,
                inp_res=tuple(aug_cfg.inp_res), out_res=tuple(aug_cfg.out_res),
                sigma=aug_cfg.sigma, mean=mean_t, std=std_t,
                dataset=aug_cfg.dataset, jitter_scales=jitter, device=dev,
            )
        model.train()
        outs = (model(aug["input"], keys=(seed, step, b["index"])) if keyed
                else model(aug["input"]))
        loss = stacked_mse(
            outs, aug["target"], aug["target_weight"] if mask_loss else None
        )
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            mean_grads_(model.parameters(), group)
        if clip_norm:
            torch.nn.utils.clip_grad_norm_(model.parameters(), clip_norm, foreach=True)
        update()
        loss = loss.detach()
        hit, cnt = pck_counts(outs[-1].detach(), aug["target"])
        if group is not None:
            # global PCK: the ratio of the summed counts, not a mean of ratios
            (loss,), (hit, cnt) = reduce_metrics(group, means=(loss,), sums=(hit, cnt))
        return {"loss": loss, "acc": pck_from_counts(hit, cnt)[0]}

    return run


def _check_state(state, model, optimizer):
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("the state holds another model or optimizer "
                         "than this train step was built for")


def make_train_step(model, optimizer, aug_cfg, mean, std=None, *, seed=0,
                    mask_loss=False, clip_norm=0.0, group=None, device="cuda"):
    """Build the baseline train step (no agent): draw augmentation, augment
    on the device, forward in train mode, summed-stack MSE, backward, one
    optimizer update, train PCK from the last stack.

    ``train_step(state, batch) -> metrics`` advances ``state``
    (:class:`posetpu_torch.train.state.TrainState` holding this ``model``
    and ``optimizer``) in place: parameters, BatchNorm statistics,
    optimizer moments and ``state.step += 1``.  ``batch`` holds what
    :func:`make_eval_step` reads plus ``index`` (B,), the samples' global
    dataset indices.  The draws (:func:`sample_aug_params_ps`, and
    :func:`sample_jitter_scales` when ``aug_cfg.color_jitter``) are keyed on
    (``seed``, ``state.step``, ``index``), so a sample draws the same
    whatever its batch.  ``mask_loss`` weights the loss by the
    ``target_weight`` of each joint; ``clip_norm`` (0: off) clips the
    gradients to that global L2 norm before the update.  ``metrics``
    (``loss``, ``acc``) stay device tensors: the step never waits for the
    device.

    With ``group`` (data parallelism) ``batch`` is this rank's slice of
    the global batch, and the gradients, loss and PCK counts are reduced
    over the group's ranks (module docstring): W ranks at B/W rows each
    compute the step of one process at B.

    The model moves to ``device`` (default CUDA; raises without it unless
    ``device="cpu"``).
    """
    run = _train_math(model, optimizer, aug_cfg, mean, std, seed, mask_loss,
                      resolve_device(device), group, clip_norm)

    def train_step(state, batch):
        _check_state(state, model, optimizer)
        metrics = run(state.step, batch, optimizer.step)
        state.step += 1
        return metrics

    return train_step


class DeviceCounters:
    """A train state's ``step`` and its optimizer's update ``count`` as 0-d
    int64 tensors on ``device``, for a step that a CUDA graph replays."""

    def __init__(self, device):
        self.step = torch.zeros((), dtype=torch.int64, device=device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)

    def load(self, state):
        """Set both from the state's ints (two fills, no sync)."""
        self.step.fill_(int(state.step))
        self.count.fill_(int(state.optimizer.count))

    @staticmethod
    def advance(state, pattern):
        """Advance the state's ints by a dispatch of ``pattern`` (one flag
        a step, :class:`GraphedSteps`): the train step updates every step."""
        state.step += len(pattern)
        state.optimizer.count += len(pattern)


def make_train_body(model, optimizer, aug_cfg, mean, std=None, *, seed=0,
                    mask_loss=False, clip_norm=0.0, group=None, device="cuda"):
    """:func:`make_train_step`'s math with its counters on the device:
    ``body(counters, batch) -> metrics`` keys the draws on
    ``counters.step``, reads the schedule at ``counters.count``
    (:meth:`OptaxRMSprop.step_at
    <posetpu_torch.train.state.OptaxRMSprop.step_at>`) and advances both
    by one in place.  It syncs with the host nowhere, so a CUDA graph can
    capture it.  The state's Python ints are the caller's to advance.
    Draws, updates and metrics equal ``make_train_step``'s exactly, with
    ``clip_norm`` and ``group`` as there."""
    run = _train_math(model, optimizer, aug_cfg, mean, std, seed, mask_loss,
                      resolve_device(device), group, clip_norm)

    def body(counters, batch):
        metrics = run(counters.step, batch, lambda: optimizer.step_at(counters.count))
        counters.step.add_(1)
        return metrics

    return body


# body steps run on a side stream before a capture (cuBLAS and cuDNN
# handles, the kernel's library, lazily made constants); their updates are
# undone, and their kernel launches count as the launches they are
WARMUP_STEPS = 2


@dataclass
class _Graph:
    """One captured pattern: the graph, its static outputs, the kernel
    launches recorded in its capture, the capture's seconds and the bytes
    of the graph's memory pool."""

    graph: torch.cuda.CUDAGraph
    out: dict
    launches: dict
    seconds: float
    pool_bytes: int


def check_dispatch(steps, dev, group, update_every=1):
    """Refuse a dispatch's arguments before a step is built (and the models
    moved to ``dev``): K = ``steps`` and ``update_every`` below 1, and on
    CUDA a gloo ``group``, whose collectives a graph cannot capture."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if update_every < 1:
        raise ValueError(f"update_every must be >= 1: {update_every}")
    if dev.type == "cuda" and is_gloo(group):
        raise ValueError("a CUDA graph cannot capture a gloo collective: the "
                         "graphed step on CUDA needs an NCCL group")


class GraphedSteps(GraphCache):
    """``dispatch(state, superbatch) -> metrics``: K steps of ``body`` over
    a (K, B, ...) superbatch in one dispatch, each metric a (K,) tensor
    (:func:`make_dispatch_step`,
    :func:`posetpu_torch.train.adversarial.make_joint_dispatch_step`).

    ``body(counters, batch, update)`` is one step with its counters on the
    device (``counters``: :class:`DeviceCounters`, or the joint step's
    ``JointCounters``, which load them from the state's ints and advance
    the ints as the body advanced them).  ``update`` is a Python bool,
    whether the step is one of every ``update_every`` (the joint step's
    agent update).  The flags of a dispatch's K steps, its *pattern*, come
    from the host's own ``state.step`` before the dispatch, without a
    sync; they depend only on ``state.step % update_every``, so there are at
    most ``update_every`` patterns.  On CUDA each pattern is captured as
    one ``torch.cuda.CUDAGraph`` (its own memory pool) at its first full
    dispatch and replayed after; the rules are the module docstring's.
    ``check_state(state)`` raises for a state of other models; the state's
    ``holders()`` gives the modules and optimizers whose tensors the
    graphs read (the recapture check's).

    The captures are counted as :class:`posetpu_torch.utils.graphs.GraphCache`
    counts them; each ``pool_bytes`` is the size of its graph's own memory
    pool (the warm-up's cached blocks released first).

    Spans (:mod:`posetpu_torch.utils.profiling`), a dispatch's in one unit
    (the thread's, such as the loader's batch, else the dispatch's own):
    ``dispatch`` (marked with its ``steps``), and in it ``dispatch.stage``
    (the superbatch to the device, the counters loaded, the graph's static
    inputs filled, and a capture's ``graph.capture`` where one is due),
    ``dispatch.replay`` (with the card's time of the replay alone as its
    device span, marked with the ``steps``) or ``dispatch.eager``, and ``dispatch.finish`` (the
    outputs cloned, the counters advanced).
    """

    def __init__(self, body, counters, check_state, steps, dev, *, update_every=1):
        super().__init__()  # graphs: pattern -> _Graph, all on the same state tensors
        self.body, self.counters, self.check_state = body, counters, check_state
        self.steps, self.dev, self.update_every = steps, dev, update_every

    def pattern(self, step, k):
        """The update flags of k steps from step ``step``."""
        return tuple((step + i) % self.update_every == 0 for i in range(k))

    def __call__(self, state, superbatch):
        with profiling.span("dispatch") as sp:
            with profiling.span("dispatch.stage"):
                self.check_state(state)
                b = _to_device(superbatch, self.dev)
                k = b["index"].shape[0]
                if not 1 <= k <= self.steps:
                    raise ValueError(f"a superbatch of {k} steps for a dispatch of {self.steps}")
                sp.mark("steps", k)
                pattern = self.pattern(state.step, k)
                self.counters.load(state)
                g = None
                if self.dev.type == "cuda" and k == self.steps:
                    g = self._staged(state, b, pattern)
            if g is None:
                # the CPU route, and the short last group of an epoch: the
                # same body, eagerly
                with profiling.span("dispatch.eager"):
                    ms = [self.body(self.counters, {n: v[i] for n, v in b.items()}, u)
                          for i, u in enumerate(pattern)]
                    out = {n: torch.stack([m[n] for m in ms]) for n in ms[0]}
            else:
                with profiling.span("dispatch.replay"), \
                        profiling.device_span("dispatch.replay") as dev_sp:
                    dev_sp.mark("steps", k)
                    g.graph.replay()
                self._replayed(g)
            with profiling.span("dispatch.finish"):
                if g is not None:
                    # the next replay writes the same outputs
                    out = {n: v.clone() for n, v in g.out.items()}
                self.counters.advance(state, pattern)
        return out

    def _staged(self, state, b, pattern):
        """The graph of ``pattern``, captured if due, its static inputs
        filled from ``b``."""
        self._drop_if_moved(*state.holders())  # a state load replaced tensors
        g = self.graphs.get(pattern)
        if g is None:
            g = self.graphs[pattern] = self._capture(state, b, pattern)
        for n, v in b.items():
            self.static_in[n].copy_(v)
        return g

    def _capture(self, state, b, pattern):
        with profiling.span("graph.capture"):
            return self._captured(self._record(state, b, pattern))

    def _record(self, state, b, pattern):
        t0 = time.perf_counter()
        if not self.graphs:  # one input buffer for every pattern's graph
            self.static_in = {n: v.clone() for n, v in b.items()}
        saved = state.snapshot()
        cur = torch.cuda.current_stream(self.dev)
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for i in range(WARMUP_STEPS):
                j = i % self.steps
                self.body(self.counters, {n: v[j] for n, v in self.static_in.items()},
                          pattern[j])
        cur.wait_stream(side)
        state.restore_(saved)
        self.counters.load(state)
        del saved

        def steps():
            ms = [self.body(self.counters, {n: v[i] for n, v in self.static_in.items()}, u)
                  for i, u in enumerate(pattern)]
            return {n: torch.stack([m[n] for m in ms]) for n in ms[0]}

        graph, out, launches, pool_bytes = record(steps, self.dev)
        return _Graph(graph, out, launches, time.perf_counter() - t0, pool_bytes)


def make_dispatch_step(model, optimizer, aug_cfg, mean, std=None, *, seed=0,
                       mask_loss=False, clip_norm=0.0, steps=2, group=None,
                       device="cuda"):
    """K = ``steps`` train steps per dispatch — the counterpart of
    ``fuse_steps`` with ``HostLoader(group=K)``.

    Returns a :class:`GraphedSteps` ``dispatch(state, superbatch) ->
    metrics``: every ``superbatch`` field carries a leading (k, ...) dim
    (k <= K stacked loader batches, :func:`posetpu_torch.data.group_stack`),
    each metric comes back as a (k,) device tensor, and ``state.step`` and
    the optimizer's ``count`` advance by k.  K steps equal K
    :func:`make_train_step` calls on the same batches exactly.

    On CUDA a full superbatch runs as one ``torch.cuda.CUDAGraph`` of K
    :func:`make_train_body` steps over a static (K, B, ...) buffer: the
    superbatch is copied into it on the current stream, the graph replays,
    the launches it recorded are counted once per replay
    (:func:`posetpu_torch.utils.profiling.add_replay`).  The capture is
    made at the first full dispatch and after every state load (module
    docstring); a capture or replay that fails raises, and nothing falls
    back to eager steps.  A short superbatch (an epoch's last group) runs
    as eager body steps.  On the CPU every dispatch runs the body k times
    eagerly.

    With ``group`` each superbatch is this rank's (K, B/W, ...) slice
    (``P(None, axis)``) and the body reduces as :func:`make_train_step`
    does; on CUDA the graph captures its all-reduces, which needs NCCL: a
    gloo group raises here.
    """
    dev = resolve_device(device)
    check_dispatch(steps, dev, group)
    body = make_train_body(model, optimizer, aug_cfg, mean, std, seed=seed,
                           mask_loss=mask_loss, clip_norm=clip_norm, group=group,
                           device=dev)
    return GraphedSteps(lambda counters, batch, _update: body(counters, batch),
                        DeviceCounters(dev), lambda st: _check_state(st, model, optimizer),
                        steps, dev)


def make_eval_step(model, aug_cfg, mean, std=None, *, group=None, device="cuda"):
    """Build the validation step: neutral crop, forward, train-time PCK and
    the full decode back to source coords.

    ``eval_step(batch) -> (metrics, preds)``.  ``batch`` holds ``image``
    (B, Hp, Wp, 3) uint8, ``valid_wh``, ``center``, ``scale``, ``pts``,
    ``vis`` and optionally ``mask`` (B,) marking padded rows (they count
    nowhere) and ``offset`` (B, 2), the loader's crop shift added back to
    the predictions.  The model moves to ``device`` (default CUDA; raises
    without it unless ``device="cpu"``); arrays may be numpy or tensors and
    move there too.  The step runs under ``torch.no_grad()`` with the model
    in ``eval()`` and restores the model's mode afterwards.

    With ``group`` the batch is this rank's slice; ``pck_hit``,
    ``pck_cnt``, the masked loss sum and the real-row count are summed over
    the ranks before ``loss`` and ``acc`` (the reference's ``psum``), and
    ``preds`` stay this rank's rows.
    """
    dev = resolve_device(device)
    model.to(dev)
    mean_t, std_t = _normalization(mean, std, dev)

    def eval_step(batch):
        b = _to_device(batch, dev)
        B = b["image"].shape[0]
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                aug = augment_batch(
                    b["image"], b["valid_wh"], b["center"], b["scale"],
                    b["pts"], b["vis"], neutral_params(B, dev),
                    inp_res=tuple(aug_cfg.inp_res),
                    out_res=tuple(aug_cfg.out_res),
                    sigma=aug_cfg.sigma, mean=mean_t, std=std_t,
                    dataset=aug_cfg.dataset, device=dev,
                )
                outs = model(aug["input"])
        finally:
            model.train(was_training)
        scores = outs[-1].float()
        mask = b.get("mask")
        mask = (
            torch.ones((B,), device=dev) if mask is None else mask.float()
        )
        hit, cnt = pck_counts(scores, aug["target"], sample_mask=mask)
        loss_sum = (per_sample_stacked_mse(outs, aug["target"]) * mask).sum()
        n = mask.sum()
        if group is not None:
            _, sums = reduce_metrics(group, sums=(hit, cnt, loss_sum, n))
            counts = hit.dtype
            hit, cnt, loss_sum, n = sums
            hit, cnt = hit.to(counts), cnt.to(counts)
        loss = loss_sum / torch.clamp(n, min=1.0)
        metrics = {
            "loss": loss,
            "acc": pck_from_counts(hit, cnt)[0],
            # per-joint counts: sum across batches, take the ratio once
            "pck_hit": hit,
            "pck_cnt": cnt,
        }
        preds = final_preds(
            scores, aug["center"], aug["scale"], tuple(aug_cfg.out_res)
        )
        off = b.get("offset")
        if off is not None:
            preds = preds + off[:, None, :].to(preds.dtype)
        return metrics, preds

    return eval_step


class GraphedEvalStep:
    """``eval_step(batch) -> (metrics, preds)``: :func:`make_eval_step`'s
    contract, on CUDA replayed from one CUDA graph per batch signature
    (:func:`make_graphed_eval_step`)."""

    def __init__(self, eager, model, dev):
        self.eager = eager
        self.graphs = None
        if dev.type == "cuda":
            self.graphs = ShapeGraphs(
                eager, lambda: (model,), dev, name="validate")

    def __call__(self, batch):
        if self.graphs is None:
            return self.eager(batch)
        metrics, preds = self.graphs(batch)
        # the next replay writes the same outputs: each call keeps its own
        return {k: v.clone() for k, v in metrics.items()}, preds.clone()


def make_graphed_eval_step(model, aug_cfg, mean, std=None, *, group=None, device="cuda"):
    """:func:`make_eval_step` as one CUDA graph per batch signature — the
    counterpart of the JAX package's ``jax.jit`` of its eval step, and the
    validation step :class:`posetpu_torch.train.loop.Experiment` runs.

    Returns a :class:`GraphedEvalStep` with :func:`make_eval_step`'s
    contract and arguments.  On CUDA the graph of a batch is keyed by the
    name, shape and dtype of each field, so a batch with ``mask`` or
    ``offset`` and one without take graphs of their own; it is captured at
    the signature's first batch and again after the model's storage moves
    (:class:`posetpu_torch.utils.graphs.ShapeGraphs`, whose docstring holds
    the rules and what the shared pool holds).  The body is
    :func:`make_eval_step`'s step itself, so the graph computes what it
    computes; the rasterizer's launches count once per replay.  Host
    batches are copied into the graph's buffers through pinned staging
    buffers.  The metrics and predictions returned are copies of the
    graph's outputs, which the next replay overwrites.  A capture or replay
    that fails raises: nothing falls back to eager calls.  With ``group``
    the graph captures the step's all-reduces, which needs NCCL: a gloo
    group on CUDA raises here.  On the CPU every call runs
    :func:`make_eval_step`'s step eagerly.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and is_gloo(group):
        raise ValueError("a CUDA graph cannot capture a gloo collective: the "
                         "graphed eval step on CUDA needs an NCCL group")
    eager = make_eval_step(model, aug_cfg, mean, std, group=group, device=dev)
    return GraphedEvalStep(eager, model, dev)
