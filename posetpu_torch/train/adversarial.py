"""Joint adversarial augmentation training — counterpart of
``posetpu/train/adversarial.py`` (``make_joint_step``).

One joint minimax step:

  neutral crop                                  aug.pipeline
  -> agent forward, train mode                  models.agent
  -> keyed draws: bins, occlusion, flips, the reference augmentation
  -> adversarial + reference crops in one warp over 2B crops, and their
     targets (the rasterizer kernel)
  -> occlusion of the adversarial crops (tree, parts or flat)
  -> reference forward, eval mode, no grad: the reward's baseline
  -> pose forward/backward on the adversarial crops, RMSprop update
  -> reward = per-sample loss(adversarial) - loss(reference), normalized
  -> REINFORCE update of the agent on steps where step % update_every == 0

The reference builds this same math twice (``make_joint_step`` and
``make_joint_step_split``) for XLA's compile times; the port has it once
(``_joint_math``), run three ways: :func:`make_joint_step`, the eager
reference, with the state's Python ints; :func:`make_joint_body`, with its
counters on the device (:class:`JointCounters`) and the agent's update
branch a Python bool, which a CUDA graph can capture; and
:func:`make_joint_dispatch_step`, K body steps a dispatch (the counterpart
of ``fuse_steps(make_joint_step)``), one captured graph per update pattern
on CUDA (:class:`posetpu_torch.train.step.GraphedSteps`).

Data parallelism (the reference's ``axis_name``): with ``group`` each rank
runs the step on its slice of the global batch; the pose and agent
gradients are averaged over the ranks before their updates, the advantage
is standardized with the moments of the global batch, and the metrics are
reduced (:func:`make_joint_step`).  The draws are keyed on the global
sample index, so W ranks draw what one process draws at the global batch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from posetpu_torch.aug.color import sample_jitter_scales
from posetpu_torch.aug.keyed import (
    STREAM_ADV_FLIP,
    STREAM_OCC,
    STREAM_ROT_BIN,
    STREAM_SCALE_BIN,
    bits_to_uniform,
    keyed_bits,
    sample_categorical,
)
from posetpu_torch.aug.pipeline import (
    AugParams,
    augment_batch,
    neutral_params,
    sample_aug_params_ps,
)
from posetpu_torch.eval.decode import pck_counts, pck_from_counts
from posetpu_torch.models.agent import (
    AugAgent,
    occlusion_hierarchy,
    occlusion_tree_logp,
    part_level_sizes,
    part_occlusion_boxes,
    rotation_bin_table,
    sample_occlusion_tree,
    scale_bin_table,
)
from posetpu_torch.parallel.dp import mean_grads_, reduce_metrics
from posetpu_torch.train.state import TrainState, make_optimizer
from posetpu_torch.train.step import (
    GraphedSteps,
    _normalization,
    _to_device,
    check_dispatch,
    per_sample_stacked_mse,
)
from posetpu_torch.utils.device import resolve_device


@dataclass
class JointState:
    """The pose network's and the agent's train states, and the number of
    joint steps taken, which keys the draws and the agent's cadence.  The
    agent's ``step`` and its optimizer's count advance on update steps
    only."""

    pose: TrainState
    agent: TrainState
    step: int = 0

    def holders(self):
        """(modules, optimizers): the pose network's and the agent's."""
        return (self.pose.model, self.agent.model), (self.pose.optimizer, self.agent.optimizer)

    def tensors(self):
        """Every tensor a joint step updates in place
        (:meth:`TrainState.tensors` of the pose network's state, then the
        agent's)."""
        return self.pose.tensors() + self.agent.tensors()

    def snapshot(self):
        """(the pose state's :meth:`TrainState.snapshot`, the agent's,
        ``step``)."""
        return self.pose.snapshot(), self.agent.snapshot(), self.step

    def restore_(self, snap):
        """Put a :meth:`snapshot` back, the tensors *in place*."""
        pose, agent, step = snap
        self.pose.restore_(pose)
        self.agent.restore_(agent)
        self.step = step


def apply_occlusion(images, node_idx, boxes):
    """Zero the sampled occluder box of each sample (zero is the dataset
    mean after normalization).

    images (B, H, W, C); node_idx (B,) into ``boxes``, node 0 "no
    occlusion" with box (0, 0, 0, 0); boxes (N, 4) int (y0, x0, h, w) for
    every sample, or (B, N, 4) per sample (body parts).
    """
    B, H, W, _ = images.shape
    dev = images.device
    boxes = torch.as_tensor(boxes, device=dev)
    node_idx = torch.as_tensor(node_idx, device=dev).long()
    if boxes.dim() == 3:
        box = boxes.gather(1, node_idx[:, None, None].expand(B, 1, 4))[:, 0]
    else:
        box = boxes[node_idx]
    y0, x0, h, w = (box[:, i, None, None] for i in range(4))
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    inside = (ys >= y0) & (ys < y0 + h) & (xs >= x0) & (xs < x0 + w)
    return torch.where(inside[..., None], 0.0, images)


def occ_box_table(occ, occ_boxes, tpts, target_weight, aug_cfg):
    """The box table of :func:`apply_occlusion`: the static grid (tree and
    flat), or body-part boxes from the adversarial crop's own keypoints
    (parts).  ``tpts`` are the untruncated heatmap coordinates
    (``tpts_float``); the crop coordinates are their exact linear rescale
    ``(tpts - 1) * inp/out`` (the truncated ints would pull the boxes up to
    inp/out pixels toward the origin)."""
    if occ["mode"] != "parts":
        return occ_boxes
    ry = aug_cfg.inp_res[0] / aug_cfg.out_res[0]
    rx = aug_cfg.inp_res[1] / aug_cfg.out_res[1]
    # scalar factors: a (2,) table copied to the card is a host copy, which
    # a CUDA graph's capture refuses
    crop = torch.stack([(tpts[..., 0] - 1.0) * rx, (tpts[..., 1] - 1.0) * ry], dim=-1)
    return part_occlusion_boxes(crop, target_weight, occ["dataset"])


def sample_policy(seed, step, index, logits, aug_cfg, scale_table, rot_table, occ):
    """Every draw of one joint step, keyed on (``seed``, ``step``, global
    sample ``index``): a sample draws the same whatever its batch.

    ``logits`` are the agent's (detached); ``occ`` is None or the occlusion
    spec of :func:`make_joint_step`.  Returns (extras, adv_params,
    ref_params, jitter): ``extras`` the sampled path (``si``, ``ri`` and
    ``oi``, plus ``occ_lvl`` and ``occ_cell`` for a tree) that
    :func:`policy_logp` re-evaluates; the adversarial crop's AugParams
    (the bins' scale and rotation, a flip with ``flip_prob``); the
    reference crop's, from the plain training distribution; the (B, 3)
    jitter scales both crops share, or None without color jitter.
    """
    si, _ = sample_categorical(seed, step, index, STREAM_SCALE_BIN, logits["scale"])
    ri, _ = sample_categorical(seed, step, index, STREAM_ROT_BIN, logits["rot"])
    extras = {"si": si, "ri": ri}
    if occ is not None:
        if occ["mode"] in ("tree", "parts"):
            node, lvl, cell, _ = sample_occlusion_tree(
                seed, step, index, STREAM_OCC, logits["occ_level"], logits["occ_cells"]
            )
            extras.update({"oi": node, "occ_lvl": lvl, "occ_cell": cell})
        else:
            extras["oi"], _ = sample_categorical(
                seed, step, index, STREAM_OCC, logits["occ"]
            )
    flip_u = bits_to_uniform(keyed_bits(seed, step, index, STREAM_ADV_FLIP, 1)[:, 0])
    adv_params = AugParams(
        scale_factor=scale_table[si],
        rot=rot_table[ri],
        flip=flip_u < aug_cfg.flip_prob,
    )
    ref_params = sample_aug_params_ps(
        seed, step, index, scale_factor=aug_cfg.scale_factor,
        rot_factor=aug_cfg.rot_factor, rot_prob=aug_cfg.rot_prob,
        flip_prob=aug_cfg.flip_prob, scale_mode=aug_cfg.scale_mode,
    )
    jitter = sample_jitter_scales(seed, step, index) if aug_cfg.color_jitter else None
    return extras, adv_params, ref_params, jitter


def _pick(logits, idx):
    return torch.log_softmax(logits, dim=-1).gather(1, idx[:, None])[:, 0]


def policy_logp(logits, extras):
    """log pi of the sampled path per sample (B,), differentiable in
    ``logits``; the indices in ``extras`` are fixed (REINFORCE)."""
    logp = _pick(logits["scale"], extras["si"]) + _pick(logits["rot"], extras["ri"])
    if "occ_lvl" in extras:
        logp = logp + occlusion_tree_logp(
            logits["occ_level"], logits["occ_cells"], extras["occ_lvl"],
            extras["occ_cell"],
        )
    elif "oi" in extras:
        logp = logp + _pick(logits["occ"], extras["oi"])
    return logp


def _head_entropy(head_logits):
    p = torch.softmax(head_logits, dim=-1)
    return -(p * torch.log_softmax(head_logits, dim=-1)).sum(-1).mean()


def entropy(logits):
    """Mean categorical entropy (nats) over every head of the policy:
    scale, rotation, and the occlusion heads (the flat head, or the level
    head and each cell head), so a collapse of any of them shows."""
    ents = [_head_entropy(logits[h]) for h in ("scale", "rot", "occ", "occ_level")
            if h in logits]
    ents += [_head_entropy(c) for c in logits.get("occ_cells", ())]
    return sum(ents) / len(ents)


def normalize_advantage(adv, baseline, group=None):
    """``"batch_mean"``: standardize with the batch's biased moments,
    ``(adv - m) / (sqrt(max(E[adv²] - m², 0)) + 1e-6)``; ``"sign"``: its
    sign; any other value leaves it as it is, as the reference does.  With
    ``group`` the moments m and E[adv²] are averaged over the ranks before
    the std (equal slices make them the global batch's): the mean of the
    ranks' stds is not the global std."""
    adv = adv.detach()
    if baseline == "batch_mean":
        m = adv.mean()
        m2 = (adv * adv).mean()
        if group is not None:
            (m, m2), _ = reduce_metrics(group, means=(m, m2))
        s = torch.sqrt(torch.clamp(m2 - m * m, min=0.0)) + 1e-6
        adv = (adv - m) / s
    elif baseline == "sign":
        adv = torch.sign(adv)
    return adv


def _occ_spec(occ_boxes, agent_model, occ_mode, occ_levels):
    """The sampler's occlusion spec, matching the agent's heads; None
    arguments resolve from the agent's own fields.  "parts" needs no static
    table and is on when the agent has occlusion heads; the grid modes are
    on when ``occ_boxes`` is given."""
    mode = occ_mode or agent_model.occ_mode
    if mode == "parts":
        if agent_model.num_occ_nodes <= 0:
            return None
        return {"mode": mode, "levels": (), "dataset": agent_model.occ_dataset}
    if occ_boxes is None:
        return None
    return {"mode": mode, "levels": tuple(occ_levels or agent_model.occ_levels)}


def _detached(logits):
    return {k: tuple(t.detach() for t in v) if isinstance(v, tuple) else v.detach()
            for k, v in logits.items()}


def _check_joint_state(state, pose_model, agent_model, pose_opt, agent_opt):
    if (state.pose.model is not pose_model or state.pose.optimizer is not pose_opt
            or state.agent.model is not agent_model
            or state.agent.optimizer is not agent_opt):
        raise ValueError("the state holds other models or optimizers "
                         "than this joint step was built for")


def _joint_math(pose_model, agent_model, pose_opt, agent_opt, aug_cfg, mean, std, dev, *,
                seed=0, scale_table, rot_table, occ_boxes=None, occ_mode=None,
                occ_levels=None, baseline="batch_mean", ref_baseline=True,
                pose_ref_weight=0.0, group=None):
    """``run(step, batch, do_update, pose_update, agent_update) -> metrics``:
    one joint step's math with the draws keyed on ``step`` (an int or a
    0-d device tensor), ``pose_update()`` and, where ``do_update`` (a
    Python bool), ``agent_update()`` applying the optimizers
    (:func:`make_joint_step` documents the options)."""
    if pose_ref_weight and not ref_baseline:
        raise ValueError("pose_ref_weight > 0 requires ref_baseline=True")
    if not 0.0 <= pose_ref_weight < 1.0:
        raise ValueError(f"pose_ref_weight must be in [0, 1): {pose_ref_weight}")
    pose_model.to(dev)
    agent_model.to(dev)
    mean_t, std_t = _normalization(mean, std, dev)
    scale_table = torch.as_tensor(scale_table, dtype=torch.float32, device=dev)
    rot_table = torch.as_tensor(rot_table, dtype=torch.float32, device=dev)
    occ = _occ_spec(occ_boxes, agent_model, occ_mode, occ_levels)
    if occ_boxes is not None:
        occ_boxes = torch.as_tensor(occ_boxes, dtype=torch.int32, device=dev)
    mixed = pose_ref_weight > 0.0

    def augment(b, params, jitter, src_index=None):
        if src_index is not None:  # metadata of both crops of each sample
            b = {k: (v if k == "image" else torch.cat([v, v])) for k, v in b.items()}
        return augment_batch(
            b["image"], b["valid_wh"], b["center"], b["scale"], b["pts"],
            b["vis"], params, inp_res=tuple(aug_cfg.inp_res),
            out_res=tuple(aug_cfg.out_res), sigma=aug_cfg.sigma, mean=mean_t,
            std=std_t, dataset=aug_cfg.dataset, jitter_scales=jitter,
            src_index=src_index, device=dev,
        )

    def run(t, batch, do_update, pose_update, agent_update):
        b = _to_device(batch, dev)
        B = b["image"].shape[0]

        # 1-3: neutral crop, agent forward, draws.  One train-mode forward
        # serves the draws (detached) and the REINFORCE loss; its
        # BatchNorm statistics are kept on update steps only
        with torch.no_grad():
            inp_n = augment(b, neutral_params(B, dev), None)["input"]
        agent_model.train()
        kept = None if do_update else [x.clone() for x in agent_model.buffers()]
        with torch.set_grad_enabled(do_update):
            logits = agent_model(inp_n)
        if kept is not None:
            with torch.no_grad():
                for x, old in zip(agent_model.buffers(), kept):
                    x.copy_(old)
        drawn = _detached(logits)
        # a module-level name: tests substitute the reference's draws
        extras, adv_params, ref_params, jitter = sample_policy(
            seed, t, b["index"], drawn, aug_cfg, scale_table, rot_table, occ,
        )

        # 4-5: adversarial and reference crops in one warp, then occlusion
        with torch.no_grad():
            if ref_baseline:
                pair = AugParams(*(torch.cat(p) for p in zip(adv_params, ref_params)))
                both = None if jitter is None else torch.cat([jitter, jitter])
                aug = augment(b, pair, both, src_index=torch.arange(B, device=dev).repeat(2))
                inp_r, tgt_r = aug["input"][B:], aug["target"][B:]
            else:
                aug = augment(b, adv_params, jitter)
            inp_a, tgt_a = aug["input"][:B], aug["target"][:B]
            if occ is not None:
                boxes = occ_box_table(occ, occ_boxes, aug["tpts_float"][:B],
                                      aug["target_weight"][:B], aug_cfg)
                inp_a = apply_occlusion(inp_a, extras["oi"], boxes)

        # 7 before 6: the reward's reference forward reads the pose
        # network's parameters and running statistics from before this
        # step's update, which the train forward and the optimizer move
        if ref_baseline and not mixed:
            pose_model.eval()
            with torch.no_grad():
                l_ref = per_sample_stacked_mse(pose_model(inp_r), tgt_r)

        # 6: pose forward/backward and update
        pose_model.train()
        if mixed:
            inp_t, tgt_t = torch.cat([inp_a, inp_r]), torch.cat([tgt_a, tgt_r])
        else:
            inp_t, tgt_t = inp_a, tgt_a
        outs = pose_model(inp_t)
        l_sample = per_sample_stacked_mse(outs, tgt_t)
        if mixed:
            loss = ((1.0 - pose_ref_weight) * l_sample[:B].mean()
                    + pose_ref_weight * l_sample[B:].mean())
        else:
            loss = l_sample.mean()
        pose_opt.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            mean_grads_(pose_model.parameters(), group)
        pose_update()

        # reward: harder-than-reference draws get a positive advantage
        l_sample = l_sample.detach()
        l_adv = l_sample[:B]
        if mixed:
            l_ref = l_sample[B:]
        elif not ref_baseline:
            l_ref = l_adv.mean() * torch.ones_like(l_adv)
        gap = l_adv - l_ref
        adv = normalize_advantage(gap, baseline, group=group)
        agent_loss = -(adv * policy_logp(logits, extras)).mean()
        if do_update:
            agent_opt.zero_grad(set_to_none=True)
            agent_loss.backward()
            if group is not None:
                mean_grads_(agent_model.parameters(), group)
            agent_update()

        hit, cnt = pck_counts(outs[-1][:B].detach().float(), tgt_a)
        means = [loss.detach(), agent_loss.detach(), gap.mean(), entropy(drawn)]
        if group is not None:
            means, (hit, cnt) = reduce_metrics(group, means=means, sums=(hit, cnt))
        return {
            "loss": means[0],
            "acc": pck_from_counts(hit, cnt)[0],
            "agent_loss": means[1],
            "advantage": means[2],
            "entropy": means[3],
        }

    return run


def make_joint_step(
    pose_model,
    agent_model,
    pose_opt,
    agent_opt,
    aug_cfg,
    mean,
    std=None,
    *,
    seed=0,
    scale_table,
    rot_table,
    occ_boxes=None,
    occ_mode=None,
    occ_levels=None,
    baseline="batch_mean",
    ref_baseline=True,
    update_every=1,
    pose_ref_weight=0.0,
    group=None,
    device="cuda",
):
    """Build the joint minimax step.

    ``joint_step(state, batch) -> metrics`` advances ``state``
    (:class:`JointState` holding these models and optimizers) in place.
    ``batch`` is a train batch (``image``, ``valid_wh``, ``center``,
    ``scale``, ``pts``, ``vis``, ``index``).  ``metrics`` (``loss``,
    ``acc``, ``agent_loss``, ``advantage``, ``entropy``) stay device
    tensors.

    - ``ref_baseline=False`` drops the reference crops and rewards against
      the batch's mean adversarial loss.
    - ``update_every=N`` updates the agent (parameters, BatchNorm
      statistics, RMSprop moments and count, ``state.agent.step``) only
      where ``state.step % N == 0``; ``agent_loss`` and ``entropy`` are
      reported every step.  The pose network updates every step.
    - ``pose_ref_weight=w`` (0 <= w < 1, needs ``ref_baseline``) trains the
      pose network on concat(adversarial, reference) with loss
      ``(1-w)*mean(l_adv) + w*mean(l_ref)``, BatchNorm statistics from the
      2B crops, and takes the reward's baseline from that pass.
    - ``occ_boxes`` (N, 4) turns on grid occlusion (tree or flat); "parts"
      is on when the agent has occlusion heads.  ``occ_mode`` and
      ``occ_levels`` default to the agent's own.
    - ``group`` (data parallelism): ``batch`` is this rank's slice of the
      global batch.  The pose and agent gradients are averaged over the
      ranks, ``normalize_advantage`` takes the global moments, ``loss``,
      ``agent_loss``, ``entropy`` and ``advantage`` are averaged and the
      PCK hits and counts summed.  Every rank takes the same
      ``update_every`` branch (the step count is the same on all).  The
      models' BatchNorms take the group through
      :func:`posetpu_torch.models.batchnorm.convert_cross_replica_`.

    The models move to ``device`` (default CUDA; raises without it unless
    ``device="cpu"``).  This eager step is the reference that the graphed
    one (:func:`make_joint_dispatch_step`) is held to.
    """
    if update_every < 1:
        raise ValueError(f"update_every must be >= 1: {update_every}")
    run = _joint_math(
        pose_model, agent_model, pose_opt, agent_opt, aug_cfg, mean, std,
        resolve_device(device), seed=seed, scale_table=scale_table,
        rot_table=rot_table, occ_boxes=occ_boxes, occ_mode=occ_mode,
        occ_levels=occ_levels, baseline=baseline, ref_baseline=ref_baseline,
        pose_ref_weight=pose_ref_weight, group=group,
    )

    def joint_step(state, batch):
        _check_joint_state(state, pose_model, agent_model, pose_opt, agent_opt)
        do_update = state.step % update_every == 0
        metrics = run(state.step, batch, do_update, pose_opt.step, agent_opt.step)
        if do_update:
            state.agent.step += 1
        state.pose.step += 1
        state.step += 1
        return metrics

    return joint_step


class JointCounters:
    """A :class:`JointState`'s ints as 0-d int64 tensors on ``device``, for
    a joint step that a CUDA graph replays: ``step`` (the joint step, which
    keys the draws), the pose network's ``pose_step`` and update count
    ``pose_count``, the agent's ``agent_step`` and update count
    ``agent_count``."""

    NAMES = ("step", "pose_step", "pose_count", "agent_step", "agent_count")

    def __init__(self, device):
        for n in self.NAMES:
            setattr(self, n, torch.zeros((), dtype=torch.int64, device=device))

    @staticmethod
    def ints(state):
        """The state's ints in the order of ``NAMES``."""
        return (state.step, state.pose.step, state.pose.optimizer.count,
                state.agent.step, state.agent.optimizer.count)

    def load(self, state):
        """Set every counter from the state's ints (fills, no sync)."""
        for n, v in zip(self.NAMES, self.ints(state)):
            getattr(self, n).fill_(int(v))

    @staticmethod
    def advance(state, pattern):
        """Advance the state's ints by a dispatch of ``pattern`` (one update
        flag a step): the joint and pose steps and the pose count by its
        length, the agent's step and count by its update steps."""
        k, u = len(pattern), sum(pattern)
        state.step += k
        state.pose.step += k
        state.pose.optimizer.count += k
        state.agent.step += u
        state.agent.optimizer.count += u


def make_joint_body(pose_model, agent_model, pose_opt, agent_opt, aug_cfg, mean,
                    std=None, *, device="cuda", **kw):
    """:func:`make_joint_step`'s math with its counters on the device:
    ``body(counters, batch, do_update) -> metrics``.

    ``counters`` is a :class:`JointCounters`; the draws are keyed on
    ``counters.step``, each optimizer reads its schedule at its count
    (:meth:`OptaxRMSprop.step_at
    <posetpu_torch.train.state.OptaxRMSprop.step_at>`), and the body
    advances the counters as ``make_joint_step`` advances the state's
    ints.  ``do_update`` is a Python bool, whether this is an agent update
    step: a CUDA graph captures one branch.  The body syncs with the host
    nowhere, so a graph can capture it; the state's ints are the caller's
    to advance (:meth:`JointCounters.advance`).  ``kw`` are
    ``make_joint_step``'s options but ``update_every``.  Draws, updates,
    statistics and metrics equal ``make_joint_step``'s exactly.
    """
    run = _joint_math(pose_model, agent_model, pose_opt, agent_opt, aug_cfg, mean, std,
                      resolve_device(device), **kw)

    def body(counters, batch, do_update):
        metrics = run(counters.step, batch, do_update,
                      lambda: pose_opt.step_at(counters.pose_count),
                      lambda: agent_opt.step_at(counters.agent_count))
        counters.step.add_(1)
        counters.pose_step.add_(1)
        if do_update:
            counters.agent_step.add_(1)
        return metrics

    return body


def make_joint_dispatch_step(pose_model, agent_model, pose_opt, agent_opt, aug_cfg, mean,
                             std=None, *, steps=2, update_every=1, group=None,
                             device="cuda", **kw):
    """K = ``steps`` joint steps per dispatch — the counterpart of
    ``fuse_steps(make_joint_step)``, jitted on one chip or sharded under
    data parallelism.  The arguments are :func:`make_joint_step`'s.

    Returns a :class:`posetpu_torch.train.step.GraphedSteps`
    ``dispatch(state, superbatch) -> metrics``: every ``superbatch`` field
    carries a leading (k, ...) dim (k <= K), each metric (the joint step's
    five) comes back as a (k,) device tensor, and the :class:`JointState`'s
    ints advance as k joint steps advance them.  K steps equal K
    :func:`make_joint_step` calls on the same batches exactly.

    On CUDA a full superbatch replays a ``torch.cuda.CUDAGraph`` of K
    :func:`make_joint_body` steps.  The steps that update the agent depend
    only on the first step modulo ``update_every``; each such pattern is
    captured at its first full dispatch (one graph for ``update_every=1``)
    and again after any state load.  A capture or replay that fails
    raises; nothing falls back to eager steps.  A short superbatch (an
    epoch's last group) runs as eager body steps, and on the CPU every
    dispatch does.  With ``group`` (NCCL) the graph captures the step's
    all-reduces: the pose and agent gradient buckets, the advantage's
    moments, the metric bucket and the cross-replica BatchNorms'; a gloo
    group on CUDA raises.
    """
    dev = resolve_device(device)
    check_dispatch(steps, dev, group, update_every)
    body = make_joint_body(pose_model, agent_model, pose_opt, agent_opt, aug_cfg, mean,
                           std, group=group, device=dev, **kw)
    return GraphedSteps(
        body, JointCounters(dev),
        lambda st: _check_joint_state(st, pose_model, agent_model, pose_opt, agent_opt),
        steps, dev, update_every=update_every,
    )


def agent_from_config(cfg, *, steps_per_epoch=1, widths=(32, 64, 128, 256),
                      device="cuda"):
    """The agent of ``cfg`` and what :func:`make_joint_step` needs with it:
    ``(agent, agent_optimizer, joint_kw)``.

    The bin tables (rotation bins over +-``aug.rot_factor``), the occlusion
    table of ``occ_mode`` and ``occ_levels`` at ``aug.inp_res``, and the
    agent's optimizer: the experiment's with ``agent.lr``, its schedule
    over ``steps_per_epoch``.  ``agent.occ_nodes`` turns occlusion on and
    must equal the node count of the hierarchy.  ``widths`` is the agent's
    conv widths (the reference's default).  The agent is made on ``device``
    (default CUDA; raises without it unless ``device="cpu"``).
    """
    a = cfg.agent
    if not a.enabled:
        raise ValueError(f"config {cfg.name!r} trains no agent")
    occ_boxes = None
    if a.occ_mode == "parts":
        occ_nodes = 1 + sum(part_level_sizes(cfg.aug.dataset)) if a.occ_nodes else 0
        src = f"PART_GROUPS[{cfg.aug.dataset!r}]"
    else:
        if a.occ_nodes:
            occ_boxes = occlusion_hierarchy(tuple(cfg.aug.inp_res), tuple(a.occ_levels))
        occ_nodes = 0 if occ_boxes is None else len(occ_boxes)
        src = f"occ_levels={tuple(a.occ_levels)}"
    if a.occ_nodes and a.occ_nodes != occ_nodes:
        raise ValueError(f"agent.occ_nodes={a.occ_nodes} does not match the "
                         f"{a.occ_mode!r} hierarchy: {src} defines {occ_nodes} nodes")
    agent = AugAgent(
        num_scale_bins=a.scale_bins, num_rot_bins=a.rot_bins,
        num_occ_nodes=occ_nodes, occ_mode=a.occ_mode,
        occ_levels=tuple(a.occ_levels), occ_dataset=cfg.aug.dataset,
        widths=widths, input_downscale=a.input_downscale,
        dtype=torch.bfloat16 if cfg.model.bf16 else torch.float32, device=device,
    )
    agent_opt = make_optimizer(
        agent.parameters(), dataclasses.replace(cfg.optim, lr=a.lr), steps_per_epoch
    )
    joint_kw = dict(
        scale_table=scale_bin_table(a.scale_bins),
        rot_table=rotation_bin_table(a.rot_bins, -cfg.aug.rot_factor, cfg.aug.rot_factor),
        occ_boxes=occ_boxes, occ_mode=a.occ_mode, occ_levels=tuple(a.occ_levels),
        baseline=a.reward_baseline, update_every=a.update_every,
        pose_ref_weight=a.pose_ref_weight,
    )
    return agent, agent_opt, joint_kw
