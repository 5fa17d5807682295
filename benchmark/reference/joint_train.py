"""The joint adversarial step (Peng et al. 2018: the agent picks the
augmentation that the pose network finds hardest, rewarded by how much
harder it was than the plain one) in plain float32 PyTorch.  Each step:

1. the neutral crop (the person's box, no scale change, rotation or
   flip), the dataset mean subtracted;
2. the agent's logits of it (``agent.py``, its norms on the batch), and a
   scale bin, a rotation bin (Gumbel-max on the keyed draws) and a flip;
3. the adversarial crop from those bins, the plain crop from the training
   distribution, both with the same colour scales, and their targets;
4. the pose network in eval mode on the plain crops: each sample's loss,
   the reward's baseline (before this step's update);
5. the pose network in train mode on the adversarial crops: each sample's
   loss summed over stacks, their mean, the gradients and RMSprop; the
   norms' running statistics take flax's update;
6. the reward: each sample's adversarial loss less its plain loss,
   standardized over the batch, ``(r - m) / (sqrt(E r^2 - m^2) + 1e-6)``;
   the agent's loss ``-mean(reward * log p(bins))``, its gradients and
   RMSprop at the agent's learning rate.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.frozen.keyed import (
    STREAM_ROT_BIN,
    STREAM_SCALE_BIN,
    adversarial_flip,
    aug_params,
    jitter_scales,
    sample_categorical,
)
from benchmark.reference import agent
from benchmark.reference.augment import crop, train_crops, transform
from benchmark.reference.hourglass import Net


def per_sample(outs, target):
    return sum(((o - target) ** 2).mean((1, 2, 3)) for o in outs)


def bin_tables(cfg, device):
    """(scale factors 2^linspace(-0.4, 0.4, S), rotations linspace(-rf, rf,
    R) in degrees) of the agent's bins."""
    a, rf = cfg["agent"], cfg["aug"]["rot_factor"]
    scale = np.exp2(np.linspace(-0.4, 0.4, a["scale_bins"])).astype(np.float32)
    rot = np.linspace(-rf, rf, a["rot_bins"]).astype(np.float32)
    return torch.from_numpy(scale).to(device), torch.from_numpy(rot).to(device)


class _RMSprop:
    """optax's RMSprop from zero second moments of the parameters
    ``names`` of ``w``; keeps the moments in float64 too."""

    def __init__(self, w, names, decay, eps, lr):
        self.nu = {n: torch.zeros_like(w[n]) for n in names}
        self.added = {n: torch.zeros_like(w[n], dtype=torch.float64) for n in names}
        self.d, self.eps, self.lr = decay, eps, lr

    @torch.no_grad()
    def step(self, w, grads):
        for n, g in zip(self.nu, grads):
            self.nu[n].mul_(self.d).add_((1.0 - self.d) * g * g)
            self.added[n].mul_(self.d).add_((1.0 - self.d) * g.double() ** 2)
            w[n].sub_(self.lr * g * torch.rsqrt(self.nu[n] + self.eps))


def follow(pose_w, pose_params, agent_w, agent_params, batches, *, first, seed, cfg,
           quant=False, rows=None):
    """Joint steps, one batch each, from the benchmark's weights, as a
    fresh run (zero moments).  ``rows`` keeps the first ``rows`` rows of
    each batch (a planted fault).  Returns ({"loss", "agent_loss"}: each
    step's, float64), (the pose network's parameters after the last step,
    its second moments after the first ``first`` steps, float64), (the
    agent's, the same))."""
    pw = {n: t.detach().float().clone() for n, t in pose_w.items()}
    aw = {n: t.detach().float().clone() for n, t in agent_w.items()}
    o, a, aug = cfg["optim"], cfg["agent"], cfg["aug"]
    pose_opt = _RMSprop(pw, pose_params, o["rms_decay"], o["rms_eps"], o["lr"])
    agent_opt = _RMSprop(aw, agent_params, o["rms_decay"], o["rms_eps"], a["lr"])
    early = None
    scale_table, rot_table = bin_tables(cfg, next(iter(pw.values())).device)
    inp_res = tuple(aug["inp_res"])
    mean = torch.as_tensor(cfg["mean"], dtype=torch.float32)
    losses, agent_losses = [], []
    for t, b in enumerate(batches):
        if rows is not None:
            b = {k: v[:rows] for k, v in b.items()}
        index = b["index"]
        with torch.no_grad():
            tn = transform(b["center"], b["scale"], inp_res, torch.zeros_like(b["scale"]))
            x_n = crop(b["image"], tn, inp_res) - mean.to(tn.device)
        a_leaves = [aw[n].requires_grad_(True) for n in agent_params]
        lg = agent.logits(aw, x_n, convs=len(a["widths"]),
                          input_downscale=a["input_downscale"], quant=quant)
        si = sample_categorical(seed, t, index, STREAM_SCALE_BIN, lg["scale"].detach())
        ri = sample_categorical(seed, t, index, STREAM_ROT_BIN, lg["rot"].detach())
        flip = adversarial_flip(seed, t, index, aug["flip_prob"])
        jit = jitter_scales(seed, t, index) if aug["color_jitter"] else None
        with torch.no_grad():
            x_a, tgt_a = train_crops(b, scale_table[si], rot_table[ri], flip, jit, aug,
                                     cfg["mean"])
            x_r, tgt_r = train_crops(b, *aug_params(seed, t, index, aug), jit, aug,
                                     cfg["mean"])
            l_ref = per_sample(Net(pw, cfg["model"], train=False, quant=quant)(x_r), tgt_r)
        p_leaves = [pw[n].requires_grad_(True) for n in pose_params]
        l_adv = per_sample(Net(pw, cfg["model"], train=True, quant=quant, stats=pw)(x_a),
                           tgt_a)
        loss = l_adv.mean()
        pose_opt.step(pw, torch.autograd.grad(loss, p_leaves))
        gap = l_adv.detach() - l_ref
        m, m2 = gap.mean(), (gap * gap).mean()
        adv = (gap - m) / (torch.sqrt(torch.clamp(m2 - m * m, min=0.0)) + 1e-6)
        logp = (torch.log_softmax(lg["scale"], -1).gather(1, si[:, None])[:, 0]
                + torch.log_softmax(lg["rot"], -1).gather(1, ri[:, None])[:, 0])
        agent_loss = -(adv * logp).mean()
        agent_opt.step(aw, torch.autograd.grad(agent_loss, a_leaves))
        for leaf in a_leaves + p_leaves:
            leaf.requires_grad_(False)
        losses.append(float(loss.detach()))
        agent_losses.append(float(agent_loss.detach()))
        if t + 1 == first:
            early = ({n: v.clone() for n, v in pose_opt.added.items()},
                     {n: v.clone() for n, v in agent_opt.added.items()})
    per_step = {"loss": torch.tensor(losses, dtype=torch.float64),
                "agent_loss": torch.tensor(agent_losses, dtype=torch.float64)}
    return (per_step, ({n: pw[n] for n in pose_params}, early[0]),
            ({n: aw[n] for n in agent_params}, early[1]))
