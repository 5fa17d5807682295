"""ViTPose's training step in plain float32 PyTorch: the keyed draws, the
crops and targets (``augment.py``), their joints' weights, the network in
train mode (``vitpose.py``), ``JointsMSELoss`` with target weights (each
squared error times its joint's weight, the mean over every element: the
same as weighing the difference, for weights of 0 or 1), the gradients,
the global-norm clip (torch's ``clip_grad_norm_``: every gradient times
``min(1, c / (||g|| + 1e-6))``), and torch's AdamW as ViTPose's mmcv runner
drives it: each parameter's rate ``lr(count) * decay ** (depth + 1 -
layer)`` (layer 0 the embeddings, ``i + 1`` block ``i``, ``depth + 1`` the
last norm and the head), no weight decay on 1-D tensors, biases and
``pos_embed``, the rate warmed up linearly over ``warmup_iters`` updates
from ``warmup_ratio`` times and dropped by ``gamma`` at each epoch of
``schedule``.

:func:`follow` runs ``len(batches)`` steps from the benchmark's weights
and zero moments (a fresh run), with TF32 off, and returns each step's
loss, the parameters after and AdamW's first moment after the first
step.
"""

from __future__ import annotations

import math

import torch

from benchmark.frozen.keyed import aug_params, jitter_scales
from benchmark.reference.augment import FLIP_PAIRS, map_points, train_crops, transform
from benchmark.reference.vitpose import Net, keep_scales


def joint_weights(b, flip, scale_f, rot, aug):
    """(B, K) float32: 1 where a joint is visible after the flip and its
    truncated point's integer window of +-3 sigma touches the heatmap
    (``augment.gaussians``' rule), else 0."""
    w = b["valid_wh"][:, 0].to(torch.float32)
    pts, vis, center = b["pts"], b["vis"], b["center"]
    K = pts.shape[1]
    perm = list(range(K))
    for i, j in FLIP_PAIRS[aug["dataset"]]:
        perm[i], perm[j] = perm[j], perm[i]
    cx = torch.where(flip, w - center[:, 0], center[:, 0])
    center = torch.stack([cx, center[:, 1]], dim=-1)
    mirrored = torch.stack([w[:, None] - pts[:, perm, 0], pts[:, perm, 1]], dim=-1)
    pts = torch.where(flip[:, None, None], mirrored, pts)
    vis = torch.where(flip[:, None], vis[:, perm], vis)
    H, W = aug["out_res"]
    tp = torch.trunc(map_points(pts, transform(center, b["scale"] * scale_f, (H, W), rot)))
    s3 = float(int(3 * aug["sigma"]))
    ix, iy = tp[..., 0], tp[..., 1]
    inside = (ix - s3 < W) & (iy - s3 < H) & (ix + s3 + 1 >= 0) & (iy + s3 + 1 >= 0)
    return ((vis > 0) & inside).to(torch.float32)


def layer_of(name, depth):
    if name == "pos_embed" or name.startswith("patch_embed."):
        return 0
    if name.startswith("blocks."):
        return int(name.split(".")[1]) + 1
    return depth + 1


def decays(name, shape):
    return not (len(shape) == 1 or name.endswith(".bias") or name == "pos_embed")


def lr_at(count, optim, steps_per_epoch):
    """The learning rate of update ``count`` (0 first)."""
    lr = optim["lr"] * optim["gamma"] ** sum(
        count >= int(e) * steps_per_epoch for e in optim["schedule"])
    warm = optim["warmup_iters"]
    if count < warm:
        lr *= 1.0 - (1.0 - count / warm) * (1.0 - optim["warmup_ratio"])
    return lr


def follow(weights, params, batches, *, seed, model, aug, optim, mean, steps_per_epoch,
           quant=False, rows=None, grad_norms=None):
    """``weights``: every named tensor the network reads (copied here);
    ``params``: the names of those that train, from zero moments at update
    count 0.  ``batches``: one batch a step, its ``index`` the samples'
    global indices (the draws' keys, the step's number the key's step).
    ``rows`` keeps only the first ``rows`` rows of each batch (a planted
    fault: half the batch left out); ``quant``: the fp8 control;
    ``grad_norms``, a list, takes each step's gradient norm before the
    clip.  Returns
    (each step's loss, {name: parameter after the last step}, {name:
    AdamW's first moment after the first step})."""
    # float32 products and convolutions, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = {n: t.detach().float().clone() for n, t in weights.items()}
    stats = {n: t for n, t in w.items() if "running_" in n}
    moments = {n: (torch.zeros_like(w[n]), torch.zeros_like(w[n])) for n in params}
    depth = model["vit_depth"]
    b1, b2 = optim["betas"]
    losses, first = [], None
    for step, b in enumerate(batches):
        if rows is not None:
            b = {k: v[:rows] for k, v in b.items()}
        scale_f, rot, flip = aug_params(seed, step, b["index"], aug)
        jitter = jitter_scales(seed, step, b["index"]) if aug["color_jitter"] else None
        with torch.no_grad():
            x, target = train_crops(b, scale_f, rot, flip, jitter, aug, mean)
            weight = joint_weights(b, flip, scale_f, rot, aug)
            keep = keep_scales(seed, step, b["index"], depth, model["drop_path_rate"])
        leaves = [w[n].requires_grad_(True) for n in params]
        heat = Net(w, model, train=True, quant=quant, remat=True, stats=stats)(x, keep)
        loss = (((heat - target) ** 2) * weight[:, :, None, None]).mean()
        grads = torch.autograd.grad(loss, leaves)
        del heat
        for leaf in leaves:
            leaf.requires_grad_(False)
        with torch.no_grad():
            if optim["clip_norm"]:
                total = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(g) for g in grads]))
                coef = torch.clamp(optim["clip_norm"] / (total + 1e-6), max=1.0)
                if grad_norms is not None:
                    grad_norms.append(float(total))
                for g in grads:
                    g.mul_(coef)
            lr, t = lr_at(step, optim, steps_per_epoch), step + 1
            for n, g in zip(params, grads):
                m, v = moments[n]
                p = w[n]
                lr_n = lr * optim["layer_decay"] ** (depth + 1 - layer_of(n, depth))
                if decays(n, p.shape):
                    p.mul_(1.0 - lr_n * optim["weight_decay"])
                m.lerp_(g, 1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = v.sqrt() / math.sqrt(1.0 - b2 ** t) + optim["adam_eps"]
                p.addcdiv_(m, denom, value=-lr_n / (1.0 - b1 ** t))
        losses.append(float(loss.detach()))
        if step == 0:
            first = {n: moments[n][0].clone() for n in params}
        del loss, grads, x, target
    return torch.tensor(losses, dtype=torch.float64), {n: w[n] for n in params}, first
