"""Loss, train step and validation step — counterpart of
``posetpu/train/step.py`` (``stacked_mse``, ``per_sample_stacked_mse``,
``make_train_step``, ``make_eval_step``).

The port's network returns (B, K, H, W) heatmaps, so the losses take
targets in that layout (the reference's take NHWC).  ``axis_name`` (data
parallelism), ``fuse_steps`` (K steps per XLA dispatch) and remat wait for
their slices.
"""

from __future__ import annotations

import torch

from posetpu_torch.aug.color import sample_jitter_scales
from posetpu_torch.aug.pipeline import (
    augment_batch,
    neutral_params,
    sample_aug_params_ps,
)
from posetpu_torch.eval.decode import final_preds, pck_counts, pck_from_counts
from posetpu_torch.utils.device import resolve_device


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


def make_train_step(model, optimizer, aug_cfg, mean, std=None, *, seed=0,
                    mask_loss=False, device="cuda"):
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
    ``target_weight`` of each joint.  ``metrics`` (``loss``, ``acc``) stay
    device tensors: the step never waits for the device.

    The model moves to ``device`` (default CUDA; raises without it unless
    ``device="cpu"``).
    """
    dev = resolve_device(device)
    model.to(dev)
    mean_t, std_t = _normalization(mean, std, dev)

    def train_step(state, batch):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer "
                             "than this train step was built for")
        b = _to_device(batch, dev)
        # module-level names: tests substitute the reference's draws
        params = sample_aug_params_ps(
            seed, state.step, b["index"],
            scale_factor=aug_cfg.scale_factor, rot_factor=aug_cfg.rot_factor,
            rot_prob=aug_cfg.rot_prob, flip_prob=aug_cfg.flip_prob,
            scale_mode=aug_cfg.scale_mode,
        )
        jitter = (sample_jitter_scales(seed, state.step, b["index"])
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
        outs = model(aug["input"])
        loss = stacked_mse(
            outs, aug["target"], aug["target_weight"] if mask_loss else None
        )
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        hit, cnt = pck_counts(outs[-1].detach(), aug["target"])
        state.step += 1
        return {"loss": loss.detach(), "acc": pck_from_counts(hit, cnt)[0]}

    return train_step


def make_eval_step(model, aug_cfg, mean, std=None, *, device="cuda"):
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
        loss = loss_sum / torch.clamp(mask.sum(), min=1.0)
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
