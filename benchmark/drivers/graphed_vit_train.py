"""Graphed ViTPose training traffic: ``graphed_train``'s closed loop (the
program's K-step dispatch, one CUDA graph of K steps, fed from a pool of
superbatches on the card, each dispatch ended by the host's fetch of its
last loss) over the program's ViTPose, built through
``posetpu_torch.models.build_model`` and trained with its layer-decay
AdamW, the global-norm clip and the loss masked by the joints' weights.

Traffic keys: ``steps_per_dispatch`` (K), ``check_dispatches``, ``pool``
(distinct superbatches, cycled), ``frames`` (distinct person canvases),
``steps_per_epoch`` (the schedule's epoch in updates).

Set-up draws the benchmark's weights (``benchmark/weights_vit.py``), starts
from zero moments at update 0 (a fresh run), and runs the first
``check_dispatches`` dispatches through the same call the window makes:
their losses, AdamW's first moment after the first (the clipped gradient
times 1 - b1) and the parameters after the last are what ``check`` holds
to the plain reference (``benchmark/reference/vitpose_train.py``), computed
on the card after the program's state is freed, in float32 without TF32,
on all the batch's rows (the head's norms take the whole batch's
statistics), each block recomputed in the backward pass to fit.

The numbers (each a gap, 0 where the two agree), over the parameter
tensors ("leaves") whose reference gradient is at least a thousandth of
the median leaf's:

- ``grad_gap``: the worst leaf's ``||m_p - m_r||`` over the larger of its
  and the median leaf's ``||m_r||`` (m: the first moment after step 1, the
  signed gradient);
- ``median_grad_gap``: the median leaf's ``||m_p - m_r|| / ||m_r||``;
- ``change_gap``, ``median_change_gap``: the same of the norms of each
  leaf's change over the steps followed (``|‖Δp‖ - ‖Δr‖|``), over the
  elements whose reference gradient is at least ten times AdamW's eps:
  below it AdamW's update is the gradient over eps, and where the
  gradient is a rounding's size (the qkv bias's key third, whose
  gradient is 0 by the softmax's invariance to a shift of every key; late
  blocks' query and key weights) it is round-off magnified, which bf16
  and float32 magnify differently (the worst leaf read 0.12–0.17 of its
  change on every seed without the rule); the median over the leaves the
  reference moved (a LayerNorm scale near 1 under the warm-up's first
  rates, times 0.85 ** 33 at the bottom, moves by less than its ulp on
  both sides);
- ``loss_gap``, ``first_loss_gap``: the losses' relative gaps.

The window's records add the program's ``launches.attention`` counted in
the window (``attention_launches``) and one launch's operations
(``attention_ops``, ``benchmark/counts_vitpose.py``), for
``attention_roofline.vit``.
"""

from __future__ import annotations

import torch

from benchmark import counts, counts_vitpose
from benchmark.drivers import graphed_train
from benchmark.drivers.common import Phases, free, reference_precision
from benchmark.frozen.synthetic import train_pool
from benchmark.reference import vitpose_train
from benchmark.weights import load_
from benchmark.weights_vit import make_weights

KIND = "train"
TINY_GRAD = 1e-3
ATTENTION_LAUNCHES = "launches.attention"
# what the program holds as ViTPose-H's constants, which the configuration
# file states: (group, key, where in the program, the constant's name)
CONSTANTS = (("model", "patch_size", "posetpu_torch.models.vitpose", "PATCH_SIZE"),
             ("model", "patch_padding", "posetpu_torch.models.vitpose", "PATCH_PADDING"),
             ("model", "mlp_ratio", "posetpu_torch.models.vitpose", "MLP_RATIO"),
             ("model", "deconv_filters", "posetpu_torch.models.vitpose", "DECONV_FILTERS"),
             ("optim", "betas", "posetpu_torch.train.state", "ADAMW_BETAS"),
             ("optim", "adam_eps", "posetpu_torch.train.state", "ADAMW_EPS"),
             ("optim", "warmup_ratio", "posetpu_torch.train.state", "WARMUP_RATIO"))


class Ctx:
    pass


def port_configs(cfg):
    """The program's ``ViTConfig``, ``AugConfig`` and ``AdamWConfig`` of
    configuration file ``cfg``; raises where the file states a value of
    ``CONSTANTS`` other than the program's."""
    import importlib

    from posetpu_torch.configs import AdamWConfig, AugConfig, ViTConfig

    for group, key, module, name in CONSTANTS:
        held = getattr(importlib.import_module(module), name)
        stated = cfg[group][key]
        if (list(held) if isinstance(held, tuple) else held) != stated:
            raise ValueError(f"{group}.{key} is {stated}; the program holds {name} = {held}")
    fixed = {key for _, key, _, _ in CONSTANTS}

    def fields(group, drop=()):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in group.items()
                if k not in drop and k not in fixed}

    return (ViTConfig(**fields(cfg["model"], drop=("arch",))), AugConfig(**fields(cfg["aug"])),
            AdamWConfig(**fields(cfg["optim"], drop=("optimizer",))))


def setup(cfg, traffic, seed, device):
    from posetpu_torch.models import build_model
    from posetpu_torch.train import TrainState, make_dispatch_step, make_optimizer
    from posetpu_torch.utils import profiling

    c = Ctx()
    c.cfg, c.traffic, c.seed, c.device = cfg, traffic, seed, device
    c.phases = Phases(device)
    model_cfg, aug, optim = port_configs(cfg)
    with profiling.span("model.build"):
        with torch.device(device):
            c.model = build_model(model_cfg)
        c.weights = make_weights(c.model, seed, device)
        load_(c.model, c.weights)
    c.params = [n for n, _ in c.model.named_parameters()]
    opt = make_optimizer(c.model.param_groups(optim), optim, traffic["steps_per_epoch"])
    c.state = TrainState(c.model, opt)
    c.dispatch = make_dispatch_step(c.model, opt, aug, tuple(cfg["mean"]), seed=seed,
                                    mask_loss=c.model.masked_loss, clip_norm=optim.clip_norm,
                                    steps=traffic["steps_per_dispatch"], device=device)
    res, out = cfg["aug"]["inp_res"][0], cfg["aug"]["out_res"]
    c.pool = train_pool(seed + 1, traffic["pool"], traffic["steps_per_dispatch"],
                        cfg["batch"], res, traffic["frames"], device)
    c.phases.mark("built")
    m = cfg["model"]
    tokens = ((res + 2 * m["patch_padding"] - m["patch_size"]) // m["patch_size"] + 1) ** 2
    c.work = {"flops_per_image": counts_vitpose.train_step_flops(m, res),
              "raster_bytes_per_step": [counts.raster_bytes(cfg["batch"], m["classes"], *out)],
              "attention_ops": counts_vitpose.attention_ops(
                  cfg["batch"], m["num_heads"], tokens, m["embed_dim"] // m["num_heads"])}
    c.optim_counts = {k: profiling.counter(k) for k in ("optim.param_groups", "optim.params")}
    named = dict(c.model.named_parameters())
    opt.init_moments()
    losses = []
    for i in range(traffic["check_dispatches"]):
        losses.append(c.dispatch(c.state, graphed_train.superbatch(c.pool, i))["loss"])
        if i == 0:
            c.first_m = {n: opt.state[named[n]]["exp_avg"].detach().clone() for n in c.params}
    c.first_loss = torch.cat(losses).double().cpu()
    c.after = {n: named[n].detach().clone() for n in c.params}
    c.phases.mark("dispatched")
    return c


def window(c, seconds):
    """``graphed_train``'s window, with the attention calls counted."""
    from posetpu_torch.utils import profiling

    before = profiling.counter(ATTENTION_LAUNCHES)
    rec = graphed_train.window(c, seconds)
    rec["attention_launches"] = profiling.counter(ATTENTION_LAUNCHES) - before
    return rec


def program_side(c):
    """The program's readings of the first dispatches; frees its state."""
    prog = (c.first_loss, c.after, c.first_m)
    c.state = c.dispatch = c.model = c.after = c.first_m = None
    free(c.device)
    return prog


def check_batches(c):
    return [{f: v[d, i] for f, v in c.pool.items()}
            for d in range(c.traffic["check_dispatches"])
            for i in range(c.traffic["steps_per_dispatch"])]


def follow(c, **kw):
    """The reference's readings of the steps ``check`` follows."""
    reference_precision()
    model_cfg = dict(c.cfg["model"])
    return vitpose_train.follow(c.weights, c.params, check_batches(c), seed=c.seed,
                                model=model_cfg, aug=c.cfg["aug"], optim=c.cfg["optim"],
                                mean=c.cfg["mean"],
                                steps_per_epoch=c.traffic["steps_per_epoch"], **kw)


def _norm(t):
    return float(t.double().norm())


def numbers(prog, ref, start, floor):
    """``prog``, ``ref``: (losses, {leaf: parameter after}, {leaf: first
    moment after step 1}); ``start``: {leaf: parameter before};
    ``floor``: the least first moment of an element whose change is
    compared.  Returns ({number: value}, details); module docstring."""
    lp, pp, mp = prog
    lr, pr, mr = ref
    leaves = list(pr)
    gr = {n: _norm(mr[n]) for n in leaves}
    med = torch.tensor(list(gr.values())).median().item()
    keep = [n for n in leaves if gr[n] >= TINY_GRAD * med]
    gd = {n: _norm(mp[n] - mr[n]) for n in keep}
    moved = {n: mr[n].abs() >= floor for n in keep}
    cp = {n: _norm((pp[n] - start[n])[moved[n]]) for n in keep}
    cr = {n: _norm((pr[n] - start[n])[moved[n]]) for n in keep}
    cd = {n: abs(cp[n] - cr[n]) for n in keep}

    def worst(gap, base):
        m = torch.tensor([base[n] for n in keep]).median().item()
        rel = {n: gap[n] / max(base[n], m) for n in keep}
        name = max(rel, key=rel.get)
        return rel[name], name, m

    def median(gap, base):
        # a leaf whose reference did not move (a norm's scale of 1 under
        # an update below its ulp) has no relative gap; ``worst`` holds it
        return torch.tensor([gap[n] / base[n] for n in keep if base[n] > 0]).median().item()

    grad_gap, grad_leaf, med_g = worst(gd, gr)
    change_gap, change_leaf, med_c = worst(cd, cr)
    loss = ((lp.double() - lr.double()).abs() / lr.double().abs())
    out = {"loss_gap": float(loss.max()), "first_loss_gap": float(loss[0]),
           "grad_gap": grad_gap, "median_grad_gap": median(gd, gr),
           "change_gap": change_gap, "median_change_gap": median(cd, cr)}
    compared = sum(int(m.sum()) for m in moved.values())
    return out, {"grad_leaf": [grad_leaf, gd[grad_leaf], gr[grad_leaf], med_g],
                 "change_leaf": [change_leaf, cp[change_leaf], cr[change_leaf], med_c],
                 "leaves": len(leaves), "left_out": len(leaves) - len(keep),
                 "change_elements": [compared, sum(mr[n].numel() for n in keep)],
                 "losses": [float(v) for v in lp], "reference_losses": [float(v) for v in lr]}


def _floor(c):
    """The least first moment after step 1 of a compared change: a
    gradient of ten times AdamW's eps, times 1 - b1."""
    o = c.cfg["optim"]
    return (1.0 - o["betas"][0]) * 10.0 * o["adam_eps"]


def check(c):
    prog = program_side(c)
    start = {n: c.weights[n] for n in c.params}
    norms = []
    got, details = numbers(prog, follow(c, grad_norms=norms), start, _floor(c))
    # the reference's gradient norms before the clip: above clip_norm, the
    # clip scaled every step
    return got, {**details, "grad_norms": norms, "setup_phases": c.phases,
                 **c.optim_counts}


def calibrate(c):
    """The program's readings, the control's (the reference in fp8 in the
    program's place) and a planted fault's (the reference on the first
    half of each batch in the program's place)."""
    prog = program_side(c)
    start = {n: c.weights[n] for n in c.params}
    ref = follow(c)
    out = {}
    for name, side in (("program", prog), ("control", follow(c, quant=True)),
                       ("fault_half_batch", follow(c, rows=c.cfg["batch"] // 2))):
        out[name], out[name + "_details"] = numbers(side, ref, start, _floor(c))
        del side
    return out
