"""Graphed joint adversarial training traffic: the program's K-step joint
dispatch (``posetpu_torch.train.adversarial.make_joint_dispatch_step``,
one CUDA graph of K steps of the pose network and its augmentation
agent) fed, timed and checked as ``graphed_train`` feeds, times and
checks the pose-only dispatch, with the same keys, against the plain
reference ``benchmark/reference/joint_train.py``: both networks' losses,
gradients and changes.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark import counts
from benchmark.compare import train_numbers
from benchmark.drivers import graphed_train
from benchmark.drivers.common import Phases, free, port_configs, port_network, reference_precision
from benchmark.frozen.synthetic import train_pool
from benchmark.reference import joint_train
from benchmark.weights import load_, make_weights

KIND = "train"
window = graphed_train.window


class Ctx:
    pass


def setup(cfg, traffic, seed, device):
    from posetpu_torch.configs.config import AgentConfig
    from posetpu_torch.train import TrainState, make_optimizer
    from posetpu_torch.train.adversarial import (
        JointState,
        agent_from_config,
        make_joint_dispatch_step,
    )

    c = Ctx()
    c.cfg, c.traffic, c.seed, c.device = cfg, traffic, seed, device
    c.phases = Phases(device)
    aug, optim = port_configs(cfg)
    agent_cfg = {k: v for k, v in cfg["agent"].items() if k != "widths"}
    agent_cfg["occ_levels"] = tuple(agent_cfg["occ_levels"])
    port = SimpleNamespace(name=cfg["name"], aug=aug, optim=optim,
                           agent=AgentConfig(enabled=True, **agent_cfg),
                           model=SimpleNamespace(bf16=cfg["model"]["bf16"]))
    spe, k = traffic["steps_per_epoch"], traffic["steps_per_dispatch"]
    pose = port_network(cfg, device)
    agent, agent_opt, joint_kw = agent_from_config(
        port, steps_per_epoch=spe, widths=tuple(cfg["agent"]["widths"]), device=device)
    c.pose_w = make_weights(pose, seed, device)
    c.agent_w = make_weights(agent, seed + 3, device)
    load_(pose, c.pose_w)
    load_(agent, c.agent_w)
    pose_opt = make_optimizer(pose.parameters(), optim, spe)
    c.state = JointState(TrainState(pose, pose_opt), TrainState(agent, agent_opt))
    c.dispatch = make_joint_dispatch_step(pose, agent, pose_opt, agent_opt, aug,
                                          tuple(cfg["mean"]), seed=seed, steps=k,
                                          device=device, **joint_kw)
    res, out = cfg["aug"]["inp_res"][0], cfg["aug"]["out_res"]
    c.pool = train_pool(seed + 1, traffic["pool"], k, cfg["batch"], res, traffic["frames"],
                        device)
    named_p, named_a = dict(pose.named_parameters()), dict(agent.named_parameters())
    c.pose_params, c.agent_params = list(named_p), list(named_a)
    pose_opt.init_moments()
    agent_opt.init_moments()
    joints, batch = cfg["model"]["classes"], cfg["batch"]
    c.work = {"flops_per_image": counts.joint_step_flops(cfg["model"], cfg["agent"], res),
              # the neutral crop's targets, then the pair of crops' in one launch
              "raster_bytes_per_step": [counts.raster_bytes(batch, joints, *out),
                                        counts.raster_bytes(2 * batch, joints, *out)]}
    c.phases.mark("built")
    losses, agent_losses = [], []
    for i in range(traffic["check_dispatches"]):
        m = c.dispatch(c.state, graphed_train.superbatch(c.pool, i))
        losses.append(m["loss"])
        agent_losses.append(m["agent_loss"])
        if i == 0:
            nu_p = {n: pose_opt.state[p]["nu"].double() for n, p in named_p.items()}
            nu_a = {n: agent_opt.state[p]["nu"].double() for n, p in named_a.items()}
    c.first = {"loss": torch.cat(losses).double().cpu(),
               "agent_loss": torch.cat(agent_losses).double().cpu()}
    c.pose_after = ({n: p.detach().clone() for n, p in named_p.items()}, nu_p)
    c.agent_after = ({n: p.detach().clone() for n, p in named_a.items()}, nu_a)
    c.phases.mark("dispatched")
    return c


def numbers(prog, ref, c):
    """The pose network's numbers, and the agent's under ``agent_``."""
    (lp, pp, ap), (lr, pr, ar) = prog, ref
    pose, details = train_numbers((lp["loss"], *pp), (lr["loss"], *pr),
                                  {n: c.pose_w[n] for n in c.pose_params})
    agent, _ = train_numbers((lp["agent_loss"], *ap), (lr["agent_loss"], *ar),
                             {n: c.agent_w[n] for n in c.agent_params})
    return {**pose, **{f"agent_{n}": v for n, v in agent.items()}}, details


def program_side(c):
    prog = (c.first, c.pose_after, c.agent_after)
    c.state = c.dispatch = None
    free(c.device)
    return prog


def follow(c, **kw):
    reference_precision()
    return joint_train.follow(c.pose_w, c.pose_params, c.agent_w, c.agent_params,
                              graphed_train.check_batches(c),
                              first=c.traffic["steps_per_dispatch"], seed=c.seed,
                              cfg=c.cfg, **kw)


def check(c):
    got, details = numbers(program_side(c), follow(c), c)
    return got, {**details, "setup_phases": c.phases}


def calibrate(c):
    """The program's readings, the control's (the reference in fp8 in the
    program's place) and a planted fault's (the reference on the first half
    of each batch)."""
    prog = program_side(c)
    ref = follow(c)
    out = {}
    for name, side in (("program", prog), ("control", follow(c, quant=True)),
                       ("fault_half_batch", follow(c, rows=c.cfg["batch"] // 2))):
        out[name], out[name + "_details"] = numbers(side, ref, c)
    return out
