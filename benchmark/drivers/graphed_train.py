"""Graphed training traffic: the program's K-step dispatch
(``posetpu_torch.train.make_dispatch_step``, one CUDA graph of K steps)
fed from a pool of superbatches that stays on the card, in a closed loop:
each dispatch ends with the host's fetch of its last loss.

Traffic keys: ``steps_per_dispatch`` (K), ``pool`` (distinct superbatches,
cycled), ``steps_per_epoch`` (the learning rate's schedule, as an epoch of
the configuration's data set would set it), ``moment_rms`` (the starting
second moments' scale, ``benchmark/weights.py:make_moments``: a run
resumed mid-way, whose RMSprop steps scale with the gradient; from zero
moments the first step moves every element by about 10 learning rates
whatever its gradient, and a gradient whose sign rounding flips moves the
other way).

Set-up builds the state from the benchmark's weights and moments and runs
the first
dispatch through the same call the window makes; its K losses, and the
parameters and the optimizer's moments after it, are what ``check`` holds
to the plain reference (``benchmark/reference/pose_train.py``) once the
window has closed.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from benchmark import counts
from benchmark.compare import train_numbers
from benchmark.drivers.common import (
    Clock,
    Phases,
    free,
    port_configs,
    port_network,
    reference_precision,
)
from benchmark.frozen.synthetic import train_pool
from benchmark.reference import pose_train
from benchmark.weights import load_, make_weights

KIND = "train"


class Ctx:
    pass


def make_step(cfg, traffic, seed, model, device):
    """(state, dispatch) of the program over ``model``."""
    from posetpu_torch.train import TrainState, make_dispatch_step, make_optimizer

    aug, optim = port_configs(cfg)
    opt = make_optimizer(model.parameters(), optim, traffic["steps_per_epoch"])
    dispatch = make_dispatch_step(model, opt, aug, tuple(cfg["mean"]), seed=seed,
                                  steps=traffic["steps_per_dispatch"], device=device)
    return TrainState(model, opt), dispatch


def superbatch(pool, i):
    return {k: v[i] for k, v in pool.items()}


def setup(cfg, traffic, seed, device):
    c = Ctx()
    c.cfg, c.traffic, c.seed, c.device = cfg, traffic, seed, device
    c.phases = Phases(device)
    c.model = port_network(cfg, device)
    c.weights = make_weights(c.model, seed, device)
    load_(c.model, c.weights)
    c.params = [n for n, _ in c.model.named_parameters()]
    c.state, c.dispatch = make_step(cfg, traffic, seed, c.model, device)
    res, out = cfg["aug"]["inp_res"][0], cfg["aug"]["out_res"]
    c.pool = train_pool(seed + 1, traffic["pool"], traffic["steps_per_dispatch"],
                        cfg["batch"], res, traffic["frames"], device)
    c.phases.mark("built")
    c.work = {"flops_per_image": counts.train_step_flops(cfg["model"], res),
              "raster_bytes_per_step": [counts.raster_bytes(cfg["batch"],
                                                            cfg["model"]["classes"], *out)]}
    named = dict(c.model.named_parameters())
    opt = c.state.optimizer
    opt.init_moments()
    c.first_loss, c.first_nu = first_dispatches(c, opt, named)
    c.after = {n: named[n].detach().clone() for n in c.params}
    c.phases.mark("dispatched")
    return c


def first_dispatches(c, opt, named):
    """Run the dispatches that ``check`` follows (the first captures):
    (their losses, {leaf: the second moment after the first}, float64)."""
    losses, first = [], None
    for i in range(c.traffic["check_dispatches"]):
        losses.append(c.dispatch(c.state, superbatch(c.pool, i))["loss"])
        if i == 0:
            first = {n: opt.state[named[n]]["nu"].double() for n in named}
    return torch.cat(losses).double().cpu(), first


def window(c, seconds):
    """Dispatches over the pool, each ended by a fetch, until ``seconds``
    have passed; the records of the window."""
    clock = Clock(c.device)
    k, batch, n = c.traffic["steps_per_dispatch"], c.cfg["batch"], 0
    t0 = time.perf_counter()
    while True:
        sb = superbatch(c.pool, (n + c.traffic["check_dispatches"]) % c.traffic["pool"])
        with record_function("bench.dispatch"):
            clock.start()
            m = c.dispatch(c.state, sb)
            clock.stop()
        with record_function("bench.fetch"):
            float(m["loss"][-1])
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    return {"kind": KIND, "images": n * k * batch, "steps": n * k, "units": n,
            "window_s": window_s, "spans_ms": clock.ms(), **c.work}


def program_side(c):
    """The program's readings of the first dispatch; frees its state."""
    prog = (c.first_loss, c.after, c.first_nu)
    c.state = c.dispatch = c.model = None
    free(c.device)
    return prog


def check_batches(c):
    """The batches of the dispatches ``check`` follows, one a step."""
    return [{f: v[d, i] for f, v in c.pool.items()}
            for d in range(c.traffic["check_dispatches"])
            for i in range(c.traffic["steps_per_dispatch"])]


def follow(c, **kw):
    reference_precision()
    return pose_train.follow(c.weights, c.params, check_batches(c),
                             first=c.traffic["steps_per_dispatch"], seed=c.seed,
                             model=c.cfg["model"], aug=c.cfg["aug"], optim=c.cfg["optim"],
                             mean=c.cfg["mean"], **kw)


def check(c):
    """({number: value}, details) of the program against the reference."""
    prog = program_side(c)
    start = {n: c.weights[n] for n in c.params}
    numbers, details = train_numbers(prog, follow(c), start)
    return numbers, {**details, "setup_phases": c.phases}


def calibrate(c):
    """The readings that set the limits: the program's, the control's (the
    reference in fp8 in the program's place) and a planted fault's (the
    reference in the program's place on the first half of each batch)."""
    prog = program_side(c)
    start = {n: c.weights[n] for n in c.params}
    ref = follow(c)
    out = {}
    for name, side in (("program", prog), ("control", follow(c, quant=True)),
                       ("fault_half_batch", follow(c, rows=c.cfg["batch"] // 2))):
        out[name], out[name + "_details"] = train_numbers(side, ref, start)
    return out
