"""Profiling and duty-cycle measurement — the counterpart of
``posetpu/utils/profiling.py``.

* :func:`trace` wraps a block in ``torch.profiler`` (CPU activity, and CUDA
  activity where a card is present) and writes a Chrome trace
  (``chrome://tracing``, Perfetto) into a directory;
  :mod:`posetpu_torch.tools.profile_step` reads it.
* :class:`DeviceTimer` is the card's clock: pairs of CUDA events around
  units of work on the current stream.
* :func:`time_device_step` is the device time of a train (or joint) step:
  K steps replayed as one CUDA graph over one batch resident on the card.
* :func:`measure_duty_cycle` and :func:`measure_duty_cycle_fused` are the
  device-busy share of the real pipeline (loader, copy, step), the device
  time over the wall time a step: duty = t_dev / t_wall.

How the port's arguments map to the reference's.  The reference's steps take
a PRNG key and are jitted by these functions; the port's take none (their
draws are keyed on (seed, step, sample index), ``aug/keyed.py``) and come
built: a *dispatch* is what :func:`posetpu_torch.train.step.make_dispatch_step`
or :func:`posetpu_torch.train.adversarial.make_joint_dispatch_step` returns,
``dispatch(state, superbatch) -> metrics`` over a (k, B, ...) superbatch of
k <= ``dispatch.steps`` loader batches, advancing ``state`` in place.

- ``time_device_step(dispatch, state, batch)``: the reference's
  ``steps``-long ``lax.scan`` is one replay of a dispatch of K =
  ``dispatch.steps`` steps (its ``steps=10`` is such a dispatch of 10) over
  ``batch`` stacked K times on the card;
- ``measure_duty_cycle(step, dispatch, state, loader)``: ``step`` is the
  driver's dispatch of one step over ``loader``'s (1, B, ...) superbatches
  (``HostLoader(group=1)``, as :class:`posetpu_torch.train.loop.Experiment`
  wires it), the reference's jitted ``step_fn``; ``dispatch`` times the
  device, as the reference's ``time_device_step(step_fn, ...)`` does;
- ``measure_duty_cycle_fused(step, dispatch, state, loader)``: ``step`` is
  a dispatch of K steps over ``loader``'s (K, B, ...) superbatches, the
  reference's ``jax.jit(fuse_steps(step_fn))``.

On CUDA the device time comes from CUDA events around the replay and ends
with a fetch of the last loss to the host; the wall time is the host's
clock, ended by such a fetch (every step of the chain is then done).  On
the CPU the same logic runs, timed by the host's clock.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# steps of the reference's time_device_step scan (its default ``steps``)
DEVICE_STEPS = 10


@contextlib.contextmanager
def trace(logdir):
    """Profile the block; on exit, wait for the card and write
    ``<logdir>/trace_<pid>.json``.  Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def _fetch(metrics):
    """One scalar of a step's metrics read on the host: the wait for every
    step before it."""
    m = metrics["loss"] if isinstance(metrics, dict) and "loss" in metrics else (
        next(iter(metrics.values())) if isinstance(metrics, dict) else metrics)
    return float(torch.as_tensor(m).reshape(-1)[-1])


def _device(dispatch):
    return getattr(dispatch, "dev", None) or torch.device("cpu")


def _stack(batch, k, dev):
    """``batch`` (B, ...) fields as a (k, B, ...) superbatch on ``dev``."""
    out = {}
    for n, v in batch.items():
        t = torch.as_tensor(v).to(dev)
        out[n] = t.unsqueeze(0).expand(k, *t.shape).contiguous()
    return out


def _leading(superbatch):
    return next(iter(superbatch.values())).shape[0]


class DeviceTimer:
    """The card's clock: a pair of CUDA events around each unit of work
    enqueued on the current stream, ``with timer.span(): ...`` or
    :meth:`start` then :meth:`stop`.  An event fires when the stream
    reaches it, so a span holds the stream's work between the two and any
    wait of the stream for the host inside it: start a span once the
    host's own part of the unit (a staging copy, a decode) is done."""

    def __init__(self):
        self._spans = []
        self._start = None

    def start(self):
        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record()

    def stop(self):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._spans.append((self._start, end))
        self._start = None

    @contextlib.contextmanager
    def span(self):
        self.start()
        yield
        self.stop()

    def ms(self):
        """The ms of every span so far (waits for the last)."""
        out = []
        for start, end in self._spans:
            end.synchronize()
            out.append(start.elapsed_time(end))
        return out


def time_device_step(dispatch, state, batch, warmup=1):
    """Average device time of one step: ``batch`` stacked K =
    ``dispatch.steps`` times on the device, ``warmup`` dispatches (the
    first captures the graph), then one timed dispatch ended by a fetch of
    its last loss (module docstring).  ``state`` advances by
    (``warmup`` + 1) x K steps.  Returns (seconds a step, state)."""
    k = dispatch.steps
    dev = _device(dispatch)
    superbatch = _stack(batch, k, dev)
    for _ in range(warmup):
        _fetch(dispatch(state, superbatch))
    if dev.type == "cuda":
        timer = DeviceTimer()
        with timer.span():
            m = dispatch(state, superbatch)
        _fetch(m)
        seconds = timer.ms()[0] / 1e3
    else:
        t0 = time.perf_counter()
        _fetch(dispatch(state, superbatch))
        seconds = time.perf_counter() - t0
    return seconds / k, state


def _first_batch(superbatch):
    return {n: v[0] for n, v in superbatch.items()}


def measure_duty_cycle(step, dispatch, state, loader, max_steps=30):
    """Duty cycle of the real pipeline (loader -> copy -> step, enqueued
    without waiting): ``step`` is a dispatch of one step over ``loader``'s
    (1, B, ...) superbatches, ``dispatch`` the dispatch that
    :func:`time_device_step` times the device with (module docstring).
    The first superbatch times the device, then warms ``step`` (its graph
    is captured outside the timed loop); a fresh pass of ``loader`` then
    runs at most ``max_steps`` steps.  Returns (duty, t_device, t_wall),
    seconds a step, the duty at most 1."""
    first = next(iter(loader))
    t_dev, state = time_device_step(dispatch, state, _first_batch(first))
    # warm the per-step graph too: its capture must not land in the loop
    _fetch(step(state, first))

    n = 0
    m = None
    t0 = time.perf_counter()
    for batch in loader:
        if n >= max_steps:
            break
        m = step(state, batch)
        n += 1
    if m is None:
        raise ValueError(
            "loader yielded no batches after the two warmup steps — pass a "
            "restartable loader (not an exhausted one-shot iterator)"
        )
    _fetch(m)  # one stream: every step before it is done
    t_wall = (time.perf_counter() - t0) / n
    return min(t_dev / t_wall, 1.0), t_dev, t_wall


def measure_duty_cycle_fused(step, dispatch, state, loader, max_dispatches=8):
    """Duty cycle of the K-steps-per-dispatch path
    (``Experiment(steps_per_dispatch=K)``): ``step`` is a dispatch of K
    steps and ``loader`` yields (K, B, ...) superbatches (``group=K``);
    ``dispatch`` times the device on one batch of the first superbatch
    (:func:`time_device_step`).  A superbatch of fewer than K steps (the
    ragged last group of a split that is not whole K x B groups) is
    skipped, never dispatched: its decode stays in the wall time, and the
    steps are counted as run.  Returns (duty, t_device a step, t_wall a
    step), the duty at most 1."""

    def endless():
        while True:
            got = False
            for b in loader:
                got = True
                yield b
            if not got:
                raise ValueError(
                    "loader yielded no superbatches — an exhausted one-shot "
                    "iterator would spin here forever"
                )

    it = endless()
    first = next(it)
    k = _leading(first)
    t_dev, state = time_device_step(dispatch, state, _first_batch(first))
    _fetch(step(state, first))  # capture + warm

    n = 0
    steps = 0
    skipped = 0
    m = None
    t0 = time.perf_counter()
    while n < max_dispatches:
        b = next(it)
        bk = _leading(b)
        if bk != k:
            skipped += 1
            if skipped > 8 * max_dispatches:
                raise ValueError(
                    f"loader keeps yielding ragged superbatches (leading dim "
                    f"!= {k}); configure group=K with a dataset sized to "
                    "whole K*B groups"
                )
            # a short group would run eagerly, outside the graph, and fewer
            # than k steps: skip it, its decode stays in the wall time
            continue
        m = step(state, b)
        n += 1
        steps += bk
    _fetch(m)  # one stream: every dispatch before it is done
    t_wall = (time.perf_counter() - t0) / max(steps, 1)
    return min(t_dev / t_wall, 1.0), t_dev, t_wall
