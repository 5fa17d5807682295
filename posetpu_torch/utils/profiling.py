"""Profiling and duty-cycle measurement — the counterpart of
``posetpu/utils/profiling.py``.

* :func:`span`, :func:`device_span` and :func:`count` are the program's
  own spans and counters, one registry (:class:`Registry`, the process's
  :data:`REGISTRY`) for every layer: the loader's producer and consumer,
  the decoder's stages, the dispatch and its graph's capture and replay,
  serving's staging and replay, the kernels' builds and launches.
* :func:`trace` wraps a block in ``torch.profiler`` (CPU activity, and CUDA
  activity where a card is present) and writes a Chrome trace
  (``chrome://tracing``, Perfetto) into a directory, the host and device
  spans of every thread merged in on rows of their own, and the counters'
  counts in the block as counter tracks;
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

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import _profiler_enabled

# steps of the reference's time_device_step scan (its default ``steps``)
DEVICE_STEPS = 10

# the records a registry keeps, the newest
RING = 1 << 16
# the Chrome trace's rows of a thread's spans: this plus the thread's id;
# of its device spans: DEVICE_ROWS plus the thread's id
SPAN_ROWS = 1 << 32
DEVICE_ROWS = 1 << 50


class Record:
    """One span: ``name``, the thread's ``tid`` (``threading.get_ident``)
    and ``thread`` name, ``start_ns`` and ``end_ns`` on the profiler's clock
    (Unix-epoch ns), its own ``id``, its ``parent``'s id (None at the
    top of its thread's stack), its ``unit`` and ``marks`` (a dict).  A
    device span (``device`` true) holds the pair of CUDA events around its
    work on the card, read by :attr:`ms`; its stamps are the host's, around
    the enqueue."""

    __slots__ = ("name", "tid", "thread", "start_ns", "end_ns", "id", "parent", "unit",
                 "marks", "device", "_events", "_ms")

    def __init__(self, name, start_ns, end_ns, id, parent, unit, marks, events=None):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        t = threading.current_thread()
        self.tid, self.thread = t.ident, t.name
        self.id, self.parent, self.unit, self.marks = id, parent, unit, marks
        self.device = events is not None
        self._events, self._ms = events, None

    @property
    def ms(self):
        """The span's ms: the host's, or for a device span the card's
        between its two events (waits for the second)."""
        if not self.device:
            return (self.end_ns - self.start_ns) / 1e6
        if self._ms is None:
            start, end = self._events
            end.synchronize()
            self._ms, self._events = start.elapsed_time(end), None
        return self._ms


class _Off:
    """What :func:`span` gives while tracing is off: it records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        return False

    def mark(self, key, value=True):
        pass

    def cancel(self):
        pass


OFF = _Off()


class _Stack(threading.local):
    def __init__(self):
        self.spans = []  # the thread's open spans
        self.unit = None  # the unit a span without one takes at the top


class _Span:
    __slots__ = ("reg", "name", "unit", "parent", "id", "marks", "start", "range", "keep",
                 "events", "stream")

    def __init__(self, reg, name, unit, profiled, stream=None, device=False):
        self.reg, self.name, self.unit, self.marks, self.keep = reg, name, unit, {}, True
        self.range = torch.profiler.record_function(name) if profiled and not device else None
        self.events = None
        if device:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.stream = stream

    def mark(self, key, value=True):
        """Set ``marks[key]`` of the span's record."""
        self.marks[key] = value

    def cancel(self):
        """Record nothing of this span (its children stay)."""
        self.keep = False

    def __enter__(self):
        stack = self.reg._stack
        spans = stack.spans
        parent = spans[-1] if spans else None
        self.parent = parent and parent.id
        self.id = next(self.reg._ids)
        if self.unit is None:
            self.unit = parent.unit if parent else (stack.unit if stack.unit is not None
                                                    else ("span", self.id))
        if self.events is not None:
            self.events[0].record(self.stream)
        else:
            spans.append(self)
            if self.range is not None:
                self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        else:
            if self.range is not None:
                self.range.__exit__(*exc)
            self.reg._stack.spans.pop()
        if self.keep:
            off = self.reg.offset_ns
            self.reg._add(Record(self.name, self.start + off, end + off, self.id, self.parent,
                                 self.unit, self.marks, self.events))
        return False


class Registry:
    """The program's spans and counters.

    A span (:meth:`span`) is recorded only while tracing is on: while
    :func:`trace` runs, and while a ``torch.profiler`` is active on the
    thread that drives the loop.  The profiler's flag is the thread's own,
    so each span asks it (``torch.autograd._profiler_enabled``, a fraction
    of a microsecond) and the thread that finds it set publishes tracing to
    the process; spans on other threads (a loader's producer) follow that,
    and the driving thread takes it back at its first span after its
    profiler stops.  A span on a thread whose profiler is active also opens
    ``torch.profiler.record_function(name)``, so the profiler's trace holds
    it.  Off, a span costs that flag read and records nothing.

    Each record (:class:`Record`) holds its parent, from the thread's stack
    of open spans, and a *unit*: the work it belongs to, shared by every
    span of one batch or dispatch across threads.  A span given none takes
    its parent's, else the thread's (:meth:`set_unit`), else a unit of its
    own.  The newest ``size`` records are kept, stamped on the profiler's
    clock: ``time.perf_counter_ns()`` shifted to Unix-epoch ns by an offset
    measured when tracing turns on.

    Counters (:meth:`count`) are always on: exact sums, under a lock, for
    the loaders' threads."""

    __slots__ = ("_lock", "_counters", "_ring", "_ids", "_stack", "published", "driving",
                 "forced", "offset_ns")

    def __init__(self, size=RING):
        self._lock = threading.Lock()
        self._counters = {}
        self._ring = collections.deque(maxlen=size)
        self._ids = itertools.count(1)
        self._stack = _Stack()
        self.published = False  # a driving thread's profiler is on
        self.driving = None  # that thread's ident
        self.forced = 0  # trace() blocks open
        self.offset_ns = 0

    # -- tracing on and off -------------------------------------------------------

    def _turned_on(self):
        if not (self.published or self.forced):
            self.offset_ns = time.time_ns() - time.perf_counter_ns()

    @property
    def tracing(self):
        return self.published or self.forced

    @contextlib.contextmanager
    def forced_on(self):
        """Tracing on in the block, for every thread."""
        with self._lock:
            self._turned_on()
            self.forced += 1
        try:
            yield
        finally:
            with self._lock:
                self.forced -= 1

    # -- spans --------------------------------------------------------------------

    def span(self, name, unit=None):
        """A context manager: the block's span ``name`` while tracing is on
        (:class:`Registry`); its ``mark(key, value=True)`` sets a mark of
        the record and ``cancel()`` drops it."""
        if _profiler_enabled():  # this thread's profiler: tracing on, published
            if not self.published:
                self._turned_on()
                self.driving, self.published = threading.get_ident(), True
            return _Span(self, name, unit, True)
        if self.published and self.driving == threading.get_ident():
            self.published = False  # the driving thread's profiler has stopped
        if self.published or self.forced:
            return _Span(self, name, unit, False)
        return OFF

    def device_span(self, name, stream=None):
        """While tracing is on, a pair of CUDA events on ``stream`` (the
        current stream) around the block's work there, recorded as a device
        span (:attr:`Record.ms` reads the card's time) of the thread's open
        span and unit; nothing otherwise.  It asks no profiler: open it
        inside a :meth:`span`."""
        if not (self.published or self.forced):
            return OFF
        return _Span(self, name, None, False, stream, device=True)

    def set_unit(self, unit):
        """The unit of this thread's spans that open with no parent and
        none given (a batch the thread took from a loader)."""
        self._stack.unit = unit

    def _add(self, rec):
        with self._lock:
            self._ring.append(rec)

    def watermark(self):
        """An id below every span opened from now on (:meth:`records`)."""
        return next(self._ids)

    def records(self, name=None, since=0):
        """The records kept (named ``name``, opened after :meth:`watermark`
        gave ``since``), oldest first by their end."""
        with self._lock:
            recs = list(self._ring)
        return [r for r in recs if r.id > since and (name is None or r.name == name)]

    def window(self, name=None):
        """The records (named ``name``) of the windows a driving thread's
        profiler traced: those that ended by the end of that thread's last
        span.  A span of another thread still open when the profiler stopped
        ends in no window: the profiler's teardown holds the interpreter's
        lock for seconds, and such a span would count that wait as its own.
        Every record where no profiler drove tracing (:func:`trace`'s)."""
        with self._lock:
            recs = list(self._ring)
        ends = [r.end_ns for r in recs if r.tid == self.driving]
        last = max(ends) if ends else None
        return [r for r in recs if (name is None or r.name == name)
                and (last is None or r.end_ns <= last)]

    # -- counters -----------------------------------------------------------------

    def count(self, name, n=1):
        """Add ``n`` to counter ``name``."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name):
        """Counter ``name``'s value (0 before its first count)."""
        return self._counters.get(name, 0)

    def counters(self, prefix=""):
        """Every counter whose name starts with ``prefix``."""
        with self._lock:
            return {k: v for k, v in self._counters.items() if k.startswith(prefix)}

    def reset_counters(self, *prefixes):
        """Zero the counters whose names start with one of ``prefixes``."""
        with self._lock:
            for k in self._counters:
                if k.startswith(prefixes):
                    self._counters[k] = 0

    def reset(self):
        """Drop every record and counter, tracing's published state and
        driving thread, and this thread's unit."""
        with self._lock:
            self._ring.clear()
            self._counters.clear()
            self.published, self.driving = False, None
        self._stack.unit = None


# the process's registry, and its methods as the module's functions
REGISTRY = Registry()
span = REGISTRY.span
device_span = REGISTRY.device_span
set_unit = REGISTRY.set_unit
records = REGISTRY.records
window = REGISTRY.window
count = REGISTRY.count
counter = REGISTRY.counter
counters = REGISTRY.counters
reset_counters = REGISTRY.reset_counters


def merge_spans(path, recs, counts=()):
    """Write the spans ``recs`` into the Chrome trace at ``path`` as
    complete events, shifted by the trace's own base time onto its
    timeline.  A thread's host spans go on a row of their own (``SPAN_ROWS``
    + its id, named "spans: <thread>"), its device spans on another
    (``DEVICE_ROWS`` + its id, "device spans: <thread>"): each lasts the
    card's ms between its events and starts at its host stamp (its enqueue)
    or at the end of the thread's device span before it, whichever is
    later, as one stream runs its work; the card may have begun it later
    still.  ``counts``: (Unix-epoch ns, {counter: value}) samples, written
    as counter events, each counter's value less its first sample's (0
    where a sample lacks it)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events, rows, ends = doc["traceEvents"], {}, {}
    for r in recs:
        if r.device:
            tid, label = DEVICE_ROWS + r.tid, "device spans"
            start = max(r.start_ns, ends.get(tid, 0))
            end = ends[tid] = start + round(r.ms * 1e6)
        else:
            tid, label, start, end = SPAN_ROWS + r.tid, "spans", r.start_ns, r.end_ns
        if tid not in rows:
            rows[tid] = r.thread
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                           "args": {"name": f"{label}: {r.thread}"}})
        events.append({"ph": "X", "cat": "span", "name": r.name, "pid": pid, "tid": tid,
                       "ts": (start - base) / 1e3, "dur": (end - start) / 1e3,
                       "args": {"id": r.id, "parent": r.parent, "unit": repr(r.unit),
                                **{k: repr(v) for k, v in r.marks.items()}}})
    first = counts[0][1] if counts else {}
    names = sorted({n for _, values in counts for n in values})
    for stamp, values in counts:
        for name in names:
            events.append({"ph": "C", "cat": "counter", "name": name, "pid": pid,
                           "ts": (stamp - base) / 1e3,
                           "args": {"value": values.get(name, 0) - first.get(name, 0)}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir):
    """Profile the block with tracing on (:class:`Registry`); on exit, wait
    for the card and write ``<logdir>/trace_<pid>.json``, every thread's
    spans of the block merged in, and every counter's count in the block
    at its start and its end (:func:`merge_spans`).  Yields the
    ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    since = REGISTRY.watermark()
    with REGISTRY.forced_on(), profile(activities=activities) as prof:
        counts = [(time.time_ns(), REGISTRY.counters())]
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        counts.append((time.time_ns(), REGISTRY.counters()))
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    merge_spans(path, REGISTRY.records(since=since), counts)


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
