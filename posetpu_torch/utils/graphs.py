"""One CUDA graph per input shape — the port's counterpart of ``jax.jit``
and its per-shape cache, for a function that reads weights but advances no
state of its own: the serving forward (:class:`posetpu_torch.infer.PosePredictor`)
and the validation step (:func:`posetpu_torch.train.step.make_graphed_eval_step`).

The rules, as :class:`posetpu_torch.train.step.GraphedSteps` keeps them for
training:

- the graph of an input signature (each field's name, shape and dtype) is
  captured at its first call, after ``WARMUP_CALLS`` calls of the function
  on a side stream (cuDNN and cuBLAS handles, the kernels' library, lazily
  made constants); the warm-up's kernel launches run and count, the
  capture's count once per replay (:func:`posetpu_torch.utils.profiling.add_replay`);
- every graph reads the weights where they were at its capture: when a
  weight's storage has moved (``load_state_dict`` of a module copies in
  place, a ``.to()`` or a parameter replaced does not), every graph is
  dropped and captured again at its next call (:class:`GraphCache` says
  how a call finds that out without walking the module tree);
- the inputs are copied into the graph's static buffers *outside* the
  capture (a capture refuses host-to-card copies): a CUDA tensor card to
  card; host data first into a pinned staging buffer of the graph's own,
  then without blocking, so the host only waits for the previous copy out
  of the same staging buffer before it overwrites it;
- a capture or replay that fails raises; nothing falls back to eager calls.

Memory: the graphs of one :class:`ShapeGraphs` share one memory pool, which
holds each graph's temporaries and its static outputs.  A replay may write
into memory that another graph's outputs occupy, so a graph's outputs hold
until the next replay of any graph of the same object: the caller copies
them out (a clone, or a copy to the host) on the current stream before it
replays again, and stream order does the rest.  The static input buffers
and the pinned staging buffers are ordinary allocations, one set per
signature.
"""

from __future__ import annotations

import operator
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.nn.modules import module as nn_module

from posetpu_torch.utils import profiling

# calls of the function on a side stream before each capture
WARMUP_CALLS = 1


@dataclass
class _ShapeGraph:
    """One signature's graph, its static inputs and outputs, the pinned
    staging buffers of its host inputs, the event after their last copy,
    the launches its capture recorded, the capture's seconds and what the
    capture added to the card's reserved memory."""

    graph: torch.cuda.CUDAGraph
    static_in: dict
    out: object
    launches: dict
    seconds: float
    pool_bytes: int
    staging: dict = field(default_factory=dict)
    copied: torch.cuda.Event | None = None


def record(fn, dev, pool=None):
    """Capture ``fn()`` (already warm) as one CUDA graph on ``dev``, in
    ``pool`` (``None``: a pool of its own).  Returns (graph, the outputs
    ``fn`` returned, the kernel launches the capture recorded, what the
    capture added to the card's reserved memory, the cache's free blocks
    released first).  Raises if the capture fails."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph()
    # thread_local: a loader's thread may go on pinning and copying on its
    # own stream while this thread captures
    with profiling.counted_as_replays() as launches:
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            out = fn()
    torch.cuda.synchronize(dev)
    return graph, out, launches, torch.cuda.memory_reserved(dev) - reserved


# parameters, buffers and submodules registered in the process so far, by
# ``register_*`` or by setting a module's attribute: torch's registration
# hooks are global, so the count is too; a cache only compares it with the
# value it saw at its last walk
_registrations = 0
_hooks = []


def _registered(module, name, value):
    global _registrations
    _registrations += 1  # returns None: the value is registered as it is


def _watch_registrations():
    """Count every registration from now on (once a process)."""
    if not _hooks:
        _hooks.extend(hook(_registered) for hook in (
            nn_module.register_module_parameter_registration_hook,
            nn_module.register_module_buffer_registration_hook,
            nn_module.register_module_module_registration_hook))


def state_slots(modules, optimizers=()):
    """``(dicts, keys)``: where each tensor that a step or a forward of
    ``modules`` reads in place lives, ``dicts[i][keys[i]]`` the i-th, in a
    fixed order: the parameters of each module (its tree's
    ``_parameters`` dicts, each tensor once, in ``parameters()``'s order),
    then its buffers likewise, then the moments of each optimizer by
    parameter and key, over all its groups (an ``OptaxRMSprop`` or a
    ``LayerDecayAdamW``, whose ``init_moments()`` makes first those no
    update has made yet, so the list is the same before and after a
    step)."""
    dicts, keys = [], []
    for m in modules:
        for kind in ("_parameters", "_buffers"):
            seen = set()
            for sub in m.modules():
                d = getattr(sub, kind)
                for k, t in d.items():
                    if t is not None and id(t) not in seen:
                        seen.add(id(t))
                        dicts.append(d)
                        keys.append(k)
    for opt in optimizers:
        opt.init_moments()
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state[p]
                for k in sorted(st):
                    dicts.append(st)
                    keys.append(k)
    return dicts, keys


def _sign(modules, optimizers):
    """What changes, in O(1) of the tensors, when the set of tensors of
    :func:`state_slots` may have: (the objects, compared by identity: the
    modules, the optimizers, each optimizer's ``state`` and
    ``param_groups``, which its ``load_state_dict`` replaces; the counts,
    compared by value: the process's registrations, each optimizer's
    number of groups)."""
    objs = (*modules, *optimizers, *(o.state for o in optimizers),
            *(o.param_groups for o in optimizers))
    return objs, (_registrations, *(len(o.param_groups) for o in optimizers))


def _same(a, b):
    return (b is not None and a[1] == b[1] and len(a[0]) == len(b[0])
            and all(map(operator.is_, a[0], b[0])))


def _pointers(slots):
    """The data pointer of the tensor in each slot now."""
    return list(map(torch.Tensor.data_ptr, map(operator.getitem, *slots)))


class GraphCache:
    """What :class:`ShapeGraphs` and
    :class:`posetpu_torch.train.step.GraphedSteps` share: ``graphs`` by key,
    every one dropped when a tensor they read has moved (the recapture
    rule), and the bookkeeping of the captures made: ``captures``, and
    ``capture_seconds`` and ``pool_bytes``, each capture's seconds (warm-up
    included) and what it added to the card's reserved memory.  The
    registry (:mod:`posetpu_torch.utils.profiling`) counts the process's
    ``graph.capture_s`` (every cache's capture seconds),
    ``graph.recaptures`` (graphs dropped to be captured again),
    ``graph.state_walks`` (walks of the tensors' slots, below) and
    ``graph.replays``.

    The recapture check (:meth:`_drop_if_moved`) runs before every call.
    It keeps, from its last walk of the modules and optimizers
    (:func:`state_slots`), the dict and key that hold each tensor and the
    tensors' data pointers.  Each call reads every slot again and compares
    every pointer, in one pass: that sees a storage moved (``.data =``,
    ``.to()``, ``set_``, a swap) and a tensor replaced in its dict (a
    parameter or buffer set by ``setattr``, a buffer moved by ``.to()``, a
    moment replaced in ``optimizer.state[p]``).  It walks again only when
    an O(1) sign (:func:`_sign`) says the set of tensors may have changed
    (a parameter, buffer or submodule registered anywhere in the process;
    an optimizer's ``load_state_dict``, or a group added), when a slot is
    gone, or when a pointer moved, so the slots kept are always those of
    the graphs' capture.  It does not see a submodule taken out of a
    ``ModuleList`` by ``del``, nor a parameter's whole moment dict
    replaced (``optimizer.state[p] = {...}``)."""

    def __init__(self):
        _watch_registrations()
        self.graphs = {}
        self._sign = self._slots = self._ptrs = None
        self.captures = 0
        self.capture_seconds = []
        self.pool_bytes = []

    def _drop_if_moved(self, modules, optimizers=()):
        """Drop every graph if a tensor of ``modules`` (parameters and
        buffers) or ``optimizers`` (moments) has moved since the last
        call."""
        sign = _sign(modules, optimizers)
        if _same(sign, self._sign):
            try:
                if _pointers(self._slots) == self._ptrs:
                    return
            except KeyError:  # a tensor deleted from its dict
                pass
        profiling.count("graph.state_walks")
        self._sign, self._slots = sign, state_slots(modules, optimizers)
        ptrs = _pointers(self._slots)
        if ptrs != self._ptrs:
            # every graph reads the old storage
            if self.graphs:
                profiling.count("graph.recaptures", len(self.graphs))
            self.graphs.clear()
            self._ptrs = ptrs

    def _captured(self, g):
        """Count ``g`` (``seconds``, ``pool_bytes``) as a capture; returns it."""
        self.captures += 1
        self.capture_seconds.append(g.seconds)
        self.pool_bytes.append(g.pool_bytes)
        profiling.count("graph.capture_s", g.seconds)
        return g

    @staticmethod
    def _replayed(g):
        """Count one replay of ``g``, and the launches it recorded."""
        profiling.count("graph.replays")
        profiling.add_replay(g.launches)


def _signature(inputs):
    return tuple((n, tuple(v.shape), str(v.dtype)) for n, v in sorted(inputs.items()))


def _as_tensor(v):
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(v))


class ShapeGraphs(GraphCache):
    """``graphs(inputs) -> outputs``: ``fn(inputs)`` replayed from one CUDA
    graph per input signature (module docstring).

    ``fn`` takes a dict of CUDA tensors and returns tensors (a tensor, or
    dicts and tuples of them); it must not synchronize with the host.
    ``modules()`` returns the modules whose parameters and buffers the
    graphs read in place.  ``inputs`` maps names to numpy arrays, CPU
    tensors or CUDA tensors; each keeps its dtype.  The outputs returned
    are the graph's static ones: copy them before the next call.

    The captures are counted as :class:`GraphCache` counts them.  A
    :class:`posetpu_torch.utils.profiling.DeviceTimer` set as ``timer``
    times each call on the card: the copies in and the replay, from once
    the host's staging is done.  ``name`` names the call's spans
    (:mod:`posetpu_torch.utils.profiling`), each with the call's ``unit``:
    ``<name>.stage`` (the wait for the previous copy out of the staging
    buffers, the copies into them and the copies to the card enqueued) and
    ``<name>.replay``.
    """

    def __init__(self, fn, modules, device, name):
        super().__init__()  # graphs: signature -> _ShapeGraph
        self.fn, self.modules, self.dev = fn, modules, device
        self.pool = None
        self.timer = None
        self.spans = (f"{name}.stage", f"{name}.replay")

    def __call__(self, inputs, unit=None):
        inputs = {n: _as_tensor(v) for n, v in inputs.items()}
        self._drop_if_moved(self.modules())
        key = _signature(inputs)
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(inputs)
        self._fill(g, inputs, self.timer, unit)
        with profiling.span(self.spans[1], unit):
            g.graph.replay()
        if self.timer is not None:
            self.timer.stop()
        self._replayed(g)
        return g.out

    def _fill(self, g, inputs, timer=None, unit=None):
        """Copy ``inputs`` into the static buffers on the current stream:
        host data into the staging buffers first, then every copy to the
        card; ``timer`` starts between the two."""
        host = [n for n, v in inputs.items() if v.device.type == "cpu"]
        src = dict(inputs)
        with profiling.span(self.spans[0], unit):
            if host and g.copied is not None:
                g.copied.synchronize()  # the previous copy out of the staging buffers
            for n in host:
                v = inputs[n]
                stage = g.staging.get(n)
                if stage is None:
                    stage = g.staging[n] = torch.empty(v.shape, dtype=v.dtype,
                                                       pin_memory=True)
                stage.copy_(v)
                src[n] = stage
            if timer is not None:
                timer.start()
            for n, v in src.items():
                g.static_in[n].copy_(v, non_blocking=True)
            if host:
                if g.copied is None:
                    g.copied = torch.cuda.Event()
                g.copied.record()

    def _capture(self, inputs):
        with profiling.span("graph.capture"):
            t0 = time.perf_counter()
            static_in = {n: torch.empty(v.shape, dtype=v.dtype, device=self.dev)
                         for n, v in inputs.items()}
            g = _ShapeGraph(None, static_in, None, {}, 0.0, 0)
            self._fill(g, inputs)
            cur = torch.cuda.current_stream(self.dev)
            side = torch.cuda.Stream(self.dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    self.fn(static_in)
            cur.wait_stream(side)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            g.graph, g.out, g.launches, g.pool_bytes = record(
                lambda: self.fn(static_in), self.dev, self.pool)
            g.seconds = time.perf_counter() - t0
        return self._captured(g)
