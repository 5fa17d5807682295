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
  capture's count once per replay (:func:`posetpu_torch.aug.cuda_kernels.add_replay`);
- every graph reads the weights where they were at its capture: when a
  weight's storage has moved (``load_state_dict`` of a module copies in
  place, a ``.to()`` or a parameter replaced does not), every graph is
  dropped and captured again at its next call;
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

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from posetpu_torch.aug import cuda_kernels

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
    with cuda_kernels.counted_as_replays() as launches:
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            out = fn()
    torch.cuda.synchronize(dev)
    return graph, out, launches, torch.cuda.memory_reserved(dev) - reserved


class GraphCache:
    """What :class:`ShapeGraphs` and
    :class:`posetpu_torch.train.step.GraphedSteps` share: ``graphs`` by key,
    every one dropped when a tensor they read has moved (the recapture
    rule), and the bookkeeping of the captures made: ``captures``, and
    ``capture_seconds`` and ``pool_bytes``, each capture's seconds (warm-up
    included) and what it added to the card's reserved memory."""

    def __init__(self):
        self.graphs = {}
        self._ptrs = None
        self.captures = 0
        self.capture_seconds = []
        self.pool_bytes = []

    def _drop_if_moved(self, tensors):
        ptrs = [t.data_ptr() for t in tensors]
        if ptrs != self._ptrs:
            # every graph reads the old storage
            self.graphs.clear()
            self._ptrs = ptrs

    def _captured(self, g):
        """Count ``g`` (``seconds``, ``pool_bytes``) as a capture; returns it."""
        self.captures += 1
        self.capture_seconds.append(g.seconds)
        self.pool_bytes.append(g.pool_bytes)
        return g


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
    ``weights()`` lists the tensors the graphs read in place (a module's
    parameters and buffers).  ``inputs`` maps names to numpy arrays, CPU
    tensors or CUDA tensors; each keeps its dtype.  The outputs returned
    are the graph's static ones: copy them before the next call.

    The captures are counted as :class:`GraphCache` counts them.
    """

    def __init__(self, fn, weights, device):
        super().__init__()  # graphs: signature -> _ShapeGraph
        self.fn, self.weights, self.dev = fn, weights, device
        self.pool = None

    def __call__(self, inputs):
        inputs = {n: _as_tensor(v) for n, v in inputs.items()}
        self._drop_if_moved(self.weights())
        key = _signature(inputs)
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(inputs)
        self._fill(g, inputs)
        g.graph.replay()
        cuda_kernels.add_replay(g.launches)
        return g.out

    def _fill(self, g, inputs):
        """Copy ``inputs`` into the static buffers on the current stream."""
        host = [n for n, v in inputs.items() if v.device.type == "cpu"]
        if host and g.copied is not None:
            g.copied.synchronize()  # the previous copy out of the staging buffers
        for n, v in inputs.items():
            if v.device.type == "cpu":
                stage = g.staging.get(n)
                if stage is None:
                    stage = g.staging[n] = torch.empty(v.shape, dtype=v.dtype,
                                                       pin_memory=True)
                stage.copy_(v)
                g.static_in[n].copy_(stage, non_blocking=True)
            else:
                g.static_in[n].copy_(v)
        if host:
            if g.copied is None:
                g.copied = torch.cuda.Event()
            g.copied.record()

    def _capture(self, inputs):
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
