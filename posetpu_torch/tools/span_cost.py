"""The cost of the program's spans on this host
(:mod:`posetpu_torch.utils.profiling`): microseconds a span, each the mean
over ``--spans`` spans opened and closed in a loop, with tracing off; on,
in a thread with no profiler of its own (a loader's producer); on, in the
thread a ``torch.profiler`` runs in (each span then a profiler range
too); and on a card, a host span with a device span inside (two CUDA
events).  Prints one JSON line, the card's name beside the numbers.

    python -m posetpu_torch.tools.span_cost [--spans 100000]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from posetpu_torch.utils.profiling import REGISTRY, device_span, span


def _us(n, body):
    t0 = time.perf_counter()
    body(n)
    return (time.perf_counter() - t0) / n * 1e6


def _host(n):
    for _ in range(n):
        with span("span_cost"):
            pass


def _device(n):
    for _ in range(n):
        with span("span_cost"), device_span("span_cost"):
            pass
    torch.cuda.synchronize()


def measure(n):
    REGISTRY.reset()
    _host(n // 10)  # warm
    out = {"spans": n, "cpus": os.cpu_count(), "off_us": _us(n, _host)}
    with REGISTRY.forced_on():
        out["on_us"] = _us(n, _host)
    with profile(activities=[ProfilerActivity.CPU]):
        out["on_profiled_us"] = _us(n, _host)
    if torch.cuda.is_available():
        out["card"] = torch.cuda.get_device_name(0)
        with REGISTRY.forced_on():
            _device(100)  # the events' first use
            out["on_device_us"] = _us(n, _device)
    REGISTRY.reset()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m posetpu_torch.tools.span_cost",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", type=int, default=100_000)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.spans)), flush=True)


if __name__ == "__main__":
    main()
