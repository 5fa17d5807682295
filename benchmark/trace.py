"""The reduction of a traced window (``torch.profiler``, CPU and CUDA
activity) to what the per-layer metrics and the ``breakdown`` read.

The window is the host's ``bench.window`` range.  Device work is every
kernel, copy and fill the profiler saw on the card (every device event but
the host's ranges mirrored there); a kernel replayed from a CUDA graph is
recorded one by one.  ``busy_s`` is the union of their
intervals inside the window; an idle gap is a stretch of the window with
none, named by the innermost host range open at its start (the drivers
mark theirs as ``bench.*``).
"""

from __future__ import annotations

import bisect

from benchmark.frozen.kinds import kind_of

WINDOW = "bench.window"
TOP = 10


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof):
    """{window_s, busy_s, kernels: {name: [count, seconds]}, device_ops,
    idle_gaps} of the profiled window; raises if the trace has no window
    or no device work."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW and e.device_type().name == "CPU"]
    if not win:
        raise RuntimeError("the trace holds no bench.window range")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    device, host, kernels = [], [], {}
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if e.device_type().name == "CUDA":
            # ranges such as Optimizer.step#... also land on the device's
            # timeline: spans over kernels, not work
            if e.is_user_annotation() or t <= w0 or s >= w1:
                continue
            device.append((max(s, w0), min(t, w1)))
            k = kernels.setdefault(e.name(), [0, 0.0])
            k[0] += 1
            k[1] += (t - s) / 1e9
        elif e.device_type().name == "CPU" and e.name() != WINDOW:
            host.append((s, t, e.name()))
    if not device:
        raise RuntimeError("the profiler saw no device work in the window")
    busy = _merge(device)
    busy_s = sum(e - s for s, e in busy) / 1e9
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    host.sort()
    starts = [h[0] for h in host]
    idle = []
    for length, at in gaps:
        # the innermost host range open at the gap's start
        open_ = [h for h in host[:bisect.bisect_right(starts, at)] if h[1] >= at]
        name = max(open_)[2] if open_ else "host between ranges"
        idle.append([name, length / 1e9])
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_s, "kernels": kernels,
            "device_ops": [[f"{kind_of(n)}: {n}"[:200], v[1]] for n, v in ranked],
            "idle_gaps": idle}
