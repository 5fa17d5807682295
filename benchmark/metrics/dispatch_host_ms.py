"""dispatch_host_ms: the host's ms of a graphed training dispatch outside
its graph's replay: each of the program's own ``dispatch`` spans of the
traced window (``posetpu_torch/utils/profiling.py``'s ``window()``) that
replayed a graph (the superbatch to the card, the static inputs and
counters filled, the outputs cloned and the counters advanced) less its
host ``dispatch.replay`` span, over the spans' number.  Nothing to read
where the program records no such span (an eager dispatch has no
replay)."""


def read(rec):
    try:
        from posetpu_torch.utils import profiling

        replay = {}
        for r in profiling.window("dispatch.replay"):
            if not r.device:
                replay[r.parent] = replay.get(r.parent, 0.0) + r.ms
        ms = [r.ms - replay[r.id] for r in profiling.window("dispatch") if r.id in replay]
    except (ImportError, AttributeError):
        return None
    return sum(ms) / len(ms) if ms else None
