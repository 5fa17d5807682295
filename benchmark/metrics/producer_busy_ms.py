"""producer_busy_ms: the host's ms the loader's producer thread took to make
a batch: each of the program's own ``loader.produce`` spans of the traced
window (``posetpu_torch/utils/profiling.py``'s ``window()``: reading,
decoding and placing the batch, then handing it over) less its
``loader.put_wait`` (blocked on a full queue), over the spans' number.
Nothing to read where the program records no such span."""


def read(rec):
    try:
        from posetpu_torch.utils import profiling

        blocked = {}
        for r in profiling.window("loader.put_wait"):
            blocked[r.parent] = blocked.get(r.parent, 0.0) + r.ms
        ms = [r.ms - blocked.get(r.id, 0.0) for r in profiling.window("loader.produce")]
    except (ImportError, AttributeError):
        return None
    return sum(ms) / len(ms) if ms else None
