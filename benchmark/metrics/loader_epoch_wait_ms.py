"""loader_epoch_wait_ms: the host's ms the loader's consumer waited for the
first batch of an epoch: the program's own ``loader.wait`` spans marked
``first_of_epoch``, those of the traced window
(``posetpu_torch/utils/profiling.py``'s ``window()``), over their number.
Nothing to read where the program records no such span."""


def read(rec):
    try:
        from posetpu_torch.utils import profiling

        ms = [r.ms for r in profiling.window("loader.wait") if r.marks.get("first_of_epoch")]
    except (ImportError, AttributeError):
        return None
    return sum(ms) / len(ms) if ms else None
