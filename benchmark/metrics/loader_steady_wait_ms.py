"""loader_steady_wait_ms: the host's ms the loader's consumer waited for a
batch inside an epoch: the program's own ``loader.wait`` spans not marked
``first_of_epoch``, those of the traced window
(``posetpu_torch/utils/profiling.py``'s ``window()``), over their number.
Nothing to read where the program records no such span."""


def read(rec):
    try:
        from posetpu_torch.utils import profiling

        ms = [r.ms for r in profiling.window("loader.wait")
              if not r.marks.get("first_of_epoch")]
    except (ImportError, AttributeError):
        return None
    return sum(ms) / len(ms) if ms else None
