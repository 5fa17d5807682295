"""capture_s: the seconds the program spent capturing its CUDA graphs, the
warm-up before each capture included: the program's own counter
``graph.capture_s`` (``posetpu_torch/utils/profiling.py``'s registry),
summed over the run.  Captures fall in the set-up, so this counter is not
windowed.  Nothing to read where the program counts no capture."""


def read(rec):
    try:
        from posetpu_torch.utils import profiling

        seconds = profiling.counter("graph.capture_s")
    except (ImportError, AttributeError):
        return None
    return float(seconds) if seconds else None
