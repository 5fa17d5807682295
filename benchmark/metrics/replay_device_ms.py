"""replay_device_ms: the card's ms a training step of the graph's replay
alone: the program's own device spans ``dispatch.replay`` of the traced
window (``posetpu_torch/utils/profiling.py``'s ``window()``; CUDA events
around ``graph.replay()``, each marked with its dispatch's ``steps``),
summed, over their steps.  Beside ``step_device_ms.train`` (the whole
dispatch on the card, from outside) the difference is the dispatch's
copies and counter fills there and the host's staging, where the card
waits for it.  Nothing to read where the program records no such span."""


def read(rec):
    try:
        from posetpu_torch.utils import profiling

        spans = [r for r in profiling.window("dispatch.replay") if r.device]
        steps = sum(r.marks.get("steps", 0) for r in spans)
        ms = sum(r.ms for r in spans)
    except (ImportError, AttributeError):
        return None
    return ms / steps if steps else None
