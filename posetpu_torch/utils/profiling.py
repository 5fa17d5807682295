"""Profiling — the counterpart of ``posetpu/utils/profiling.py:trace``.

:func:`trace` wraps a block in ``torch.profiler`` (CPU activity, and CUDA
activity where a card is present) and writes a Chrome trace
(``chrome://tracing``, Perfetto) into a directory.  The reference's
``measure_duty_cycle`` and ``time_device_step`` wait for the port's bench.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(logdir):
    """Profile the block; on exit, wait for the card and write
    ``<logdir>/trace_<pid>.json``.  Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))
