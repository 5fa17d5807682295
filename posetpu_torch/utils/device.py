"""Device resolution for the port's entry points.

There is no silent CPU fallback: asking for CUDA on a machine without it is
an error, so a run that was meant for the GPU can never quietly measure the
CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` (default), ``"cuda:N"`` or ``"cpu"`` -> ``torch.device``.

    Raises RuntimeError for a CUDA device when CUDA is not available, and
    ValueError for any other device type.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
