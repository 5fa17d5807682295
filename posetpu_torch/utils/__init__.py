"""Device resolution and the CUDA kernel builder."""

from posetpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
