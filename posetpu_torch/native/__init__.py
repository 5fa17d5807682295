"""The host's C++ JPEG decode pool (built with g++ and libjpeg at first use)."""

from posetpu_torch.native.bindings import NativeDecoder

__all__ = ["NativeDecoder"]
