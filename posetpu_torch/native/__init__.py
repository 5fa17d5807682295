"""The JPEG decode routes of the host loader: the host's C++ pool (built
with g++ and libjpeg at first use) and the card's nvJPEG route (nvJPEG
planes and the ``ycc_canvas`` kernel, built with nvcc at first use)."""

from posetpu_torch.native.bindings import NativeDecoder
from posetpu_torch.native.nvjpeg import NvjpegDecoder

__all__ = ["NativeDecoder", "NvjpegDecoder"]
