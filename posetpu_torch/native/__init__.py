"""The JPEG decode routes of the host loader: the host's C++ pool (built
with g++ and libjpeg at first use) and the card's route (a hand-written
entropy decoder built with g++, the ``idct_islow`` and ``ycc_canvas``
kernels built with nvcc, all at first use)."""

from posetpu_torch.native.bindings import NativeDecoder
from posetpu_torch.native.jpeg_gpu import GpuJpegDecoder

__all__ = ["NativeDecoder", "GpuJpegDecoder"]
