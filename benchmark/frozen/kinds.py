"""Kinds of device time, frozen for the benchmark's ``breakdown``.  Copied
from ``posetpu_torch/tools/profile_step.py`` (``PROFILE_KINDS``,
``OTHER_KIND``, ``kind_of``)."""

from __future__ import annotations

# kernel-name patterns that sort device time into kinds; the first match
# wins, anything unmatched is "other elementwise"
PROFILE_KINDS = (
    ("rasterize", ("rasterize",)),
    ("copies", ("Memcpy", "Memset")),
    ("convolution / gemm", ("gemm", "xmma", "nvjet", "conv", "cutlass", "cudnn")),
    ("batch_norm", ("batch_norm",)),
    ("upsample / pool", ("upsample", "pool")),
    ("gather / index (warp, decode)", ("index", "gather")),
    ("reductions", ("reduce",)),
    ("optimizer and BN-statistics update (_foreach)", ("multi_tensor_apply",)),
    ("dtype casts", ("_copy_kernel",)),
)
OTHER_KIND = "other elementwise"


def kind_of(name):
    """The :data:`PROFILE_KINDS` kind of a kernel (or operator) name."""
    return next((k for k, keys in PROFILE_KINDS if any(s in name for s in keys)),
                OTHER_KIND)
