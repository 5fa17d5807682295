"""mfu.loader: the loader-fed window's share of the card's bf16 peak: the
benchmark's own count of a training step's operations a image
(``benchmark/counts.py``) times the images, over the window's seconds,
over 989 TFLOP/s, in %."""

from benchmark.counts import BF16_FLOPS_PER_S


def read(rec):
    if rec.get("kind") != "loader":
        return None
    return 100.0 * rec["flops_per_image"] * rec["images"] / rec["window_s"] / BF16_FLOPS_PER_S
