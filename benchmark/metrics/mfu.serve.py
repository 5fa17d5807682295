"""mfu.serve: the serving window's share of the card's bf16 peak: the
benchmark's own count of one forward's operations a served image
(``benchmark/counts.py``) times the images, over the window's seconds,
over 989 TFLOP/s, in %."""

from benchmark.counts import BF16_FLOPS_PER_S


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return 100.0 * rec["flops_per_image"] * rec["images"] / rec["window_s"] / BF16_FLOPS_PER_S
