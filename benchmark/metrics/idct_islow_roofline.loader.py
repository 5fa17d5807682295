"""idct_islow_roofline.loader: the idct_islow kernel's share of its roofline in the
traced window: every launch the profiler saw times the least time to move
a batch's bytes at 3.35 TB/s (``benchmark/counts.py:jpeg_420_bytes``,
copied from chip_smoke's bound), over the profiler's time of the kernel,
in %.  Nothing to read without a trace that saw the kernel."""

from benchmark.counts import bound_ms

KERNEL = "idct_islow"


def read(rec):
    prof = rec.get("profile")
    if rec.get("kind") != "loader" or not prof:
        return None
    hits = [v for name, v in prof["kernels"].items() if KERNEL in name]
    count, seconds = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not count or seconds <= 0:
        return None
    return 100.0 * count * bound_ms(rec["idct_bytes_per_batch"]) / 1e3 / seconds
