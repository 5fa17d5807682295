"""rasterize_roofline.train: the target rasterizer's share of its roofline
in the traced window: the least time to move its bytes at 3.35 TB/s
(``benchmark/counts.py``: points and visibility read, targets and
visibility written once) for every launch the profiler saw (a step
launches it once for each entry of ``raster_bytes_per_step``), over the
profiler's time of its kernel, in %.  Nothing to read without a trace that
saw the kernel."""

from benchmark.counts import bound_ms

KERNEL = "rasterize_gaussians"


def read(rec):
    prof = rec.get("profile")
    if rec.get("kind") != "train" or not prof:
        return None
    hits = [v for name, v in prof["kernels"].items() if KERNEL in name]
    per_step = rec["raster_bytes_per_step"]
    count = sum(v[0] for v in hits)
    seconds = sum(v[1] for v in hits)
    if not count or seconds <= 0:
        return None
    least_s = count / len(per_step) * sum(bound_ms(b) for b in per_step) / 1e3
    return 100.0 * least_s / seconds
