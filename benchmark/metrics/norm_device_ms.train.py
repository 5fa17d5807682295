"""norm_device_ms.train: the card's ms a training step in kernels whose
name contains ``batch_norm`` (torch's channels-last ``batch_norm_*``
kernels, or the port's fused ``batch_norm_relu_*`` ones, which take the
ReLU in too), from the profiler's time of the traced window, over the
window's steps.  Nothing to read without such kernels in the trace."""

KERNEL = "batch_norm"


def read(rec):
    prof = rec.get("profile")
    if rec.get("kind") != "train" or not prof or not rec.get("steps"):
        return None
    seconds = sum(v[1] for name, v in prof["kernels"].items() if KERNEL in name)
    return 1e3 * seconds / rec["steps"] if seconds > 0 else None
