"""optim_device_ms.vit: the card's ms a training step in the optimizer's
``multi_tensor_apply`` kernels (the clip's ``_foreach`` norms and scaling,
and the fused AdamW over its layer-decay groups), from the
profiler's time of the traced window, over the window's steps.  Nothing
to read without such kernels in the trace."""

KERNEL = "multi_tensor_apply"


def read(rec):
    prof = rec.get("profile")
    if rec.get("kind") != "train" or not prof or not rec.get("steps"):
        return None
    seconds = sum(v[1] for name, v in prof["kernels"].items() if KERNEL in name)
    return 1e3 * seconds / rec["steps"] if seconds > 0 else None
