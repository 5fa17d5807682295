"""attention_roofline.vit: the ViT's attention kernels' share of their
roofline in the traced window: the program's attention calls counted in
the window (its counter ``launches.attention``, once a replayed step a
block) times one call's operations in a training step
(``benchmark/counts_vitpose.py:attention_ops``: the forward's q k^T and
p v, the backward's four products), at 989 TFLOP/s, over the profiler's
time in the kernels of ``scaled_dot_product_attention``'s routes (flash,
memory-efficient, cuDNN: names matched below), forward and backward, in
%.  Nothing to read without a count or without such kernels in the
trace."""

from benchmark.counts import BF16_FLOPS_PER_S

KERNELS = ("flash", "fmha", "attention", "sdpa")


def read(rec):
    prof = rec.get("profile")
    launches = rec.get("attention_launches")
    if rec.get("kind") != "train" or not prof or not launches:
        return None
    seconds = sum(v[1] for name, v in prof["kernels"].items()
                  if any(k in name.lower() for k in KERNELS))
    if seconds <= 0:
        return None
    return 100.0 * launches * rec["attention_ops"] / BF16_FLOPS_PER_S / seconds
