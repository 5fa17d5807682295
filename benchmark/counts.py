"""The yardstick's arithmetic: the card's peaks, the model's operations
counted from a configuration's widths, and the bytes a kernel must move.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the full
700 W: 989 TFLOP/s in bf16, 3.35 TB/s of HBM3.

Model operations count the convolutions and the dense layers only (two
operations a multiply-add), as ``torch.utils.flop_counter`` counts them;
norms, activations, pooling and the warp are left out.  A training step
counts three forwards (forward, and the backward's two products), the
convention, with no recompute.

Kernel bytes count each input byte read once and each output byte written
once.  The rasterizer's are copied from ``chip_smoke.py:_raster_bound``.
"""

from __future__ import annotations

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def _conv(cin, cout, k, pixels):
    return 2 * cin * cout * k * k * pixels


def _bottleneck(cin, planes, pixels):
    cout = 2 * planes
    ops = (_conv(cin, planes, 1, pixels) + _conv(planes, planes, 3, pixels)
           + _conv(planes, cout, 1, pixels))
    if cin != cout:
        ops += _conv(cin, cout, 1, pixels)
    return ops


def hourglass_forward_flops(model, res):
    """Operations of one image's forward through the stacked hourglass of
    ``model`` (a configuration's ``model`` group: ``stacks``, ``blocks``,
    ``feats``, ``classes``, ``depth``) at a square input of side ``res``:
    the 7x7 stride-2 stem, a bottleneck at res/2, a max pool, two
    bottlenecks at res/4, then each stack's hourglass, residual, 1x1 head
    and score, and between stacks the two 1x1 remaps."""
    feats, classes, blocks = model["feats"], model["classes"], model["blocks"]
    ch = 2 * feats
    half, quarter = (res // 2) ** 2, (res // 4) ** 2
    ops = _conv(3, 64, 7, half) + _bottleneck(64, 64, half)
    ops += _bottleneck(128, feats, quarter) + _bottleneck(ch, feats, quarter)
    side = res // 4
    # residual sites of one hourglass: up1 at each level's side, low1 and
    # low3 at the next level down, and low2 at the bottom
    sites = 0
    for d in range(model["depth"]):
        s = side >> d
        sites += s * s + 2 * (s // 2) ** 2
    sites += (side >> model["depth"]) ** 2
    per_stack = blocks * _bottleneck(ch, feats, 1) * (sites + quarter)
    per_stack += _conv(ch, ch, 1, quarter) + _conv(ch, classes, 1, quarter)
    remap = _conv(ch, ch, 1, quarter) + _conv(classes, ch, 1, quarter)
    stacks = model["stacks"]
    return ops + stacks * per_stack + (stacks - 1) * remap


def train_step_flops(model, res):
    """A pose training step's operations a image: three forwards."""
    return 3 * hourglass_forward_flops(model, res)


def agent_forward_flops(agent, res):
    """Operations of one image's forward through the augmentation agent of
    ``agent`` (``widths``, ``input_downscale``, ``scale_bins``,
    ``rot_bins``) on a square crop of side ``res``: stride-2 convs (7x7,
    then 3x3) from the pooled crop, the 256-wide dense layer, two heads."""
    side, cin, ops = res // agent["input_downscale"], 3, 0
    for i, w in enumerate(agent["widths"]):
        side = -(-side // 2)
        ops += _conv(cin, w, 3 if i else 7, side * side)
        cin = w
    hidden = 256
    return ops + 2 * cin * hidden + 2 * hidden * (agent["scale_bins"] + agent["rot_bins"])


def joint_step_flops(model, agent, res):
    """A joint step's operations a image: the pose network's training step
    on the adversarial crop, its forward on the plain crop (the reward's
    baseline), and the agent's forward and backward (three forwards)."""
    return 4 * hourglass_forward_flops(model, res) + 3 * agent_forward_flops(agent, res)


def raster_bytes(batch, joints, height, width):
    """The rasterizer's bytes: (B*K) float32 points (x, y) and visibility
    read, the (B, K, H, W) float32 targets and (B, K) visibility written."""
    rows = batch * joints
    return rows * (2 * 4 + 4) + rows * height * width * 4 + rows * 4


def jpeg_420_bytes(frames, width, height, canvas):
    """(``idct_islow``'s bytes, ``ycc_canvas``'s bytes) for a batch of
    ``frames`` 4:2:0 JPEG frames of ``width`` x ``height`` decoded into
    (frames, *canvas, 3) uint8, copied from ``chip_smoke.py``'s
    ``_idct_bound`` and ``_ycc_bound``: 128 B of coefficients a block and
    128 B of tables a component read, the planes written; the planes read,
    the canvas written."""
    luma = width * height
    chroma = 2 * (-(-width // 2)) * (-(-height // 2))
    blocks = -(-width // 8) * (-(-height // 8)) + 2 * (-(-width // 16)) * (-(-height // 16))
    planes = frames * (luma + chroma)
    idct = frames * (blocks * 128 + 3 * 128) + planes
    return idct, planes + frames * canvas[0] * canvas[1] * 3


def bound_ms(nbytes):
    """The least milliseconds to move ``nbytes`` at the HBM's peak."""
    return nbytes / HBM_BYTES_PER_S * 1e3
