"""The yardstick's arithmetic of ViTPose: the operations of a forward
pass counted from a configuration's widths, and the attention's.

Operations count the dense layers, the convolutions and the attention's
two products (two operations a multiply-add), as
``torch.utils.flop_counter`` counts them; norms, activations, softmax and
drop path are left out.  A training step counts three forwards, the
convention, with no recompute (``counts.py``).
"""

from __future__ import annotations


def vitpose_flops(model, res):
    """Operations of one image's forward through the ViTPose of ``model``
    (a configuration's ``model`` group: ``embed_dim``, ``vit_depth``,
    ``mlp_ratio``, ``patch_size``, ``patch_padding``, ``deconv_filters``,
    ``classes``) at a square input of side ``res``: the patch
    convolution, each block's qkv, output and two MLP projections and its
    attention's q k^T and p v, two stride-2 4x4 deconvolutions and the
    final 1x1 conv."""
    D, p = model["embed_dim"], model["patch_size"]
    grid = (res + 2 * model["patch_padding"] - p) // p + 1
    T = grid * grid
    ops = 2 * 3 * p * p * D * T
    linear = 3 * D * D + D * D + 2 * D * model["mlp_ratio"] * D
    ops += model["vit_depth"] * (2 * T * linear + 2 * 2 * T * T * D)
    cin, side = D, grid
    for _ in range(2):
        # each input pixel meets the 4x4 kernel once
        ops += 2 * cin * model["deconv_filters"] * 16 * side * side
        cin, side = model["deconv_filters"], side * 2
    return ops + 2 * cin * model["classes"] * side * side


def train_step_flops(model, res):
    """A training step's operations an image: three forwards."""
    return 3 * vitpose_flops(model, res)


def attention_ops(batch, heads, tokens, head_dim):
    """One layer's attention operations in a training step: the forward's
    q k^T and p v (4 T^2 d a head), the backward's four products (8 T^2
    d), over ``batch`` images and ``heads`` heads; a recompute not
    counted."""
    return 12 * batch * heads * tokens * tokens * head_dim
