"""posetpu_torch.aug.warp / color against posetpu.aug: the bilinear warp on
uint8 and float sources with valid_wh and src_index, and color
normalize/jitter."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.aug import affine as ref_affine
from posetpu.aug.color import color_normalize as ref_normalize
from posetpu.aug.warp import affine_warp as ref_warp
from posetpu_torch.aug.color import color_jitter, color_normalize
from posetpu_torch.aug.warp import affine_warp


def _case(seed, B=3, N=5, hw=(120, 160)):
    rng = np.random.RandomState(seed)
    H, W = hw
    center = rng.uniform(30, 130, (N, 2)).astype(np.float32)
    scale = rng.uniform(0.3, 1.2, (N,)).astype(np.float32)
    rot = rng.uniform(-45, 45, (N,)).astype(np.float32)
    t = np.array(ref_affine.make_transform(center, scale, (64, 64), rot))
    valid_wh = np.stack(
        [rng.randint(W // 2, W + 1, N), rng.randint(H // 2, H + 1, N)], axis=1
    ).astype(np.int32)
    src = rng.randint(0, B, N).astype(np.int32)
    return rng, t, valid_wh, src


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("with_valid", [True, False])
@pytest.mark.parametrize("with_src", [True, False])
def test_affine_warp_matches_reference(dtype, with_valid, with_src):
    rng, t, valid_wh, src = _case(0)
    if dtype == "uint8":
        imgs = rng.randint(0, 256, (3, 120, 160, 3), dtype=np.uint8)
    else:
        imgs = rng.rand(3, 120, 160, 3).astype(np.float32)
    if not with_src:  # one output per source image
        t, valid_wh, src = t[:3], valid_wh[:3], None
    kw = dict(valid_wh=valid_wh if with_valid else None, src_index=src)
    want = ref_warp(imgs, t, (64, 64), **kw)
    got = affine_warp(
        torch.from_numpy(imgs), torch.from_numpy(t), (64, 64),
        valid_wh=None if kw["valid_wh"] is None else torch.from_numpy(valid_wh),
        src_index=None if src is None else torch.from_numpy(src),
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_valid_wh_masks_padding_garbage():
    """Nonzero padding outside valid_wh must not leak into the crop."""
    rng = np.random.RandomState(1)
    img = np.full((1, 48, 48, 3), 255, np.uint8)
    img[0, :32, :32] = rng.randint(0, 256, (32, 32, 3), dtype=np.uint8)
    t = np.array(ref_affine.make_transform(
        np.array([[16.0, 16.0]], np.float32), np.array([0.2], np.float32),
        (32, 32), np.zeros(1, np.float32)))
    vwh = np.array([[32, 32]], np.int32)
    want = ref_warp(img, t, (32, 32), valid_wh=jnp.asarray(vwh))
    got = affine_warp(torch.from_numpy(img), torch.from_numpy(t), (32, 32),
                      valid_wh=torch.from_numpy(vwh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("std", [None, (0.2, 0.25, 0.3)])
def test_color_normalize(std):
    x = np.random.RandomState(2).rand(2, 8, 8, 3).astype(np.float32)
    mean = (0.4404, 0.4440, 0.4327)
    got = color_normalize(torch.from_numpy(x), mean, std)
    want = ref_normalize(jnp.asarray(x), mean, std)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_color_jitter_injected_scales():
    """The reference's jitter formula with the same per-sample scales."""
    rng = np.random.RandomState(3)
    x = rng.rand(4, 8, 8, 3).astype(np.float32)
    scales = rng.uniform(0.8, 1.2, (4, 3)).astype(np.float32)
    got = color_jitter(torch.from_numpy(x), torch.from_numpy(scales))
    want = jnp.clip(jnp.asarray(x) * jnp.asarray(scales)[:, None, None, :], 0.0, 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
