"""posetpu_torch.aug.augment_batch against posetpu.aug.augment_batch with
the same injected AugParams (flips and rotations included) and the same
color-jitter scales.

The augmented ``input`` is held to INPUT_ATOL, derived from the one place
where the two packages compute different numbers: sin and cos of the
rotation.  The port takes them of the f32 angle in float64 and rounds once;
XLA's float32 sin and cos on the CPU are not correctly rounded.

1. Their ulp error.  The two packages' sin and cos differ by at most one
   ulp (``test_reference_sin_cos_within_one_ulp``), and one ulp of a value
   below 1 is at most 2**-24.
2. The largest sampling offset from the crop center.  The crop side is
   h = 200 * scale * sf <= 96 * 1.2 * 1.25 = 144 source pixels at the test's
   sizes (valid height <= 96, scale jitter <= 1.2, sf <= 1.25), so a sample
   lies at most r = h / sqrt(2) from the crop center.  An error e in cos
   moves it by e * r (the inverse affine's derivative is -e * R^T (src - c)),
   and one in sin likewise, so both move it by at most 2 * 2**-24 * r.
3. The image's largest slope per pixel.  Neighbouring uint8 pixels differ
   by at most 255 / 255 = 1, and the jitter scales by at most 1.2, so a
   bilinear sample changes by at most 1.2 * (|shift_x| + |shift_y|), which
   is at most 1.2 * sqrt(2) * |shift|.

Together: 1.2 * sqrt(2) * 2 * 2**-24 * 144 / sqrt(2) = 2.06e-5.  The rest
of the arithmetic is the same f32 sequence in both packages; its own
rounding is not bounded here.  Seeds 0-39 read at most 1.02e-5 (seed 12,
no jitter, the one above the former 1e-5), and seed 12 is a case below.

``tpts_float`` is held to TPTS_ATOL heatmap pixels, not to ulps of its own
value: it is a sum of affine terms up to 64 px that cancel to values near 0
(seeds 12 and 13 differ by 4 and 16 ulps, both 1.9e-6 px).  The same sin
and cos error moves a point at distance d from the crop center by at most
2 * 2**-24 * d, with d <= 16 / 45.6 * 41 * sqrt(2) = 20.4 output px at the
test's sizes (points within 40 px of the center and 1 px of shift, crop
side >= 76 * 0.8 * 0.75 = 45.6); one rounding that the two packages take
differently adds one ulp of a term below 64, 2**-18.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.aug import AugParams as RefParams
from posetpu.aug import augment_batch as ref_augment
from posetpu_torch.aug import AugParams, augment_batch, flip_permutation
from posetpu.aug import flip_permutation as ref_flip_permutation

MEAN = (0.4404, 0.4440, 0.4327)

_SLOPE = 1.2  # largest |d value / d pixel| of the jittered [0, 1] image
_CROP = 96 * 1.2 * 1.25  # largest crop side h in source pixels (_batch)
_ULP = 2.0**-24  # one ulp of a value in [0.5, 1)
INPUT_ATOL = _SLOPE * math.sqrt(2) * 2 * _ULP * _CROP / math.sqrt(2)
_PT_OUT = 16 / (76 * 0.8 * 0.75) * 41 * math.sqrt(2)  # farthest point, out px
TPTS_ATOL = 2 * _ULP * _PT_OUT + 2.0**-18


def _batch(seed, B=4, K=16, hw=(96, 128)):
    rng = np.random.RandomState(seed)
    H, W = hw
    valid_wh = np.stack(
        [rng.randint(W - 30, W + 1, B), rng.randint(H - 20, H + 1, B)], axis=1
    ).astype(np.int32)
    center = (valid_wh / 2 + rng.uniform(-5, 5, (B, 2))).astype(np.float32)
    scale = (valid_wh[:, 1] / 200.0 * rng.uniform(0.8, 1.2, B)).astype(np.float32)
    pts = (center[:, None, :] + rng.uniform(-40, 40, (B, K, 2))).astype(np.float32)
    vis = rng.randint(0, 2, (B, K)).astype(np.float32)
    images = rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8)
    sf = rng.uniform(0.75, 1.25, B).astype(np.float32)
    rot = rng.uniform(-40, 40, B).astype(np.float32)
    rot[0] = 0.0
    flip = np.arange(B) % 2 == 1
    return images, valid_wh, center, scale, pts, vis, (sf, rot, flip)


@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 12, 13])
def test_augment_batch_matches_reference(seed, jitter):
    images, valid_wh, center, scale, pts, vis, (sf, rot, flip) = _batch(seed)
    B = images.shape[0]
    kw = dict(inp_res=(64, 64), out_res=(16, 16), sigma=1.0, mean=MEAN)
    key = jax.random.PRNGKey(seed + 5) if jitter else None
    want = ref_augment(
        images, jnp.asarray(valid_wh), jnp.asarray(center), jnp.asarray(scale),
        jnp.asarray(pts), jnp.asarray(vis),
        RefParams(jnp.asarray(sf), jnp.asarray(rot), jnp.asarray(flip)),
        jitter_key=key, raster_backend="xla", **kw,
    )
    scales = None
    if jitter:  # the reference's own draw, injected into the port
        scales = torch.from_numpy(np.array(
            jax.random.uniform(key, (B, 1, 1, 3), minval=0.8, maxval=1.2)
        ).reshape(B, 3))
    t = torch.from_numpy
    got = augment_batch(
        t(images), t(valid_wh), t(center), t(scale), t(pts), t(vis),
        AugParams(t(sf), t(rot), t(flip)), jitter_scales=scales, device="cpu",
        **kw,
    )
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    np.testing.assert_allclose(got["input"], want["input"], atol=INPUT_ATOL)
    np.testing.assert_allclose(got["target"], want["target"], atol=1e-6)
    for k in ("target_weight", "tpts", "center", "scale"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["tpts_float"], want["tpts_float"], rtol=0,
                               atol=TPTS_ATOL)
    assert want["target"].max() > 0.5  # the targets are not all empty


def test_reference_sin_cos_within_one_ulp():
    """The premise of INPUT_ATOL: over the test's rotations (|rot| <= 40
    degrees) XLA's f32 sin and cos differ from the port's by at most one ulp."""
    deg = np.linspace(-40.0, 40.0, 200_001).astype(np.float32)
    rad = -torch.from_numpy(deg) * (math.pi / 180.0)  # as make_transform
    for name, ref in (("sin", jnp.sin), ("cos", jnp.cos)):
        port = getattr(torch, name)(rad.double()).float().numpy()
        got = np.asarray(ref(jnp.asarray(rad.numpy())))
        ulps = np.abs(got - port) / np.spacing(np.abs(port))
        assert ulps.max() <= 1.0, name
        assert np.abs(got - port).max() <= _ULP, name


@pytest.mark.parametrize("dataset,K", [("mpii", 16), ("lsp", 14)])
def test_flip_permutation(dataset, K):
    np.testing.assert_array_equal(
        flip_permutation(K, dataset, "cpu").numpy(),
        np.asarray(ref_flip_permutation(K, dataset)),
    )
