"""posetpu_torch.aug.augment_batch against posetpu.aug.augment_batch with
the same injected AugParams (flips and rotations included) and the same
color-jitter scales."""

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
@pytest.mark.parametrize("seed", [0, 1])
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
    np.testing.assert_allclose(got["input"], want["input"], atol=1e-5)
    np.testing.assert_allclose(got["target"], want["target"], atol=1e-6)
    for k in ("target_weight", "tpts", "center", "scale"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_max_ulp(got["tpts_float"], want["tpts_float"], maxulp=2)
    assert want["target"].max() > 0.5  # the targets are not all empty


@pytest.mark.parametrize("dataset,K", [("mpii", 16), ("lsp", 14)])
def test_flip_permutation(dataset, K):
    np.testing.assert_array_equal(
        flip_permutation(K, dataset, "cpu").numpy(),
        np.asarray(ref_flip_permutation(K, dataset)),
    )
