"""posetpu_torch.aug.affine against posetpu.aug.affine: the closed-form f32
geometry within 2 ulp, truncated ints equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.aug import affine as ref
from posetpu_torch.aug import affine as port


def _inputs(seed, B=6, K=16):
    rng = np.random.RandomState(seed)
    center = rng.uniform(40, 400, (B, 2)).astype(np.float32)
    scale = rng.uniform(0.4, 3.0, (B,)).astype(np.float32)
    rot = rng.uniform(-60, 60, (B,)).astype(np.float32)
    rot[0] = 0.0
    pts = rng.uniform(-20, 500, (B, K, 2)).astype(np.float32)
    return center, scale, rot, pts


def _ulp(a, b):
    np.testing.assert_array_max_ulp(np.asarray(a), np.asarray(b), maxulp=2)


@pytest.mark.parametrize("res", [(64, 64), (256, 256), (64, 48)])
@pytest.mark.parametrize("seed", [0, 1])
def test_make_transform(seed, res):
    center, scale, rot, _ = _inputs(seed)
    _ulp(
        port.make_transform(torch.from_numpy(center), torch.from_numpy(scale), res,
                            torch.from_numpy(rot)),
        ref.make_transform(center, scale, res, rot),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compose_and_invert(seed):
    center, scale, rot, _ = _inputs(seed)
    c2, s2, r2, _ = _inputs(seed + 10)
    a_np = np.array(ref.make_transform(center, scale, (256, 256), rot))
    b_np = np.array(ref.make_transform(c2, s2, (64, 64), r2))
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    _ulp(port.compose_affine(a, b), ref.compose_affine(jnp.asarray(a_np), jnp.asarray(b_np)))
    _ulp(port.invert_affine(a), ref.invert_affine(jnp.asarray(a_np)))


@pytest.mark.parametrize("truncate", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_transform_points(seed, truncate):
    center, scale, rot, pts = _inputs(seed)
    t_np = np.array(ref.make_transform(center, scale, (64, 64), rot))
    got = port.transform_points(torch.from_numpy(pts), torch.from_numpy(t_np), truncate)
    want = ref.transform_points(pts, jnp.asarray(t_np), truncate)
    if truncate:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _ulp(got, want)
    ints, floats = port.transform_points_int_float(
        torch.from_numpy(pts), torch.from_numpy(t_np)
    )
    r_ints, r_floats = ref.transform_points_int_float(pts, jnp.asarray(t_np))
    np.testing.assert_array_equal(ints.numpy(), np.asarray(r_ints))
    _ulp(floats, r_floats)


def test_trunc_one_ulp_below_integer():
    """out = 0.99999994f: the int comes from trunc(out) = 0 (+1 -> 1), not
    from trunc((out + 1) - 1), which would give 1 (+1 -> 2)."""
    below_one = np.nextafter(np.float32(1.0), np.float32(0.0))
    t = np.eye(3, dtype=np.float32)[None].repeat(2, axis=0)
    t[:, 0, 2] = below_one
    t[:, 1, 2] = np.float32(4.0) - np.float32(4.0) * np.finfo(np.float32).epsneg
    pts = np.ones((2, 3, 2), np.float32)  # 0-indexed (0, 0)
    ints, floats = port.transform_points_int_float(torch.from_numpy(pts), torch.from_numpy(t))
    r_ints, r_floats = ref.transform_points_int_float(pts, jnp.asarray(t))
    np.testing.assert_array_equal(ints.numpy(), np.asarray(r_ints))
    np.testing.assert_array_equal(ints.numpy()[..., 0], 1.0)
    np.testing.assert_array_equal(ints.numpy()[..., 1], 4.0)
    np.testing.assert_array_equal(floats.numpy(), np.asarray(r_floats))
