"""posetpu_torch.eval.decode against posetpu.eval.decode on the same numpy
heatmaps, ties and all-nonpositive rows included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.eval import decode as ref
from posetpu_torch.eval import decode as port


def _heatmaps(seed, B=4, K=5, H=16, W=16):
    rng = np.random.RandomState(seed)
    hm = rng.randn(B, K, H, W).astype(np.float32)
    hm[0, 0] = -np.abs(hm[0, 0])  # all <= 0: pred zeroed
    hm[0, 1] = 0.0  # all zero: the first maximum, then zeroed
    hm[1, 0] = 0.5
    hm[1, 0, 3, 7] = hm[1, 0, 9, 2] = 2.0  # a tie: the first one wins
    hm[1, 1] = 0.0
    hm[1, 1, 5, 5] = 1.0  # equal neighbours: sign(0) = 0, no offset
    hm[2, 2] = 0.0
    hm[2, 2, 0, 0] = 1.0  # peaks on the border: no offset
    hm[2, 3] = 0.0
    hm[2, 3, H - 1, W - 1] = 1.0
    return hm


@pytest.mark.parametrize("seed", [0, 1])
def test_get_preds_and_quarter_offset(seed):
    hm = _heatmaps(seed)
    got = port.get_preds(torch.from_numpy(hm))
    want = ref.get_preds(jnp.asarray(hm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[1, 0], [8.0, 4.0])
    np.testing.assert_array_equal(got.numpy()[0, :2], 0.0)
    np.testing.assert_array_equal(
        port.quarter_offset(got, torch.from_numpy(hm)).numpy(),
        np.asarray(ref.quarter_offset(want, jnp.asarray(hm))),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_final_preds(seed):
    hm = _heatmaps(seed)
    rng = np.random.RandomState(seed + 1)
    center = rng.uniform(50, 300, (4, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2.5, 4).astype(np.float32)
    got = port.final_preds(torch.from_numpy(hm), torch.from_numpy(center),
                           torch.from_numpy(scale), (16, 16))
    want = ref.final_preds(jnp.asarray(hm), jnp.asarray(center), jnp.asarray(scale), (16, 16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pck_counts_and_ratio(seed, masked):
    out = _heatmaps(seed)
    tgt = _heatmaps(seed + 10)
    tgt[:, :, :, :] = np.where(np.random.RandomState(seed).rand(*tgt.shape) < 0.5, tgt, out)
    mask = np.array([1, 0, 1, 1], np.float32) if masked else None
    hit, cnt = port.pck_counts(torch.from_numpy(out), torch.from_numpy(tgt),
                               sample_mask=None if mask is None else torch.from_numpy(mask))
    r_hit, r_cnt = ref.pck_counts(jnp.asarray(out), jnp.asarray(tgt),
                                  sample_mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(r_hit))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(r_cnt))
    np.testing.assert_array_equal(
        port.pck_from_counts(hit, cnt).numpy(),
        np.asarray(ref.pck_from_counts(r_hit, r_cnt)),
    )


@pytest.mark.parametrize("cnt", [[0, 0, 0], [3, 0, 7], [1, 2, 3]])
def test_pck_from_counts_edges(cnt):
    cnt = np.array(cnt, np.int32)
    hit = np.minimum(cnt, np.array([1, 0, 5], np.int32))
    np.testing.assert_array_equal(
        port.pck_from_counts(torch.from_numpy(hit), torch.from_numpy(cnt)).numpy(),
        np.asarray(ref.pck_from_counts(jnp.asarray(hit), jnp.asarray(cnt))),
    )
