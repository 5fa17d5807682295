"""posetpu_torch's keyed augmentation and jitter samplers.

The port cannot draw JAX's threefry bits, so it is held to the
distribution of the JAX package's ``sample_aug_params_ps`` and
``color_jitter_ps`` (two-sample Kolmogorov-Smirnov at fixed seeds, so the
result is the same on every run) and to the properties the keying exists
for: a sample's draws depend on (seed, step, global index, stream) alone.

Shares: with N = 20,000 draws, a Bernoulli share p has standard error
sqrt(p(1-p)/N) <= 0.0035; SHARE_ATOL = 0.014 is four of them.  KS: the
test passes at P_MIN = 0.001 (the seeds are fixed, so this is a gate on a
wrong distribution, which reads p-values of 0 at this N, not a flaky
draw).
"""

import numpy as np
import pytest
import torch

from posetpu_torch.aug import sample_aug_params_ps, sample_jitter_scales
from posetpu_torch.aug.keyed import (
    STREAM_AUG,
    STREAM_JITTER,
    bits_to_uniform,
    keyed_bits,
    pcg_hash,
)

N = 20_000
SHARE_ATOL = 4 * np.sqrt(0.25 / N)
P_MIN = 1e-3


@pytest.fixture(scope="module")
def reference_draws():
    """The JAX package's draws for N samples, keyed as its train step keys
    them: fold_in(key, step) -> split -> per_sample_keys(index)."""
    import jax
    import jax.numpy as jnp

    from posetpu.aug.pipeline import per_sample_keys
    from posetpu.aug.pipeline import sample_aug_params_ps as ref_sample

    key = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    k_par, k_jit = jax.random.split(key)
    index = jnp.arange(N)
    out = {}
    for mode in ("exp", "linear"):
        p = ref_sample(per_sample_keys(k_par, index), scale_mode=mode)
        out[mode] = {k: np.asarray(v) for k, v in p._asdict().items()}
    out["jitter"] = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (3,), minval=0.8, maxval=1.2)
    )(per_sample_keys(k_jit, index)))
    return out


def _port(mode="exp", seed=0, step=0, index=None):
    index = torch.arange(N) if index is None else index
    p = sample_aug_params_ps(seed, step, index, scale_mode=mode)
    return {k: v.numpy() for k, v in p._asdict().items()}


@pytest.mark.parametrize("mode", ["exp", "linear"])
def test_distribution_matches_reference(reference_draws, mode):
    from scipy.stats import ks_2samp

    ref, got = reference_draws[mode], _port(mode)
    assert ks_2samp(got["scale_factor"], ref["scale_factor"]).pvalue > P_MIN
    # rotations: the kept ones (the zeroed share is tested below)
    assert ks_2samp(got["rot"][got["rot"] != 0], ref["rot"][ref["rot"] != 0]).pvalue > P_MIN
    assert abs((got["rot"] == 0).mean() - (ref["rot"] == 0).mean()) <= 2 * SHARE_ATOL
    assert abs(got["flip"].mean() - ref["flip"].mean()) <= 2 * SHARE_ATOL


def test_jitter_distribution_matches_reference(reference_draws):
    from scipy.stats import ks_2samp

    got = sample_jitter_scales(0, 0, torch.arange(N)).numpy()
    ref = reference_draws["jitter"]
    assert got.shape == ref.shape == (N, 3)
    for c in range(3):
        assert ks_2samp(got[:, c], ref[:, c]).pvalue > P_MIN, c
    assert got.min() >= 0.8 and got.max() < 1.2


def test_shares():
    got = _port()
    assert abs((got["rot"] == 0).mean() - 0.4) <= SHARE_ATOL  # 1 - rot_prob
    assert abs(got["flip"].mean() - 0.5) <= SHARE_ATOL


@pytest.mark.parametrize("mode", ["exp", "linear"])
def test_clip_bounds(mode):
    sf, rf = 0.25, 30.0
    got = _port(mode)
    s = got["scale_factor"]
    lo, hi = (2.0 ** (-2 * sf), 2.0 ** (2 * sf)) if mode == "exp" else (1 - sf, 1 + sf)
    assert s.min() >= np.float32(lo) and s.max() <= np.float32(hi)
    # 2 sigma clips: about 4.6% of draws sit on each bound
    assert (s == np.float32(lo)).mean() > 0.01 and (s == np.float32(hi)).mean() > 0.01
    assert np.abs(got["rot"]).max() == 2 * rf
    assert got["scale_factor"].dtype == got["rot"].dtype == np.float32
    assert got["flip"].dtype == np.bool_


def test_unknown_scale_mode_raises():
    with pytest.raises(ValueError):
        sample_aug_params_ps(0, 0, torch.arange(2), scale_mode="log")


def test_draws_do_not_depend_on_batch_position_or_mates():
    index = torch.tensor([5, 17, 123456789, 2**31 + 7, 0])
    alone = {int(i): (_port(index=i[None]), sample_jitter_scales(1, 4, i[None]))
             for i in index}
    perm = torch.tensor([3, 0, 4, 2, 1])
    mates = torch.cat([index[perm], torch.tensor([99, 100])])
    batch = _port(index=mates)
    jitter = sample_jitter_scales(1, 4, mates)
    for pos, i in enumerate(mates[:5].tolist()):
        want, want_j = alone[i]
        for k in ("scale_factor", "rot", "flip"):
            assert batch[k][pos] == want[k][0], (i, k)
        assert torch.equal(jitter[pos], want_j[0])


def test_draws_differ_across_steps_seeds_and_streams():
    index = torch.arange(64)
    base = keyed_bits(0, 0, index, STREAM_AUG, 6)
    for other in (keyed_bits(0, 1, index, STREAM_AUG, 6),
                  keyed_bits(1, 0, index, STREAM_AUG, 6),
                  keyed_bits(0, 0, index, STREAM_JITTER, 6)):
        assert (other != base).float().mean() > 0.99
    # and the parameters themselves move with the step
    a, b = _port(step=0, index=index), _port(step=1, index=index)
    assert (a["scale_factor"] != b["scale_factor"]).mean() > 0.9
    # words within a key differ too
    assert (base[:, 0] != base[:, 1]).all()


def test_uniform_bits():
    """The hash is a bijection of 32-bit words and the uniforms are exact
    multiples of 2**-24 in [0, 1), equally spread over 16 bins."""
    x = torch.arange(1 << 16, dtype=torch.int64) * 65_537
    h = pcg_hash(x)
    assert h.min() >= 0 and h.max() < 2**32
    assert len(torch.unique(h)) == len(x)
    assert pcg_hash(12345) == int(pcg_hash(torch.tensor([12345]))[0])
    u = bits_to_uniform(keyed_bits(2, 3, torch.arange(N), STREAM_AUG, 1))[:, 0]
    assert u.min() >= 0 and u.max() < 1
    assert torch.equal(u * 2**24, torch.round(u * 2**24))
    counts = torch.bincount((u * 16).long(), minlength=16).numpy()
    assert np.abs(counts / N - 1 / 16).max() <= 4 * np.sqrt(1 / 16 / N)


@pytest.mark.cuda
def test_same_integers_and_draws_on_the_card():
    """The hash is integer arithmetic: the card computes the CPU's words.
    Flips are comparisons of exact uniforms, so they are equal; scale and
    rotation are float64 arithmetic rounded once to float32, so they agree
    to one float32 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    index = torch.arange(N)
    for stream in (STREAM_AUG, STREAM_JITTER):
        assert torch.equal(keyed_bits(7, 3, index.cuda(), stream, 6).cpu(),
                           keyed_bits(7, 3, index, stream, 6))
    for mode in ("exp", "linear"):
        cpu = sample_aug_params_ps(7, 3, index, scale_mode=mode)
        gpu = sample_aug_params_ps(7, 3, index.cuda(), scale_mode=mode)
        assert torch.equal(gpu.flip.cpu(), cpu.flip)
        for k in ("scale_factor", "rot"):
            a, b = getattr(gpu, k).cpu().numpy(), getattr(cpu, k).numpy()
            assert (np.abs(a - b) <= np.spacing(np.abs(b))).all(), k
    j_cpu = sample_jitter_scales(7, 3, index)
    j_gpu = sample_jitter_scales(7, 3, index.cuda()).cpu()
    assert (np.abs(j_gpu.numpy() - j_cpu.numpy()) <= np.spacing(j_cpu.numpy())).all()
