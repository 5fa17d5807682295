"""The port's train-mode BatchNorm against flax's: one train-mode forward of
the hourglass and the running statistics it leaves, in float64 on both
sides, and the eval-mode forward untouched by the train-mode correction.

Configuration: 2 stacks, feats 8, 16 joints, 64² input, hourglass depth 2,
batch 6.  The deepest level is 4x4, so its BatchNorms take their
statistics over n = 6*4*4 = 96 values per channel.

FWD64_ATOL.  In float64 both packages compute the same math, except that
the JAX package's score head is float32 on purpose
(``nn.Conv(dtype=float32)``): each stack's heatmaps are rounded to float32
(2**-24 relative) after a 16-term float32 sum (at most 16 more roundings),
and the next stack reads them back.  Taken over values below 8:
32 * 2**-24 * 8 = 1.5e-5.  Read: under 1e-6 (my CPU run).  torch's own
update of the running variance (the unbiased batch variance) misses
flax's by 0.1*var/(n-1), about 1e-3 here; the test checks that it fails.
Float32 is not compared here: flax takes the batch variance as
E[x²] - E[x]², which loses about eps32 * E[x²]/var to cancellation, so the
two float32 forwards differ by their rounding (tests/test_torch_train_step.py
holds them by derived bounds).
"""

import copy

import numpy as np
import torch

from posetpu_torch.ckpt import from_flax_variables
from posetpu_torch.models import hg

STACKS, FEATS, CLASSES, DEPTH, B = 2, 8, 16, 2, 6
FWD64_ATOL = 32 * 2.0**-24 * 8


def _flax(seed=0):
    import jax
    import jax.numpy as jnp

    from posetpu.models import hg as ref_hg

    model = ref_hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS,
                   depth=DEPTH, dtype=jnp.float64)
    rng = np.random.RandomState(seed)
    v = model.init(jax.random.PRNGKey(seed + 3), jnp.zeros((1, 64, 64, 3)), train=False)
    v = jax.tree.map(lambda a: a + 0.05 * jnp.asarray(rng.randn(*a.shape), a.dtype), v)
    return model, v


def _port(v, dtype=torch.float32):
    model = hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
               dtype=dtype)
    model.load_state_dict(from_flax_variables(v["params"], v["batch_stats"],
                                              num_stacks=STACKS, depth=DEPTH))
    return model


def test_train_forward_matches_flax_in_float64():
    """One train-mode forward: the heatmaps and the updated running
    statistics equal flax's ``mutable=["batch_stats"]`` in float64
    (FWD64_ATOL), and torch's own update of the running variance (the
    unbiased batch variance) would not."""
    import jax
    import jax.numpy as jnp

    x = np.random.RandomState(7).rand(B, 64, 64, 3) - 0.4
    with jax.enable_x64(True):
        ref, v = _flax()
        fwd = jax.jit(lambda v, x: ref.apply(v, x, train=True, mutable=["batch_stats"]))
        outs, mut = fwd(v, jnp.asarray(x, jnp.float64))
        outs = [np.asarray(o, np.float64).transpose(0, 3, 1, 2) for o in outs]
        new_stats = jax.tree.map(lambda a: np.asarray(a, np.float64), mut["batch_stats"])

    want = from_flax_variables(v["params"], new_stats, num_stacks=STACKS, depth=DEPTH)
    model = _port(v).double().train()
    plain = copy.deepcopy(model)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert max(np.abs(w).max() for w in outs) < 8
    for g, w in zip(got, outs):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=FWD64_ATOL)
    sd = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * len(model._norms)
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=FWD64_ATOL, err_msg=k)

    # the same forward under torch's own rule misses flax's variances
    with torch.no_grad():
        plain._forward(torch.from_numpy(x))
    gap = max((plain.state_dict()[k] - want[k].double()).abs().max().item()
              for k in stats if k.endswith("running_var"))
    assert gap > 20 * FWD64_ATOL, gap


def test_eval_forward_leaves_statistics_alone():
    """Eval mode (the served path) is torch's BatchNorm as it is: the
    output equals the uncorrected forward exactly and no statistic moves."""
    import jax

    with jax.enable_x64(True):
        _, v = _flax()
    model = _port(v).eval()
    before = {k: t.clone() for k, t in model.state_dict().items()}
    x = torch.from_numpy(np.random.RandomState(8).rand(2, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        got = model(x)
        want = model._forward(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_batch_count_is_recorded_per_norm():
    """Each BatchNorm records how many values per channel its batch
    statistics took, B*H*W of its own input, in train mode only."""
    import jax

    with jax.enable_x64(True):
        _, v = _flax()
    model = _port(v).train()
    with torch.no_grad():
        model(torch.zeros(3, 64, 64, 3))
    counts = {n: m.batch_count for n, m in model.named_modules() if m in model._norms}
    assert counts["stem.1"] == 3 * 32 * 32
    assert counts["hgs.0.low2.bn1"] == 3 * 4 * 4
    assert counts["fc.1.1"] == 3 * 16 * 16
    assert set(counts.values()) == {3 * 32 * 32, 3 * 16 * 16, 3 * 8 * 8, 3 * 4 * 4}


def test_cpu_train_statistics_do_not_depend_on_the_layout():
    """A network's NHWC input, permuted to NCHW, reaches its norms in the
    channels-last layout.  torch's CPU ``batch_norm`` takes the statistics
    of such an input 1.3e-4 from float64 at this shape, against 6.1e-7 for
    a contiguous one (read on the CPU), and the error turned the port's
    ReLUs far more often than the JAX package's (ROADMAP §3).  On the CPU a
    train-mode norm takes its input contiguous: channels-last and
    contiguous float32 inputs give the same output and statistics, within
    2e-6 of float64."""
    from posetpu_torch.models.batchnorm import BatchNorm2d

    x = np.maximum(np.random.RandomState(0).randn(6, 64, 32, 32), 0) * 0.5
    x = torch.from_numpy(x.astype(np.float32))
    ref = BatchNorm2d(64).double().train()
    want = ref(x.double())
    got = []
    for fmt in (torch.contiguous_format, torch.channels_last):
        bn = BatchNorm2d(64).train()
        y = bn(x.contiguous(memory_format=fmt))
        assert (y.double() - want).abs().max() <= 2e-6, fmt
        got.append((y, bn.running_mean, bn.running_var))
    for a, b in zip(*got):
        assert torch.equal(a, b)
    assert (got[0][2].double() - ref.running_var).abs().max() <= 2e-6
