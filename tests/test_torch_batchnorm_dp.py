"""Cross-replica BatchNorm (posetpu_torch.models.batchnorm.convert_cross_replica_)
against flax's ``nn.BatchNorm(axis_name="data")`` under the JAX package's
``shard_map`` on a 2-device mesh (the 8 virtual CPU devices of
tests/conftest.py), and a converted hourglass's running statistics against
the reference hourglass with ``axis_name``.

The port's ranks are two gloo processes on the CPU
(:class:`posetpu_torch.parallel.RankPool`), started once for the module.
Both sides compute flax 0.12's statistics: the float32 mean and mean of
squares of each rank, averaged over the ranks, ``var = max(mu2 - mu², 0)``,
running statistics ``0.9 r + 0.1 stat`` with the biased global variance.

Tolerances (float32 unless stated):

- F32_RTOL = 1e-5 on the output, the running statistics and the input
  gradient.  The two sides take the same sums in a different order (XLA's
  reduction tree, torch's): a mean over n values rounds by about
  log2(n) ulps, and rsqrt(var + eps) of a variance from two such means
  carries a few more; 1e-5 is 80 ulps (read 1.2e-6 on this CPU).  The
  absolute floor, F32_ATOL = 1e-6, covers values near zero.
- bf16 inputs: each side computes in float32 and rounds the output to
  bfloat16 once, so the outputs differ by at most one bf16 ulp
  (2^-8 relative) where the float32 values straddle a rounding boundary.
  The bf16 input gradients are held by their ratio to the f32 gap
  (ROADMAP's precision rule; the test says why).
- The hourglass's running statistics and heatmaps after one train-mode
  forward: STATS_RTOL = 1e-4, and OUT_ATOL = 1e-4 on the heatmaps.
  Deeper layers inherit the rounding of every layer above (heatmaps read
  2.4e-5 apart).
"""

import numpy as np
import pytest
import torch

from posetpu_torch.models.batchnorm import BatchNorm2d, convert_cross_replica_, flax_train_forward
from posetpu_torch.models import hg
from posetpu_torch.parallel import RankPool, shard_slice

W = 2
B, H, WD, C = 8, 6, 5, 4
F32_RTOL, F32_ATOL = 1e-5, 1e-6
STATS_RTOL, OUT_ATOL = 1e-4, 1e-4
BF16_ULP = 2.0**-8
STACKS, FEATS, CLASSES, DEPTH = 1, 8, 16, 2


@pytest.fixture(scope="module")
def pool():
    with RankPool(W, devices="cpu", threads=1) as p:
        yield p


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "x": (rng.randn(B, H, WD, C) * 2.0 + 0.5).astype(np.float32),
        "r": rng.randn(B, H, WD, C).astype(np.float32),
        "scale": (1.0 + 0.1 * rng.randn(C)).astype(np.float32),
        "bias": (0.1 * rng.randn(C)).astype(np.float32),
        "mean": (0.1 * rng.randn(C)).astype(np.float32),
        "var": (1.0 + 0.1 * rng.rand(C)).astype(np.float32),
    }


def _port_bn(d):
    bn = BatchNorm2d(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(d["scale"]))
        bn.bias.copy_(torch.from_numpy(d["bias"]))
        bn.running_mean.copy_(torch.from_numpy(d["mean"]))
        bn.running_var.copy_(torch.from_numpy(d["var"]))
    return bn


def _rank_bn(ctx, d, dtype_name):
    """One train-mode forward and backward of a converted norm on this
    rank's rows (NHWC in and out, as flax's)."""
    dtype = getattr(torch, dtype_name)
    bn = convert_cross_replica_(_port_bn(d), ctx.group)
    part = shard_slice({"x": d["x"], "r": d["r"]}, ctx.rank, ctx.world)
    x = torch.from_numpy(part["x"]).to(dtype).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(x)
    (y.float() * torch.from_numpy(part["r"]).permute(0, 3, 1, 2)).sum().backward()
    return {"y": y.permute(0, 2, 3, 1), "gx": x.grad.permute(0, 2, 3, 1),
            "mean": bn.running_mean, "var": bn.running_var}


def _flax(d, dtype_name, world):
    """flax's BatchNorm with axis_name under shard_map on ``world`` devices
    (world 1: the plain module on the whole batch)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from posetpu.parallel.dp import _shard_map, make_mesh

    dtype = getattr(jnp, dtype_name)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, dtype=dtype,
                      param_dtype=jnp.float32, axis_name="data" if world > 1 else None)
    v = {"params": {"scale": d["scale"], "bias": d["bias"]},
         "batch_stats": {"mean": d["mean"], "var": d["var"]}}

    def f(v, x, r):
        def loss(x):
            y, mut = bn.apply(v, x, mutable=["batch_stats"])
            return (y.astype(jnp.float32) * r).sum(), (y, mut["batch_stats"])

        (_, (y, stats)), gx = jax.value_and_grad(loss, has_aux=True)(x)
        return y, gx, stats

    x = jnp.asarray(d["x"]).astype(dtype)
    if world > 1:
        f = _shard_map(f, mesh=make_mesh(world), in_specs=(P(), P("data"), P("data")),
                       out_specs=(P("data"), P("data"), P()))
    y, gx, stats = jax.jit(f)(v, x, jnp.asarray(d["r"]))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return {"y": f32(y), "gx": f32(gx), "mean": f32(stats["mean"]), "var": f32(stats["var"])}


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks])


@pytest.mark.parametrize("what", ["y", "gx", "mean", "var"])
def test_f32_matches_flax_axis_name_under_shard_map(pool, what):
    d = _data()
    ranks = pool.run(_rank_bn, d, "float32")
    want = _flax(d, "float32", W)
    got = _cat(ranks, what) if what in ("y", "gx") else ranks[0][what]
    np.testing.assert_allclose(got, want[what], rtol=F32_RTOL, atol=F32_ATOL)
    if what in ("mean", "var"):  # every rank holds the same statistics
        np.testing.assert_array_equal(ranks[0][what], ranks[1][what])


def test_f32_sharded_equals_one_batch(pool):
    """Two ranks at B/2 rows compute flax's single-device norm of the B
    rows: the global statistics and the gradient through them."""
    d = _data(1)
    ranks = pool.run(_rank_bn, d, "float32")
    want = _flax(d, "float32", 1)
    for k in ("y", "gx"):
        np.testing.assert_allclose(_cat(ranks, k), want[k], rtol=F32_RTOL, atol=F32_ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(ranks[0][k], want[k], rtol=F32_RTOL, atol=F32_ATOL)


def test_bf16_output_within_one_ulp_of_flax(pool):
    """bf16 activations: the output keeps the reference's dtype and differs
    from it by at most one bf16 ulp."""
    d = _data(2)
    ranks = pool.run(_rank_bn, d, "bfloat16")
    want = _flax(d, "bfloat16", W)["y"]
    got = _cat(ranks, "y")
    assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-30), \
        np.abs(got - want).max()


def test_bf16_input_gradient_by_its_ratio_to_the_f32_gap(pool):
    """The bf16 input gradient: flax's backward rounds to bf16 at other
    points than torch's, so each lies about as far from the f32 gradient
    as from the other (read: flax 8.8e-3, the port 6.8e-3, each other
    7.8e-3 at most).  Held as tests/test_torch_hourglass.py holds bf16
    heatmaps: within twice the reference's own mean f32 gap."""
    d = _data(2)
    ranks = pool.run(_rank_bn, d, "bfloat16")
    want16 = _flax(d, "bfloat16", W)["gx"]
    want32 = _flax(d, "float32", W)["gx"]
    got = _cat(ranks, "gx")
    gap = np.abs(want32 - want16).mean()
    assert gap > 0
    assert np.abs(got - want16).mean() <= 2.0 * gap


def test_bf16_statistics_are_float32_and_match(pool):
    d = _data(3)
    ranks = pool.run(_rank_bn, d, "bfloat16")
    want = _flax(d, "bfloat16", W)
    for k in ("mean", "var"):
        assert ranks[0][k].dtype == np.float32
        np.testing.assert_allclose(ranks[0][k], want[k], rtol=F32_RTOL, atol=F32_ATOL)


def test_running_variance_is_corrected_once():
    """flax_train_forward corrects the running variance of a local norm
    and leaves a cross-replica norm's, which takes flax's update itself:
    with a group of one rank forced on, both end at flax's value."""
    d = _data(4)
    x = torch.from_numpy(d["x"]).permute(0, 3, 1, 2)
    local, cross = _port_bn(d), _port_bn(d)
    cross.group = object()  # marks it as cross-replica; never reached below
    with torch.no_grad():
        flax_train_forward([local], local, x)
        xf = x.double()
        var = (xf * xf).mean((0, 2, 3)) - xf.mean((0, 2, 3)) ** 2
    want = 0.9 * torch.from_numpy(d["var"]).double() + 0.1 * var
    np.testing.assert_allclose(local.running_var.numpy(), want.numpy(), rtol=F32_RTOL)
    # the cross-replica norm is left out: forward untouched, no correction
    before = cross.running_var.clone()
    out = flax_train_forward([cross], lambda t: t, x)
    assert out is x and torch.equal(cross.running_var, before)


def test_convert_keeps_names_and_one_rank_stays_local():
    model = hg(num_stacks=1, num_feats=8, num_classes=4, depth=2, dtype=torch.float32)
    names = list(model.state_dict())
    convert_cross_replica_(model, None)
    assert list(model.state_dict()) == names
    assert all(m.group is None for m in model.modules() if isinstance(m, BatchNorm2d))


def _ref_hourglass_stats(variables, x):
    import jax
    from jax.sharding import PartitionSpec as P
    import jax.numpy as jnp

    from posetpu.models import hg as ref_hg
    from posetpu.parallel.dp import _shard_map, make_mesh

    model = ref_hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
                   dtype=jnp.float32, axis_name="data")

    def f(v, x):
        outs, mut = model.apply(v, x, train=True, mutable=["batch_stats"])
        return outs[-1], mut["batch_stats"]

    f = _shard_map(f, mesh=make_mesh(W), in_specs=(P(), P("data")),
                   out_specs=(P("data"), P()))
    return jax.jit(f)(variables, jnp.asarray(x))


def _rank_hourglass(ctx, state, x):
    model = hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
               dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    convert_cross_replica_(model, ctx.group).train()
    part = shard_slice({"x": x}, ctx.rank, ctx.world)["x"]
    with torch.no_grad():
        out = model(torch.from_numpy(part))[-1]
    return {"out": out, "state": model.state_dict()}


def test_hourglass_running_statistics_match_reference_axis_name(pool):
    """A converted hourglass's train-mode forward on 2 ranks leaves every
    BatchNorm's running statistics at the reference's (``axis_name``)."""
    import jax
    import jax.numpy as jnp

    from posetpu.models import hg as ref_hg
    from posetpu_torch.ckpt import from_flax_variables

    rng = np.random.RandomState(5)
    ref = ref_hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
                 dtype=jnp.float32)
    v = ref.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    v = jax.tree.map(lambda a: a + 0.05 * jnp.asarray(rng.randn(*a.shape), a.dtype), v)
    x = rng.randn(B, 64, 64, 3).astype(np.float32)
    out, stats = _ref_hourglass_stats(v, x)
    state = {k: t.numpy() for k, t in
             from_flax_variables(v["params"], v["batch_stats"], num_stacks=STACKS,
                                 depth=DEPTH).items()}
    ranks = pool.run(_rank_hourglass, state, x)
    want = from_flax_variables(v["params"], stats, num_stacks=STACKS, depth=DEPTH)
    n = 0
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(ranks[0]["state"][k], w.numpy(), rtol=STATS_RTOL,
                                       atol=F32_ATOL, err_msg=k)
            np.testing.assert_array_equal(ranks[0]["state"][k], ranks[1]["state"][k])
            n += 1
    assert n > 20
    np.testing.assert_allclose(
        np.concatenate([r["out"] for r in ranks]),
        np.asarray(out).transpose(0, 3, 1, 2), rtol=STATS_RTOL, atol=OUT_ATOL)
