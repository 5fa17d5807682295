"""posetpu_torch's hourglass variants against the JAX package's:
``num_blocks=2`` (``--blocks 2``), the scanned layout (``scan_stacks``) and
remat.

Size: 2 stacks, feats 8, depth 2, 64² input, float32 on the CPU.  Flax
variables (every leaf perturbed, BatchNorm statistics included) are
carried into the port's network with ``from_flax_variables`` in the same
layout.  Tolerances are those of the unrolled network's tests:

- heatmaps in eval mode: atol 2e-4, rtol 1e-3
  (tests/test_torch_hourglass.py);
- running statistics after one train-mode forward: ``STATS_ATOL``; a train
  step's loss, gradients and statistics: ``LOSS_RTOL``, ``GRAD_ATOL``,
  ``STATS_ATOL`` (tests/test_torch_train_step.py, whose derivations hold
  here: each residual site adds one more bottleneck of the same width).

Remat recomputes the same float32 operations on the same inputs, so remat
on and remat off are held to exact equality: loss, gradients, parameters
after an update, ``running_mean``, ``running_var`` and
``num_batches_tracked``, for the local norm and for the cross-replica norm
(a one-rank gloo group set on every norm by hand).  The scanned network's
last remap takes no part in the forward; optax still updates it with a
zero gradient (it decays under ``weight_decay``, and its moments decay),
and so must the port: held to optax within test_torch_train_state.py's
per-step bounds.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

import posetpu_torch.models.batchnorm as port_bn
import posetpu_torch.train.step as port_step
from posetpu_torch.ckpt import from_flax_variables, from_optax_state
from posetpu_torch.models import hg
from posetpu_torch.models.batchnorm import BatchNorm2d
from posetpu_torch.train.state import TrainState, make_optimizer
from posetpu_torch.train.step import make_dispatch_step, make_train_step
from test_torch_train_step import (
    GRAD_ATOL,
    LOSS_RTOL,
    MEAN,
    STATS_ATOL,
    _batch,
    _cfg,
    _inject,
    _ref_draws,
)

STACKS, FEATS, CLASSES, DEPTH, RES = 2, 8, 16, 2, 64
ULP = 2.0**-23
# (num_blocks, scan_stacks) of the variants
VARIANTS = {"blocks2": (2, False), "scan": (1, True), "blocks2_scan": (2, True)}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread: the suite runs several test processes at once
    (tests/test_torch_experiment.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax(blocks, scan, seed=0, stacks=STACKS):
    """The JAX package's network of this layout, seeded variables for it
    (lecun-normal kernels, every other leaf near flax's init: scales and
    variances 1 + 0.05 N(0, 1), biases and means 0.05 N(0, 1)) drawn with
    numpy on the shapes of ``model.init``, and an input batch."""
    import jax
    import jax.numpy as jnp

    from posetpu.models import hg as ref_hg

    model = ref_hg(num_stacks=stacks, num_blocks=blocks, num_classes=CLASSES,
                   num_feats=FEATS, depth=DEPTH, dtype=jnp.float32, scan_stacks=scan)
    rng = np.random.RandomState(seed)
    x = rng.rand(3, RES, RES, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":  # (..., H, W, I, O): fan_in = H * W * I
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[-4:-1]))
        elif name in ("scale", "var"):
            a = 1.0 + 0.05 * rng.randn(*shape)
        else:
            a = 0.05 * rng.randn(*shape)
        return a.astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes), x


def _port(blocks, scan, v=None, remat=False, stacks=STACKS):
    model = hg(num_stacks=stacks, num_blocks=blocks, num_classes=CLASSES, num_feats=FEATS,
               depth=DEPTH, dtype=torch.float32, remat=remat, scan_stacks=scan)
    if v is not None:
        model.load_state_dict(from_flax_variables(
            v["params"], v["batch_stats"], num_stacks=stacks, num_blocks=blocks,
            depth=DEPTH, scan_stacks=scan), strict=True)
    return model


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_eval_heatmaps_match_flax(variant):
    import jax.numpy as jnp

    blocks, scan = VARIANTS[variant]
    ref, v, x = _flax(blocks, scan)
    want = ref.apply(v, jnp.asarray(x), train=False)
    model = _port(blocks, scan, v).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want) == STACKS
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2),
                                   atol=2e-4, rtol=1e-3, err_msg=f"stack {i}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_mode_statistics_match_flax(variant):
    """One train-mode forward: every running mean and variance against
    flax's updated ``batch_stats`` (the scanned network under remat, as the
    train command builds it)."""
    import jax.numpy as jnp

    blocks, scan = VARIANTS[variant]
    ref, v, x = _flax(blocks, scan, seed=1)
    _, upd = ref.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    model = _port(blocks, scan, v, remat=scan).train()
    with torch.no_grad():
        model(torch.from_numpy(x))
    stats = from_flax_variables({}, upd["batch_stats"], num_stacks=STACKS,
                                num_blocks=blocks, depth=DEPTH, scan_stacks=scan)
    sd = model.state_dict()
    assert len(stats) == 2 * len(model._norms)
    for k, w in stats.items():
        gap = (sd[k] - w).abs().max().item()
        assert gap <= STATS_ATOL, f"{k} by {gap}"


@pytest.fixture(scope="module")
def ref_step():
    """One step of the JAX package's jitted ``make_train_step`` of two
    stacks at ``num_blocks=2`` from seeded variables (its draws rebuilt),
    and ``jax.grad`` of the same loss in float64 on the same crops."""
    import jax
    import jax.numpy as jnp

    from posetpu.aug.pipeline import AugParams as RefParams
    from posetpu.aug.pipeline import per_sample_keys
    from posetpu.configs import named_config as ref_named_config
    from posetpu.models import hg as ref_hg
    from posetpu.train.state import TrainState as RefState
    from posetpu.train.state import make_optimizer as ref_make_optimizer
    from posetpu.train.step import _augment, stacked_mse
    from posetpu.train.step import make_train_step as ref_make_train_step

    rcfg = ref_named_config("hg2_mpii_mini")
    rcfg.aug.inp_res, rcfg.aug.out_res = (64, 64), (16, 16)
    model, v, _ = _flax(2, False, seed=2)
    tx = ref_make_optimizer(rcfg.optim, steps_per_epoch=1)
    s0 = RefState(params=v["params"], batch_stats=v["batch_stats"],
                  opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
    batch = _batch(200)
    key = jax.random.PRNGKey(2000)
    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    s1, metrics = jax.jit(ref_make_train_step(model, tx, rcfg.aug, MEAN))(s0, jb, key)
    draws = _ref_draws(key, 0, jb["index"], rcfg.aug)
    params = RefParams(*(jnp.asarray(draws[n]) for n in ("scale_factor", "rot", "flip")))
    aug = _augment(jb, params, rcfg.aug, MEAN, None,
                   per_sample_keys(draws["k_jit"], jb["index"]))
    model64 = ref_hg(num_stacks=STACKS, num_blocks=2, num_classes=CLASSES, num_feats=FEATS,
                     depth=DEPTH, dtype=jnp.float64)

    @jax.jit
    def grads64(p, batch_stats, inp, tgt):
        def loss_fn(p):
            outs, _ = model64.apply({"params": p, "batch_stats": batch_stats}, inp,
                                    train=True, mutable=["batch_stats"])
            return stacked_mse(outs, tgt)

        return jax.grad(loss_fn)(p)

    with jax.enable_x64(True):
        f64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           (v["params"], v["batch_stats"], aug["input"],
                            aug["target"].transpose(0, 2, 3, 1)))
        g64 = jax.tree.map(np.asarray, grads64(*f64))
    return {"v": v, "batch": batch, "draws": draws, "state": s1,
            "loss": float(metrics["loss"]), "grads64": g64,
            "input": np.array(aug["input"]), "target": np.array(aug["target"])}


@pytest.mark.parametrize("norm", ["local", "cross_replica"])
def test_train_step_matches_jax_at_two_blocks(ref_step, monkeypatch, norm, request):
    """One ``make_train_step`` of a two-stack ``num_blocks=2`` network from
    the JAX step's state, on its draws (the crops equal the JAX step's
    exactly), with the local norm and with every norm on the cross-replica
    route (a one-rank group): the loss (``LOSS_RTOL``), the running
    statistics (``STATS_ATOL``), the update count and the step against the
    JAX package's jitted step; the gradients against ``jax.grad`` in
    float64: the port's network in float64 on the same crops within 1e-6
    (9.0e-8 read: the carried reference is rounded to float32), and the
    port's float32 ones within ``GRAD_ATOL``.

    A float32 gradient leaves float64's by the whole gradient of a unit
    wherever a pre-activation lies within float32's rounding of 0 and its
    ReLU takes the other side.  The local norm's gradients read 8.8e-6
    from float64 (no side taken differently).  The cross-replica norm
    takes flax's fast variance, E[x²] - E[x]², as the JAX package does, and
    its rounding turns ReLUs as the JAX package's does: here one of the
    forward's 2.5 million pre-activations, which puts the gradients 7.1e-3
    from float64 (the JAX package's own float32 gradient: 6.7e-3; read on
    the CPU).  So on that route the step's ReLUs take the float64
    forward's sides, and the rest of its float32 arithmetic is held at
    ``GRAD_ATOL`` (6.0e-6 read)."""
    r = ref_step
    group = request.getfixturevalue("one_rank_group") if norm == "cross_replica" else None
    model64 = _port(2, False, r["v"]).double().train()
    for m in model64.modules():
        if isinstance(m, BatchNorm2d):
            m.group = group
    sides = []
    relu = F.relu

    def record(x, inplace=False):
        sides.append(x.detach() > 0)
        return relu(x)

    monkeypatch.setattr(F, "relu", record)
    target = torch.from_numpy(r["target"]).double()
    sum(((o - target) ** 2).mean()
        for o in model64(torch.from_numpy(r["input"]).double())).backward()
    taken = iter(sides)
    if norm == "cross_replica":
        monkeypatch.setattr(F, "relu", lambda x, inplace=False: x * next(taken).to(x.dtype))
    else:
        monkeypatch.setattr(F, "relu", relu)

    _inject(monkeypatch, {0: r["draws"]})
    cfg = _cfg()
    cfg.model.blocks = 2
    crops = {}
    real = port_step.augment_batch
    monkeypatch.setattr(port_step, "augment_batch",
                        lambda *a, **k: crops.update(real(*a, **k)) or crops)
    metrics, grads, _, sd = _one_step(_port(2, False, r["v"]), r["batch"], cfg, group)
    np.testing.assert_array_equal(crops["input"].numpy(), r["input"])
    np.testing.assert_array_equal(crops["target"].numpy(), r["target"])
    if norm == "cross_replica":
        assert next(taken, None) is None  # every ReLU of the forward took its side
    np.testing.assert_allclose(float(metrics["loss"]), r["loss"], rtol=LOSS_RTOL)
    stats = from_flax_variables({}, r["state"].batch_stats, num_stacks=STACKS,
                                num_blocks=2, depth=DEPTH)
    for k, w in stats.items():
        gap = (sd[k] - w).abs().max().item()
        assert gap <= STATS_ATOL, f"{k} by {gap}"
    assert int(r["state"].step) == 1 and all(
        int(n) == 1 for k, n in sd.items() if k.endswith("num_batches_tracked"))

    want = from_flax_variables(r["grads64"], None, num_stacks=STACKS, num_blocks=2,
                               depth=DEPTH)
    named = dict(model64.named_parameters())
    assert set(named) == set(want) == set(grads)
    for k, w in want.items():
        gap = (grads[k] - w).abs().max().item()
        assert gap <= GRAD_ATOL, f"float32 {k} by {gap}"
        gap = (named[k].grad - w.double()).abs().max().item()
        assert gap <= 1e-6, f"float64 {k} by {gap}"


@pytest.fixture
def one_rank_group():
    """A gloo group of one rank in this process (an in-memory store)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _one_step(model, batch, cfg, group=None):
    """One train step of ``model`` from its state: (loss, gradients, the
    state dict after the update)."""
    if group is not None:
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.group = group  # every norm on the cross-replica route
    opt = make_optimizer(model.parameters(), cfg.optim, steps_per_epoch=1)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, cfg.aug, MEAN, group=group, device="cpu")
    metrics = step(state, batch)
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    nu = {n: opt.state[p]["nu"].clone() for n, p in model.named_parameters()}
    return metrics, grads, nu, {k: v.clone() for k, v in model.state_dict().items()}


def _assert_same_step(a, b):
    assert torch.equal(a[0]["loss"], b[0]["loss"]) and torch.equal(a[0]["acc"], b[0]["acc"])
    for i in (1, 2, 3):
        assert a[i].keys() == b[i].keys()
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k]), k


@pytest.mark.parametrize("norm", ["local", "cross_replica"])
@pytest.mark.parametrize("variant", ["blocks2", "scan"])
def test_remat_equals_no_remat_exactly(variant, norm, request, monkeypatch):
    """Remat on and off, from one state, one train step: the loss, the
    gradients, the parameters and moments after the update and every buffer
    (running statistics and ``num_batches_tracked``) are equal.  The
    recompute's norms must leave their statistics alone; with the
    recompute's flag kept off they would count and average in the batch
    twice, which this test sees."""
    blocks, scan = VARIANTS[variant]
    group = request.getfixturevalue("one_rank_group") if norm == "cross_replica" else None
    _, v, _ = _flax(blocks, scan, seed=3)
    cfg = _cfg()
    batch = _batch(300)
    base = _port(blocks, scan, v)
    off = _one_step(copy.deepcopy(base), batch, cfg, group)
    remat = copy.deepcopy(base)
    remat.remat = True
    on = _one_step(remat, batch, cfg, group)
    _assert_same_step(off, on)
    low2 = "hgs.0.low2.0.bn1" if blocks > 1 else "hgs.0.low2.bn1"
    assert on[3]["stem.1.num_batches_tracked"] == 1
    assert on[3][f"{low2}.num_batches_tracked"] == 1

    # the trap the recompute context guards against
    remat = copy.deepcopy(base)
    remat.remat = True
    unguarded = (contextlib.nullcontext(), contextlib.nullcontext())
    monkeypatch.setattr(port_bn, "_recompute_context", lambda: unguarded)
    unguarded = _one_step(remat, batch, cfg, group)
    assert unguarded[3][f"{low2}.num_batches_tracked"] == 2
    assert not torch.equal(unguarded[3][f"{low2}.running_mean"],
                           off[3][f"{low2}.running_mean"])


def test_remat_dispatch_equals_eager_steps():
    """``make_dispatch_step`` of a remat network at K = 2 (the CPU runs the
    graph's body eagerly) equals two eager ``make_train_step`` calls of the
    network without remat, from one state."""
    _, v, _ = _flax(2, False, seed=4)
    cfg = _cfg()
    batches = [_batch(400 + t) for t in range(2)]
    eager = _port(2, False, v)
    opt_e = make_optimizer(eager.parameters(), cfg.optim, steps_per_epoch=1)
    st_e = TrainState(eager, opt_e)
    step = make_train_step(eager, opt_e, cfg.aug, MEAN, device="cpu")
    losses = torch.stack([step(st_e, b)["loss"] for b in batches])

    graphed = _port(2, False, v, remat=True)
    opt_g = make_optimizer(graphed.parameters(), cfg.optim, steps_per_epoch=1)
    st_g = TrainState(graphed, opt_g)
    dispatch = make_dispatch_step(graphed, opt_g, cfg.aug, MEAN, steps=2, device="cpu")
    superbatch = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    out = dispatch(st_g, superbatch)
    assert torch.equal(out["loss"], losses)
    assert st_g.step == opt_g.count == st_e.step == 2
    for a, b in zip(st_e.tensors(), st_g.tensors(), strict=True):
        assert torch.equal(a, b)


def test_scan_unused_remap_follows_optax():
    """The scanned network's last ``fc_`` and ``score_`` take no part in the
    forward.  With weight decay and momentum, one step from a carried optax
    state moves them, their ``nu`` and their trace as optax moves them with
    a zero gradient (test_torch_train_state.py's bounds for one update);
    the rest of the network trains."""
    import jax
    import jax.numpy as jnp
    import optax

    from posetpu.configs.config import OptimConfig as RefOptimConfig
    from posetpu.train.state import make_optimizer as ref_make_optimizer

    _, v, _ = _flax(1, True, seed=5)
    kw = dict(momentum=0.9, weight_decay=1e-4)
    tx = ref_make_optimizer(RefOptimConfig(**kw), steps_per_epoch=1)
    rng = np.random.RandomState(5)
    g = jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape), a.dtype), v["params"])
    _, opt_state = tx.update(g, tx.init(v["params"]), v["params"])
    cfg = _cfg()
    cfg.optim.weight_decay, cfg.optim.momentum = kw["weight_decay"], kw["momentum"]
    cfg.model.scan_stacks = True
    model = _port(1, True, v, remat=True)
    opt = make_optimizer(model.parameters(), cfg.optim, steps_per_epoch=1)
    opt.load_carried(model, from_optax_state(opt_state, num_stacks=STACKS, depth=DEPTH,
                                             scan_stacks=True))
    state = TrainState(model, opt, step=1)
    named = dict(model.named_parameters())
    unused = [f"{m}.{STACKS - 1}.{leaf}" for m in ("fc_", "score_")
              for leaf in ("weight", "bias")]
    before = {n: (named[n].detach().clone(), opt.state[named[n]]["nu"].clone(),
                  opt.state[named[n]]["trace"].clone()) for n in unused}
    make_train_step(model, opt, cfg.aug, MEAN, device="cpu")(state, _batch(500))

    params = {n: jnp.asarray(b[0].numpy()) for n, b in before.items()}
    one = tx.init(params)
    one = optax.tree_utils.tree_set(
        one, nu={n: jnp.asarray(b[1].numpy()) for n, b in before.items()},
        trace={n: jnp.asarray(b[2].numpy()) for n, b in before.items()},
        count=jnp.asarray(1, jnp.int32))
    u, after = tx.update(jax.tree.map(jnp.zeros_like, params), one, params)
    want_p = optax.apply_updates(params, u)
    nu_rtol = ULP / (1 - 0.99)
    u_rtol = nu_rtol / 2 + 4 * ULP
    for n in unused:
        p = named[n].detach().numpy()
        uu = np.abs(np.asarray(u[n]))
        assert (uu > 0).any() and not np.array_equal(p, before[n][0].numpy()), n
        # the update, then its trace (mu*m + u) and the sum into p
        tol = u_rtol * uu / (1 - 0.9) + ULP * uu / (1 - 0.9) ** 2 + ULP * np.abs(p)
        assert (np.abs(p - np.asarray(want_p[n])) <= tol).all(), n
        np.testing.assert_allclose(opt.state[named[n]]["nu"].numpy(),
                                   np.asarray(optax.tree_utils.tree_get(after, "nu")[n]),
                                   rtol=nu_rtol, atol=0, err_msg=n)
    assert named["fc_.0.weight"].grad is not None
    assert all(named[n].grad is None for n in unused)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
def test_remat_all_reduces_each_recomputed_norm_once_more(one_rank_group, monkeypatch, scan):
    """Under a group, remat adds one all-reduce (a norm's two moments) for
    each cross-replica norm inside a recomputed unit: at hg8's
    architecture (8 stacks, depth 4; one block) 39 norms an hourglass, and
    43 a scanned stack (the hourglass, ``res`` and ``fc``'s norm): 312 and
    344 a train step, beyond the 2 x norms + 2 of a step without remat
    (each norm's moments and their cotangent, the gradient bucket and the
    metrics)."""
    calls = []
    real = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = _cfg()
    batch = _batch(600)
    counts = {}
    for remat in (False, True):
        torch.manual_seed(6)
        model = hg(num_stacks=8, num_classes=CLASSES, num_feats=FEATS, depth=4,
                   dtype=torch.float32, remat=remat, scan_stacks=scan)
        calls.clear()
        _one_step(model, batch, cfg, one_rank_group)
        counts[remat] = len(calls)
    norms = sum(isinstance(m, BatchNorm2d) for m in model.modules())
    per_unit = 39 + (4 if scan else 0)
    assert counts[False] == 2 * norms + 2
    assert counts[True] - counts[False] == 8 * per_unit == (344 if scan else 312)
