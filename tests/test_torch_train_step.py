"""posetpu_torch's train step against the JAX package's.

The draws: the port cannot reproduce JAX's threefry bits, so these tests
rebuild the JAX step's own draws (``fold_in`` -> ``split`` ->
``per_sample_keys`` -> ``sample_aug_params_ps`` and the jitter
``uniform``) and substitute them for the port's samplers by monkeypatch.
Both packages then see the same augmentation.

Configuration: ``hg2_mpii_mini`` at feats 8, 64² input, 16² heatmaps,
hourglass depth 2, batch 6.  The deepest level is 4x4, so its BatchNorms
take their statistics over n = 6*4*4 = 96 values per channel, where the
unbiased and the biased variance differ by 1%.  The train-mode forward and
its running statistics are held to flax's in float64 by
tests/test_torch_batchnorm.py.

Why each step starts from the JAX package's state.  From zero moments,
RMSprop's update -lr*g/sqrt(0.01 g² + 1e-8) is a sign for |g| >> 1e-3
and 2.5*g for |g| << 1e-3, so float32 rounding gaps grow from step to
step: three chained steps of the port and of the JAX package end with 88%
of the parameters more than 1e-4 apart and losses 2.3e-3 apart, and
chaining torch's own RMSprop instead reads the same (my CPU run).  A
chained comparison cannot tell a right optimizer from a wrong one here.
So each compared step starts from the JAX package's state (carried with
``from_optax_state``), and the update is held to optax's own update of the
port's gradients, which is tight.

Tolerances.

- LOSS_RTOL, the loss of a step from a common state.  Both forwards are
  float32 and differ by their rounding, most in BatchNorm (flax takes the
  variance as E[x²] - E[x]², torch in two passes): the loss read at most
  5.3e-6 relative over the seven steps here (my CPU run); 4e-5 holds it
  with a factor of 7.
- GRAD_ATOL, the gradients of a step from a common state.  The float32
  forwards differ by about 1e-5 relative at the 4x4 BatchNorms.  Where a
  value before a ReLU lies that close to 0 the two packages take opposite
  sides of the kink, the gradient there changes by its whole value, and
  the change spreads to every layer below: up to 5.1e-4 on gradients up
  to 0.12 (my CPU run; in float64 the two agree to 1.4e-7, so this is
  rounding, not a difference of math).  GRAD_ATOL = 4e-3 holds that with
  a factor of 8.
- OPTAX_RTOL, the port's update against optax's update of the port's own
  gradients from the same moments: both compute nu from equal inputs (one
  ulp apart at most, a fused multiply-add), the update through rsqrt (two
  ulps), two products (one each), and the sum into p, which rounds each
  side by half an ulp of its result: ``|dp| <= 5*2**-23*|u| +
  2*2**-23*|p|``.
- STATS_ATOL, BatchNorm statistics after one step from a common state:
  0.1 times the gap of the batch statistics, which read at most 8.3e-5
  after the step (my CPU run); 5e-4.
- The second of two chained steps: its loss is held by what the first
  step's parameter gap can move it, ``sum |dL/dp| * |dp|`` with the port's
  own gradients, plus LOSS_RTOL.
"""

import copy

import numpy as np
import pytest
import torch

import posetpu_torch.train.step as port_step
from posetpu_torch.aug.pipeline import AugParams
from posetpu_torch.ckpt import from_flax_variables, from_optax_state
from posetpu_torch.configs import named_config
from posetpu_torch.models import hg
from posetpu_torch.train.state import TrainState, make_optimizer
from posetpu_torch.train.step import make_train_step

STACKS, FEATS, CLASSES, DEPTH, B = 2, 8, 16, 2, 6
MEAN = (0.4404, 0.4440, 0.4327)
JAX_STEPS = 7  # the schedule (6, 8) at one step per epoch drops at update 6
CARRY_AT = 5  # a state carried at count 5 steps across that drop

ULP = 2.0**-23
LOSS_RTOL = 4e-5
GRAD_ATOL = 4e-3
STATS_ATOL = 5e-4


def _cfg():
    cfg = named_config("hg2_mpii_mini")
    cfg.model.feats = FEATS
    cfg.model.depth = DEPTH
    cfg.model.bf16 = False
    cfg.aug.inp_res = (64, 64)
    cfg.aug.out_res = (16, 16)
    return cfg


def _batch(seed, hw=(96, 128)):
    rng = np.random.RandomState(seed)
    H, W = hw
    valid_wh = np.stack(
        [rng.randint(W - 30, W + 1, B), rng.randint(H - 20, H + 1, B)], axis=1
    ).astype(np.int32)
    center = (valid_wh / 2 + rng.uniform(-5, 5, (B, 2))).astype(np.float32)
    scale = (valid_wh[:, 1] / 200.0 * rng.uniform(0.8, 1.2, B)).astype(np.float32)
    return {
        "image": rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8),
        "valid_wh": valid_wh,
        "center": center,
        "scale": scale,
        "pts": (center[:, None, :] + rng.uniform(-40, 40, (B, CLASSES, 2))).astype(np.float32),
        "vis": (rng.rand(B, CLASSES) < 0.8).astype(np.float32),
        "index": rng.choice(10_000, B, replace=False).astype(np.int32),
    }


def _ref_model(dtype_name="float32"):
    import jax.numpy as jnp

    from posetpu.models import hg as ref_hg

    return ref_hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS,
                  depth=DEPTH, dtype=getattr(jnp, dtype_name))


def _ref_variables(model, seed=0):
    """Flax init, every leaf perturbed (BN statistics included)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    v = model.init(jax.random.PRNGKey(seed + 3), jnp.zeros((1, 64, 64, 3)), train=False)
    return jax.tree.map(
        lambda a: a + 0.05 * jnp.asarray(rng.randn(*a.shape), a.dtype), v
    )


def _ref_draws(key, step, index, aug_cfg):
    """The JAX train step's own draws for one step, as numpy."""
    import jax

    from posetpu.aug.pipeline import per_sample_keys, sample_aug_params_ps

    k_par, k_jit = jax.random.split(jax.random.fold_in(key, step))
    p = sample_aug_params_ps(
        per_sample_keys(k_par, index), scale_factor=aug_cfg.scale_factor,
        rot_factor=aug_cfg.rot_factor, rot_prob=aug_cfg.rot_prob,
        flip_prob=aug_cfg.flip_prob, scale_mode=aug_cfg.scale_mode,
    )
    jitter = jax.vmap(lambda k: jax.random.uniform(k, (3,), minval=0.8, maxval=1.2))(
        per_sample_keys(k_jit, index)
    )
    return {"index": np.asarray(index), "scale_factor": np.array(p.scale_factor),
            "rot": np.array(p.rot), "flip": np.array(p.flip),
            "jitter": np.array(jitter), "k_jit": k_jit}


def _inject(monkeypatch, draws_by_step):
    """The port's samplers return the JAX step's draws of that step."""

    def params(seed, step, index, **kw):
        d = draws_by_step[step]
        np.testing.assert_array_equal(index.cpu().numpy(), d["index"])
        t = lambda a: torch.from_numpy(a).to(index.device)  # noqa: E731
        return AugParams(t(d["scale_factor"]), t(d["rot"]), t(d["flip"]))

    def jitter(seed, step, index):
        return torch.from_numpy(draws_by_step[step]["jitter"]).to(index.device)

    monkeypatch.setattr(port_step, "sample_aug_params_ps", params)
    monkeypatch.setattr(port_step, "sample_jitter_scales", jitter)


@pytest.fixture(scope="module")
def ref_run():
    """JAX_STEPS steps of the JAX package's jitted make_train_step (every
    state and metric kept, each step's draws rebuilt), and jitted helpers:
    its loss and gradients on given draws, and its optimizer update."""
    import jax
    import jax.numpy as jnp

    from posetpu.aug.pipeline import AugParams as RefParams
    from posetpu.aug.pipeline import per_sample_keys
    from posetpu.configs import named_config as ref_named_config
    from posetpu.train.state import TrainState as RefState
    from posetpu.train.state import make_optimizer as ref_make_optimizer
    from posetpu.train.step import _augment, stacked_mse
    from posetpu.train.step import make_train_step as ref_make_train_step

    cfg = ref_named_config("hg2_mpii_mini")
    cfg.aug.inp_res = (64, 64)
    cfg.aug.out_res = (16, 16)
    model = _ref_model()
    v = _ref_variables(model)
    tx = ref_make_optimizer(cfg.optim, steps_per_epoch=1)
    state = RefState(params=v["params"], batch_stats=v["batch_stats"],
                     opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
    step = jax.jit(ref_make_train_step(model, tx, cfg.aug, MEAN))
    batches = [_batch(100 + t) for t in range(JAX_STEPS)]
    keys = [jax.random.PRNGKey(1000 + t) for t in range(JAX_STEPS)]
    states, metrics = [state], []
    for t in range(JAX_STEPS):
        state, m = step(state, {k: jnp.asarray(a) for k, a in batches[t].items()}, keys[t])
        states.append(state)
        metrics.append({k: float(x) for k, x in m.items()})
    draws = {t: _ref_draws(keys[t], t, jnp.asarray(batches[t]["index"]), cfg.aug)
             for t in range(JAX_STEPS)}

    def augment(t, dtype_name="float32"):
        d, jb = draws[t], {k: jnp.asarray(a) for k, a in batches[t].items()}
        p = RefParams(jnp.asarray(d["scale_factor"]), jnp.asarray(d["rot"]),
                      jnp.asarray(d["flip"]))
        return _augment(jb, p, cfg.aug, MEAN, None, per_sample_keys(d["k_jit"], jb["index"]))

    @jax.jit
    def loss_and_grads(params, batch_stats, inp, target, weight):
        def loss_fn(p):
            outs, _ = model.apply({"params": p, "batch_stats": batch_stats}, inp,
                                  train=True, mutable=["batch_stats"])
            return stacked_mse(outs, target, weight)

        return jax.value_and_grad(loss_fn)(params)

    def grads_at(t, params, batch_stats, mask_loss=False):
        aug = augment(t)
        weight = aug["target_weight"] if mask_loss else None
        return loss_and_grads(params, batch_stats, aug["input"],
                              aug["target"].transpose(0, 2, 3, 1), weight)

    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    return {"model": model, "states": states, "metrics": metrics, "batches": batches,
            "draws": draws, "augment": augment, "grads_at": grads_at,
            "update": update, "tx": tx, "template": v["params"]}


def _port_state(params, batch_stats, opt_state=None, step=0, dtype=torch.float32):
    model = hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
               dtype=dtype)
    model.load_state_dict(
        from_flax_variables(params, batch_stats, num_stacks=STACKS, depth=DEPTH)
    )
    opt = make_optimizer(model.parameters(), _cfg().optim, steps_per_epoch=1)
    if opt_state is not None:
        opt.load_carried(model, from_optax_state(opt_state, num_stacks=STACKS, depth=DEPTH))
    return TrainState(model, opt, step)


def _step(state, batch, mask_loss=False):
    step = make_train_step(state.model, state.optimizer, _cfg().aug, MEAN,
                           mask_loss=mask_loss, device="cpu")
    return step(state, batch)


def _to_flax(named, template):
    """{port name: tensor} -> a tree shaped like the flax ``template``, by
    running the carry (from_flax_variables) twice on the template: once
    with each leaf's number in every element, once with each element's
    position in its leaf (both exact in float32), and reading them back."""
    import jax

    leaves, treedef = jax.tree.flatten(template)
    runs = [
        [np.full(a.shape, i, np.float32) for i, a in enumerate(leaves)],
        [np.arange(a.size, dtype=np.float32).reshape(a.shape) for a in leaves],
    ]
    leaf_of, pos_of = (
        from_flax_variables(jax.tree.unflatten(treedef, r), None,
                            num_stacks=STACKS, depth=DEPTH)
        for r in runs
    )
    out = [np.zeros(a.shape, np.float32) for a in leaves]
    for name, leaf in leaf_of.items():
        i = int(leaf.reshape(-1)[0])
        pos = pos_of[name].numpy().astype(np.int64).reshape(-1)
        out[i].reshape(-1)[pos] = named[name].detach().cpu().numpy().reshape(-1)
    return jax.tree.unflatten(treedef, out)


def _port_update_is_optax(ref_run, before, after, grads, count):
    """The port's parameters after a step equal optax's update of the port's
    own gradients from the port's own parameters and moments (OPTAX_RTOL
    derivation in the module docstring)."""
    import jax
    import jax.numpy as jnp
    import optax

    tmpl = ref_run["template"]
    params = _to_flax(before["params"], tmpl)
    opt_state = ref_run["tx"].init(params)
    opt_state = (opt_state[0]._replace(nu=_to_flax(before["nu"], tmpl)),
                 opt_state[1]._replace(count=jnp.asarray(count, jnp.int32)),
                 *opt_state[2:])
    u, _ = ref_run["update"](_to_flax(grads, tmpl), opt_state, params)
    want = optax.apply_updates(params, u)
    got = _to_flax(after, tmpl)
    for w, g, uu, p in zip(jax.tree.leaves(want), jax.tree.leaves(got),
                           jax.tree.leaves(u), jax.tree.leaves(params)):
        w, g, uu, p = (np.asarray(a) for a in (w, g, uu, p))
        assert (np.abs(g - w) <= 5 * ULP * np.abs(uu) + 2 * ULP * np.abs(p)).all(), \
            np.abs(g - w).max()


def _snapshot(state):
    params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    nu = {n: state.optimizer.state[p]["nu"].clone() if "nu" in state.optimizer.state[p]
          else torch.zeros_like(p) for n, p in state.model.named_parameters()}
    return {"params": params, "nu": nu}


def _check_stats(state, ref_state, what):
    want = from_flax_variables(ref_state.params, ref_state.batch_stats,
                               num_stacks=STACKS, depth=DEPTH)
    got = state.model.state_dict()
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            gap = (got[k] - w).abs().max().item()
            assert gap <= STATS_ATOL, f"{what}: {k} differs by {gap}"


@pytest.mark.parametrize("mask_loss", [False, True])
def test_step1_gradients_match_jax_grad(ref_run, monkeypatch, mask_loss):
    """The port's first train step leaves the gradients that jax.grad gives
    for the same loss on the same draws (GRAD_ATOL), the summed-stack MSE
    masked by ``target_weight`` when ``mask_loss``; the loss within
    LOSS_RTOL."""
    r = ref_run
    s0 = r["states"][0]
    want_loss, grads = r["grads_at"](0, s0.params, s0.batch_stats, mask_loss)
    want = from_flax_variables(grads, None, num_stacks=STACKS, depth=DEPTH)

    _inject(monkeypatch, r["draws"])
    state = _port_state(s0.params, s0.batch_stats)
    metrics = _step(state, r["batches"][0], mask_loss=mask_loss)
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=LOSS_RTOL)
    named = dict(state.model.named_parameters())
    assert set(named) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(named[k].grad.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_ATOL, err_msg=k)
    if mask_loss:  # the mask drops invisible joints: a smaller loss
        assert float(metrics["loss"]) < r["metrics"][0]["loss"]
    else:
        np.testing.assert_allclose(float(metrics["loss"]), r["metrics"][0]["loss"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("t", [0, 1, 2])
def test_steps_match_make_train_step(ref_run, monkeypatch, t):
    """Step t of the JAX package's jitted ``make_train_step`` (t = 0, 1, 2),
    taken by the port from the same state: its loss and PCK, its gradients
    against jax.grad, its update against optax's update of those gradients,
    and its BatchNorm statistics against the JAX step's."""
    r = ref_run
    _inject(monkeypatch, r["draws"])
    s = r["states"][t]
    state = _port_state(s.params, s.batch_stats, s.opt_state if t else None, step=t)
    before = _snapshot(state)
    m = _step(state, r["batches"][t])
    assert m["loss"].dtype == torch.float32 and m["loss"].shape == ()
    np.testing.assert_allclose(float(m["loss"]), r["metrics"][t]["loss"], rtol=LOSS_RTOL)
    # PCK: one joint more or less near a tie of the argmax
    assert abs(float(m["acc"]) - r["metrics"][t]["acc"]) <= 0.1
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    _, want = r["grads_at"](t, s.params, s.batch_stats)
    for k, w in from_flax_variables(want, None, num_stacks=STACKS, depth=DEPTH).items():
        assert (grads[k] - w).abs().max() <= GRAD_ATOL, k
    _port_update_is_optax(r, before, dict(state.model.named_parameters()), grads, t)
    _check_stats(state, r["states"][t + 1], f"step {t}")
    assert state.step == t + 1 and state.optimizer.count == t + 1


def test_carried_state_continues_across_the_lr_drop(ref_run, monkeypatch):
    """A JAX TrainState taken at step 5 (update count 5) continues in the
    port for two chained steps, the second past the schedule's drop at
    update 6: each update is optax's update of the port's gradients at the
    count it has reached, and the losses are the JAX package's own."""
    r = ref_run
    _inject(monkeypatch, r["draws"])
    s = r["states"][CARRY_AT]
    state = _port_state(s.params, s.batch_stats, s.opt_state, step=int(s.step))
    assert state.optimizer.count == CARRY_AT
    lr = state.optimizer.schedule
    assert lr(CARRY_AT) == float(np.float32(2.5e-4)) and lr(CARRY_AT + 1) < lr(CARRY_AT)
    gap_before = None
    for t in range(CARRY_AT, JAX_STEPS):
        before = _snapshot(state)
        m = _step(state, r["batches"][t])
        grads = {n: p.grad for n, p in state.model.named_parameters()}
        _port_update_is_optax(r, before, dict(state.model.named_parameters()), grads, t)
        want = r["metrics"][t]["loss"]
        tol = LOSS_RTOL * want
        if gap_before is not None:  # what the first step's parameter gap can move
            tol += sum(float((grads[k].abs() * gap_before[k]).sum()) for k in grads)
        assert abs(float(m["loss"]) - want) <= tol, (t, float(m["loss"]), want, tol)
        ref_params = from_flax_variables(r["states"][t + 1].params, None,
                                         num_stacks=STACKS, depth=DEPTH)
        gap_before = {k: (p.detach() - ref_params[k]).abs()
                      for k, p in state.model.named_parameters()}
    assert state.step == JAX_STEPS and state.optimizer.count == JAX_STEPS


def test_from_optax_state_maps_every_moment(ref_run):
    """nu and trace of an optax rmsprop with momentum and weight decay map
    by the port's parameter names, conv kernels HWIO -> OIHW, as the
    reference's own converter maps params."""
    import jax
    import jax.numpy as jnp
    import optax

    from posetpu.ckpt.transplant import to_reference_state_dict
    from posetpu.configs.config import OptimConfig as RefOptimConfig
    from posetpu.train.state import make_optimizer as ref_make_optimizer

    params = ref_run["states"][0].params
    tx = ref_make_optimizer(RefOptimConfig(momentum=0.9, weight_decay=1e-4))
    rng = np.random.RandomState(1)
    grads = jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape), a.dtype), params)
    update = jax.jit(tx.update)
    _, opt_state = update(grads, tx.init(params), params)
    _, opt_state = update(grads, opt_state, params)
    carried = from_optax_state(opt_state, num_stacks=STACKS, depth=DEPTH)
    assert carried["count"] == 2
    model = hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
               dtype=torch.float32)
    names = {n for n, _ in model.named_parameters()}
    for key in ("nu", "trace"):
        assert set(carried[key]) == names
        ref = to_reference_state_dict(optax.tree_utils.tree_get(opt_state, key),
                                      num_stacks=STACKS, depth=DEPTH)
        for k, a in carried[key].items():
            np.testing.assert_array_equal(a.numpy(), ref[k], err_msg=f"{key} {k}")
    opt = make_optimizer(model.parameters(), _cfg().optim)
    opt.load_carried(model, carried)
    assert opt.count == 2
    p = model.stem[0].weight
    assert torch.equal(opt.state[p]["trace"], carried["trace"]["stem.0.weight"])
    with pytest.raises(KeyError):
        opt.load_carried(model, {"count": 0, "nu": {"stem.0.weight": p.detach()}})
    with pytest.raises(ValueError):
        from_optax_state((), num_stacks=STACKS, depth=DEPTH)


def _dtypes_by_port_name(intermediates):
    from posetpu_torch.ckpt.transplant import _BOTTLENECK, _module_map

    names = _module_map(STACKS, 1, DEPTH)
    names.update({f"hg{i}": f"hgs.{i}" for i in range(STACKS)})
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "__call__":
                parent, _, child = path.rpartition("/")
                if path in names:
                    out[names[path]] = str(v[0].dtype)
                elif parent in names and child in _BOTTLENECK:
                    out[f"{names[parent]}.{_BOTTLENECK[child]}"] = str(v[0].dtype)
            else:
                walk(v, f"{path}/{k}" if path else k)

    walk(intermediates, "")
    return out


def test_bf16_step_matches_flax_bf16(ref_run, monkeypatch):
    """The bf16 train step: every module's output has the dtype of the
    flax module it mirrors in a bf16 train-mode forward, parameters and
    gradients stay float32, and the step-1 loss is as close to the JAX
    package's bf16 loss as that is to its f32 loss (within 2x), as
    tests/test_torch_hourglass.py holds the bf16 heatmaps, and really
    rounded: its gap to the port's own f32 loss exceeds LOSS_RTOL.  That
    gap is smaller than the reference's (1.8e-4 against 2.0e-3 here, my
    CPU run): torch's BatchNorm normalizes a bf16 input in float32."""
    import jax

    from posetpu.train.step import stacked_mse

    r = ref_run
    s0 = r["states"][0]
    aug = r["augment"](0)
    target = aug["target"].transpose(0, 2, 3, 1)
    variables = {"params": s0.params, "batch_stats": s0.batch_stats}
    ref_loss, dtypes = {}, None
    for name in ("float32", "bfloat16"):
        model = _ref_model(name)
        outs, st = jax.jit(lambda v, x, model=model: model.apply(
            v, x, train=True, mutable=["batch_stats", "intermediates"],
            capture_intermediates=True))(variables, aug["input"])
        ref_loss[name] = float(stacked_mse(outs, target))
        if name == "bfloat16":
            dtypes = _dtypes_by_port_name(st["intermediates"])

    _inject(monkeypatch, r["draws"])
    losses = {}
    for dtype in (torch.bfloat16, torch.float32):
        state = _port_state(s0.params, s0.batch_stats, dtype=dtype)
        seen = {}
        if dtype == torch.bfloat16:
            for n, mod in state.model.named_modules():
                if n in dtypes:
                    mod.register_forward_hook(
                        lambda m, i, o, n=n: seen.__setitem__(n, str(o.dtype))
                    )
        losses[dtype] = float(_step(state, r["batches"][0])["loss"])
        if dtype == torch.bfloat16:
            assert set(seen) == set(dtypes) and {"bfloat16", "float32"} <= set(dtypes.values())
            for n, want in dtypes.items():
                assert seen[n] == f"torch.{want}", n
            assert all(p.dtype == torch.float32 for p in state.model.parameters())
            assert all(p.grad.dtype == torch.float32 for p in state.model.parameters())
    gap = abs(ref_loss["float32"] - ref_loss["bfloat16"])
    assert gap > 0
    assert abs(losses[torch.bfloat16] - ref_loss["bfloat16"]) <= 2.0 * gap
    # rounded to bf16: beyond the float32 noise of the same loss
    assert abs(losses[torch.bfloat16] - losses[torch.float32]) > LOSS_RTOL * ref_loss["float32"]


def test_step_refuses_another_state():
    model = hg(num_stacks=1, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
               dtype=torch.float32)
    opt = make_optimizer(model.parameters(), _cfg().optim)
    step = make_train_step(model, opt, _cfg().aug, MEAN, device="cpu")
    other = hg(num_stacks=1, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
               dtype=torch.float32)
    with pytest.raises(ValueError):
        step(TrainState(other, opt), _batch(0))


@pytest.mark.cuda
def test_cuda_step_matches_cpu_step():
    """One f32 step (TF32 off) on the card and on the CPU from the same
    weights and batch, with the port's own draws (the same integers on both
    devices): the loss within LOSS_RTOL, the gradients within GRAD_ATOL and
    the statistics within STATS_ATOL, the derivations above with cuDNN's
    summation order in place of flax's; then a second step from each
    device's own state, its update held to the bound of one RMSprop step,
    2 * 10 * lr per parameter (|u| <= lr/sqrt(1 - 0.99) on each side)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        torch.manual_seed(0)
        cfg = _cfg()
        base = hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
                  dtype=torch.float32)
        runs = {}
        for dev in ("cpu", "cuda"):
            model = copy.deepcopy(base).to(dev)
            opt = make_optimizer(model.parameters(), cfg.optim)
            state = TrainState(model, opt)
            step = make_train_step(model, opt, cfg.aug, MEAN, seed=3, device=dev)
            loss = float(step(state, _batch(200))["loss"])
            # clones: .cpu() of a CPU tensor is the tensor the next step updates
            grads = {n: p.grad.cpu().clone() for n, p in model.named_parameters()}
            stats = {k: v.cpu().clone() for k, v in model.state_dict().items()
                     if "running" in k}
            step(state, _batch(201))
            runs[dev] = (loss, grads, stats,
                         {n: p.detach().cpu() for n, p in model.named_parameters()})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    (lc, gc, sc, pc), (lg, gg, sg, pg) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=LOSS_RTOL)
    for k in gc:
        assert (gg[k] - gc[k]).abs().max() <= GRAD_ATOL, k
    for k in sc:
        assert (sg[k] - sc[k]).abs().max() <= STATS_ATOL, k
    lr = cfg.optim.lr
    for k in pc:
        assert (pg[k] - pc[k]).abs().max() <= 2 * 2 * 10 * lr, k
