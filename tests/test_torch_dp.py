"""posetpu_torch's data parallelism (posetpu_torch.parallel, the steps'
``group``, the sharded loaders and the driver's ranks) against the JAX
package's ``shard_map`` steps on a W-device mesh (the 8 virtual CPU devices
of tests/conftest.py) and against the port's own single-process step on
the same global batch.

The port's ranks are gloo processes on the CPU
(:class:`posetpu_torch.parallel.RankPool`), one pool per world size,
started once for the module; each function a rank runs lives at the top
of this module.  The JAX package is imported inside the functions that
use it, so a rank never imports it.

Configuration: hourglass of 2 stacks, feats 8, depth 2, 16 joints; 64²
crops, 16² heatmaps; global batch 8 (W = 1, 2, 4), float32.  The train
step takes the JAX step's own draws (rebuilt as
tests/test_torch_train_step.py rebuilds them) and each rank looks its rows
up by the global sample index.  The reference's sharded step runs with an
optimizer that updates nothing and keeps the (``pmean``'d) gradients as
its state (``torch_joint_harness._capture``).

Tolerances (tests/test_torch_train_step.py derives the first three for a
float32 step from a common state; a W-rank step adds only the order of
its sums):

- LOSS_RTOL = 4e-5 on the loss, STATS_ATOL = 5e-4 on the running
  statistics.
- GRAD_ATOL = 4e-3 on the averaged gradients, held (as
  tests/torch_joint_harness.py holds the joint step's) to the JAX
  package's float64 gradient of the step's loss on the whole batch: on
  this batch the float32 gradients lie 4.3e-3 (the reference's sharded
  step) and 4.8e-3 (the port's single process) from it, the port's W-rank
  step 3.1e-4 (its cross-replica statistics are flax's; my CPU run), and
  in float64 the port's W = 2 and W = 1 gradients agree to 2.3e-14.
- acc: equal to the single-process port's, and within ACC_ATOL = 0.1 of
  the reference's (a joint more or less near a tie, as
  tests/torch_joint_harness.py holds it).
- The update: every rank's parameters after the step equal, bit for bit,
  the port's own optimizer applied to the averaged gradients in this
  process, and equal each other's.
- Eval: LOSS_RTOL on the loss, the PCK counts exactly, predictions within
  PRED_ATOL = 1e-4 px (the reference's own DP eval test holds 1e-4).
- The driver's checkpoint after one f32 step against a single process's:
  the statistics within STATS_ATOL or STATS_RTOL = 1e-4 of their value
  (running variances reach 15 there; the cross-replica norm's one-pass
  variance and torch's two-pass one read 3.3e-5 apart).  The parameters:
  RMSprop's first step from zero moments, lr*g/sqrt(0.01 g² + eps), has
  slope lr/sqrt(eps) = 2.5 at g = 0 with the default eps 1e-8, so float32
  gradients a rounding apart (up to 4.8e-3 here, the module's gradient
  note) move parameters by up to 20 lr, and 14% of them read more than
  1e-4 apart: no comparison.  This test sets eps = 1, where the step is
  lr*g to within 1%, so the parameters lie within lr * GRAD_ATOL (+ 4 ulps
  of the parameter) of each other.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import posetpu_torch.train.step as port_step
import torch_joint_harness as h
from posetpu_torch.aug.pipeline import AugParams
from posetpu_torch.ckpt import CheckpointManager, from_flax_variables
from posetpu_torch.configs import named_config
from posetpu_torch.data import HostLoader, MpiiDataset, WorkerLoader, make_synthetic_dataset, pad_batch
from posetpu_torch.models import hg
from posetpu_torch.models.batchnorm import convert_cross_replica_
from posetpu_torch.parallel import (
    RankPool,
    broadcast_state_,
    check_batch,
    gather_rows,
    ranks_equal,
    resolve_num_devices,
    shard_slice,
)
from posetpu_torch.parallel.launch import to_numpy
from posetpu_torch.train import cli
from posetpu_torch.train.loop import Experiment
from posetpu_torch.train.state import TrainState, make_optimizer
from posetpu_torch.train.step import make_dispatch_step, make_eval_step, make_train_step

STACKS, FEATS, CLASSES, DEPTH, B = 2, 8, 16, 2, 8
MEAN = (0.4404, 0.4440, 0.4327)
LOSS_RTOL = 4e-5
GRAD_ATOL = 4e-3
STATS_ATOL = 5e-4
STATS_RTOL = 1e-4
ACC_ATOL = 0.1
PRED_ATOL = 1e-4
ULP = 2.0**-23
SMALL = ["--stacks", "1", "--features", "8", "--train-batch", "4"]


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread for this process's CPU steps (the ranks take one
    each too): the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pools():
    """``pools(W)``: a pool of W gloo ranks, started at first use and kept
    for the module."""
    made = {}

    def get(world):
        if world not in made:
            made[world] = RankPool(world, devices="cpu", threads=1)
        return made[world]

    yield get
    for p in made.values():
        p.close()


def _cfg():
    c = named_config("hg2_mpii_mini")
    c.model.feats = FEATS
    c.model.depth = DEPTH
    c.model.bf16 = False
    c.aug.inp_res = (64, 64)
    c.aug.out_res = (16, 16)
    return c


def _batch(seed, n=B, hw=(96, 128)):
    rng = np.random.RandomState(seed)
    H, W = hw
    valid_wh = np.stack(
        [rng.randint(W - 30, W + 1, n), rng.randint(H - 20, H + 1, n)], axis=1
    ).astype(np.int32)
    center = (valid_wh / 2 + rng.uniform(-5, 5, (n, 2))).astype(np.float32)
    scale = (valid_wh[:, 1] / 200.0 * rng.uniform(0.8, 1.2, n)).astype(np.float32)
    return {
        "image": rng.randint(0, 256, (n, H, W, 3), dtype=np.uint8),
        "valid_wh": valid_wh,
        "center": center,
        "scale": scale,
        "pts": (center[:, None, :] + rng.uniform(-40, 40, (n, CLASSES, 2))).astype(np.float32),
        "vis": (rng.rand(n, CLASSES) < 0.8).astype(np.float32),
        "index": rng.choice(10_000, n, replace=False).astype(np.int32),
    }


# ---- the port's side (these run on the ranks, and in this process at W = 1)


@contextlib.contextmanager
def _injected(draws):
    """The train step's samplers return ``draws`` (the reference's), each
    sample's row looked up by its global index."""
    row = {int(i): j for j, i in enumerate(draws["index"])}

    def rows(index):
        return torch.as_tensor([row[int(i)] for i in index.tolist()])

    def params(seed, step, index, **kw):
        r = rows(index)
        return AugParams(*(torch.from_numpy(draws[k])[r] for k in ("scale_factor", "rot", "flip")))

    def jitter(seed, step, index):
        return torch.from_numpy(draws["jitter"])[rows(index)]

    saved = port_step.sample_aug_params_ps, port_step.sample_jitter_scales
    port_step.sample_aug_params_ps, port_step.sample_jitter_scales = params, jitter
    try:
        yield
    finally:
        port_step.sample_aug_params_ps, port_step.sample_jitter_scales = saved


def _port_state(state_np, group):
    model = hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
               dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_np.items()})
    convert_cross_replica_(model, group)
    return TrainState(model, make_optimizer(model.parameters(), _cfg().optim, steps_per_epoch=1))


def _train(group, rank, world, state_np, batch, draws):
    state = _port_state(state_np, group)
    step = make_train_step(state.model, state.optimizer, _cfg().aug, MEAN, group=group,
                           device="cpu")
    with _injected(draws):
        m = step(state, shard_slice(batch, rank, world))
    model = state.model
    return {"loss": m["loss"], "acc": m["acc"],
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "params": dict(model.named_parameters()),
            "stats": {k: v for k, v in model.state_dict().items() if "running" in k}}


def _rank_train(ctx, state_np, batch, draws):
    return _train(ctx.group, ctx.rank, ctx.world, state_np, batch, draws)


def _eval(group, rank, world, state_np, batch):
    state = _port_state(state_np, group)
    step = make_eval_step(state.model, _cfg().aug, MEAN, group=group, device="cpu")
    m, preds = step(shard_slice(batch, rank, world))
    return {"metrics": m, "preds": gather_rows(preds, group)}


def _rank_eval(ctx, state_np, batch):
    return _eval(ctx.group, ctx.rank, ctx.world, state_np, batch)


def _superbatch_shard(superbatch, rank, world):
    """This rank's (K, B/W, ...) share of a (K, B, ...) superbatch, as a
    sharded loader stacks it: each step's batch sliced, then stacked (the
    reference's ``P(None, axis)``)."""
    steps = [shard_slice({k: v[i] for k, v in superbatch.items()}, rank, world)
             for i in range(len(superbatch["index"]))]
    return {k: np.stack([s[k] for s in steps]) for k in superbatch}


def _rank_dispatch(ctx, state_np, superbatch):
    """Two eager DP steps and one K = 2 dispatch from the same state, on
    this rank's (K, B/W, ...) slice of the superbatch."""
    out = {}
    local = _superbatch_shard(superbatch, ctx.rank, ctx.world)
    for how in ("eager", "dispatch"):
        st = _port_state(state_np, ctx.group)
        kw = dict(group=ctx.group, device="cpu")
        if how == "eager":
            step = make_train_step(st.model, st.optimizer, _cfg().aug, MEAN, **kw)
            ms = [step(st, {k: v[i] for k, v in local.items()}) for i in range(2)]
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        else:
            step = make_dispatch_step(st.model, st.optimizer, _cfg().aug, MEAN, steps=2, **kw)
            m = step(st, local)
        out[how] = {"metrics": m, "state": st.model.state_dict(), "step": st.step,
                    "count": st.optimizer.count}
    return out


def _rank_refuses_cuda_graph_on_gloo(ctx, state_np):
    """make_dispatch_step on a CUDA device with this gloo group raises
    before it touches the device (CUDA is faked as present)."""
    st = _port_state(state_np, ctx.group)
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: True
    try:
        make_dispatch_step(st.model, st.optimizer, _cfg().aug, MEAN, group=ctx.group,
                           device="cuda")
    except ValueError as e:
        return str(e)
    finally:
        torch.cuda.is_available = real
    return None


def _rank_collectives(ctx):
    from posetpu_torch.parallel import all_reduce_mean_, all_reduce_sum_

    r = float(ctx.rank)
    a, b = torch.full((3,), r), torch.full((2, 2), 10.0 * r)
    all_reduce_sum_([a, b], ctx.group)
    m = torch.tensor([r, 2.0])
    all_reduce_mean_([m], ctx.group)
    g = gather_rows(torch.arange(4.0).reshape(2, 2) + 100 * r, ctx.group)
    model = hg(num_stacks=1, num_classes=4, num_feats=8, depth=1, dtype=torch.float32)
    torch.manual_seed(ctx.rank)  # every rank starts from other weights
    for p in model.parameters():
        torch.nn.init.normal_(p)
    broadcast_state_(model, ctx.group)
    return {"sum": [a, b], "mean": m, "gather": g, "state": model.state_dict()}


def _rank_experiment(ctx, cfg, train):
    exp = Experiment(cfg, device="cpu", rank=ctx.rank, world=ctx.world)
    try:
        out = {"val0": exp.validate(0)}
        if train:
            out["train"] = exp.train_epoch(0)
            out["state"] = exp.model.state_dict()
        return out
    finally:
        exp.close()


# ---- the reference's side


def _ref_model(axis_name=None):
    import jax.numpy as jnp

    from posetpu.models import hg as ref_hg

    return ref_hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
                  dtype=jnp.float32, axis_name=axis_name)


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
            "rot": np.array(p.rot), "flip": np.array(p.flip), "jitter": np.array(jitter),
            "k_jit": np.asarray(jax.random.key_data(k_jit))}


def _grads64(v, jbatch, draws, aug_cfg):
    """jax.grad of the train step's loss on the whole batch in float64, on
    the crops of ``draws`` built op by op."""
    import jax
    import jax.numpy as jnp

    from posetpu.aug.pipeline import AugParams as RefParams
    from posetpu.aug.pipeline import per_sample_keys
    from posetpu.models import hg as ref_hg
    from posetpu.train.step import _augment, stacked_mse

    p = RefParams(*(jnp.asarray(draws[k]) for k in ("scale_factor", "rot", "flip")))
    k_jit = jax.random.wrap_key_data(jnp.asarray(draws["k_jit"]))
    aug = _augment(jbatch, p, aug_cfg, MEAN, None, per_sample_keys(k_jit, jbatch["index"]))
    model = ref_hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
                   dtype=jnp.float64)
    with jax.enable_x64(True):
        f64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           (v["params"], v["batch_stats"], aug["input"],
                            aug["target"].transpose(0, 2, 3, 1)))
        params, stats, inp, tgt = f64

        def loss_fn(q):
            outs, _ = model.apply({"params": q, "batch_stats": stats}, inp, train=True,
                                  mutable=["batch_stats"])
            return stacked_mse(outs, tgt)

        g = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params))
    return _carry(g)


def _carry(params, stats=None):
    return {k: v.numpy() for k, v in
            from_flax_variables(params, stats, num_stacks=STACKS, depth=DEPTH).items()}


@pytest.fixture(scope="module")
def ref():
    """Perturbed reference variables, a batch, its draws, and the reference's
    sharded train step at ``world`` (cached): metrics, ``pmean``'d
    gradients and new statistics."""
    import jax
    import jax.numpy as jnp

    from posetpu.configs import named_config as ref_named_config
    from posetpu.parallel import make_mesh, shard_eval_step, shard_train_step
    from posetpu.train.state import TrainState as RefState
    from posetpu.train.step import make_eval_step as ref_make_eval_step
    from posetpu.train.step import make_train_step as ref_make_train_step

    cfg = ref_named_config("hg2_mpii_mini")
    cfg.aug.inp_res, cfg.aug.out_res = (64, 64), (16, 16)
    rng = np.random.RandomState(0)
    v = _ref_model().init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)), train=False)
    v = jax.tree.map(lambda a: a + 0.05 * jnp.asarray(rng.randn(*a.shape), a.dtype), v)
    batch = _batch(100)
    key = jax.random.PRNGKey(1000)
    cap = h._capture()
    state = RefState(params=v["params"], batch_stats=v["batch_stats"],
                     opt_state=cap.init(v["params"]), step=jnp.zeros((), jnp.int32))
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    runs = {}

    def train(world):
        if world not in runs:
            step = shard_train_step(
                ref_make_train_step(_ref_model("data"), cap, cfg.aug, MEAN, axis_name="data"),
                make_mesh(world), donate=False)
            new, m = step(state, jbatch, key)
            runs[world] = {"metrics": {k: float(x) for k, x in m.items()},
                           "grads": _carry(new.opt_state),
                           "stats": {k: x for k, x in _carry(new.params, new.batch_stats).items()
                                     if "running" in k}}
        return runs[world]

    def evaluate(world, padded):
        step = shard_eval_step(
            ref_make_eval_step(_ref_model("data"), cfg.aug, MEAN, axis_name="data"),
            make_mesh(world))
        m, preds = step(state, {k: jnp.asarray(a) for k, a in padded.items()})
        return {k: np.asarray(x) for k, x in m.items()}, np.asarray(preds)

    draws = _ref_draws(key, 0, jbatch["index"], cfg.aug)
    return {"state_np": _carry(v["params"], v["batch_stats"]), "batch": batch,
            "draws": draws, "train": train, "evaluate": evaluate,
            "grads64": _grads64(v, jbatch, draws, cfg.aug)}


@pytest.fixture(scope="module")
def train_runs(ref, pools):
    """``train_runs(W)``: the port's W ranks, the port's single process and
    the reference's sharded step on one global batch (cached)."""
    cache = {}

    def get(world):
        if world not in cache:
            args = (ref["state_np"], ref["batch"], ref["draws"])
            cache[world] = {"ranks": pools(world).run(_rank_train, *args),
                            "one": to_numpy(_train(None, 0, 1, *args)),
                            "ref": ref["train"](world)}
        return cache[world]

    return get


def _max_gap(got, want):
    assert set(got) == set(want)
    return max(np.abs(got[k] - want[k]).max() for k in want)


# ---- (b) the train step


@pytest.mark.parametrize("world", [2, 4])
def test_dp_train_loss_and_acc(train_runs, world):
    r = train_runs(world)
    got = r["ranks"][0]
    for other in (r["ref"]["metrics"]["loss"], float(r["one"]["loss"])):
        np.testing.assert_allclose(float(got["loss"]), other, rtol=LOSS_RTOL)
    assert float(got["acc"]) == float(r["one"]["acc"])
    assert abs(float(got["acc"]) - r["ref"]["metrics"]["acc"]) <= ACC_ATOL


@pytest.mark.parametrize("world", [2, 4])
def test_dp_train_gradients_are_the_global_batch_gradients(ref, train_runs, world):
    """The averaged gradients every rank applies are the gradients of the
    whole batch's loss: held to the JAX package's float64 gradient of the
    step's loss on the step's crops (module docstring)."""
    r = train_runs(world)
    g64 = {k: v.astype(np.float32) for k, v in ref["grads64"].items()}
    assert _max_gap(r["ranks"][0]["grads"], g64) <= GRAD_ATOL


@pytest.mark.parametrize("world", [2, 4])
def test_dp_train_batchnorm_statistics(train_runs, world):
    r = train_runs(world)
    got = r["ranks"][0]["stats"]
    assert _max_gap(got, r["ref"]["stats"]) <= STATS_ATOL
    assert _max_gap(got, r["one"]["stats"]) <= STATS_ATOL


@pytest.mark.parametrize("world", [2, 4])
def test_dp_train_update_is_the_optimizers_and_ranks_agree(ref, train_runs, world):
    r = train_runs(world)
    assert ranks_equal(r["ranks"])
    state = _port_state(ref["state_np"], None)
    named = dict(state.model.named_parameters())
    for n, p in named.items():
        p.grad = torch.from_numpy(r["ranks"][0]["grads"][n])
    state.optimizer.step()
    for n, p in named.items():
        np.testing.assert_array_equal(r["ranks"][0]["params"][n], p.detach().numpy(), err_msg=n)


# ---- (c) the eval step on a ragged last batch


@pytest.fixture(scope="module")
def eval_runs(ref, pools):
    ragged = {k: v[:5] for k, v in ref["batch"].items()}
    padded = pad_batch(ragged, B)
    return {"ranks": pools(2).run(_rank_eval, ref["state_np"], padded),
            "one": to_numpy(_eval(None, 0, 1, ref["state_np"], padded)),
            "ref": ref["evaluate"](2, padded)}


def test_dp_eval_ragged_batch_metrics(eval_runs):
    """The padded rows count nowhere: the global loss, acc and per-joint
    counts equal the reference's sharded eval and the single process's."""
    got = eval_runs["ranks"][0]["metrics"]
    for want in (eval_runs["ref"][0], eval_runs["one"]["metrics"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_array_equal(got["pck_hit"], want["pck_hit"])
        np.testing.assert_array_equal(got["pck_cnt"], want["pck_cnt"])
        assert float(got["acc"]) == pytest.approx(float(want["acc"]), abs=1e-7)
    assert ranks_equal([r["metrics"] for r in eval_runs["ranks"]])


def test_dp_eval_gathers_predictions_in_global_order(eval_runs):
    got = eval_runs["ranks"][0]["preds"]
    assert got.shape == (B, CLASSES, 2)
    np.testing.assert_allclose(got, eval_runs["ref"][1], atol=PRED_ATOL)
    np.testing.assert_allclose(got, eval_runs["one"]["preds"], atol=PRED_ATOL)
    assert ranks_equal([r["preds"] for r in eval_runs["ranks"]])


# ---- (e) K steps per dispatch under a group


def test_dp_dispatch_k2_equals_two_eager_dp_steps(ref, pools):
    superbatch = {k: np.stack([v, w]) for (k, v), w in
                  zip(_batch(7).items(), _batch(8).values())}
    ranks = pools(2).run(_rank_dispatch, ref["state_np"], superbatch)
    for r in ranks:
        e, d = r["eager"], r["dispatch"]
        assert (e["step"], e["count"]) == (d["step"], d["count"]) == (2, 2)
        for k in e["state"]:
            np.testing.assert_array_equal(e["state"][k], d["state"][k], err_msg=k)
        for k in e["metrics"]:
            np.testing.assert_array_equal(e["metrics"][k], d["metrics"][k], err_msg=k)
    assert ranks_equal(ranks)


def test_gloo_group_refuses_a_cuda_graph(ref, pools):
    msgs = pools(2).run(_rank_refuses_cuda_graph_on_gloo, ref["state_np"])
    assert all(m and "NCCL" in m for m in msgs), msgs


# ---- the collectives and the loaders' shards


def test_collectives_sum_mean_gather_and_broadcast(pools):
    ranks = pools(4).run(_rank_collectives)
    np.testing.assert_array_equal(ranks[0]["sum"][0], np.full(3, 6.0))
    np.testing.assert_array_equal(ranks[0]["sum"][1], np.full((2, 2), 60.0))
    np.testing.assert_array_equal(ranks[0]["mean"], [1.5, 2.0])
    want = np.concatenate([np.arange(4.0).reshape(2, 2) + 100 * r for r in range(4)])
    np.testing.assert_array_equal(ranks[0]["gather"], want)
    assert ranks_equal(ranks)  # rank 0's weights everywhere


def test_shard_slice_batch_and_superbatch_dims():
    b = {"x": np.arange(24).reshape(2, 12), "index": np.zeros((2, 12))}
    np.testing.assert_array_equal(_superbatch_shard(b, 2, 4)["x"], [[6, 7, 8], [18, 19, 20]])
    np.testing.assert_array_equal(shard_slice({"x": np.arange(8)}, 1, 2)["x"], [4, 5, 6, 7])
    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        check_batch(8, 3)


def test_rank_pool_defaults_to_the_card(monkeypatch):
    """Without ``devices`` the ranks go to ``cuda:r``: with no CUDA the pool
    raises before it starts a process, unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RankPool(2)


def test_device_count_rule():
    n = os.cpu_count()
    assert resolve_num_devices(None, "cpu") == 1
    assert resolve_num_devices(2, "cpu") == 2
    with pytest.raises(RuntimeError, match=f"--num-devices {n}"):
        resolve_num_devices(n + 1, "cpu")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_split")
    make_synthetic_dataset(str(root), num_train=8, num_val=6, res=(96, 80), seed=1,
                           head_rects=True)
    return str(root)


@pytest.mark.parametrize("loader", [HostLoader, WorkerLoader])
def test_sharded_train_loader_rows_are_slices_of_the_global_batch(split, loader):
    ds = MpiiDataset(os.path.join(split, "annotations.json"), os.path.join(split, "images"))
    kw = dict(pad_hw=(128, 128), seed=3)
    whole = list(loader(ds, 4, **kw))
    parts = [list(loader(ds, 4, shard=(r, 2), **kw)) for r in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == 2
    for b, batch in enumerate(whole):
        for k, v in batch.items():
            got = np.concatenate([np.asarray(p[b][k]) for p in parts])
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


@pytest.mark.parametrize("loader", [HostLoader, WorkerLoader])
def test_sharded_validation_loader_pads_like_pad_batch(split, loader):
    """A padded validation loader, whole or cut into two ranks, yields
    what ``pad_batch`` makes of the plain loader's ragged batches; a sharded
    loader that would keep a ragged batch refuses."""
    ds = MpiiDataset(os.path.join(split, "annotations.json"), os.path.join(split, "images"),
                     split="valid")
    kw = dict(pad_hw=(128, 128), shuffle=False, drop_last=False)
    want = [pad_batch(b, 4) for b in loader(ds, 4, **kw)]
    whole = list(loader(ds, 4, pad=True, **kw))
    parts = [list(loader(ds, 4, pad=True, shard=(r, 2), **kw)) for r in range(2)]
    assert [len(p) for p in (whole, *parts)] == [2, 2, 2]
    assert want[-1]["mask"].tolist() == [1, 1, 0, 0]
    for b, batch in enumerate(want):
        assert batch.keys() == whole[b].keys() == parts[0][b].keys()
        for k, v in batch.items():
            np.testing.assert_array_equal(np.asarray(whole[b][k]), np.asarray(v), err_msg=k)
            got = np.concatenate([np.asarray(p[b][k]) for p in parts])
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    with pytest.raises(ValueError, match="must pad"):
        loader(ds, 4, shard=(0, 2), **kw)


# ---- (f) the driver and the command line


def _exp_cfg(split, ckpt, **kw):
    cfg = named_config("hg2_mpii_mini")
    cfg.model.stacks, cfg.model.feats, cfg.model.bf16 = 1, 8, False
    cfg.batch_size, cfg.steps_per_epoch, cfg.pad_hw = 4, 1, (192, 192)
    cfg.optim.rms_eps = 1.0  # a step linear in the gradient (module docstring)
    cfg.annotations = os.path.join(split, "annotations.json")
    cfg.images_dir = os.path.join(split, "images")
    cfg.checkpoint_dir = ckpt
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def test_experiment_two_ranks_equal_one_process(split, tmp_path, pools):
    """The driver at W = 2 against W = 1 on the same split: validation
    (the ragged last batch padded and masked by the sharded loader, the
    predictions gathered in order), then one train step."""
    cfg = _exp_cfg(split, str(tmp_path / "two"))
    ranks = pools(2).run(_rank_experiment, cfg, True)
    one = Experiment(_exp_cfg(split, str(tmp_path / "one")), device="cpu")
    try:
        val, preds = one.validate(0)
        tr = one.train_epoch(0)
        state = to_numpy(one.model.state_dict())
    finally:
        one.close()
    got_val, got_preds = ranks[0]["val0"]
    assert got_preds.shape == preds.shape == (6, CLASSES, 2)
    np.testing.assert_allclose(got_preds, preds, atol=PRED_ATOL)
    np.testing.assert_allclose(got_val["loss"], val["loss"], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got_val["pck_cnt"], val["pck_cnt"])
    np.testing.assert_allclose(ranks[0]["train"]["loss"], tr["loss"], rtol=LOSS_RTOL)
    assert ranks_equal([r["state"] for r in ranks])
    got = ranks[0]["state"]
    lr = _exp_cfg(split, "").optim.lr
    for k, w in state.items():
        if "running" in k:
            np.testing.assert_allclose(got[k], w, rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=k)
        elif w.dtype == np.float32:
            assert np.all(np.abs(got[k] - w) <= lr * GRAD_ATOL + 4 * ULP * np.abs(w)), k


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("dp_cli"))
    argv = ["--config", "hg2_mpii_mini", "--cpu", "--synthetic", "--num-devices", "2",
            "--epochs", "1", "--steps-per-epoch", "2", "--checkpoint", ckpt, *SMALL]
    assert cli.main(argv) == 0
    return ckpt, argv


def test_cli_two_cpu_ranks_train_validate_and_checkpoint_from_rank0(cli_run):
    ckpt, _ = cli_run
    run = os.path.join(ckpt, "hg2_mpii_mini")
    names = sorted(n for n in os.listdir(run) if n != "log.png")
    assert names == ["best", "ckpt", "config.json", "log.txt", "preds.mat"]
    assert os.listdir(os.path.join(run, "ckpt")) == ["00000"]  # no rank's temp dir left
    with open(os.path.join(run, "log.txt")) as f:
        rows = f.read().splitlines()
    assert len(rows) == 2 and rows[1].startswith("0\t")  # one writer, one row
    import scipy.io

    preds = scipy.io.loadmat(os.path.join(run, "preds.mat"))["preds"]
    assert preds.shape[0] == 16  # the synthetic split's validation images


def test_cli_resume_continues_on_two_ranks(cli_run):
    ckpt, argv = cli_run
    assert cli.main([*argv[:argv.index("--epochs")], "--epochs", "2", "--resume", "auto",
                     *argv[argv.index("--epochs") + 2:]]) == 0
    run = os.path.join(ckpt, "hg2_mpii_mini")
    with open(os.path.join(run, "log.txt")) as f:
        rows = f.read().splitlines()
    assert [r.split("\t")[0] for r in rows[1:]] == ["0", "1"]
    payload = CheckpointManager(run).load()
    assert payload["epoch"] == 1 and payload["state"]["step"] == 4


def test_num_devices_above_visible_and_indivisible_batch_raise(split, tmp_path):
    n = os.cpu_count()
    with pytest.raises(RuntimeError, match=f"--num-devices {n}"):
        cli.main(["--config", "hg2_mpii_mini", "--cpu", "--num-devices", str(n + 1),
                  "--checkpoint", str(tmp_path), "--synthetic", *SMALL])
    with pytest.raises(ValueError, match="--num-devices 2"):
        Experiment(_exp_cfg(split, str(tmp_path), num_devices=2), device="cpu")
    with pytest.raises(ValueError, match="not divisible by 2 devices"):
        Experiment(_exp_cfg(split, str(tmp_path), batch_size=5), device="cpu", rank=0, world=2)
    assert not os.listdir(tmp_path)


# ---- (g) the fifth named config


def test_named_config_dp8_equals_the_reference_field_for_field():
    """Every field the port's config holds equals the reference's."""
    import dataclasses

    from posetpu.configs import named_config as ref_named_config

    def check(mine, theirs, path):
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):
                check(a, b, f"{path}.{f.name}")
            else:
                assert (tuple(a) if isinstance(a, (list, tuple)) else a) == \
                    (tuple(b) if isinstance(b, (list, tuple)) else b), f"{path}.{f.name}"

    cfg = named_config("hg8_mpii_384_dp8")
    check(cfg, ref_named_config("hg8_mpii_384_dp8"), "cfg")
    assert (cfg.model.stacks, cfg.model.feats, cfg.batch_size, cfg.num_devices) == (8, 128, 48, 8)
    assert tuple(cfg.aug.inp_res) == (384, 384) and tuple(cfg.aug.out_res) == (96, 96)
    assert cfg.agent.enabled
