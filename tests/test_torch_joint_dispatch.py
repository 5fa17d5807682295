"""K joint (agent) steps per dispatch (``make_joint_dispatch_step``, the
counterpart of ``fuse_steps(make_joint_step)``), its body and counters, at
small shapes (hourglass of 2 stacks, feats 8, depth 2; agent widths
(8, 16); 64² crops, 16² heatmaps; float32; batch 4, or the harness's 6):

- ``make_joint_body`` with ``JointCounters`` equals ``make_joint_step``
  exactly over four steps (metrics, both networks' parameters and
  BatchNorm statistics, both optimizers' moments, every step and count),
  for hg8_mpii_asr's agent (scale and rotation), hg8_lsp_aho's (tree
  occlusion over 22 nodes, 14 joints), body parts, ``update_every=3``,
  ``pose_ref_weight=0.3`` and the ``sign`` baseline; on a non-update step
  the body leaves the agent's statistics as they were;
- a dispatch of K = 3 and a short one of 2 equal 5 eager steps exactly,
  host ints of both states included, for ``update_every`` 1, 2 and 3;
- ``JointState.snapshot``/``restore_`` put every tensor back in place;
- the dispatch's K = 2 metrics against the JAX package's
  ``jax.jit(fuse_steps(make_joint_step))`` on the reference's own draws
  (tolerances below);
- an ``Experiment`` with the agent at K = 2 and 3 (``update_every`` 2, an
  epoch cap that trims a group) writes the ``log.txt`` of K = 1 and
  checkpoints the same agent step and count;
- at W = 2 gloo ranks, a K = 2 joint dispatch equals two eager DP joint
  steps exactly on every rank;
- on the card (``cuda`` marker; skips here) the graphed joint steps equal
  eager steps bit for bit in f32, each update pattern is captured once, a
  non-update pattern's replay keeps the agent's statistics, and a gloo
  group on CUDA raises.

Tolerances of the comparison with the JAX package
(tests/torch_joint_harness.py derives the one-step ones):

- step 1 starts from the common carried state, so its metrics hold the
  harness's one-step bounds (``metric_bounds``);
- step 2 starts from two states that the first step's float32 rounding
  has already moved apart, and chained f32 trajectories are
  ill-conditioned (ROADMAP §3: three chained steps end 2.3e-3 apart in
  loss).  So step 2 is held in two parts.  (a) The port's eager step taken
  from the *reference's* state after step 1 (carried) holds the one-step
  bounds T against the reference's step 2: the math of step 2.  (b) The
  rest is the chain's drift D = |f(port's state 1) - f(reference's state
  1)|, f the port's step-2 metric on the same draws.  For the loss (a
  train-mode forward: the running statistics do not enter) D is at most
  sum_i |dL/dp_i| |dp_i| to first order, dp the gap of the two states 1
  over the pose parameters and dL/dp the port's step-2 gradient; the test
  holds D to DRIFT_FACTOR = 2 times that bound, room for the second-order
  term, which at a step this small is far below it (read: D was 0.015 of
  the bound).  Each metric's step-2 gap is then within T + D (the triangle
  inequality with (a)).
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

import torch_joint_harness as h
from posetpu_torch.ckpt.manager import CheckpointManager
from posetpu_torch.configs import apply_overrides, named_config
from posetpu_torch.data import make_synthetic_dataset
from posetpu_torch.models import hg
from posetpu_torch.models.batchnorm import convert_cross_replica_
from posetpu_torch.parallel import RankPool, ranks_equal, shard_slice
from posetpu_torch.train import cli
from posetpu_torch.train.adversarial import (
    JointCounters,
    JointState,
    agent_from_config,
    make_joint_body,
    make_joint_dispatch_step,
    make_joint_step,
)
from posetpu_torch.train.loop import Experiment
from posetpu_torch.train.state import TrainState, make_optimizer
from posetpu_torch.train.step import WARMUP_STEPS, GraphedSteps
from posetpu_torch.utils.profiling import counter, reset_counters

B = 4
DRIFT_FACTOR = 2.0
# (named config, agent fields): each case cut to the small shapes above
CASES = {
    "asr": ("hg8_mpii_asr", {}),
    "aho_tree": ("hg8_lsp_aho", {}),
    "parts": ("hg8_mpii_asr", dict(occ_mode="parts", occ_nodes=9)),
    "every3": ("hg8_mpii_asr", dict(update_every=3)),
    "mixed": ("hg8_mpii_asr", dict(pose_ref_weight=0.3)),
    "sign": ("hg8_mpii_asr", dict(reward_baseline="sign")),
}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread for this module's CPU training (several test
    processes share the machine; tests/test_torch_dispatch.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, **agent):
    cfg = named_config(name)
    cfg.model.stacks, cfg.model.feats, cfg.model.depth, cfg.model.bf16 = 2, 8, 2, False
    cfg.aug.inp_res, cfg.aug.out_res = (64, 64), (16, 16)
    # at 2 updates an epoch the learning rates drop at updates 2 and 4
    cfg.optim.schedule = (1, 2)
    for k, v in agent.items():
        setattr(cfg.agent, k, v)
    return cfg


def _state(cfg, seed=0):
    """Seeded pose network and agent of ``cfg`` on the CPU, their
    optimizers, and ``make_joint_step``'s options for them."""
    torch.manual_seed(seed)
    m = cfg.model
    pose = hg(num_stacks=m.stacks, num_classes=m.classes, num_feats=m.feats, depth=m.depth,
              dtype=torch.float32)
    pose_opt = make_optimizer(pose.parameters(), cfg.optim, steps_per_epoch=2)
    agent, agent_opt, kw = agent_from_config(cfg, steps_per_epoch=2, widths=(8, 16),
                                             device="cpu")
    return JointState(TrainState(pose, pose_opt), TrainState(agent, agent_opt)), kw


def _args(state, cfg):
    return (state.pose.model, state.agent.model, state.pose.optimizer,
            state.agent.optimizer, cfg.aug, h.MEAN)


def _batch(seed, joints, batch=B, hw=(72, 96)):
    rng = np.random.RandomState(seed)
    H, W = hw
    valid_wh = np.stack([rng.randint(W - 20, W + 1, batch),
                         rng.randint(H - 10, H + 1, batch)], axis=1).astype(np.int32)
    center = (valid_wh / 2 + rng.uniform(-5, 5, (batch, 2))).astype(np.float32)
    scale = (valid_wh[:, 1] / 200.0 * rng.uniform(0.8, 1.2, batch)).astype(np.float32)
    return {
        "image": rng.randint(0, 256, (batch, H, W, 3), dtype=np.uint8),
        "valid_wh": valid_wh,
        "center": center,
        "scale": scale,
        "pts": (center[:, None, :] + rng.uniform(-30, 30, (batch, joints, 2))).astype(np.float32),
        "vis": (rng.rand(batch, joints) < 0.8).astype(np.float32),
        "index": rng.choice(10_000, batch, replace=False).astype(np.int32),
    }


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _assert_nets_equal(a, b):
    """Both networks' parameters, statistics and moments equal exactly."""
    for x, y in ((a.pose, b.pose), (a.agent, b.agent)):
        for t, u in zip(x.tensors(), y.tensors(), strict=True):
            assert torch.equal(t, u)


def _ints(state):
    return JointCounters.ints(state)


@pytest.mark.parametrize("case", list(CASES))
def test_body_equals_the_eager_step(case):
    """Four steps of ``make_joint_step`` and of ``make_joint_body`` from
    one state: equal metrics, networks and moments; the counters end at
    the eager state's ints, the body's state keeps its own."""
    name, agent = CASES[case]
    cfg = _cfg(name, **agent)
    eager, kw = _state(cfg)
    graphed, _ = _state(cfg)
    every = kw.pop("update_every")
    step = make_joint_step(*_args(eager, cfg), seed=3, update_every=every, device="cpu", **kw)
    body = make_joint_body(*_args(graphed, cfg), seed=3, device="cpu", **kw)
    counters = JointCounters("cpu")
    counters.load(graphed)
    non_update = 0
    for t in range(4):
        b = _batch(10 + t, cfg.model.classes)
        update = t % every == 0
        stats = [x.clone() for x in graphed.agent.model.buffers()]
        me, mb = step(eager, b), body(counters, b, update)
        assert set(me) == set(mb) == {"loss", "acc", "agent_loss", "advantage", "entropy"}
        for k in me:
            assert torch.equal(me[k], mb[k]), (t, k)
        if not update:
            non_update += 1
            for x, old in zip(graphed.agent.model.buffers(), stats, strict=True):
                assert torch.equal(x, old)
    assert non_update == (2 if every == 3 else 0)
    _assert_nets_equal(eager, graphed)
    assert tuple(int(getattr(counters, n)) for n in JointCounters.NAMES) == _ints(eager)
    assert _ints(eager)[:3] == (4, 4, 4) and _ints(graphed) == (0,) * 5


@pytest.mark.parametrize("update_every", [1, 2, 3])
def test_dispatch_equals_eager_steps(update_every):
    """From joint step 1, a dispatch of K = 3 and a short one of 2 against
    5 eager steps: metrics, networks, moments and the ints of both
    states."""
    cfg = _cfg("hg8_lsp_aho", update_every=update_every)
    batches = [_batch(20 + t, cfg.model.classes) for t in range(5)]
    runs = {}
    for how in ("eager", "dispatch"):
        state, kw = _state(cfg, seed=1)
        state.step = state.pose.step = state.pose.optimizer.count = 1
        state.agent.step = state.agent.optimizer.count = 1
        if how == "eager":
            step = make_joint_step(*_args(state, cfg), seed=5, device="cpu", **kw)
            ms = [step(state, b) for b in batches]
            metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        else:
            dispatch = make_joint_dispatch_step(*_args(state, cfg), seed=5, steps=3,
                                                device="cpu", **kw)
            assert isinstance(dispatch, GraphedSteps) and dispatch.update_every == update_every
            m1 = dispatch(state, _stack(batches[:3]))
            assert state.step == 4 and m1["agent_loss"].shape == (3,)
            m2 = dispatch(state, _stack(batches[3:]))
            metrics = {k: torch.cat([m1[k], m2[k]]) for k in m1}
        runs[how] = (state, metrics)
    (se, me), (sd, md) = runs["eager"], runs["dispatch"]
    updates = sum((1 + t) % update_every == 0 for t in range(5))
    assert _ints(se) == _ints(sd) == (6, 6, 6, 1 + updates, 1 + updates)
    _assert_nets_equal(se, sd)
    for k in me:
        assert torch.equal(me[k], md[k]), k


def test_joint_state_snapshot_restores_in_place():
    cfg = _cfg("hg8_lsp_aho", update_every=2)
    state, kw = _state(cfg)
    step = make_joint_step(*_args(state, cfg), device="cpu", **kw)
    step(state, _batch(1, 14))
    snap = state.snapshot()
    ptrs = [t.data_ptr() for t in state.tensors()]
    ints = _ints(state)
    step(state, _batch(2, 14))
    step(state, _batch(3, 14))
    assert _ints(state) != ints
    assert not all(torch.equal(t, v) for t, v in zip(state.tensors(), snap[0][0] + snap[1][0]))
    state.restore_(snap)
    assert [t.data_ptr() for t in state.tensors()] == ptrs
    for t, v in zip(state.tensors(), snap[0][0] + snap[1][0], strict=True):
        assert torch.equal(t, v)
    assert _ints(state) == ints == (1, 1, 1, 1, 1)


def test_dispatch_refuses_bad_arguments():
    cfg = _cfg("hg8_mpii_asr")
    state, kw = _state(cfg)
    with pytest.raises(ValueError):
        make_joint_dispatch_step(*_args(state, cfg), steps=0, device="cpu", **kw)
    with pytest.raises(ValueError):
        make_joint_dispatch_step(*_args(state, cfg), steps=2, device="cpu",
                                 **dict(kw, update_every=0))
    dispatch = make_joint_dispatch_step(*_args(state, cfg), steps=2, device="cpu", **kw)
    with pytest.raises(ValueError):
        dispatch(state, _stack([_batch(i, 16) for i in range(3)]))
    other = JointState(state.pose, TrainState(copy.deepcopy(state.agent.model),
                                              state.agent.optimizer))
    with pytest.raises(ValueError):
        dispatch(other, _stack([_batch(0, 16)]))


# ---- against the JAX package


def test_dispatch_matches_fused_reference(monkeypatch):
    """K = 2 from the harness's carried state on the reference's draws of
    ``fuse_steps``' key chain, against ``jax.jit(fuse_steps(make_joint_step))``
    with optax's real updates (module docstring)."""
    import jax
    import jax.numpy as jnp

    from posetpu.train.adversarial import JointState as RefJointState
    from posetpu.train.adversarial import make_joint_step as ref_make_joint_step
    from posetpu.train.state import TrainState as RefState
    from posetpu.train.state import make_optimizer as ref_make_optimizer
    from posetpu.train.step import fuse_steps

    rj = h.RefJoint(None)
    c = h.cfg()
    tx_pose = ref_make_optimizer(c.optim, steps_per_epoch=1)
    tx_agent = ref_make_optimizer(dataclasses.replace(c.optim, lr=c.agent.lr),
                                  steps_per_epoch=1)

    def real(ts, tx):
        return RefState(params=ts.params, batch_stats=ts.batch_stats,
                        opt_state=tx.init(ts.params), step=ts.step)

    s0 = RefJointState(pose=real(rj.state0.pose, tx_pose),
                       agent=real(rj.state0.agent, tx_agent), step=rj.state0.step)
    raw = ref_make_joint_step(rj.pose_model, rj.agent_model, tx_pose, tx_agent, c.aug,
                              h.MEAN, **rj.tables)
    batches = [h.batch(100), h.batch(101)]
    key = jax.random.PRNGKey(7)
    _, _, fm = jax.jit(fuse_steps(raw))(
        s0, {k: jnp.asarray(v) for k, v in _stack(batches).items()}, key)
    m = [{k: float(v[i]) for k, v in fm.items()} for i in range(2)]
    # fuse_steps' key chain: each step splits the carried key, takes the
    # second half and carries the first
    carry, sub1 = jax.random.split(key)
    _, sub2 = jax.random.split(carry)
    s1, _ = jax.jit(raw)(s0, {k: jnp.asarray(v) for k, v in batches[0].items()}, sub1)
    d = [rj.draws(s0, batches[0], sub1), rj.draws(s1, batches[1], sub2)]
    h.inject(monkeypatch, {0: d[0], 1: d[1]})
    rec = h.record(monkeypatch)

    js, _ = rj.port(rj.state0)
    dispatch = make_joint_dispatch_step(*_args(js, c), seed=0, steps=2, device="cpu",
                                        **rj.tables)
    got = dispatch(js, _stack(batches))
    pm = [{k: float(v[i]) for k, v in got.items()} for i in range(2)]
    steps = list(rec["steps"])
    assert len(steps) == 2 and js.step == 2
    grads = {n: p.grad.clone() for n, p in js.pose.model.named_parameters()}

    # step 1, from the common state
    bounds, _ = h.metric_bounds(steps[0], d[0]["logits"], m[0])
    for k, tol in bounds.items():
        assert abs(pm[0][k] - m[0][k]) <= tol, (k, pm[0], m[0], tol)

    # step 2 (a): the port's step from the reference's state 1
    ref1, step1 = rj.port(s1, step_no=1, agent_count=1)
    ref_params = {n: p.detach().clone() for n, p in ref1.pose.model.named_parameters()}
    rec["steps"].clear()
    ma = {k: float(v) for k, v in step1(ref1, batches[1]).items()}
    bounds, _ = h.metric_bounds(rec["steps"][0], d[1]["logits"], m[1])
    for k, tol in bounds.items():
        assert abs(ma[k] - m[1][k]) <= tol, (k, ma, m[1], tol)

    # step 2 (b): the chain's drift, the loss's against its first order
    own1, own_step = rj.port(rj.state0)
    own_step(own1, batches[0])  # the port's state 1, as the dispatch had it
    first_order = sum((grads[n].abs() * (p.detach() - ref_params[n]).abs()).sum()
                      for n, p in own1.pose.model.named_parameters()).item()
    drift = {k: abs(pm[1][k] - ma[k]) for k in bounds}
    assert drift["loss"] <= DRIFT_FACTOR * first_order, (drift, first_order)
    for k, tol in bounds.items():
        assert abs(pm[1][k] - m[1][k]) <= tol + drift[k], (k, pm[1], m[1], tol, drift)


# ---- Experiment


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("joint_dispatch_split")
    make_synthetic_dataset(str(root), num_train=20, num_val=5, res=(96, 80), seed=4,
                           head_rects=True)
    return ["--json", str(root / "annotations.json"), "--image-path", str(root / "images")]


def _exp_cfg(split, ckpt, k, update_every, cap):
    argv = ["--config", "hg2_mpii_mini", "--checkpoint", ckpt, "--stacks", "1",
            "--features", "8", "--train-batch", "4", "--epochs", "2",
            "--steps-per-dispatch", str(k), "--steps-per-epoch", str(cap), *split]
    cfg = apply_overrides(named_config("hg2_mpii_mini"), cli.build_parser().parse_args(argv))
    cfg.agent.enabled = True
    cfg.agent.update_every = update_every
    return cfg


@pytest.mark.parametrize("k, update_every, cap", [(2, 1, 3), (3, 2, 4)])
def test_experiment_with_the_agent_at_k_writes_the_log_of_k1(split, tmp_path, k,
                                                            update_every, cap):
    """5 batches an epoch, capped at ``cap``: a full dispatch of k and one
    the cap trims.  The log rows and the checkpointed steps and counts of
    both networks equal those of K = 1."""
    logs, saved = {}, {}
    for K in (1, k):
        ckpt = str(tmp_path / f"k{K}")
        exp = Experiment(_exp_cfg(split, ckpt, K, update_every, cap), device="cpu")
        assert exp.loader.group == K and exp.train_step.steps == K
        assert exp.train_step.update_every == update_every
        exp.fit(progress=lambda s: None)
        exp.close()
        run_dir = os.path.join(ckpt, "hg2_mpii_mini")
        logs[K] = open(os.path.join(run_dir, "log.txt")).read()
        st = CheckpointManager(run_dir).load()["state"]
        saved[K] = (st["step"], st["pose"]["step"], st["pose"]["count"],
                    st["agent"]["step"], st["agent"]["count"])
    updates = sum(t % update_every == 0 for t in range(2 * cap))
    assert saved[1] == saved[k] == (2 * cap,) * 3 + (updates,) * 2
    assert logs[1] == logs[k] and logs[1].count("\n") == 3


# ---- data parallelism


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, devices="cpu", threads=1) as p:
        yield p


def _rank_dispatch(ctx, update_every):
    """On one rank of a gloo group: two eager DP joint steps and one DP
    dispatch of K = 2 from the same state (hg8_lsp_aho's agent), each on
    this rank's rows of a global batch of B."""
    cfg = _cfg("hg8_lsp_aho", update_every=update_every)
    batches = [shard_slice(_batch(40 + t, 14), ctx.rank, ctx.world) for t in range(2)]
    out = {}
    for how in ("eager", "dispatch"):
        state, kw = _state(cfg, seed=2)
        convert_cross_replica_(state.pose.model, ctx.group)
        convert_cross_replica_(state.agent.model, ctx.group)
        if how == "eager":
            step = make_joint_step(*_args(state, cfg), group=ctx.group, device="cpu", **kw)
            ms = [step(state, b) for b in batches]
            metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        else:
            dispatch = make_joint_dispatch_step(*_args(state, cfg), steps=2, group=ctx.group,
                                                device="cpu", **kw)
            metrics = dispatch(state, _stack(batches))
        out[how] = {"metrics": metrics, "tensors": state.tensors(), "ints": _ints(state)}
    return out


@pytest.mark.parametrize("update_every", [1, 2])
def test_dp_dispatch_equals_eager_dp_steps(pool, update_every):
    ranks = pool.run(_rank_dispatch, update_every)
    for r in ranks:
        e, d = r["eager"], r["dispatch"]
        assert e["ints"] == d["ints"] == (2, 2, 2, 3 - update_every, 3 - update_every)
        for x, y in zip(e["tensors"], d["tensors"], strict=True):
            np.testing.assert_array_equal(x, y)
        for k in e["metrics"]:
            np.testing.assert_array_equal(e["metrics"][k], d["metrics"][k])
    assert ranks_equal(ranks)


# ---- on the card


@pytest.fixture
def exact_cuda():
    """f32 on the card with TF32 off and deterministic algorithms; skips
    without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev[:2]
    torch.use_deterministic_algorithms(prev[2])


@pytest.mark.cuda
def test_cuda_joint_graph_equals_eager_steps(exact_cuda):
    """hg8_lsp_aho's agent at ``update_every=3``: three graphed dispatches
    of K = 2 (patterns (T, F), (F, T), (F, F), each captured once) equal 6
    eager steps bit for bit; the (F, F) replay leaves the agent as it was;
    the rasterizer counts 2 launches a replayed step and the warm-ups'."""
    from posetpu_torch.aug import cuda_kernels

    cfg = _cfg("hg8_lsp_aho", update_every=3)
    batches = [_batch(60 + t, 14) for t in range(6)]
    runs = {}
    for how in ("eager", "graph"):
        state, kw = _state(cfg, seed=3)
        state.pose.model.cuda()
        state.agent.model.cuda()
        if how == "eager":
            step = make_joint_step(*_args(state, cfg), seed=4, device="cuda", **kw)
            ms = [step(state, b) for b in batches]
            metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        else:
            dispatch = make_joint_dispatch_step(*_args(state, cfg), seed=4, steps=2,
                                                device="cuda", **kw)
            reset_counters(cuda_kernels.RASTERIZE_LAUNCHES)
            parts = [dispatch(state, _stack(batches[0:2])), dispatch(state, _stack(batches[2:4]))]
            agent_before = [t.clone() for t in state.agent.tensors()]
            parts.append(dispatch(state, _stack(batches[4:6])))
            torch.cuda.synchronize()
            for t, u in zip(state.agent.tensors(), agent_before, strict=True):
                assert torch.equal(t, u)
            assert dispatch.captures == 3 and len(dispatch.graphs) == 3
            assert counter(cuda_kernels.RASTERIZE_LAUNCHES) == 2 * (6 + 3 * WARMUP_STEPS)
            metrics = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        torch.cuda.synchronize()
        runs[how] = (state, {k: v.cpu() for k, v in metrics.items()})
    (se, me), (sg, mg) = runs["eager"], runs["graph"]
    assert _ints(se) == _ints(sg) == (6, 6, 6, 2, 2)
    _assert_nets_equal(se, sg)
    for k in me:
        assert torch.equal(me[k], mg[k]), k


@pytest.mark.cuda
def test_cuda_dispatch_refuses_a_gloo_group():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import torch.distributed as dist

    from posetpu_torch.parallel import free_port, init_process_group

    cfg = _cfg("hg8_mpii_asr")
    state, kw = _state(cfg)
    group = init_process_group(0, 1, "cuda:0", backend="gloo", port=free_port())
    try:
        with pytest.raises(ValueError, match="gloo"):
            make_joint_dispatch_step(*_args(state, cfg), steps=2, group=group,
                                     device="cuda", **kw)
    finally:
        dist.destroy_process_group()
