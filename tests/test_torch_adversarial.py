"""posetpu_torch's joint adversarial step against the JAX package's
``make_joint_step``: occlusion masking, advantage normalization, and one
joint step from a common carried state on the JAX step's own draws
(tests/torch_joint_harness.py), without occlusion, in mixed mode
(``pose_ref_weight=0.25``), with the batch-mean baseline
(``ref_baseline=False``) and over the ``update_every=2`` cadence.  The
occlusion modes' joint steps are in tests/test_torch_agent.py, so that the
two files' JAX compiles run on two workers.

Tolerances (the harness holds them; read on the six configurations of the
two files, on the CPU):

- LOSS_RTOL = 4e-5, a float32 forward's loss from a common state
  (tests/test_torch_train_step.py derives it); read 1.8e-6.  It holds
  each per-sample loss too, the same kind of forward.
- The advantage, mean(l_adv - l_ref): the mean over samples of
  LOSS_RTOL * (|l_adv| + |l_ref|).
- LOGIT_ATOL = 1e-5, the agent's float32 logits: a four-layer f32 CNN at
  width 8-16 rounds its logits (below 3) by a few ulps; read 2.4e-7.
- The entropy: dH/dx_j = -p_j (log p_j + H), so |dH| <= max|dx| * 2 *
  max|log p|.
- agent_loss = -mean(adv * logp): with d_i the bound of sample i's loss
  gap and d the largest, m and s the advantage's moments move by at most
  d, so |d adv_i| <= (d_i + d + |adv_i| d) / s (+ 8 ulps); log_softmax
  moves by at most twice the logits' gap, once per head on the path.
- GRAD_ATOL = 4e-3, the pose gradients, held to the JAX package's
  float64 gradient of the step's pose loss on the step's own crops (built
  op by op: the jitted program's crops differ from them by up to 2.3e-5).
  The float32 reference is no reference here: once occluders make large
  constant regions, the JAX package's f32 gradient lies 3.9e-3 from its
  own float64 one and the port's 7.1e-7 (in float64 the two packages
  agree to 7e-8; parts mode, on the CPU).  The ReLU-kink derivation of
  tests/test_torch_train_step.py stands; read 1.7e-3 (mixed mode).
- The agent's gradients, -mean(adv_i * dlogp_i): sum_i |d adv_i| *
  |dlogp_i/dtheta| / B, from the per-sample gradients, plus
  AGENT_GRAD_ROUND = 1e-5 for the backward's own rounding (read 2e-6
  where the advantages agree to 1e-7, without occlusion).
- Both updates: optax's update of the port's own gradients
  (``update_is_optax``, the 5-ulp bound of tests/test_torch_train_step.py).
- STATS_ATOL = 5e-4, the pose network's BatchNorm statistics (read
  7.1e-5); AGENT_STATS_ATOL = 2e-6, the agent's: 0.1 times a gap of batch
  statistics of values near 1 (read 1.2e-7, one ulp).
"""

import copy

import numpy as np
import pytest
import torch

import torch_joint_harness as h
from posetpu_torch.configs import named_config
from posetpu_torch.models import hg
from posetpu_torch.train.adversarial import (
    JointState,
    apply_occlusion,
    make_joint_step,
    normalize_advantage,
)
from posetpu_torch.train.state import TrainState, make_optimizer

CONFIGS = {
    "plain": dict(update_every=2),
    "mixed": dict(pose_ref_weight=0.25),
    "mean_baseline": dict(ref_baseline=False),
}


@pytest.fixture(scope="module")
def refs():
    """The JAX joint step of each configuration, jitted once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = h.RefJoint(None, **CONFIGS[name])
        return cache[name]

    return get


@pytest.mark.parametrize("per_sample", [False, True])
def test_apply_occlusion_matches_reference(per_sample):
    """Static (N, 4) and per-sample (B, N, 4) boxes, with corners off the
    crop on every side: the port zeroes exactly the reference's pixels."""
    import jax.numpy as jnp

    from posetpu.train.adversarial import apply_occlusion as ref_apply_occlusion

    rng = np.random.RandomState(3 + per_sample)
    B, H, W, N = 5, 20, 24, 7
    shape = (B, N, 4) if per_sample else (N, 4)
    boxes = np.stack([rng.randint(-8, 22, shape[:-1]), rng.randint(-8, 26, shape[:-1]),
                      rng.randint(0, 15, shape[:-1]), rng.randint(0, 15, shape[:-1])],
                     axis=-1).astype(np.int32)
    boxes[..., 0, :] = 0  # node 0: no occlusion
    images = rng.rand(B, H, W, 3).astype(np.float32) + 0.5
    nodes = np.array([0, 1, 3, 6, 2], np.int64)
    want = np.asarray(ref_apply_occlusion(jnp.asarray(images), jnp.asarray(nodes),
                                          jnp.asarray(boxes)))
    got = apply_occlusion(torch.from_numpy(images), torch.from_numpy(nodes),
                          torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got[0] == images[0]).all()


@pytest.mark.parametrize("baseline", ["batch_mean", "sign", "none"])
def test_normalize_advantage_matches_reference(baseline):
    """``batch_mean`` within 1e-5 relative: the two sum the moments in
    another order (a few ulps of E[x²], here below 10 times var) and divide
    by s; ``sign`` and any other value exactly."""
    import jax.numpy as jnp

    from posetpu.train.adversarial import _normalize_advantage

    rng = np.random.RandomState(5)
    for gap in (rng.randn(32).astype(np.float32) * 0.3 + 0.1,
                np.array([0.0, 1e-3, -2e-3, 0.0, 5e-4], np.float32)):
        want = np.asarray(_normalize_advantage(jnp.asarray(gap), baseline, None))
        got = normalize_advantage(torch.from_numpy(gap), baseline).numpy()
        if baseline == "batch_mean":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            assert abs(got.mean()) < 1e-5 and abs(got.std() - 1.0) < 1e-2
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_joint_step_matches_jax(refs, monkeypatch, name):
    """One joint step from the JAX package's initial state, carried: the
    five metrics, the agent's logits, both networks' gradients, updates
    and BatchNorm statistics (module docstring)."""
    rj = refs(name)
    js, _, _ = h.check_step(rj, monkeypatch, rj.state0, h.batch(100), 7)
    assert js.step == js.pose.step == 1
    assert js.agent.step == js.agent.optimizer.count == 1


def _agent_state(ts):
    snap = h.snapshot(ts)
    snap["buffers"] = {n: b.clone() for n, b in ts.model.named_buffers()}
    return snap, ts.optimizer.count, ts.step


def _assert_same(a, b):
    for key in ("params", "nu", "buffers"):
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), (key, n)


def test_update_every_two_skips_the_agent_on_odd_steps(refs, monkeypatch):
    """``update_every=2``: the JAX package's step 1 (no agent update), taken
    by the port from the JAX state after step 0, matches it with the agent
    left as it was; and over two chained port steps the agent moves on
    step 0 (parameters, statistics, moments, count 1, step 1) and not on
    step 1, where agent_loss and entropy are still reported."""
    rj = refs("plain")
    b0, b1 = h.batch(100), h.batch(101)
    new0, _, d0 = rj.run(rj.state0, b0, 7)
    js, before, new1 = h.check_step(rj, monkeypatch, new0, b1, 8, step_no=1,
                                    agent_count=1)
    after = _agent_state(js.agent)
    assert after[1:] == (1, 1)
    assert all(torch.equal(p, before["agent"]["params"][n]) for n, p in after[0]["params"].items())
    for k, w in h.from_flax_agent_variables(new0.agent.params, new0.agent.batch_stats).items():
        np.testing.assert_array_equal(  # the JAX step kept its agent too
            h.from_flax_agent_variables(new1.agent.params, new1.agent.batch_stats)[k].numpy(),
            w.numpy())

    _, _, d1 = rj.run(new0, b1, 8)
    h.inject(monkeypatch, {0: d0, 1: d1})
    js, step = rj.port(rj.state0)
    start = _agent_state(js.agent)
    step(js, b0)
    moved = _agent_state(js.agent)
    assert moved[1:] == (1, 1)
    assert not any(torch.equal(moved[0]["params"][n], p) for n, p in start[0]["params"].items())
    assert all(v.abs().sum() > 0 for v in moved[0]["nu"].values())
    assert not torch.equal(moved[0]["buffers"]["bn0.running_var"],
                           start[0]["buffers"]["bn0.running_var"])
    m = step(js, b1)
    still = _agent_state(js.agent)
    _assert_same(moved[0], still[0])
    assert still[1:] == (1, 1) and js.step == 2 and js.pose.step == 2
    assert torch.isfinite(m["agent_loss"]) and m["entropy"] > 0


def test_joint_step_refuses_bad_options_and_states():
    """The reference's ValueErrors, and a state built for other models."""
    cfg = h.cfg()
    pose = hg(num_stacks=1, num_classes=h.CLASSES, num_feats=h.FEATS, depth=h.DEPTH,
              dtype=torch.float32)
    agent = h.port_agent(None)
    po = make_optimizer(pose.parameters(), cfg.optim)
    ao = make_optimizer(agent.parameters(), cfg.optim)
    kw = dict(scale_table=np.ones(h.BINS, np.float32), rot_table=np.zeros(h.BINS, np.float32),
              device="cpu")
    with pytest.raises(ValueError):
        make_joint_step(pose, agent, po, ao, cfg.aug, h.MEAN, pose_ref_weight=0.2,
                        ref_baseline=False, **kw)
    with pytest.raises(ValueError):
        make_joint_step(pose, agent, po, ao, cfg.aug, h.MEAN, pose_ref_weight=1.0, **kw)
    step = make_joint_step(pose, agent, po, ao, cfg.aug, h.MEAN, **kw)
    other = copy.deepcopy(agent)
    with pytest.raises(ValueError):
        step(JointState(TrainState(pose, po), TrainState(other, ao)), h.batch(0))


@pytest.mark.cuda
def test_cuda_joint_step_matches_cpu():
    """One f32 joint step (TF32 off, tree occlusion, mixed mode) on the card
    and on the CPU from the same weights and batch, with the port's own
    keyed draws: the draws equal, the loss within LOSS_RTOL, the pose
    gradients within GRAD_ATOL, the agent's logits within LOGIT_ATOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import posetpu_torch.train.adversarial as adv
    from posetpu_torch.models.agent import occlusion_hierarchy, rotation_bin_table
    from posetpu_torch.models.agent import scale_bin_table

    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    draw = adv.sample_policy
    try:
        torch.manual_seed(0)
        cfg = h.cfg()
        base_pose = hg(num_stacks=h.STACKS, num_classes=h.CLASSES, num_feats=h.FEATS,
                       depth=h.DEPTH, dtype=torch.float32)
        base_agent = h.port_agent("tree")
        runs = {}
        for dev in ("cpu", "cuda"):
            pose, agent = copy.deepcopy(base_pose), copy.deepcopy(base_agent).to(dev)
            po = make_optimizer(pose.parameters(), cfg.optim)
            ao = make_optimizer(agent.parameters(), cfg.optim)
            seen = {}

            def spy(*a, **k):
                out = draw(*a, **k)
                seen["draws"] = out
                seen["logits"] = a[3]
                return out

            adv.sample_policy = spy
            step = make_joint_step(
                pose, agent, po, ao, cfg.aug, h.MEAN, seed=3, device=dev,
                scale_table=scale_bin_table(h.BINS), rot_table=rotation_bin_table(h.BINS),
                occ_boxes=occlusion_hierarchy((64, 64), h.LEVELS), pose_ref_weight=0.25)
            m = step(JointState(TrainState(pose, po), TrainState(agent, ao)), h.batch(200))
            extras, a, r, _ = seen["draws"]
            runs[dev] = (float(m["loss"]), {k: v.cpu() for k, v in extras.items()},
                         [x.cpu() for x in (*a, *r)],
                         {n: p.grad.cpu() for n, p in pose.named_parameters()},
                         seen["logits"]["scale"].cpu())
    finally:
        adv.sample_policy = draw
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    (lc, ec, pc, gc, xc), (lg, eg, pg, gg, xg) = runs["cpu"], runs["cuda"]
    for k in ec:
        assert torch.equal(ec[k], eg[k]), k
    for a, b in zip(pc, pg):
        assert torch.equal(a, b)
    assert abs(lg - lc) <= h.LOSS_RTOL * abs(lc)
    for k in gc:
        assert (gg[k] - gc[k]).abs().max() <= h.GRAD_ATOL, k
    assert (xg - xc).abs().max() <= h.LOGIT_ATOL
