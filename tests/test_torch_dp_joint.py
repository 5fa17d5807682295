"""posetpu_torch's joint adversarial step under data parallelism
(``make_joint_step(group=...)``) at W = 2 against the JAX package's
``make_joint_step(axis_name="data")`` under ``shard_map`` on a 2-device
mesh, and against the port's own single-process joint step on the same
global batch: grid occlusion ("tree") off and on, ``pose_ref_weight`` 0
and 0.5.

The configuration and the common carried state are
tests/torch_joint_harness.py's (hourglass 2 stacks, feats 8, depth 2;
agent widths (8, 16), 5 scale and 5 rotation bins, occlusion levels
(1, 2); 64² crops, 16² heatmaps; global batch 6, float32).  Both the
port's ranks (gloo processes on the CPU, one pool for the module) and its
single process take the JAX step's own draws, each rank looking its rows
up by the global sample index; the draws depend only on the sample, so
the single-device step's draws are the sharded step's.  The reference's
sharded step runs with an optimizer that keeps the ``pmean``'d gradients
as its state (``torch_joint_harness._capture``).

Tolerances (the harness derives them for one process; a W-rank step adds
only the order of its sums):

- the pose loss within LOSS_RTOL, acc within 0.1 (a joint near a tie),
  the entropy within 2 * LOGIT_ATOL * max|log p|, the advantage within the
  mean of LOSS_RTOL * (|l_adv| + |l_ref|), agent_loss within the
  harness's bound from the normalized advantage and the log-probs;
- the pose gradients within GRAD_ATOL of the JAX package's float64
  gradient of the step's pose loss on the whole batch (its f32 gradient
  is no reference once occluders are drawn; the harness says why);
- the advantage as normalized on the ranks, against the single process's:
  the loss gaps within LOSS_RTOL * (|l_adv| + |l_ref|) each, and the
  normalized values within what those gaps can move them (``_adv_bound``,
  the harness's derivation; mixed mode takes both losses from the
  train-mode pass, whose cross-replica statistics round otherwise, and
  reads 2.3e-5 there).  Each rank standardizes its rows with the moments
  of the whole batch (averaged over the ranks before the std); the test
  checks that moments of a rank's own rows would land 100 bounds away;
- the agent's gradients against the single process's: AGENT_GRAD_ATOL =
  1e-5, the harness's AGENT_GRAD_ROUND (the two differ in the order of
  the sums only; read 1.5e-8);
- statistics: STATS_ATOL (pose), AGENT_STATS_ATOL (agent) against the
  reference's sharded step;
- both updates: each rank's parameters equal the port's optimizer applied
  to the averaged gradients in this process, bit for bit, and every rank
  holds the same state.
"""

import numpy as np
import pytest
import torch

import posetpu_torch.train.adversarial as port_adv
import torch_joint_harness as h
from posetpu_torch.aug.pipeline import AugParams
from posetpu_torch.models import hg
from posetpu_torch.models.batchnorm import convert_cross_replica_
from posetpu_torch.parallel import RankPool, ranks_equal, shard_slice
from posetpu_torch.parallel.launch import to_numpy
from posetpu_torch.train.adversarial import JointState, make_joint_step
from posetpu_torch.train.state import TrainState, make_optimizer

W = 2
AGENT_GRAD_ATOL = 1e-5
CONFIGS = {
    "plain": (None, 0.0),
    "mixed": (None, 0.5),
    "tree": ("tree", 0.0),
    "tree_mixed": ("tree", 0.5),
}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    with RankPool(W, devices="cpu", threads=1) as p:
        yield p


def _inject(d):
    """sample_policy returns the reference's draws ``d``, by global index."""
    row = {int(i): j for j, i in enumerate(d["index"])}

    def sample_policy(seed, step, index, logits, aug_cfg, scale_table, rot_table, occ):
        r = torch.as_tensor([row[int(i)] for i in index.tolist()])
        t = lambda a: torch.from_numpy(np.array(a))[r]  # noqa: E731
        extras = {k: t(v).long() for k, v in d["extras"].items()}
        jitter = t(d["jitter"]) if aug_cfg.color_jitter else None
        return extras, AugParams(*map(t, d["adv"])), AugParams(*map(t, d["ref"])), jitter

    return sample_policy


def _joint(group, rank, world, job):
    """One joint step of the port from the carried state, on this rank's
    rows; what it computed and where it left both networks."""
    mode, w = job["mode"], job["pose_ref_weight"]
    c = h.cfg()
    pose = hg(num_stacks=h.STACKS, num_classes=h.CLASSES, num_feats=h.FEATS, depth=h.DEPTH,
              dtype=torch.float32)
    pose.load_state_dict({k: torch.from_numpy(v) for k, v in job["pose"].items()})
    agent = h.port_agent(mode)
    agent.load_state_dict({k: torch.from_numpy(v) for k, v in job["agent"].items()})
    convert_cross_replica_(pose, group)
    convert_cross_replica_(agent, group)
    import dataclasses

    pose_opt = make_optimizer(pose.parameters(), c.optim, steps_per_epoch=1)
    agent_opt = make_optimizer(agent.parameters(), dataclasses.replace(c.optim, lr=c.agent.lr),
                               steps_per_epoch=1)
    js = JointState(TrainState(pose, pose_opt), TrainState(agent, agent_opt))
    step = make_joint_step(pose, agent, pose_opt, agent_opt, c.aug, h.MEAN, seed=0,
                           pose_ref_weight=w, group=group, device="cpu", **job["tables"])
    rec = {}
    saved = (port_adv.sample_policy, port_adv.normalize_advantage, port_adv.policy_logp,
             port_adv.per_sample_stacked_mse)
    norm, logp, mse = saved[1:]

    def rec_mse(outs, target):
        out = mse(outs, target)
        rec["l_adv"] = out.detach()[:job["batch"]["index"].shape[0] // world].clone()
        return out

    def rec_norm(gap, baseline, group=None):
        out = norm(gap, baseline, group)
        rec["gap"], rec["adv"] = gap.detach().clone(), out.clone()
        return out

    def rec_logp(logits, extras):
        out = logp(logits, extras)
        rec["logp"] = out.detach().clone()
        return out

    port_adv.sample_policy = _inject(job["draws"])
    port_adv.normalize_advantage, port_adv.policy_logp = rec_norm, rec_logp
    port_adv.per_sample_stacked_mse = rec_mse  # its last call is the train pass
    try:
        m = step(js, shard_slice(job["batch"], rank, world))
    finally:
        (port_adv.sample_policy, port_adv.normalize_advantage, port_adv.policy_logp,
         port_adv.per_sample_stacked_mse) = saved
    out = {"metrics": m, "rec": rec}
    for name, net in (("pose", pose), ("agent", agent)):
        out[name] = {"grads": {n: p.grad for n, p in net.named_parameters() if p.grad is not None},
                     "params": dict(net.named_parameters()),
                     "stats": {k: v for k, v in net.state_dict().items() if "running" in k}}
    return out


def _rank_joint(ctx, job):
    return _joint(ctx.group, ctx.rank, ctx.world, job)


def _ref_dp_step(rj, mode, w):
    """The reference's joint step with ``axis_name`` under shard_map."""
    import jax.numpy as jnp

    from posetpu.models import hg as ref_hg
    from posetpu.models.agent import AugAgent as RefAgent
    from posetpu.parallel import make_mesh, shard_train_step
    from posetpu.train.adversarial import make_joint_step as ref_make_joint_step

    pose = ref_hg(num_stacks=h.STACKS, num_classes=h.CLASSES, num_feats=h.FEATS,
                  depth=h.DEPTH, dtype=jnp.float32, axis_name="data")
    agent = RefAgent(num_scale_bins=h.BINS, num_rot_bins=h.BINS,
                     num_occ_nodes=h.occ_nodes(mode), occ_mode=mode or "tree",
                     occ_levels=h.LEVELS, widths=h.WIDTHS, input_downscale=h.DOWNSCALE,
                     dtype=jnp.float32, axis_name="data")
    cap = h._capture()
    step = ref_make_joint_step(pose, agent, cap, cap, h.cfg().aug, h.MEAN, **rj.tables,
                               axis_name="data", pose_ref_weight=w)
    return shard_train_step(step, make_mesh(W), donate=False)


@pytest.fixture(scope="module")
def runs(pool):
    """``runs(name)``: the reference's single-device step (its draws and
    float64 pose gradients), its sharded step, the port's W ranks and its
    single process, for one configuration (cached)."""
    import jax
    import jax.numpy as jnp

    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        mode, w = CONFIGS[name]
        rj = h.RefJoint(mode, pose_ref_weight=w)
        b = h.batch(11)
        key_seed = 5
        _, m1, d = rj.run(rj.state0, b, key_seed)
        new, m = _ref_dp_step(rj, mode, w)(
            rj.state0, {k: jnp.asarray(a) for k, a in b.items()}, jax.random.PRNGKey(key_seed))
        s0 = rj.state0
        job = {"mode": mode, "pose_ref_weight": w, "batch": b,
               "pose": to_numpy(h.from_flax_variables(
                   s0.pose.params, s0.pose.batch_stats, num_stacks=h.STACKS, depth=h.DEPTH)),
               "agent": to_numpy(h.from_flax_agent_variables(
                   s0.agent.params, s0.agent.batch_stats)),
               "tables": rj.tables,
               "draws": {k: v for k, v in d.items() if k not in ("pose_grads", "logits")}}
        cache[name] = {
            "job": job, "d": d,
            "ref": {"metrics": {k: float(x) for k, x in m.items()},
                    "pose_stats": to_numpy(h.from_flax_variables(
                        new.pose.params, new.pose.batch_stats, num_stacks=h.STACKS,
                        depth=h.DEPTH)),
                    "agent_stats": to_numpy(h.from_flax_agent_variables(
                        new.agent.params, new.agent.batch_stats))},
            "ranks": pool.run(_rank_joint, job),
            "one": to_numpy(_joint(None, 0, 1, job)),
        }
        return cache[name]

    return get


def _adv_bound(gap, adv, delta_i):
    """How far a normalized advantage can move when each sample's loss gap
    moves by ``delta_i`` (tests/torch_joint_harness.py derives it): the
    moments move by at most the largest, d, so |d adv_i| <= (d_i + d +
    |adv_i| d) / s, plus 8 ulps."""
    s = np.sqrt(max((gap * gap).mean() - gap.mean() ** 2, 0.0)) + 1e-6
    d = delta_i.max()
    return (delta_i + d + np.abs(adv) * d) / s + 8 * h.ULP * (1 + np.abs(adv))


def _cat_rec(ranks, key):
    return np.concatenate([r["rec"][key] for r in ranks])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dp_joint_metrics_match_the_sharded_reference(runs, name):
    r = runs(name)
    pm = {k: float(v) for k, v in r["ranks"][0]["metrics"].items()}
    m, d = r["ref"]["metrics"], r["d"]
    assert abs(pm["loss"] - m["loss"]) <= h.LOSS_RTOL * abs(m["loss"])
    assert abs(pm["acc"] - m["acc"]) <= 0.1
    max_logp = max(np.abs(x - np.log(np.exp(x).sum(-1, keepdims=True))).max()
                   for x in d["logits"].values())
    assert abs(pm["entropy"] - m["entropy"]) <= 2 * h.LOGIT_ATOL * max_logp
    # the reward: per-sample losses, their gap and its normalization
    gap, adv = _cat_rec(r["ranks"], "gap"), _cat_rec(r["ranks"], "adv")
    logp, l_adv = _cat_rec(r["ranks"], "logp"), _cat_rec(r["ranks"], "l_adv")
    delta_i = h.LOSS_RTOL * (np.abs(l_adv) + np.abs(l_adv - gap))
    assert abs(pm["advantage"] - m["advantage"]) <= delta_i.mean()
    dadv = _adv_bound(gap, adv, delta_i)
    terms = 2 + (2 if CONFIGS[name][0] else 0)  # heads on the sampled path
    bound = (np.abs(logp) * dadv).mean() + np.abs(adv).mean() * 2 * h.LOGIT_ATOL * terms
    assert abs(pm["agent_loss"] - m["agent_loss"]) <= bound, (pm, m, bound)
    assert ranks_equal([x["metrics"] for x in r["ranks"]])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dp_joint_advantage_takes_the_global_moments(runs, name):
    """The ranks' normalized advantages, in rank order, are the single
    process's: the moments are the whole batch's.  Moments of each rank's
    own rows would put them far outside the bound."""
    r = runs(name)
    adv, gap = _cat_rec(r["ranks"], "adv"), _cat_rec(r["ranks"], "gap")
    l_adv = _cat_rec(r["ranks"], "l_adv")
    want, want_gap = r["one"]["rec"]["adv"], r["one"]["rec"]["gap"]
    delta_i = h.LOSS_RTOL * (np.abs(l_adv) + np.abs(l_adv - gap))
    assert np.all(np.abs(gap - want_gap) <= delta_i + 1e-7)
    bound = _adv_bound(gap, adv, delta_i)
    assert np.all(np.abs(adv - want) <= bound), (np.abs(adv - want) / bound).max()
    local = np.concatenate([
        (g - g.mean()) / (np.sqrt(max((g * g).mean() - g.mean() ** 2, 0.0)) + 1e-6)
        for g in np.split(gap, W)])
    assert np.abs(local - want).max() > 100 * bound.max()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dp_joint_gradients(runs, name):
    r = runs(name)
    pose = r["ranks"][0]["pose"]["grads"]
    gap, k = h.max_gap({n: torch.from_numpy(g) for n, g in pose.items()},
                       r["d"]["pose_grads"])
    assert gap <= h.GRAD_ATOL, (k, gap)
    agent, want = r["ranks"][0]["agent"]["grads"], r["one"]["agent"]["grads"]
    assert set(agent) == set(want)
    for n in want:
        assert np.abs(agent[n] - want[n]).max() <= AGENT_GRAD_ATOL, n


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dp_joint_statistics_updates_and_ranks(runs, name):
    r = runs(name)
    got = r["ranks"][0]
    for net, atol in (("pose", h.STATS_ATOL), ("agent", h.AGENT_STATS_ATOL)):
        want = r["ref"][f"{net}_stats"]
        for k, v in got[net]["stats"].items():
            assert np.abs(v - want[k]).max() <= atol, (net, k)
    assert ranks_equal([{n: x[n] for n in ("pose", "agent")} for x in r["ranks"]])
    # each update is the port's optimizer applied to the averaged gradients
    import dataclasses

    c = h.cfg()
    for net, lr in (("pose", c.optim.lr), ("agent", c.agent.lr)):
        params = {n: torch.from_numpy(v.copy()) for n, v in r["job"][net].items()
                  if n in got[net]["params"]}
        ps = [torch.nn.Parameter(params[n]) for n in got[net]["params"]]
        opt = make_optimizer(ps, dataclasses.replace(c.optim, lr=lr), steps_per_epoch=1)
        for p, n in zip(ps, got[net]["params"]):
            g = got[net]["grads"].get(n)
            p.grad = None if g is None else torch.from_numpy(g)
        opt.step()
        for p, n in zip(ps, got[net]["params"]):
            np.testing.assert_array_equal(got[net]["params"][n], p.detach().numpy(), err_msg=n)
