"""Shared harness of tests/test_torch_adversarial.py and
tests/test_torch_agent.py: one joint step of the JAX package's jitted
``make_joint_step`` and of the port's, from a common carried state, on the
JAX step's own draws.

The JAX step runs with an optimizer that records the gradients in its
state and updates nothing (``_capture``): one compile per configuration
then gives the metrics, the new BatchNorm statistics and the agent's
gradients.  The pose gradients are held to jax.grad of the step's pose
loss in float64, on the crops built op by op (tests/test_torch_adversarial.py
says why).  The port's updates are held to optax's real update of the
port's own gradients (``update_is_optax``).

Configuration: hourglass of 2 stacks, feats 8, depth 2, 16 joints; agent
widths (8, 16), 5 scale and 5 rotation bins, occlusion levels (1, 2),
input_downscale 2; 64² crops, 16² heatmaps, batch 6, color jitter on.
"""

import dataclasses

import numpy as np
import torch

import posetpu_torch.train.adversarial as port_adv
from posetpu_torch.aug.pipeline import AugParams
from posetpu_torch.ckpt import from_flax_agent_variables, from_flax_variables
from posetpu_torch.configs import named_config
from posetpu_torch.models import hg
from posetpu_torch.models.agent import AugAgent
from posetpu_torch.train.adversarial import JointState, make_joint_step
from posetpu_torch.train.state import TrainState, make_optimizer

STACKS, FEATS, CLASSES, DEPTH, B = 2, 8, 16, 2, 6
WIDTHS, BINS, LEVELS, DOWNSCALE = (8, 16), 5, (1, 2), 2
MEAN = (0.4404, 0.4440, 0.4327)
ULP = 2.0**-23
LOSS_RTOL = 4e-5
GRAD_ATOL = 4e-3
STATS_ATOL = 5e-4
LOGIT_ATOL = 1e-5
AGENT_STATS_ATOL = 2e-6
AGENT_GRAD_ROUND = 1e-5


def cfg():
    c = named_config("hg2_mpii_mini")
    c.model.feats = FEATS
    c.model.depth = DEPTH
    c.model.bf16 = False
    c.aug.inp_res = (64, 64)
    c.aug.out_res = (16, 16)
    return c


def occ_nodes(mode):
    if mode is None:
        return 0
    if mode == "parts":
        return 1 + 2 + 6
    return 1 + sum(g * g for g in LEVELS)


def batch(seed, hw=(96, 128)):
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


def _perturbed(model, x, seed, train):
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    v = model.init(jax.random.PRNGKey(seed + 3), x, train=train)
    return jax.tree.map(lambda a: a + 0.05 * jnp.asarray(rng.randn(*a.shape), a.dtype), v)


def ref_agent(mode, dtype_name="float32", downscale=DOWNSCALE, widths=WIDTHS):
    import jax.numpy as jnp

    from posetpu.models.agent import AugAgent as RefAgent

    return RefAgent(num_scale_bins=BINS, num_rot_bins=BINS, num_occ_nodes=occ_nodes(mode),
                    occ_mode=mode or "tree", occ_levels=LEVELS, widths=widths,
                    input_downscale=downscale, dtype=getattr(jnp, dtype_name))


def agent_variables(model, seed=1):
    """Flax init of the agent, every leaf perturbed (statistics too; the
    variances stay positive)."""
    import jax.numpy as jnp

    return _perturbed(model, jnp.zeros((1, 64, 64, 3)), seed, train=True)


def port_agent(mode, variables=None, dtype=torch.float32, downscale=DOWNSCALE,
               widths=WIDTHS):
    agent = AugAgent(num_scale_bins=BINS, num_rot_bins=BINS, num_occ_nodes=occ_nodes(mode),
                     occ_mode=mode or "tree", occ_levels=LEVELS, widths=widths,
                     input_downscale=downscale, dtype=dtype, device="cpu")
    if variables is not None:
        agent.load_state_dict(from_flax_agent_variables(
            variables["params"], variables.get("batch_stats")))
    return agent


def _capture():
    """An optax transformation that updates nothing and keeps the last
    gradients as its state."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def _to_flax(named, template, carry):
    """{port name: tensor} -> a tree shaped like the flax ``template``, by
    running ``carry`` twice on the template: once with each leaf's number
    in every element, once with each element's position in its leaf (both
    exact in float32), and reading them back."""
    import jax

    leaves, treedef = jax.tree.flatten(template)
    runs = [
        [np.full(a.shape, i, np.float32) for i, a in enumerate(leaves)],
        [np.arange(a.size, dtype=np.float32).reshape(a.shape) for a in leaves],
    ]
    leaf_of, pos_of = (carry(jax.tree.unflatten(treedef, r)) for r in runs)
    out = [np.zeros(a.shape, np.float32) for a in leaves]
    for name, leaf in leaf_of.items():
        i = int(leaf.reshape(-1)[0])
        pos = pos_of[name].numpy().astype(np.int64).reshape(-1)
        out[i].reshape(-1)[pos] = named[name].detach().cpu().numpy().reshape(-1)
    return jax.tree.unflatten(treedef, out)


def carry_pose(tree):
    return from_flax_variables(tree, None, num_stacks=STACKS, depth=DEPTH)


def carry_agent(tree):
    return from_flax_agent_variables(tree)


class RefJoint:
    """The JAX package's joint step for one configuration (jitted once),
    its draws, and the port's counterpart built from a carried state."""

    def __init__(self, mode=None, **step_kw):
        import jax
        import jax.numpy as jnp

        from posetpu.aug.pipeline import neutral_params
        from posetpu.models import hg as ref_hg
        from posetpu.models.agent import (
            occlusion_hierarchy,
            rotation_bin_table,
            scale_bin_table,
        )
        from posetpu.train.adversarial import JointState as RefJointState
        from posetpu.train.adversarial import (
            _augment_pair,
            _occ_box_table,
            _occ_spec,
            _sample_policy,
            apply_occlusion,
            per_sample_stacked_mse,
        )
        from posetpu.train.adversarial import make_joint_step as ref_make_joint_step
        from posetpu.train.state import TrainState as RefState
        from posetpu.train.state import make_optimizer as ref_make_optimizer
        from posetpu.train.step import _augment

        self.mode, self.step_kw = mode, step_kw
        c = cfg()
        self.aug_cfg = c.aug
        self.pose_model = ref_hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS,
                                 depth=DEPTH, dtype=jnp.float32)
        self.agent_model = ref_agent(mode)
        pv = _perturbed(self.pose_model, jnp.zeros((1, 64, 64, 3)), 0, train=False)
        av = agent_variables(self.agent_model)
        cap = _capture()
        self.tables = dict(
            scale_table=scale_bin_table(BINS),
            rot_table=rotation_bin_table(BINS, -c.aug.rot_factor, c.aug.rot_factor),
            occ_boxes=(occlusion_hierarchy((64, 64), LEVELS)
                       if mode in ("tree", "flat") else None),
        )

        def ts(v):
            return RefState(params=v["params"], batch_stats=v["batch_stats"],
                            opt_state=cap.init(v["params"]), step=jnp.zeros((), jnp.int32))

        self.state0 = RefJointState(pose=ts(pv), agent=ts(av), step=jnp.zeros((), jnp.int32))
        self.step = jax.jit(ref_make_joint_step(
            self.pose_model, self.agent_model, cap, cap, c.aug, MEAN, **self.tables,
            **step_kw,
        ))
        occ = _occ_spec(self.tables["occ_boxes"], self.agent_model, None, None)
        scale_t = jnp.asarray(self.tables["scale_table"])
        rot_t = jnp.asarray(self.tables["rot_table"])
        agent_model, aug_cfg = self.agent_model, c.aug

        ref_baseline = step_kw.get("ref_baseline", True)
        w = step_kw.get("pose_ref_weight", 0.0)
        pose_model, boxes = self.pose_model, self.tables["occ_boxes"]

        @jax.jit
        def draws(state, jbatch, key):
            """make_joint_step's draws and its agent's logits."""
            key = jax.random.fold_in(key, state.step)
            n = _augment(jbatch, neutral_params(B), aug_cfg, MEAN, None, None)
            logits, _ = agent_model.apply(
                {"params": state.agent.params, "batch_stats": state.agent.batch_stats},
                n["input"], train=True, mutable=["batch_stats"])
            extras, adv, ref, jkeys = _sample_policy(
                key, jbatch, logits, aug_cfg, scale_t, rot_t, occ)
            jitter = jax.vmap(lambda k: jax.random.uniform(
                k, (3,), minval=0.8, maxval=1.2))(jkeys)
            return extras, adv, ref, jkeys, jitter, logits

        def crops(jbatch, extras, adv, ref, jkeys):
            """The crops and targets make_joint_step's pose network trains
            on, computed op by op (see the module docstring)."""
            if ref_baseline:
                aug = _augment_pair(jbatch, adv, ref, aug_cfg, MEAN, None, jkeys)
            else:
                aug = _augment(jbatch, adv, aug_cfg, MEAN, None, jkeys)
            inp, tgt = aug["input"], aug["target"].transpose(0, 2, 3, 1)
            if occ is not None:
                table = _occ_box_table(occ, boxes, aug["tpts_float"][:B],
                                       aug["target_weight"][:B], aug_cfg)
                inp = inp.at[:B].set(apply_occlusion(inp[:B], extras["oi"], table))
            if not w:
                inp, tgt = inp[:B], tgt[:B]
            return inp, tgt

        pose64 = ref_hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS,
                        depth=DEPTH, dtype=jnp.float64)

        def pose_grads(params, batch_stats, inp, tgt):
            """jax.grad of make_joint_step's pose loss on ``inp``/``tgt``, in
            float64 (see the module docstring)."""
            with jax.enable_x64(True):
                f64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                                   (params, batch_stats, inp, tgt))
                return jax.tree.map(np.asarray, grads64(*f64))

        @jax.jit
        def grads64(params, batch_stats, inp, tgt):
            def loss_fn(p):
                outs, _ = pose64.apply({"params": p, "batch_stats": batch_stats}, inp,
                                       train=True, mutable=["batch_stats"])
                l_sample = per_sample_stacked_mse(outs, tgt)
                if w:
                    return (1.0 - w) * l_sample[:B].mean() + w * l_sample[B:].mean()
                return l_sample.mean()

            return jax.grad(loss_fn)(params)

        self._pose_grads = pose_grads
        self._draws, self._crops = draws, crops
        tx = ref_make_optimizer(c.optim, steps_per_epoch=1)
        self.tx = tx
        self.update = jax.jit(lambda g, s, p: tx.update(g, s, p))

    def run(self, state, b, key_seed):
        """The JAX step from ``state`` on batch ``b`` and its draws."""
        import jax
        import jax.numpy as jnp

        key = jax.random.PRNGKey(key_seed)
        jb = {k: jnp.asarray(a) for k, a in b.items()}
        new, m = self.step(state, jb, key)
        draws, (extras, adv, ref, jkeys) = self._draw(state, jb, key)
        grads = self._pose_grads(state.pose.params, state.pose.batch_stats,
                                 *self._crops(jb, extras, adv, ref, jkeys))
        draws["pose_grads"] = carry_pose(grads)
        return new, {k: float(v) for k, v in m.items()}, draws

    def draws(self, state, b, key):
        """What the JAX step draws from ``state`` on batch ``b`` with the
        PRNG ``key``, as :func:`inject` takes it (the agent's logits under
        ``logits``)."""
        import jax.numpy as jnp

        return self._draw(state, {k: jnp.asarray(a) for k, a in b.items()}, key)[0]

    def _draw(self, state, jb, key):
        extras, adv, ref, jkeys, jitter, logits = self._draws(state, jb, key)
        draws = {"index": np.asarray(jb["index"]),
                 "extras": {k: np.asarray(v) for k, v in extras.items()},
                 "adv": [np.asarray(a) for a in adv], "ref": [np.asarray(a) for a in ref],
                 "jitter": np.asarray(jitter), "logits": _flat_logits(logits)}
        return draws, (extras, adv, ref, jkeys)

    def port(self, state, step_no=0, agent_step=None, agent_count=0):
        """The port's JointState carried from a JAX JointState, with a
        fresh optimizer for each network (zero moments, ``agent_count``
        updates taken by the agent's), and its joint step."""
        c = cfg()
        pose = hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
                  dtype=torch.float32)
        pose.load_state_dict(from_flax_variables(
            state.pose.params, state.pose.batch_stats, num_stacks=STACKS, depth=DEPTH))
        agent = port_agent(self.mode)
        agent.load_state_dict(from_flax_agent_variables(
            state.agent.params, state.agent.batch_stats))
        pose_opt = make_optimizer(pose.parameters(), c.optim, steps_per_epoch=1)
        agent_opt = make_optimizer(
            agent.parameters(), dataclasses.replace(c.optim, lr=c.agent.lr),
            steps_per_epoch=1)
        if agent_count:
            zeros = {n: torch.zeros_like(p) for n, p in agent.named_parameters()}
            agent_opt.load_carried(agent, {"count": agent_count, "nu": zeros})
        js = JointState(TrainState(pose, pose_opt, step_no),
                        TrainState(agent, agent_opt,
                                   step_no if agent_step is None else agent_step),
                        step_no)
        step = make_joint_step(pose, agent, pose_opt, agent_opt, c.aug, MEAN, seed=0,
                               device="cpu", **self.tables, **self.step_kw)
        return js, step


def _flat_logits(logits):
    """{head: (B, n) array}, the occlusion cell heads as ``occ_cells{i}``."""
    out = {k: np.asarray(v) for k, v in logits.items() if k != "occ_cells"}
    for i, c in enumerate(logits.get("occ_cells", ())):
        out[f"occ_cells{i}"] = np.asarray(c)
    return out


def inject(monkeypatch, draws_by_step):
    """The port's sample_policy returns the JAX step's draws of that step."""

    def sample_policy(seed, step, index, logits, aug_cfg, scale_table, rot_table, occ):
        d = draws_by_step[int(step)]  # an int, or a graphed step's device counter
        np.testing.assert_array_equal(index.cpu().numpy(), d["index"])
        dev = index.device

        def t(a):
            return torch.from_numpy(np.array(a)).to(dev)

        extras = {k: t(v).long() for k, v in d["extras"].items()}
        jitter = t(d["jitter"]) if aug_cfg.color_jitter else None
        return extras, AugParams(*map(t, d["adv"])), AugParams(*map(t, d["ref"])), jitter

    monkeypatch.setattr(port_adv, "sample_policy", sample_policy)


def snapshot(ts):
    """Parameters and RMSprop ``nu`` of a port TrainState, by name."""
    params = {n: p.detach().clone() for n, p in ts.model.named_parameters()}
    nu = {n: ts.optimizer.state[p]["nu"].clone() if "nu" in ts.optimizer.state[p]
          else torch.zeros_like(p) for n, p in ts.model.named_parameters()}
    return {"params": params, "nu": nu}


def update_is_optax(rj, template, carry, before, ts, count):
    """The port's parameters after a step equal optax's update of the
    port's own gradients from the port's own parameters and moments:
    ``|dp| <= 5 ulps of |u| + 2 ulps of |p|`` (tests/test_torch_train_step.py
    derives it)."""
    import jax
    import jax.numpy as jnp
    import optax

    grads = {n: p.grad for n, p in ts.model.named_parameters()}
    params = _to_flax(before["params"], template, carry)
    opt_state = rj.tx.init(params)
    opt_state = (opt_state[0]._replace(nu=_to_flax(before["nu"], template, carry)),
                 opt_state[1]._replace(count=jnp.asarray(count, jnp.int32)),
                 *opt_state[2:])
    u, _ = rj.update(_to_flax(grads, template, carry), opt_state, params)
    want = optax.apply_updates(params, u)
    got = _to_flax(dict(ts.model.named_parameters()), template, carry)
    for w, g, uu, p in zip(jax.tree.leaves(want), jax.tree.leaves(got),
                           jax.tree.leaves(u), jax.tree.leaves(params)):
        w, g, uu, p = (np.asarray(a) for a in (w, g, uu, p))
        assert (np.abs(g - w) <= 5 * ULP * np.abs(uu) + 2 * ULP * np.abs(p)).all(), \
            np.abs(g - w).max()


def max_gap(port_named, ref_named):
    """Largest |port - reference| over a {name: tensor} map, and its name."""
    assert set(port_named) == set(ref_named)
    gaps = {k: (port_named[k].detach() - ref_named[k]).abs().max().item()
            for k in ref_named}
    name = max(gaps, key=gaps.get)
    return gaps[name], name



def record(monkeypatch):
    """Wrap the port's per-sample loss, advantage normalization and policy
    log-prob so a test reads what the joint step computed: ``losses`` (one
    entry per call), ``gap``/``adv`` and ``logits``/``extras``/``logp`` of
    the last step, and under ``steps`` a copy of those for every step."""
    rec = {"losses": [], "steps": []}
    mse, norm, logp = (port_adv.per_sample_stacked_mse, port_adv.normalize_advantage,
                       port_adv.policy_logp)

    def rec_mse(outs, target):
        out = mse(outs, target)
        rec["losses"].append(out.detach().clone())
        return out

    def rec_norm(gap, baseline, group=None):
        out = norm(gap, baseline, group)
        rec["gap"], rec["adv"] = gap.detach().clone(), out.clone()
        return out

    def rec_logp(logits, extras):
        out = logp(logits, extras)
        rec.update(logits=logits, extras=extras, logp=out.detach().clone())
        # a step's last call: its losses, advantages and log-probs are in
        rec["steps"].append({k: v for k, v in rec.items() if k != "steps"}
                            | {"losses": list(rec["losses"])})
        return out

    monkeypatch.setattr(port_adv, "per_sample_stacked_mse", rec_mse)
    monkeypatch.setattr(port_adv, "normalize_advantage", rec_norm)
    monkeypatch.setattr(port_adv, "policy_logp", rec_logp)
    return rec


def _flat_port_logits(logits):
    out = {k: v.detach() for k, v in logits.items() if k != "occ_cells"}
    for i, c in enumerate(logits.get("occ_cells", ())):
        out[f"occ_cells{i}"] = c.detach()
    return out


def check_step(rj, monkeypatch, ref_state, b, key_seed, step_no=0, agent_count=0):
    """One joint step of the JAX package and of the port from ``ref_state``
    (carried), on the JAX step's draws, held by the tolerances of the
    module docstring.  Returns the port's JointState after the step, its
    state before (a snapshot of each network) and the JAX step's new
    state."""
    import copy

    from posetpu_torch.train.adversarial import policy_logp

    new, m, d = rj.run(ref_state, b, key_seed)
    inject(monkeypatch, {step_no: d})
    rec = record(monkeypatch)
    js, step = rj.port(ref_state, step_no, agent_count=agent_count)
    agent0 = copy.deepcopy(js.agent.model)
    before = {"pose": snapshot(js.pose), "agent": snapshot(js.agent)}
    seen = {}
    hook = js.agent.model.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__("x", args[0].detach().clone()))
    do_update = step_no % rj.step_kw.get("update_every", 1) == 0
    pm = {k: float(v) for k, v in step(js, b).items()}
    hook.remove()

    bounds, dadv = metric_bounds(rec, d["logits"], m)
    for k, tol in bounds.items():
        assert abs(pm[k] - m[k]) <= tol, (k, pm, m, tol)

    # pose: gradients (against jax.grad of the step's loss on its crops),
    # update, statistics
    gap_g, name = max_gap({n: p.grad for n, p in js.pose.model.named_parameters()},
                          d["pose_grads"])
    assert gap_g <= GRAD_ATOL, (name, gap_g)
    update_is_optax(rj, ref_state.pose.params, carry_pose, before["pose"], js.pose, 0)
    _check_stats(js.pose.model, from_flax_variables(
        new.pose.params, new.pose.batch_stats, num_stacks=STACKS, depth=DEPTH), STATS_ATOL)

    # agent: gradients against the derived bound, update, statistics
    if do_update:
        agent0.train()
        params = dict(agent0.named_parameters())
        lp = policy_logp(agent0(seen["x"]), rec["extras"])
        want = carry_agent(new.agent.opt_state)
        per = [torch.autograd.grad(lp[i], list(params.values()), retain_graph=True)
               for i in range(B)]
        for j, (n, p) in enumerate(js.agent.model.named_parameters()):
            tol = sum(dadv[i] * per[i][j].abs() for i in range(B)) / B + AGENT_GRAD_ROUND
            assert ((p.grad - want[n]).abs() <= tol).all(), (n, (p.grad - want[n]).abs().max())
        update_is_optax(rj, ref_state.agent.params, carry_agent, before["agent"], js.agent,
                        agent_count)
    _check_stats(js.agent.model, from_flax_agent_variables(
        new.agent.params, new.agent.batch_stats), AGENT_STATS_ATOL)
    return js, before, new


def metric_bounds(rec, ref_logits, m):
    """How far one port step's metrics may lie from the JAX step's ``m``,
    by the module docstring's derivations, from what the port's step
    computed (``rec``: :func:`record`'s, or one entry of its ``steps``) and
    the reference's logits; it asserts the port's logits within
    LOGIT_ATOL first.  Returns ({metric: tolerance}, the bound of each
    normalized advantage)."""
    # the agent's logits, then what they bound: log-probs and entropy
    logits = _flat_port_logits(rec["logits"])
    assert set(logits) == set(ref_logits)
    for k, w in ref_logits.items():
        np.testing.assert_allclose(logits[k].numpy(), w, rtol=0, atol=LOGIT_ATOL, err_msg=k)
    max_logp = max(np.abs(w - np.log(np.exp(w).sum(-1, keepdims=True))).max()
                   for w in ref_logits.values())
    # the pose loss and the reward's moments
    l_adv, gap, adv = rec["losses"][-1][:B], rec["gap"], rec["adv"]
    l_ref = l_adv - gap
    delta_i = LOSS_RTOL * (l_adv.abs() + l_ref.abs())
    delta = delta_i.max()
    s = torch.sqrt(torch.clamp((gap * gap).mean() - gap.mean() ** 2, min=0.0)) + 1e-6
    dadv = (delta_i + delta + adv.abs() * delta) / s + 8 * ULP * (1 + adv.abs())
    ex = rec["extras"]
    terms = 2 + (2 if "occ_lvl" in ex else 1 if "oi" in ex else 0)  # heads on the path
    dlogp = 2 * LOGIT_ATOL * terms
    bound = (rec["logp"].abs() * dadv).mean() + adv.abs().mean() * dlogp
    return {"entropy": 2 * LOGIT_ATOL * max_logp,
            "loss": LOSS_RTOL * abs(m["loss"]),
            "acc": 0.1,  # a joint more or less near a tie
            "advantage": delta_i.mean().item(),
            "agent_loss": bound.item()}, dadv


def _check_stats(model, want, atol):
    got = model.state_dict()
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            gap = (got[k] - w).abs().max().item()
            assert gap <= atol, f"{k} differs by {gap}"
