"""posetpu_torch's adversarial augmentation agent against the JAX
package's (``posetpu/models/agent.py``): the bin tables and occlusion
hierarchies, the body-part boxes, the AugAgent forward and its weight
carry, the keyed categorical sampler, the tree sampler and its log-prob,
and the joint step with each occlusion mode (tests/torch_joint_harness.py;
its tolerances are derived in tests/test_torch_adversarial.py).

Tolerances here:

- FWD_ATOL = 1e-5, the f32 forward's logits against flax's: a four-layer
  float32 CNN at widths 8-16 rounds its logits (below 3) by a few ulps;
  read 4.8e-7 on the CPU.  A one-pixel shift of the conv grid, the
  symmetric padding, moves them by 1e-2 or more.
- STATS_ATOL = 2e-6, the train-mode running statistics: 0.1 times a gap of
  batch statistics of values near 1 (read 1.2e-7, one ulp).  torch's own
  unbiased update misses flax's by 0.1*var/(n-1): 3.2e-5 and more here
  (n = 6*32*32 at the first conv without the input pool).
- LOGP_ATOL = 4 ulps of the log-probs (|logp| < 8): log_softmax and the
  tree's sum, computed in float32 by both packages.
- The chi-square test: 40,000 draws from 7 bins at p = 1e-4 (critical
  value 27.9 at 6 degrees of freedom).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import posetpu_torch.models.agent as port_agent_mod
import torch_joint_harness as h
from posetpu_torch.aug.keyed import STREAM_OCC, STREAM_SCALE_BIN, sample_categorical
from posetpu_torch.ckpt import from_flax_agent_variables, from_optax_agent_state
from posetpu_torch.configs import named_config
from posetpu_torch.models.agent import (
    PART_GROUPS,
    _pad_same,
    occ_level_offsets,
    occlusion_hierarchy,
    occlusion_tree_logp,
    part_level_sizes,
    part_occlusion_boxes,
    rotation_bin_table,
    sample_occlusion_tree,
    scale_bin_table,
)
from posetpu_torch.train.adversarial import agent_from_config

FWD_ATOL = 1e-5
STATS_ATOL = 2e-6
MODES = [None, "tree", "parts", "flat"]


def _x(seed=7, B=h.B):
    return np.random.RandomState(seed).rand(B, 64, 64, 3).astype(np.float32) - 0.4


def test_tables_and_hierarchies_equal_the_reference():
    from posetpu.models import agent as ref

    for args in ((), (5,), (9, -0.5, 0.3)):
        np.testing.assert_array_equal(scale_bin_table(*args), ref.scale_bin_table(*args))
    for args in ((), (5,), (7, -45.0, 45.0)):
        np.testing.assert_array_equal(rotation_bin_table(*args), ref.rotation_bin_table(*args))
    for res, levels in (((256, 256), (1, 2, 4)), ((64, 64), (1, 2)), ((65, 47), (1, 3, 5))):
        got = occlusion_hierarchy(res, levels)
        want = ref.occlusion_hierarchy(res, levels)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(occ_level_offsets(levels), ref.occ_level_offsets(levels))
    assert PART_GROUPS == ref.PART_GROUPS
    for ds in ("mpii", "lsp"):
        assert part_level_sizes(ds) == ref.part_level_sizes(ds)
    assert len(occlusion_hierarchy()) == 22  # hg8_lsp_aho's node count


@pytest.mark.parametrize("dataset", ["mpii", "lsp"])
def test_part_occlusion_boxes_equal_the_reference(dataset):
    """int32 equality with points off the crop on every side (negative
    corners truncate toward zero), fractional coordinates, and groups with
    no visible joint (zero boxes)."""
    import jax.numpy as jnp

    from posetpu.models.agent import part_occlusion_boxes as ref_boxes

    K = 16 if dataset == "mpii" else 14
    rng = np.random.RandomState(11)
    B = 8
    pts = rng.uniform(-40, 100, (B, K, 2)).astype(np.float32)
    vis = (rng.rand(B, K) < 0.6).astype(np.float32)
    vis[0] = 0.0  # nothing visible
    vis[1, list(PART_GROUPS[dataset][1][0])] = 0.0  # the head hidden
    pts[2] = -pts[2] * 0.5 - 3.3  # all negative
    got = part_occlusion_boxes(torch.from_numpy(pts), torch.from_numpy(vis), dataset)
    want = np.asarray(ref_boxes(jnp.asarray(pts), jnp.asarray(vis), dataset))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0] == 0).all() and (got[1, 1 + 2] == 0).all()
    assert (got[..., :2] < 0).any()


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_flax(mode, downscale):
    """The f32 forward with carried weights against flax: eval mode (the
    running statistics) and train mode (batch statistics), every head's
    logits within FWD_ATOL; train mode leaves flax's running statistics
    (STATS_ATOL), where torch's own update would not."""
    import jax
    import jax.numpy as jnp

    ref = h.ref_agent(mode, downscale=downscale)
    v = h.agent_variables(ref)
    agent = h.port_agent(mode, v, downscale=downscale)
    x = _x()
    want_eval = ref.apply(v, jnp.asarray(x), train=False)
    want_train, mut = ref.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got_eval = agent.eval()(torch.from_numpy(x))
        plain = h.port_agent(mode, v, downscale=downscale).train()
        plain._forward(torch.from_numpy(x))
        got_train = agent.train()(torch.from_numpy(x))
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        flat_w, flat_g = h._flat_logits(want), h._flat_port_logits(got)
        assert set(flat_g) == set(flat_w)
        for k, w in flat_w.items():
            assert flat_g[k].dtype == torch.float32
            np.testing.assert_allclose(flat_g[k].numpy(), w, rtol=0, atol=FWD_ATOL, err_msg=k)
    stats = from_flax_agent_variables(v["params"], jax.tree.map(np.asarray, mut["batch_stats"]))
    sd, sd_plain = agent.state_dict(), plain.state_dict()
    keys = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * len(h.WIDTHS)
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), stats[k].numpy(), rtol=0, atol=STATS_ATOL,
                                   err_msg=k)
    gap = max((sd_plain[k] - stats[k]).abs().max().item() for k in keys if "var" in k)
    assert gap > 5 * STATS_ATOL, gap


def test_same_padding_is_asymmetric(monkeypatch):
    """flax's SAME padding of a stride-2 conv pads (2, 3) for a 7x7 over 128
    and (0, 1) for a 3x3 over 64.  torch's symmetric ``padding=k//2`` gives
    the same shapes on a grid shifted by one pixel, and the logits then
    miss flax's far beyond FWD_ATOL."""
    import jax.numpy as jnp

    x = torch.zeros(1, 3, 128, 128)
    assert _pad_same(x, 7).shape[-2:] == (133, 133)
    marked = torch.zeros(1, 1, 64, 64)
    marked[..., 0, 0] = 1.0
    padded = _pad_same(marked, 3)
    assert padded.shape[-2:] == (65, 65) and padded[0, 0, 0, 0] == 1.0  # (0, 1)
    assert _pad_same(torch.zeros(1, 1, 128, 128), 7)[0, 0, 2, 2] == 0  # (2, 3)
    marked = torch.zeros(1, 1, 128, 128)
    marked[..., 0, 0] = 1.0
    assert _pad_same(marked, 7)[0, 0, 2, 2] == 1.0

    ref = h.ref_agent("tree", downscale=1)
    v = h.agent_variables(ref)
    want = np.asarray(ref.apply(v, jnp.asarray(_x()), train=False)["scale"])

    def scale_logits():
        with torch.no_grad():
            return h.port_agent("tree", v, downscale=1).eval()(torch.from_numpy(_x()))["scale"]

    np.testing.assert_allclose(scale_logits().numpy(), want, rtol=0, atol=FWD_ATOL)
    monkeypatch.setattr(port_agent_mod, "_pad_same",
                        lambda x, k, stride=2: F.pad(x, [k // 2] * 4))
    sym = scale_logits()
    assert sym.shape == want.shape
    assert np.abs(sym.numpy() - want).max() > 100 * FWD_ATOL


def _flax_dtypes(ref, v, x):
    import jax.numpy as jnp

    _, st = ref.apply(v, jnp.asarray(x), train=True, capture_intermediates=True,
                      mutable=["batch_stats", "intermediates"])
    names = {"Dense_0": "hidden"}
    return {names.get(k, k): str(m["__call__"][0].dtype)
            for k, m in st["intermediates"].items() if k != "__call__"}


@pytest.mark.parametrize("mode", ["tree", "flat"])
def test_bf16_placement_matches_flax(mode):
    """Under bf16 each port module's output has the dtype of the flax
    module it mirrors (convs, BatchNorms and ``hidden`` in bf16, the heads
    in float32), parameters stay float32, and the logits are as close to
    flax's bf16 logits as those are to its f32 ones (within 2x), and really
    rounded (at least half that gap from the port's own f32 logits), as
    tests/test_torch_hourglass.py holds the bf16 heatmaps."""
    import jax.numpy as jnp

    ref32 = h.ref_agent(mode)
    ref16 = h.ref_agent(mode, "bfloat16")
    v = h.agent_variables(ref32)
    x = _x()
    want = _flax_dtypes(ref16, v, x)
    agent = h.port_agent(mode, v, dtype=torch.bfloat16).train()
    seen = {}
    for name, mod in agent.named_modules():
        if name in want:
            mod.register_forward_hook(lambda m, i, o, n=name: seen.__setitem__(n, str(o.dtype)))
    with torch.no_grad():
        got16 = h._flat_port_logits(agent(torch.from_numpy(x)))
        got32 = h._flat_port_logits(h.port_agent(mode, v).train()(torch.from_numpy(x)))
    assert set(seen) == set(want) and {"bfloat16", "float32"} <= set(want.values())
    for n, w in want.items():
        assert seen[n] == f"torch.{w}", n
    assert all(p.dtype == torch.float32 for p in agent.parameters())
    w16 = h._flat_logits(ref16.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])[0])
    w32 = h._flat_logits(ref32.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])[0])
    for k in w32:
        gap = np.abs(w32[k] - w16[k]).mean()
        assert gap > 0
        assert np.abs(got16[k].numpy() - w16[k]).mean() <= 2.0 * gap, k
        assert np.abs(got16[k].numpy() - got32[k].numpy()).mean() >= 0.5 * gap, k


def test_categorical_follows_softmax():
    """40,000 keyed draws (one per sample index) from one logits row:
    chi-square against softmax; logp is log_softmax at the index."""
    logits = torch.tensor([[1.0, 0.2, -0.5, 2.0, 0.0, -3.0, 0.7]])
    n = 40_000
    idx, logp = sample_categorical(3, 5, torch.arange(n), STREAM_SCALE_BIN,
                                   logits.expand(n, -1))
    p = torch.softmax(logits[0].double(), 0).numpy()
    counts = np.bincount(idx.numpy(), minlength=7)
    chi2 = ((counts - n * p) ** 2 / (n * p)).sum()
    assert chi2 < 27.9, (chi2, counts, n * p)
    assert logp.dtype == torch.float32
    assert torch.equal(logp, torch.log_softmax(logits, -1)[0][idx])


def test_categorical_is_keyed_per_sample():
    """A sample draws the same whatever its batch-mates and position; the
    draw depends on (seed, step, index, stream, first) alone."""
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(64, 9).astype(np.float32))
    index = torch.from_numpy(rng.choice(100_000, 64, replace=False))
    idx, logp = sample_categorical(1, 2, index, STREAM_OCC, logits)
    perm = torch.from_numpy(rng.permutation(64))
    idx_p, logp_p = sample_categorical(1, 2, index[perm], STREAM_OCC, logits[perm])
    assert torch.equal(idx_p, idx[perm]) and torch.equal(logp_p, logp[perm])
    idx_1, _ = sample_categorical(1, 2, index[:5], STREAM_OCC, logits[:5])
    assert torch.equal(idx_1, idx[:5])
    for other in ((2, 2, STREAM_OCC, 0), (1, 3, STREAM_OCC, 0),
                  (1, 2, STREAM_SCALE_BIN, 0), (1, 2, STREAM_OCC, 9)):
        seed, step, stream, first = other
        assert not torch.equal(
            sample_categorical(seed, step, index, stream, logits, first)[0], idx), other


@pytest.mark.parametrize("mode", ["tree", "parts"])
def test_tree_sampler_and_logp_match_the_reference(mode):
    """The tree draw's logp equals occlusion_tree_logp on its own path, and
    its node is the level's offset plus the cell (0 for "none").  Both
    log-prob functions against the JAX package's on the same logits: the
    port's path under JAX's occlusion_tree_logp, and JAX's own sampled path
    under the port's (4 ulps)."""
    import jax
    import jax.numpy as jnp

    from posetpu.models import agent as ref

    sizes = [1, 4] if mode == "tree" else list(part_level_sizes("mpii"))
    rng = np.random.RandomState(2)
    B = 400
    lvl_logits = rng.randn(B, len(sizes) + 1).astype(np.float32)
    cell_logits = tuple(rng.randn(B, s).astype(np.float32) * 2 for s in sizes)
    t_lvl = torch.from_numpy(lvl_logits)
    t_cells = tuple(map(torch.from_numpy, cell_logits))
    node, lvl, cell, logp = sample_occlusion_tree(0, 1, torch.arange(B), STREAM_OCC,
                                                  t_lvl, t_cells)
    assert set(lvl.tolist()) == set(range(len(sizes) + 1))
    assert torch.equal(logp, occlusion_tree_logp(t_lvl, t_cells, lvl, cell))
    offs = ref._offsets_from_sizes(sizes)
    lv = lvl.numpy()
    want_node = np.where(lv == 0, 0, offs[np.maximum(lv - 1, 0)] + cell.numpy())
    np.testing.assert_array_equal(node.numpy(), want_node)
    j_cells = tuple(map(jnp.asarray, cell_logits))
    got = np.asarray(ref.occlusion_tree_logp(jnp.asarray(lvl_logits), j_cells,
                                             jnp.asarray(lvl.numpy()), jnp.asarray(cell.numpy())))
    tol = 4 * h.ULP * 8
    np.testing.assert_allclose(logp.numpy(), got, rtol=0, atol=tol)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(4), i))(jnp.arange(B))
    r_node, r_lvl, r_cell, r_logp = ref.sample_occlusion_tree(keys, jnp.asarray(lvl_logits),
                                                              j_cells)
    mine = occlusion_tree_logp(t_lvl, t_cells, torch.from_numpy(np.array(r_lvl)).long(),
                               torch.from_numpy(np.array(r_cell)).long())
    np.testing.assert_allclose(mine.numpy(), np.asarray(r_logp), rtol=0, atol=tol)


def test_weight_and_moment_carry_covers_every_tensor():
    """Every tensor of the port's agent (each occlusion layout) is carried,
    conv kernels HWIO -> OIHW and dense kernels transposed; the agent's
    optax moments map by the same names."""
    import jax

    from posetpu.train.state import make_optimizer as ref_make_optimizer

    for mode in MODES:
        ref = h.ref_agent(mode)
        v = h.agent_variables(ref)
        sd = from_flax_agent_variables(v["params"], v["batch_stats"])
        agent = h.port_agent(mode)
        assert set(sd) == {k for k in agent.state_dict() if "num_batches" not in k}
        np.testing.assert_array_equal(sd["conv0.weight"].numpy(),
                                      np.transpose(v["params"]["conv0"]["kernel"], (3, 2, 0, 1)))
        np.testing.assert_array_equal(sd["hidden.weight"].numpy(),
                                      np.asarray(v["params"]["Dense_0"]["kernel"]).T)
    tx = ref_make_optimizer(h.cfg().optim)
    grads = jax.tree.map(lambda a: a * 0.5 + 0.1, v["params"])
    _, opt_state = tx.update(grads, tx.init(v["params"]), v["params"])
    carried = from_optax_agent_state(opt_state)
    assert carried["count"] == 1
    assert set(carried["nu"]) == {n for n, _ in agent.named_parameters()}
    with pytest.raises(KeyError):
        from_flax_agent_variables({"Conv_9": {"kernel": np.zeros((1, 1))}})


def test_named_agent_configs_equal_the_reference():
    """hg8_mpii_asr and hg8_lsp_aho carry the reference's agent settings
    (every field the port has), and agent_from_config builds their agents:
    22 tree nodes over (1, 2, 4) for LSP's 14 joints."""
    from posetpu.configs import named_config as ref_named_config

    for name in ("hg8_mpii_asr", "hg8_lsp_aho"):
        cfg, want = named_config(name), ref_named_config(name)
        for f in ("enabled", "scale_bins", "rot_bins", "occ_nodes", "occ_levels", "occ_mode",
                  "input_downscale", "lr", "reward_baseline", "update_every",
                  "pose_ref_weight"):
            assert getattr(cfg.agent, f) == getattr(want.agent, f), (name, f)
        assert (cfg.model.classes, cfg.aug.dataset) == (want.model.classes, want.aug.dataset)
    cfg = named_config("hg8_lsp_aho")
    agent, opt, kw = agent_from_config(cfg, widths=(8, 16), device="cpu")
    assert agent.head_occ_cell4.out_features == 16 and len(kw["occ_boxes"]) == 22
    assert opt.schedule(0) == float(np.float32(cfg.agent.lr))
    cfg.agent.occ_nodes = 21
    with pytest.raises(ValueError):
        agent_from_config(cfg, device="cpu")
    cfg.agent.occ_mode, cfg.agent.occ_nodes = "parts", 9
    assert agent_from_config(cfg, widths=(8,), device="cpu")[2]["occ_boxes"] is None
    with pytest.raises(ValueError):
        agent_from_config(named_config("hg8_mpii"), device="cpu")


@pytest.fixture(scope="module")
def refs():
    """The JAX joint step of each occlusion mode, jitted once per module."""
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = h.RefJoint(mode)
        return cache[mode]

    return get


@pytest.mark.parametrize("mode", ["tree", "parts", "flat"])
def test_joint_step_with_occlusion_matches_jax(refs, monkeypatch, mode):
    """One joint step with each occlusion mode from the JAX package's
    initial state, carried (tests/test_torch_adversarial.py's tolerances):
    the occluded crops feed the same losses, and the occlusion heads' log
    probabilities the same REINFORCE gradients."""
    rj = refs(mode)
    js, _, _ = h.check_step(rj, monkeypatch, rj.state0, h.batch(102), 9)
    assert js.agent.step == js.agent.optimizer.count == 1
