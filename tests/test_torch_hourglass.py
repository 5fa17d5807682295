"""posetpu_torch's hourglass and weight carry against the JAX package's
flax hourglass: random flax variables (BN statistics perturbed) carried
over with from_flax_variables give the same heatmaps on every stack.

The JAX package is imported inside the tests that use it, so the CUDA test
also runs on a GPU machine without JAX (``-m cuda``, see README)."""

import numpy as np
import pytest
import torch

from posetpu_torch.ckpt import from_flax_variables
from posetpu_torch.models import hg

FEATS, CLASSES, RES = 8, 4, 64


def _flax_variables(stacks, seed=0):
    import jax
    import jax.numpy as jnp

    from posetpu.models import hg as ref_hg

    model = ref_hg(num_stacks=stacks, num_blocks=1, num_classes=CLASSES,
                   num_feats=FEATS, dtype=jnp.float32)
    rng = np.random.RandomState(seed)
    x = rng.rand(2, RES, RES, 3).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(seed + 7), jnp.asarray(x), train=False)
    # perturb every array, BN running stats included, so the carry of each
    # leaf is exercised (variances stay positive: 1 + 0.05 * N(0, 1))
    variables = jax.tree.map(
        lambda a: a + 0.05 * jnp.asarray(rng.randn(*a.shape), a.dtype), variables
    )
    return model, variables, x


def _port_model(stacks, variables):
    model = hg(num_stacks=stacks, num_classes=CLASSES, num_feats=FEATS,
               dtype=torch.float32)
    sd = from_flax_variables(variables["params"], variables["batch_stats"],
                             num_stacks=stacks)
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.mark.parametrize("stacks", [1, 2])
def test_heatmaps_match_flax(stacks):
    import jax.numpy as jnp

    ref_model, variables, x = _flax_variables(stacks)
    want = ref_model.apply(variables, jnp.asarray(x), train=False)
    model = _port_model(stacks, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(want) == stacks
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and g.shape == (2, CLASSES, RES // 4, RES // 4)
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w).transpose(0, 3, 1, 2), atol=2e-4, rtol=1e-3,
            err_msg=f"stack {i} heatmaps diverge",
        )


def test_carry_covers_every_port_tensor():
    import jax

    from posetpu.ckpt.transplant import to_reference_state_dict

    stacks = 2
    _, variables, _ = _flax_variables(stacks)
    sd = from_flax_variables(variables["params"], variables["batch_stats"],
                             num_stacks=stacks)
    model = hg(num_stacks=stacks, num_classes=CLASSES, num_feats=FEATS,
               dtype=torch.float32)
    port_keys = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == port_keys
    ref_sd = to_reference_state_dict(variables["params"], variables["batch_stats"],
                                     num_stacks=stacks)
    assert set(sd) == set(ref_sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref_sd[k], err_msg=k)
    n_flax = sum(np.asarray(leaf).size for leaf in jax.tree.leaves(variables))
    assert n_flax == sum(v.numel() for v in sd.values())


def test_bf16_forward_keeps_score_head_f32():
    _, variables, x = _flax_variables(1)
    model = hg(num_stacks=1, num_classes=CLASSES, num_feats=FEATS)  # bf16 default
    model.load_state_dict(
        from_flax_variables(variables["params"], variables["batch_stats"], num_stacks=1)
    )
    ref = _port_model(1, variables)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))[0]
        want = ref(torch.from_numpy(x))[0]
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # bf16 keeps ~3 significant digits through ~40 layers
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=0.1, rtol=0.1)


def _flax_outputs_by_port_name(ref_model, variables, x, stacks):
    """Every flax submodule's output in the reference's forward, keyed by
    the name of the port's module that computes it."""
    import jax.numpy as jnp

    from posetpu_torch.ckpt.transplant import _BOTTLENECK, _module_map

    names = _module_map(stacks, 1, 4)
    names.update({f"hg{i}": f"hgs.{i}" for i in range(stacks)})
    _, state = ref_model.apply(variables, jnp.asarray(x), train=False,
                               capture_intermediates=True, mutable=["intermediates"])
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "__call__":
                parent, _, child = path.rpartition("/")
                if path in names:
                    out[names[path]] = v[0]
                elif parent in names and child in _BOTTLENECK:
                    out[f"{names[parent]}.{_BOTTLENECK[child]}"] = v[0]
            else:
                walk(v, f"{path}/{k}" if path else k)

    walk(state["intermediates"], "")
    return out


@pytest.mark.parametrize("stacks", [1, 2])
def test_bf16_placement_matches_flax(stacks):
    """Under bf16 each port module's output has the dtype of the flax
    module it mirrors: convolutions, BatchNorms, residual sums, hourglass
    outputs and the remaps in bf16, the score heads in float32."""
    import jax.numpy as jnp

    from posetpu.models import hg as ref_hg

    _, variables, x = _flax_variables(stacks)
    ref_model = ref_hg(num_stacks=stacks, num_classes=CLASSES, num_feats=FEATS,
                       dtype=jnp.bfloat16)
    want = _flax_outputs_by_port_name(ref_model, variables, x, stacks)
    model = hg(num_stacks=stacks, num_classes=CLASSES, num_feats=FEATS)
    model.load_state_dict(
        from_flax_variables(variables["params"], variables["batch_stats"],
                            num_stacks=stacks)
    )
    got = {}
    for name, mod in model.named_modules():
        if name in want:
            mod.register_forward_hook(
                lambda m, i, o, name=name: got.__setitem__(name, (o.dtype, o.shape))
            )
    with torch.no_grad():
        outs = model.eval()(torch.from_numpy(x))
    assert set(got) == set(want)
    assert {str(w.dtype) for w in want.values()} == {"bfloat16", "float32"}
    for name, w in want.items():
        dtype, shape = got[name]
        assert str(dtype) == f"torch.{w.dtype}", name
        assert tuple(shape) == (w.shape[0], w.shape[3], w.shape[1], w.shape[2]), name
    assert all(o.dtype == torch.float32 for o in outs)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("stacks", [1, 2])
def test_bf16_heatmaps_match_flax_bf16(stacks, seed):
    """The port's bf16 forward against the reference's bf16 forward.

    The two round at different points: flax adds a convolution's bias to
    its bf16 output (a second rounding), oneDNN adds the bias inside the
    convolution and rounds once, so a share of the first convolution's
    outputs already differ.  bf16 spreads such differences through the
    whole net within a few layers: over the cases below, the mean |port
    bf16 - flax bf16| read 0.88-1.37 times the mean |flax f32 - flax bf16|,
    and the port's own bf16-to-f32 distance 0.70-1.13 times it.  No
    elementwise tolerance lies between the two bf16 paths and the f32 gap,
    so the heatmaps are held by those ratios: as close to the reference's
    bf16 as its own f32 is (within 2x), and really rounded to bf16 (at
    least half the reference's f32 gap).  The placement of each rounding
    is held exactly by test_bf16_placement_matches_flax."""
    import jax.numpy as jnp

    from posetpu.models import hg as ref_hg

    ref32, variables, x = _flax_variables(stacks, seed)
    ref16 = ref_hg(num_stacks=stacks, num_classes=CLASSES, num_feats=FEATS,
                   dtype=jnp.bfloat16)
    w32 = ref32.apply(variables, jnp.asarray(x), train=False)
    w16 = ref16.apply(variables, jnp.asarray(x), train=False)
    sd = from_flax_variables(variables["params"], variables["batch_stats"],
                             num_stacks=stacks)
    port = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = hg(num_stacks=stacks, num_classes=CLASSES, num_feats=FEATS, dtype=dtype)
        model.load_state_dict(sd)
        with torch.no_grad():
            port[dtype] = [o.numpy() for o in model.eval()(torch.from_numpy(x))]
    for i in range(stacks):
        j32 = np.asarray(w32[i]).transpose(0, 3, 1, 2)
        j16 = np.asarray(w16[i]).transpose(0, 3, 1, 2)
        p16, p32 = port[torch.bfloat16][i], port[torch.float32][i]
        gap = np.abs(j32 - j16).mean()
        assert gap > 0
        assert np.abs(p16 - j16).mean() <= 2.0 * gap, f"stack {i}"
        assert np.abs(p16 - p32).mean() >= 0.5 * gap, f"stack {i}"


def test_multi_block_model_is_rejected():
    """A model of no residual block is refused; one of two blocks a site
    is built and takes the carry of a flax num_blocks=2 network whole (its
    forward against flax: tests/test_torch_variants.py)."""
    with pytest.raises(ValueError):
        hg(num_stacks=1, num_blocks=0)
    with pytest.raises(ValueError):
        from_flax_variables({}, None, num_stacks=1, num_blocks=0)
    import jax
    import jax.numpy as jnp

    from posetpu.models import hg as ref_hg

    ref = ref_hg(num_stacks=1, num_blocks=2, num_classes=CLASSES, num_feats=FEATS,
                 depth=2, dtype=jnp.float32)
    v = ref.init(jax.random.PRNGKey(0), jnp.zeros((1, RES, RES, 3)), train=False)
    sd = from_flax_variables(v["params"], v["batch_stats"], num_stacks=1, num_blocks=2,
                             depth=2)
    model = hg(num_stacks=1, num_blocks=2, num_classes=CLASSES, num_feats=FEATS, depth=2,
               dtype=torch.float32)
    model.load_state_dict(sd, strict=True)
    assert isinstance(model.res[0], torch.nn.Sequential) and len(model.res[0]) == 2
    assert set(sd) == {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}


@pytest.mark.cuda
def test_bf16_activations_stay_bf16_on_cuda():
    """Under CUDA autocast every hourglass output and the residual stream
    stay bf16, as the reference computes them; only the score heads are
    float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA autocast has no CPU mode)")
    model = hg(num_stacks=2, num_classes=CLASSES, num_feats=FEATS).cuda().eval()
    seen = {}
    for name, mod in model.named_modules():
        if name.startswith(("hgs.", "res.")) and name.count(".") == 1:
            mod.register_forward_hook(
                lambda m, i, o, name=name: seen.__setitem__(name, o.dtype)
            )
    with torch.no_grad():
        outs = model(torch.rand(2, RES, RES, 3, device="cuda"))
    assert seen and set(seen.values()) == {torch.bfloat16}, seen
    assert all(o.dtype == torch.float32 for o in outs)
