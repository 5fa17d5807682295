"""The whole slice: posetpu_torch's validation step and PosePredictor
against the JAX package's, on the same weights (carried with
from_flax_variables) and the same batches, at a small f32 size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetpu.configs import named_config as ref_named_config
from posetpu.infer import PosePredictor as RefPredictor
from posetpu.models import hg as ref_hg
from posetpu.train.state import TrainState
from posetpu.train.step import make_eval_step as ref_make_eval_step
from posetpu.train.step import stacked_mse as ref_stacked_mse
from posetpu_torch.ckpt import from_flax_variables
from posetpu_torch.configs import named_config
from posetpu_torch.infer import PosePredictor
from posetpu_torch.models import hg
from posetpu_torch.train.step import make_eval_step, stacked_mse

STACKS, FEATS, CLASSES = 2, 8, 16
MEAN = (0.4404, 0.4440, 0.4327)


@pytest.fixture(scope="module")
def models():
    ref_model = ref_hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS,
                       dtype=jnp.float32)
    rng = np.random.RandomState(0)
    v = ref_model.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)), train=False)
    v = jax.tree.map(lambda a: a + 0.05 * jnp.asarray(rng.randn(*a.shape), a.dtype), v)
    model = hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS,
               dtype=torch.float32)
    model.load_state_dict(
        from_flax_variables(v["params"], v["batch_stats"], num_stacks=STACKS)
    )
    return ref_model, v, model


def _batch(seed, B=4, hw=(96, 128)):
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
        "vis": rng.randint(0, 2, (B, CLASSES)).astype(np.float32),
    }


def _cfg():
    cfg = named_config("hg2_mpii_mini")
    cfg.model.feats = FEATS
    cfg.model.bf16 = False
    cfg.aug.inp_res = (64, 64)
    cfg.aug.out_res = (16, 16)
    ref_cfg = ref_named_config("hg2_mpii_mini")
    ref_cfg.aug.inp_res = (64, 64)
    ref_cfg.aug.out_res = (16, 16)
    return cfg, ref_cfg


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_step_matches_reference(models, seed):
    ref_model, v, model = models
    cfg, ref_cfg = _cfg()
    batch = _batch(seed)
    batch["mask"] = np.array([1, 1, 1, 0], np.float32)
    batch["offset"] = np.random.RandomState(seed).randint(-20, 20, (4, 2)).astype(np.int32)
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=None, step=jnp.zeros((), jnp.int32))
    r_metrics, r_preds = ref_make_eval_step(ref_model, ref_cfg.aug, MEAN)(
        state, {k: jnp.asarray(x) for k, x in batch.items()}
    )
    model.train()
    metrics, preds = make_eval_step(model, cfg.aug, MEAN, device="cpu")(batch)
    assert model.training  # the step restores the model's mode
    np.testing.assert_allclose(float(metrics["loss"]), float(r_metrics["loss"]), rtol=1e-4)
    for k in ("pck_hit", "pck_cnt"):
        np.testing.assert_array_equal(metrics[k].numpy(), np.asarray(r_metrics[k]), err_msg=k)
    assert int(metrics["pck_cnt"].sum()) > 0
    np.testing.assert_allclose(float(metrics["acc"]), float(r_metrics["acc"]), rtol=1e-6)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(r_preds))


def _requests(seeds):
    out = []
    for s in seeds:
        b = _batch(s, B=3)
        out.append((b["image"], b["valid_wh"], b["center"], b["scale"]))
    return out


def _check_prediction(got, want):
    assert set(got) == set(want) == {"pred", "conf", "heatmap_coords"}
    np.testing.assert_allclose(got["conf"], want["conf"], atol=2e-4)
    np.testing.assert_array_equal(got["pred"], want["pred"])
    np.testing.assert_array_equal(got["heatmap_coords"], want["heatmap_coords"])


@pytest.mark.parametrize("depth", [0, 2])
def test_predictor_matches_reference(models, depth):
    ref_model, v, model = models
    kw = dict(inp_res=(64, 64), out_res=(16, 16))
    ref_p = RefPredictor(ref_model, v["params"], v["batch_stats"], mean=MEAN, **kw)
    p = PosePredictor(model, mean=MEAN, device="cpu", **kw)
    reqs = _requests([5, 6, 7])
    want = [ref_p(*r) for r in reqs]
    _check_prediction(p(*reqs[0]), want[0])
    got = list(p.predict_iter(iter(reqs), depth=depth))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _check_prediction(g, w)


def test_predict_single_matches_reference(models):
    ref_model, v, model = models
    kw = dict(inp_res=(64, 64), out_res=(16, 16))
    ref_p = RefPredictor(ref_model, v["params"], v["batch_stats"], mean=MEAN, **kw)
    p = PosePredictor(model, mean=MEAN, device="cpu", **kw)
    img = np.random.RandomState(8).randint(0, 256, (100, 130, 3), dtype=np.uint8)
    pred, conf = p.predict_single(img, (60.0, 50.0), 0.45)
    r_pred, r_conf = ref_p.predict_single(img, (60.0, 50.0), 0.45)
    np.testing.assert_array_equal(pred, r_pred)
    np.testing.assert_allclose(conf, r_conf, atol=2e-4)


def test_from_config_builds_the_configured_network(models):
    _, v, _ = models
    cfg, _ = _cfg()
    sd = from_flax_variables(v["params"], v["batch_stats"], num_stacks=STACKS)
    p = PosePredictor.from_config(cfg, sd, device="cpu")
    assert p.inp_res == (64, 64) and p.out_res == (16, 16)
    assert len(p.model.hgs) == STACKS and p.model.dtype == torch.float32
    out = p(*_requests([9])[0])
    assert out["pred"].shape == (3, CLASSES, 2)
    assert np.isfinite(out["pred"]).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_stacked_mse_matches_reference(weighted):
    """The port's heatmaps are (B, K, H, W); the reference's NHWC."""
    rng = np.random.RandomState(11)
    outs = [rng.randn(3, 4, 8, 8).astype(np.float32) for _ in range(STACKS)]
    target = rng.rand(3, 4, 8, 8).astype(np.float32)
    weight = (rng.rand(3, 4) < 0.6).astype(np.float32) if weighted else None
    got = stacked_mse([torch.from_numpy(o) for o in outs], torch.from_numpy(target),
                      None if weight is None else torch.from_numpy(weight))
    want = ref_stacked_mse(
        [jnp.asarray(o.transpose(0, 2, 3, 1)) for o in outs],
        jnp.asarray(target.transpose(0, 2, 3, 1)),
        None if weight is None else jnp.asarray(weight),
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
