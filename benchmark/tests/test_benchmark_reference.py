"""Each plain reference of the benchmark against the program's CPU path at
a tiny size, from the same weights and inputs."""

import json
import os

import pytest
import torch

from benchmark.drivers.common import port_configs, port_network
from benchmark.frozen.keyed import aug_params, jitter_scales
from benchmark.frozen.synthetic import serve_pool, train_pool
from benchmark.reference import pose_serve
from benchmark.reference.augment import train_crops
from benchmark.reference.hourglass import Net
from benchmark.tests.tiny import HERE
from benchmark.weights import load_, make_weights

SEED = 2**31 + 77


def tiny_cfg(depth=2):
    with open(os.path.join(HERE, "configs", "hg8_mpii.json")) as f:
        cfg = json.load(f)
    cfg["model"].update(stacks=2, feats=8, depth=depth, bf16=False)
    cfg["aug"].update(inp_res=[64, 64], out_res=[16, 16])
    return cfg


@pytest.fixture
def net():
    cfg = tiny_cfg()
    model = port_network(cfg, torch.device("cpu"))
    weights = make_weights(model, SEED, "cpu")
    load_(model, weights)
    return cfg, model, weights


@pytest.mark.parametrize("train", [False, True])
def test_network_matches_the_program(net, train):
    cfg, model, weights = net
    x = torch.randn(4, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    model.train(train)
    with torch.no_grad():
        got = model(x)
        ref = Net(weights, cfg["model"], train=train)(x)
    assert len(got) == len(ref) == cfg["model"]["stacks"]
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


def test_weights_cover_the_state_dict_and_repeat(net):
    _, model, weights = net
    assert set(weights) == set(model.state_dict())
    again = make_weights(model, SEED, "cpu")
    assert all(torch.equal(weights[n], again[n]) for n in weights)
    other = make_weights(model, SEED + 1, "cpu")
    assert not torch.equal(weights["stem.0.weight"], other["stem.0.weight"])


@pytest.mark.parametrize("step", [0, 5])
def test_draws_and_crops_match_the_program(step):
    from posetpu_torch.aug.color import sample_jitter_scales
    from posetpu_torch.aug.pipeline import augment_batch, sample_aug_params_ps

    cfg = tiny_cfg()
    aug, _ = port_configs(cfg)
    pool = train_pool(SEED, 1, 1, 16, 64, 8, "cpu")
    b = {k: v[0, 0] for k, v in pool.items()}
    params = sample_aug_params_ps(SEED, step, b["index"], scale_factor=aug.scale_factor,
                                  rot_factor=aug.rot_factor, rot_prob=aug.rot_prob,
                                  flip_prob=aug.flip_prob, scale_mode=aug.scale_mode)
    drawn = aug_params(SEED, step, b["index"], cfg["aug"])
    for p, r in zip(params, drawn):
        assert torch.equal(p, r)
    jit = jitter_scales(SEED, step, b["index"])
    assert torch.equal(sample_jitter_scales(SEED, step, b["index"]), jit)
    out = augment_batch(b["image"], b["valid_wh"], b["center"], b["scale"], b["pts"],
                        b["vis"], params, inp_res=(64, 64), out_res=(16, 16), sigma=1.0,
                        mean=torch.tensor(cfg["mean"]), dataset="mpii",
                        jitter_scales=jit, device="cpu")
    x, target = train_crops(b, *drawn, jit, cfg["aug"], cfg["mean"])
    torch.testing.assert_close(out["input"], x, rtol=0, atol=1e-4)
    assert torch.equal(out["target"], target)


def test_serving_decode_matches_the_program(net):
    from posetpu_torch.infer import PosePredictor

    cfg, model, weights = net
    pool = serve_pool(SEED, 1, 4, 80, "cpu")
    b = {k: v[0] for k, v in pool.items()}
    p = PosePredictor(model, mean=tuple(cfg["mean"]), inp_res=(64, 64), out_res=(16, 16),
                      device="cpu")
    got = p(b["images"].numpy(), b["valid_wh"].numpy(), b["center"].numpy(),
            b["scale"].numpy())
    heat = pose_serve.heatmaps(weights, b["images"], b["center"], b["scale"],
                               model=cfg["model"], inp_res=(64, 64), mean=cfg["mean"])
    ref = pose_serve.decode(heat, b["center"], b["scale"], (16, 16))
    torch.testing.assert_close(torch.as_tensor(got["conf"]), ref["conf"], rtol=1e-4,
                               atol=1e-4 * float(heat.abs().max()))
    assert torch.equal(torch.as_tensor(got["heatmap_coords"]).double(),
                       ref["heatmap_coords"])
    assert torch.equal(torch.as_tensor(got["pred"]).double(), ref["pred"])


def test_agent_matches_the_program():
    from posetpu_torch.models.agent import AugAgent

    from benchmark.reference import agent

    with open(os.path.join(HERE, "configs", "hg8_mpii_asr.json")) as f:
        a = json.load(f)["agent"]
    net = AugAgent(num_scale_bins=a["scale_bins"], num_rot_bins=a["rot_bins"],
                   widths=tuple(a["widths"]), input_downscale=a["input_downscale"],
                   dtype=torch.float32, device="cpu")
    weights = make_weights(net, SEED, "cpu")
    load_(net, weights)
    x = torch.randn(6, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    net.train()
    with torch.no_grad():
        got = net(x)
        ref = agent.logits(weights, x, convs=len(a["widths"]),
                           input_downscale=a["input_downscale"])
    for head in ("scale", "rot"):
        torch.testing.assert_close(got[head], ref[head], rtol=1e-4, atol=1e-5)


def test_categorical_draws_match_the_program():
    from posetpu_torch.aug.keyed import sample_categorical as program_draw

    from benchmark.frozen.keyed import sample_categorical

    logits = torch.randn(64, 7, generator=torch.Generator().manual_seed(3))
    index = torch.arange(64, dtype=torch.int32) * 7
    for stream in (2, 3):
        assert torch.equal(program_draw(SEED, 4, index, stream, logits)[0],
                           sample_categorical(SEED, 4, index, stream, logits))
