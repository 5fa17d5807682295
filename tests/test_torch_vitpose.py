"""ViTPose on the port's normal path (``posetpu_torch.models.vitpose``,
``build_model``, ``LayerDecayAdamW``, the clip in the train math), held to
the plain float32 reference ``tests/torch_vitpose_reference.py`` at a tiny
width: embed 64, 2 blocks of 4 heads, 64² input (4x4 tokens), 16² heatmaps,
16 joints, drop path rising to 0.55, seeded random weights.

- the forward in eval mode, and in train mode with the same keyed
  drop-path masks;
- three train steps through ``make_train_step`` and through
  ``make_dispatch_step``'s CPU route (one dispatch of 3): the losses, the
  parameters and AdamW's moments, with the clip active, across the end of
  the warm-up and a drop of the schedule;
- the layer-decay and weight-decay table of every parameter of ViTPose-H
  (one case a parameter);
- ViTPose-H's published parameter count, built on the ``meta`` device;
- ``PosePredictor.from_config`` on a ViT config, and the Experiment's
  refusals;
- the attention's launch counter, counted once a replay as the
  rasterizer's is;
- on the card (``cuda`` marker; skips here), the K = 1 and K = 2 graphs
  equal eager steps bit for bit in float32.

The reference reads the crops and targets the program's augmentation made
(recorded by wrapping ``augment_batch``): the augmentation has tests of its
own.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import posetpu_torch.train.step as port_step
import torch_vitpose_reference as ref
from posetpu_torch.configs import named_config
from posetpu_torch.infer import PosePredictor
from posetpu_torch.models import build_model
from posetpu_torch.models.vitpose import PATCH_PADDING, PATCH_SIZE
from posetpu_torch.train.loop import Experiment, seeded_init_
from posetpu_torch.train.state import (
    ADAMW_BETAS,
    ADAMW_EPS,
    WARMUP_RATIO,
    LayerDecayAdamW,
    TrainState,
    make_optimizer,
)
from posetpu_torch.train.step import make_dispatch_step, make_train_step
from posetpu_torch.utils.profiling import counter

B, SEED, MEAN = 4, 11, (0.4404, 0.4440, 0.4327)
# float32 on both sides, the same operations in other orders (SDPA
# against softmax(q k^T) v, fused linear layers against matmuls): the
# largest gap read 5.7e-7 of the heatmaps' largest value, about 10 ulps
# over 2 blocks and the head; the limit leaves 9x
FWD_RTOL = 5e-6
# the steps start from second moments of about a gradient's square (a run
# resumed after 498 updates), so an update is proportional to the
# gradient and carries its rounding, not the sign flips of a first AdamW
# step from zero moments; the largest elementwise gap over three steps
# read 2.5e-6 of the updates' scale (lr_max times 3) in the parameters and
# 4.1e-6 of the largest first moment; the limit leaves 10x
STEP_RTOL = 4e-5
# the losses read 1.0e-7 apart (relative); the limit leaves 20x
LOSS_RTOL = 2e-6
# the ViT-H parameters' names and shapes, for the table's cases
with torch.device("meta"):
    _H = build_model(named_config("vitpose_h_mpii").model)
H_PARAMS = [(n, tuple(p.shape)) for n, p in _H.named_parameters()]
del _H


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread for this module's CPU training (the suite runs
    several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = named_config("vitpose_h_mpii")
    m = cfg.model
    m.embed_dim, m.vit_depth, m.num_heads, m.img_size, m.bf16 = 64, 2, 4, 64, False
    cfg.aug.inp_res, cfg.aug.out_res = (64, 64), (16, 16)
    # 100 updates an epoch: the warm-up ends at update 500 and the rate
    # drops there too (epoch 5)
    cfg.optim.schedule = (5, 200)
    return cfg


def _model(cfg, seed=0):
    return seeded_init_(build_model(cfg.model), seed)


def _dims(cfg):
    m = cfg.model
    return dict(depth=m.vit_depth, heads=m.num_heads, patch=PATCH_SIZE,
                padding=PATCH_PADDING, rate=m.drop_path_rate)


def _weights(model):
    return {n: t.detach().clone() for n, t in model.state_dict().items()}


def _batch(seed, hw=(80, 96)):
    rng = np.random.RandomState(seed)
    H, W = hw
    valid_wh = np.stack([rng.randint(W - 16, W + 1, B), rng.randint(H - 8, H + 1, B)],
                        axis=1).astype(np.int32)
    center = (valid_wh / 2 + rng.uniform(-4, 4, (B, 2))).astype(np.float32)
    scale = (valid_wh[:, 1] / 200.0 * rng.uniform(0.8, 1.1, B)).astype(np.float32)
    return {
        "image": rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8),
        "valid_wh": valid_wh,
        "center": center,
        "scale": scale,
        "pts": (center[:, None, :] + rng.uniform(-25, 25, (B, 16, 2))).astype(np.float32),
        "vis": (rng.rand(B, 16) < 0.8).astype(np.float32),
        "index": rng.choice(10_000, B, replace=False).astype(np.int32),
    }


def _close(a, b, rtol, scale=None):
    scale = b.abs().max() if scale is None else scale
    gap = (a - b).abs().max()
    assert gap <= rtol * scale, f"{float(gap)} > {rtol} x {float(scale)}"


@pytest.mark.parametrize("train", [False, True])
def test_forward_equals_the_reference(train):
    cfg = _cfg()
    model = _model(cfg)
    model.train(train)
    x = torch.rand(B, 64, 64, 3, generator=torch.Generator().manual_seed(3)) - 0.5
    keys = (SEED, 7, torch.tensor([3, 99, 12345, 2**31 - 1], dtype=torch.int32))
    got = model(x, keys=keys) if train else model(x)
    assert isinstance(got, list) and len(got) == 1 and got[0].shape == (B, 16, 16, 16)
    want = ref.forward(_weights(model), x, train=train, keys=keys, **_dims(cfg))
    _close(got[0], want, FWD_RTOL)
    if train:  # the masks matter: other keys draw other heatmaps
        other = model(x, keys=(SEED, 8, keys[2]))[0]
        assert (other - want).abs().max() > 100 * FWD_RTOL * want.abs().max()


def test_train_mode_drop_path_needs_keys():
    model = _model(_cfg()).train()
    with pytest.raises(ValueError, match="keys"):
        model(torch.zeros(B, 64, 64, 3))


def _optimizer(model, cfg, steps_per_epoch):
    return make_optimizer(model.param_groups(cfg.optim), cfg.optim, steps_per_epoch)


def _resumed(model, opt, count, v_rms):
    """Second moments of ``v_rms`` squared and update count ``count`` (the
    schedule's, and each parameter's step), as a run resumed mid-warm-up
    holds them."""
    opt.init_moments()
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p]["exp_avg_sq"].fill_(v_rms ** 2)
            opt.state[p]["step"].fill_(count)
    opt.count = count


def _program_steps(cfg, batches, how, monkeypatch):
    """(losses, state dict, {name: (m, v)}, the recorded crops) of three
    steps of the program from the seeded weights."""
    model = _model(cfg)
    opt = _optimizer(model, cfg, 100)
    _resumed(model, opt, 498, 1e-3)
    state = TrainState(model, opt, step=40)
    crops = []
    real = port_step.augment_batch

    def recording(*a, **kw):
        out = real(*a, **kw)
        crops.append({k: v.clone() for k, v in out.items()})
        return out

    monkeypatch.setattr(port_step, "augment_batch", recording)
    kw = dict(seed=SEED, mask_loss=model.masked_loss, clip_norm=cfg.optim.clip_norm,
              device="cpu")
    if how == "eager":
        step = make_train_step(model, opt, cfg.aug, MEAN, **kw)
        losses = torch.stack([step(state, b)["loss"] for b in batches])
    else:
        dispatch = make_dispatch_step(model, opt, cfg.aug, MEAN, steps=3, **kw)
        losses = dispatch(state, {k: np.stack([b[k] for b in batches]) for k in batches[0]})["loss"]
    assert (state.step, opt.count) == (43, 501)
    named = dict(model.named_parameters())
    moments = {n: (opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"]) for n, p in named.items()}
    return losses, _weights(model), moments, crops


@pytest.fixture(scope="module")
def reference_run():
    """The reference's three steps from the same weights and state, on
    the crops the eager program made (recorded in a first run)."""
    cfg = _cfg()
    cfg.optim.clip_norm = 1e-2
    batches = [_batch(20 + i) for i in range(3)]
    mp = pytest.MonkeyPatch()
    try:
        prog = _program_steps(cfg, batches, "eager", mp)
    finally:
        mp.undo()
    w = _weights(_model(cfg))
    names = [n for n, _ in _model(cfg).named_parameters()]
    moments = {n: [torch.zeros_like(w[n]), torch.full_like(w[n], 1e-6)] for n in names}
    m, o = cfg.model, cfg.optim
    model_kw = {k: getattr(m, k) for k in ("vit_depth", "num_heads", "drop_path_rate")}
    model_kw.update(patch_size=PATCH_SIZE, patch_padding=PATCH_PADDING)
    optim_kw = {k: getattr(o, k) for k in ("lr", "schedule", "gamma", "warmup_iters",
                                           "layer_decay", "weight_decay", "clip_norm")}
    optim_kw.update(warmup_ratio=WARMUP_RATIO, betas=ADAMW_BETAS, adam_eps=ADAMW_EPS)
    losses, norms = [], []
    for i, (b, c) in enumerate(zip(batches, prog[3])):
        keys = (SEED, 40 + i, torch.as_tensor(b["index"]))
        loss, norm = ref.train_step(w, names, c["input"], c["target"], c["target_weight"],
                                    moments, 498 + i, keys, model=model_kw, optim=optim_kw,
                                    steps_per_epoch=100)
        losses.append(loss)
        norms.append(norm)
    return cfg, batches, prog, (torch.tensor(losses), w, moments, norms)


@pytest.mark.parametrize("how", ["eager", "dispatch"])
def test_three_steps_equal_the_reference(reference_run, how, monkeypatch):
    cfg, batches, prog, (losses, w, moments, norms) = reference_run
    assert min(norms) > 10 * cfg.optim.clip_norm  # the clip scales every step
    if how == "dispatch":
        prog = _program_steps(cfg, batches, how, monkeypatch)
    p_losses, p_w, p_m, _ = prog
    _close(p_losses.double(), losses.double(), LOSS_RTOL)
    lr_max = cfg.optim.lr
    for n, (m, v) in moments.items():
        _close(p_w[n], w[n], STEP_RTOL, scale=3 * lr_max)
        _close(p_m[n][0], m, STEP_RTOL)
        _close(p_m[n][1], v, STEP_RTOL)
    for n in w:  # the head's running statistics
        if "running_" in n:
            _close(p_w[n], w[n], FWD_RTOL)


def test_eager_and_dispatch_steps_are_equal(reference_run, monkeypatch):
    """The dispatch's body is the eager step's math exactly."""
    cfg, batches, eager, _ = reference_run
    prog = _program_steps(cfg, batches, "dispatch", monkeypatch)
    assert torch.equal(prog[0], eager[0])
    for n in eager[1]:
        assert torch.equal(prog[1][n], eager[1][n]), n


@pytest.fixture(scope="module")
def h_groups():
    """{name: (lr_scale, weight_decay)} of ViTPose-H's groups (meta)."""
    cfg = named_config("vitpose_h_mpii")
    assert (cfg.optim.layer_decay, cfg.optim.weight_decay) == (0.85, 0.1)
    with torch.device("meta"):
        model = build_model(cfg.model)
    return {n: (g["lr_scale"], g["weight_decay"])
            for g in model.param_groups(cfg.optim) for n in g["names"]}


@pytest.mark.parametrize("i", range(len(H_PARAMS)))
def test_layer_decay_and_weight_decay_of_every_parameter(h_groups, i):
    """Each of ViTPose-H's parameters sits in the group of its layer's
    scale, 0.85 ** (33 - layer), and of its weight decay, 0.1 or none."""
    name, shape = H_PARAMS[i]
    scale, wd = h_groups[name]
    assert scale == pytest.approx(0.85 ** (33 - ref.layer_of(name, 32)), rel=1e-12)
    assert wd == (0.1 if ref.decays(name, shape) else 0.0)


def test_published_parameter_count_and_groups():
    cfg = named_config("vitpose_h_mpii")
    with torch.device("meta"):
        model = build_model(cfg.model)
    assert sum(p.numel() for p in model.parameters()) == 637_290_512
    opt = _optimizer(model, cfg, 44)
    assert isinstance(opt, LayerDecayAdamW)
    # 34 layers; the embeddings' layer has no 1-D tensor but a bias and
    # pos_embed, the last has the head's decayed deconvolutions; 12
    # tensors a block, 3 embedding, 2 last norm, 8 head
    assert len(opt.param_groups) == 68
    assert counter("optim.param_groups") == 68 and counter("optim.params") == len(H_PARAMS)
    assert len(H_PARAMS) == 32 * 12 + 3 + 2 + 8


def test_schedule_warms_up_then_steps():
    cfg = _cfg()
    model = _model(cfg)
    opt = _optimizer(model, cfg, 100)
    for count in (0, 1, 250, 499, 500, 501, 19999, 20000):
        got = float(opt.schedule(torch.tensor(count)))
        want = ref.lr_at(count, lr=5e-4, schedule=(5, 200), gamma=0.1, steps_per_epoch=100,
                         warmup_iters=500, warmup_ratio=0.001)
        # the rate rounded once to float32
        assert got == pytest.approx(want, rel=2**-24), count


def test_predictor_from_config_serves_a_vit(tmp_path):
    cfg = _cfg()
    model = _model(cfg, seed=5)
    p = PosePredictor.from_config(cfg, model.state_dict(), device="cpu")
    b = _batch(3)
    out = p(b["image"], b["valid_wh"], b["center"], b["scale"])
    assert out["pred"].shape == (B, 16, 2) and out["conf"].shape == (B, 16)
    eager = p._graph_body({k: torch.as_tensor(b[f]) for k, f in (
        ("images", "image"), ("valid_wh", "valid_wh"), ("center", "center"),
        ("scale", "scale"))})
    assert np.array_equal(out["conf"], eager["conf"].numpy())


def test_experiment_trains_a_vit_and_serves_its_run_directory(tmp_path):
    """The train command's path: ``Experiment`` builds the network through
    ``build_model`` with ViTPose's init, AdamW with its groups and the
    dispatch with the clip and the masked loss; an epoch of 2 steps, a
    validation and a checkpoint; then ``PosePredictor.from_config`` reads
    the run directory."""
    cfg = _cfg()
    cfg.synthetic, cfg.checkpoint_dir, cfg.batch_size = True, str(tmp_path), 4
    cfg.optim.epochs, cfg.steps_per_epoch = 1, 2
    exp = Experiment(cfg, device="cpu")
    try:
        assert isinstance(exp.state.optimizer, LayerDecayAdamW)
        state, _ = exp.fit(progress=lambda *a: None)
    finally:
        exp.close()
    assert state.step == state.optimizer.count == 2
    run_dir = os.path.join(str(tmp_path), cfg.name)
    p = PosePredictor.from_config(cfg, run_dir, best=False, device="cpu")
    b = _batch(4)
    assert p(b["image"], b["valid_wh"], b["center"], b["scale"])["pred"].shape == (B, 16, 2)
    want = {n: t for n, t in exp.model.state_dict().items()}
    for n, t in p.model.state_dict().items():
        assert torch.equal(t, want[n]), n


def test_experiment_refuses_the_agent_and_an_init_pose(tmp_path):
    for field, value in (("agent", True), ("init_pose_from", str(tmp_path))):
        cfg = _cfg()
        cfg.synthetic, cfg.checkpoint_dir = True, str(tmp_path)
        if field == "agent":
            cfg.agent.enabled = value
        else:
            cfg.init_pose_from = value
        with pytest.raises(ValueError, match="hourglass"):
            Experiment(cfg, device="cpu")


def test_state_dict_round_trip_keeps_adamw_moments(reference_run):
    cfg = _cfg()
    model = _model(cfg)
    opt = _optimizer(model, cfg, 100)
    _resumed(model, opt, 7, 0.5)
    sd = copy.deepcopy(opt.state_dict())
    other = _optimizer(_model(cfg), cfg, 100)
    other.load_state_dict(sd)
    for p, q in zip(opt.param_groups[0]["params"], other.param_groups[0]["params"]):
        assert torch.equal(opt.state[p]["exp_avg_sq"], other.state[q]["exp_avg_sq"])
    assert [g["lr_scale"] for g in other.param_groups] == [g["lr_scale"] for g in opt.param_groups]


def test_attention_and_rasterizer_launches_count_once_a_replay():
    """Both are registered launch counters: a capture's launches go back
    on exit, and each replay adds them again."""
    from posetpu_torch.aug.cuda_kernels import RASTERIZE_LAUNCHES
    from posetpu_torch.models.vitpose import ATTENTION_LAUNCHES
    from posetpu_torch.utils import profiling

    names = (RASTERIZE_LAUNCHES, ATTENTION_LAUNCHES)
    before = [counter(n) for n in names]
    with profiling.counted_as_replays() as captured:
        profiling.count(RASTERIZE_LAUNCHES, 3)
        profiling.count(ATTENTION_LAUNCHES, 64)
    assert [counter(n) for n in names] == before
    assert (captured[RASTERIZE_LAUNCHES], captured[ATTENTION_LAUNCHES]) == (3, 64)
    for _ in range(2):
        profiling.add_replay(captured)
    assert [counter(n) - b for n, b in zip(names, before)] == [6, 128]


def test_the_references_import_neither_jax_nor_the_port():
    """The plain references (this one and the benchmark's copy) load
    nothing of JAX, the JAX package or the port, and turn TF32 off."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, torch\n"
            "sys.path.insert(0, 'tests')\n"
            "import torch_vitpose_reference as ref\n"
            "import benchmark.reference.vitpose, benchmark.reference.vitpose_train\n"
            "torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True\n"
            "ref.no_tf32()\n"
            "assert not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'optax', 'posetpu', 'posetpu_torch'))\n"
            "print(','.join(bad) or 'none')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "none"


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_cuda_graph_equals_eager_steps(k):
    """float32, TF32 off, deterministic algorithms, attention through
    SDPA's math route: 2 graphed dispatches of K steps equal 2 K eager
    steps bit for bit, and the attention calls count once a replayed step
    (2 a step at this depth)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.nn.attention import SDPBackend, sdpa_kernel

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    cfg = _cfg()
    batches = [_batch(50 + i) for i in range(2 * k)]
    runs = {}
    try:
        with sdpa_kernel(SDPBackend.MATH):
            for how in ("eager", "graph"):
                model = _model(cfg).cuda()
                opt = _optimizer(model, cfg, 100)
                state = TrainState(model, opt)
                kw = dict(seed=SEED, mask_loss=True, clip_norm=1e-2, device="cuda")
                if how == "eager":
                    step = make_train_step(model, opt, cfg.aug, MEAN, **kw)
                    losses = torch.stack([step(state, b)["loss"] for b in batches])
                else:
                    dispatch = make_dispatch_step(model, opt, cfg.aug, MEAN, steps=k, **kw)
                    before = counter("launches.attention")
                    parts = [dispatch(state, {f: np.stack([b[f] for b in batches[i:i + k]])
                                              for f in batches[0]}) for i in (0, k)]
                    torch.cuda.synchronize()
                    # 2 blocks a step, the replays' and the warm-up's steps
                    assert counter("launches.attention") - before == 2 * (2 * k + 2)
                    losses = torch.cat([p["loss"] for p in parts])
                torch.cuda.synchronize()
                runs[how] = (losses.cpu(), {n: t.cpu() for n, t in _weights(model).items()})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev[:2]
        torch.use_deterministic_algorithms(prev[2])
    assert torch.equal(runs["eager"][0], runs["graph"][0])
    for n in runs["eager"][1]:
        assert torch.equal(runs["eager"][1][n], runs["graph"][1][n]), n
