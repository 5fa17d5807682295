"""K train steps per dispatch (``make_dispatch_step``, the counterpart of
``fuse_steps``) and the device counters it runs on.

- ``keyed_bits``, the augmentation sampler and the jitter sampler with a
  0-d int64 ``step`` tensor equal their Python-int versions exactly;
- the schedule evaluated at a count tensor equals ``lr_schedule``'s
  Python value bit for bit over counts that cross both drops, and equals
  the JAX package's optax schedule;
- on the CPU route, a dispatch of 3 body steps and a short one of 2 equal
  5 ``make_train_step`` calls exactly: parameters, moments, BatchNorm
  statistics, metrics, ``step`` and ``count``;
- ``TrainState.snapshot`` and ``restore_`` put every tensor a step
  changes back in place, with the counts;
- an ``Experiment`` with ``steps_per_dispatch=3`` writes the same
  ``log.txt`` rows as one with 1 (both dispatch steps), and one with the
  agent at K = 2 builds and trains (tests/test_torch_joint_dispatch.py
  holds the joint dispatch to eager steps);
- on the card (``cuda`` marker; skips here) the captured graph equals
  eager steps exactly in f32 with deterministic algorithms, counts the
  rasterizer's launches per replay and the warm-up's as they ran, and
  captures again after a state load and after a parameter's storage
  moved, walking the state once a capture and not once a dispatch.
"""

import copy
import os

import numpy as np
import pytest
import torch

from posetpu_torch.aug.color import sample_jitter_scales
from posetpu_torch.aug.keyed import STREAM_AUG, STREAM_JITTER, keyed_bits
from posetpu_torch.aug.pipeline import sample_aug_params_ps
from posetpu_torch.configs import apply_overrides, named_config
from posetpu_torch.data import make_synthetic_dataset
from posetpu_torch.models import hg
from posetpu_torch.train import cli
from posetpu_torch.train.loop import Experiment
from posetpu_torch.train.state import TrainState, lr_schedule, make_optimizer
from posetpu_torch.train.step import (
    WARMUP_STEPS,
    GraphedSteps,
    make_dispatch_step,
    make_train_step,
)
from posetpu_torch.utils.profiling import counter, reset_counters

FEATS, CLASSES, DEPTH, B = 8, 16, 2, 4
MEAN = (0.4404, 0.4440, 0.4327)
STEPS = [0, 1, 7, 12345, 2**31 + 7, 2**32 - 1]


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread for this module's CPU training: the suite runs
    several test processes at once, and torch's oversubscribed OpenMP pool
    made these small steps tens of times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = named_config("hg2_mpii_mini")
    cfg.model.feats = FEATS
    cfg.model.depth = DEPTH
    cfg.model.bf16 = False
    cfg.aug.inp_res = (64, 64)
    cfg.aug.out_res = (16, 16)
    # at 2 updates an epoch the lr drops at updates 2 and 4
    cfg.optim.schedule = (1, 2)
    return cfg


def _batch(seed, hw=(72, 96)):
    rng = np.random.RandomState(seed)
    H, W = hw
    valid_wh = np.stack([rng.randint(W - 20, W + 1, B), rng.randint(H - 10, H + 1, B)],
                        axis=1).astype(np.int32)
    center = (valid_wh / 2 + rng.uniform(-5, 5, (B, 2))).astype(np.float32)
    scale = (valid_wh[:, 1] / 200.0 * rng.uniform(0.8, 1.2, B)).astype(np.float32)
    return {
        "image": rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8),
        "valid_wh": valid_wh,
        "center": center,
        "scale": scale,
        "pts": (center[:, None, :] + rng.uniform(-30, 30, (B, CLASSES, 2))).astype(np.float32),
        "vis": (rng.rand(B, CLASSES) < 0.8).astype(np.float32),
        "index": rng.choice(10_000, B, replace=False).astype(np.int32),
    }


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


@pytest.mark.parametrize("step", STEPS)
def test_keyed_bits_and_samplers_take_a_device_step(step):
    index = torch.tensor([0, 3, 99, 2**31 - 1, 17], dtype=torch.int32)
    t = torch.tensor(step, dtype=torch.int64)
    for stream in (STREAM_AUG, STREAM_JITTER, 5):
        assert torch.equal(keyed_bits(11, t, index, stream, 6, first=2),
                           keyed_bits(11, step, index, stream, 6, first=2))
    for mode in ("exp", "linear"):
        a = sample_aug_params_ps(3, t, index, scale_mode=mode)
        b = sample_aug_params_ps(3, step, index, scale_mode=mode)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(sample_jitter_scales(3, t, index), sample_jitter_scales(3, step, index))


def test_device_schedule_equals_lr_schedule_and_optax():
    import optax

    cfg = _cfg().optim
    cfg.schedule, cfg.gamma, cfg.lr = (2, 5), 0.3, 2.5e-4
    sched = lr_schedule(cfg, 3)  # drops at updates 6 and 15
    ref = optax.piecewise_constant_schedule(cfg.lr, {6: 0.3, 15: 0.3})
    for count in range(20):
        dev = sched(torch.tensor(count, dtype=torch.int64))
        assert dev.dtype == torch.float32 and dev.dim() == 0
        host = sched(count)
        assert np.float32(host) == dev.numpy() == np.asarray(ref(count), np.float32), count
    assert sched(5) != sched(6) != sched(15)


def _model():
    return hg(num_stacks=1, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
              dtype=torch.float32)


def _snapshot(state):
    opt = state.optimizer
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: {k: v.clone() for k, v in opt.state[p].items()}
             for i, p in enumerate(state.model.parameters())},
            opt.count, state.step)


def test_cpu_dispatch_equals_eager_steps():
    """A full dispatch of K = 3 and a short one of 2, against 5 eager steps
    from the same weights, across both schedule drops."""
    cfg = _cfg()
    torch.manual_seed(0)
    base = _model()
    batches = [_batch(10 + i) for i in range(5)]
    runs = {}
    for how in ("eager", "dispatch"):
        model = copy.deepcopy(base)
        opt = make_optimizer(model.parameters(), cfg.optim, steps_per_epoch=2)
        state = TrainState(model, opt, step=4)
        opt.count = 1
        kw = dict(seed=7, device="cpu")
        if how == "eager":
            step = make_train_step(model, opt, cfg.aug, MEAN, **kw)
            ms = [step(state, b) for b in batches]
            metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        else:
            dispatch = make_dispatch_step(model, opt, cfg.aug, MEAN, steps=3, **kw)
            m1 = dispatch(state, _stack(batches[:3]))
            assert state.step == 7 and opt.count == 4
            assert m1["loss"].shape == (3,)
            m2 = dispatch(state, _stack(batches[3:]))
            metrics = {k: torch.cat([m1[k], m2[k]]) for k in m1}
        runs[how] = (_snapshot(state), metrics)
    (sd_e, mo_e, count_e, step_e), met_e = runs["eager"]
    (sd_d, mo_d, count_d, step_d), met_d = runs["dispatch"]
    assert (count_e, step_e) == (count_d, step_d) == (6, 9)
    for k in sd_e:
        assert torch.equal(sd_e[k], sd_d[k]), k
    for i in mo_e:
        for k in mo_e[i]:
            assert torch.equal(mo_e[i][k], mo_d[i][k]), (i, k)
    for k in met_e:
        assert torch.equal(met_e[k], met_d[k]), k


def test_train_state_snapshot_restores_in_place():
    """A snapshot after one step, two more steps, then ``restore_``: every
    parameter, buffer and moment equals the snapshot at the address it
    had, and the count and step are back."""
    cfg = _cfg()
    torch.manual_seed(0)
    model = _model()
    opt = make_optimizer(model.parameters(), cfg.optim, steps_per_epoch=2)
    state = TrainState(model, opt)
    n_params, n_buffers = len(list(model.parameters())), len(list(model.buffers()))
    assert len(state.tensors()) >= 2 * n_params + n_buffers  # the moments made now
    step = make_train_step(model, opt, cfg.aug, MEAN, seed=7, device="cpu")
    step(state, _batch(1))
    snap = state.snapshot()
    ptrs = [t.data_ptr() for t in state.tensors()]
    step(state, _batch(2))
    step(state, _batch(3))
    assert not all(torch.equal(t, v) for t, v in zip(state.tensors(), snap[0]))
    state.restore_(snap)
    assert [t.data_ptr() for t in state.tensors()] == ptrs
    for t, v in zip(state.tensors(), snap[0], strict=True):
        assert torch.equal(t, v)
    assert (opt.count, state.step) == (1, 1)


def test_dispatch_refuses_a_superbatch_longer_than_k():
    cfg = _cfg()
    model = _model()
    opt = make_optimizer(model.parameters(), cfg.optim)
    dispatch = make_dispatch_step(model, opt, cfg.aug, MEAN, steps=2, device="cpu")
    with pytest.raises(ValueError):
        dispatch(TrainState(model, opt), _stack([_batch(i) for i in range(3)]))
    with pytest.raises(ValueError):
        dispatch(TrainState(_model(), opt), _stack([_batch(0)]))
    with pytest.raises(ValueError):
        make_dispatch_step(model, opt, cfg.aug, MEAN, steps=0, device="cpu")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("dispatch_split")
    make_synthetic_dataset(str(root), num_train=20, num_val=5, res=(96, 80), seed=4,
                           head_rects=True)
    return ["--json", str(root / "annotations.json"), "--image-path", str(root / "images")]


def _exp_cfg(split, ckpt, *extra):
    argv = ["--config", "hg2_mpii_mini", "--checkpoint", ckpt, "--stacks", "1",
            "--features", "8", "--train-batch", "4", "--epochs", "2", *split, *extra]
    return apply_overrides(named_config("hg2_mpii_mini"), cli.build_parser().parse_args(argv))


def test_experiment_with_k3_writes_the_log_of_k1(split, tmp_path):
    """5 steps an epoch: one dispatch of 3 and a short one of 2."""
    logs = {}
    for k in (1, 3):
        ckpt = str(tmp_path / f"k{k}")
        exp = Experiment(_exp_cfg(split, ckpt, "--steps-per-dispatch", str(k)), device="cpu")
        assert exp.loader.group == k and exp.steps_per_epoch == 5
        assert isinstance(exp.train_step, GraphedSteps) and exp.train_step.steps == k
        exp.fit(progress=lambda s: None)
        exp.close()
        assert exp.state.step == exp.state.optimizer.count == 10
        logs[k] = open(os.path.join(ckpt, "hg2_mpii_mini", "log.txt")).read()
    assert logs[1] == logs[3] and logs[1].count("\n") == 3


def test_k_above_one_with_the_agent_trains(split, tmp_path):
    """The joint step at K = 2: 5 steps an epoch (two dispatches of 2 and a
    short one of 1), every count advanced, the agent's metrics finite."""
    cfg = _exp_cfg(split, str(tmp_path), "--steps-per-dispatch", "2", "--epochs", "1")
    cfg.agent.enabled = True
    exp = Experiment(cfg, device="cpu")
    assert exp.loader.group == 2 and isinstance(exp.train_step, GraphedSteps)
    out = exp.train_epoch(0)
    exp.close()
    st = exp.state
    assert out["steps"] == st.step == st.pose.step == st.pose.optimizer.count == 5
    assert st.agent.step == st.agent.optimizer.count == 5
    assert all(np.isfinite(out[k]) for k in ("loss", "agent_loss", "advantage", "entropy"))


@pytest.mark.cuda
def test_cuda_graph_equals_eager_steps_and_counts_replays():
    """f32, TF32 off, deterministic algorithms: four graphed dispatches of
    K = 2 equal 8 eager steps exactly; the rasterizer counts one launch a
    replayed step; a state load (``load_state_dict``) makes it capture
    again, and so does a parameter's storage moved (``p.data =``), and
    each next dispatch still equals eager steps; the state is walked once
    a capture (``graph.state_walks``), not once a dispatch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from posetpu_torch.aug import cuda_kernels

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    try:
        cfg = _cfg()
        torch.manual_seed(0)
        base = _model()
        batches = [_batch(30 + i) for i in range(8)]
        runs = {}
        for how in ("eager", "graph"):
            model = copy.deepcopy(base).cuda()
            opt = make_optimizer(model.parameters(), cfg.optim, steps_per_epoch=2)
            state = TrainState(model, opt)
            kw = dict(seed=7, device="cuda")
            if how == "eager":
                step = make_train_step(model, opt, cfg.aug, MEAN, **kw)
                ms = [step(state, b) for b in batches]
                metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
            else:
                dispatch = make_dispatch_step(model, opt, cfg.aug, MEAN, steps=2, **kw)
                reset_counters(cuda_kernels.RASTERIZE_LAUNCHES, "graph.state_walks")
                parts = [dispatch(state, _stack(batches[i:i + 2])) for i in (0, 2)]
                torch.cuda.synchronize()
                # 4 replayed steps and the warm-up before the one capture
                assert counter(cuda_kernels.RASTERIZE_LAUNCHES) == 4 + WARMUP_STEPS
                assert dispatch.captures == 1
                sd = copy.deepcopy(opt.state_dict())
                opt.load_state_dict(sd)  # new moment tensors: a new capture
                parts.append(dispatch(state, _stack(batches[4:6])))
                assert dispatch.captures == 2
                w = next(model.parameters())
                w.data = w.data.clone()  # new storage: a new capture
                parts.append(dispatch(state, _stack(batches[6:8])))
                assert dispatch.captures == 3
                assert counter("graph.state_walks") == dispatch.captures  # of 4 dispatches
                metrics = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
            torch.cuda.synchronize()
            runs[how] = (_snapshot(state), {k: v.cpu() for k, v in metrics.items()})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev[:2]
        torch.use_deterministic_algorithms(prev[2])
    (sd_e, mo_e, count_e, step_e), met_e = runs["eager"]
    (sd_g, mo_g, count_g, step_g), met_g = runs["graph"]
    assert (count_e, step_e) == (count_g, step_g) == (8, 8)
    for k in sd_e:
        assert torch.equal(sd_e[k], sd_g[k]), k
    for i in mo_e:
        for k in mo_e[i]:
            assert torch.equal(mo_e[i][k], mo_g[i][k]), (i, k)
    for k in met_e:
        assert torch.equal(met_e[k], met_g[k]), k
