"""Checkpoints across the two packages, and the run-directory serving of
``PosePredictor.from_config``.

- JAX -> port: the JAX package's ``save_torch_checkpoint`` writes the
  unrolled, ``num_blocks=2`` and scanned hg2 (feats 8, depth 2) with its
  optax state, with and without ``add_decayed_weights`` (and momentum's
  trace with it); the port's reader loads it.  The forward matches flax's
  (atol 2e-4, rtol 1e-3, tests/test_torch_hourglass.py) and the moments and
  count that ``OptaxRMSprop.load_carried`` takes equal optax's exactly.
- port -> JAX: the port's writer writes a state the port trained; the JAX
  package's ``load_torch_checkpoint`` reads it into flax templates.  flax's
  forward matches the port's and every optimizer leaf equals the port's.
- ``from_config`` picks ``best/`` or the latest ``ckpt/<epoch>`` by the
  reference's rules (``posetpu/infer.py``), serves the pose network of a
  joint run directory, and still takes a state dict.
- The train and eval command lines run a ``--blocks 2 --scan-stacks``
  network, and ``from_config`` serves its run directory.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from posetpu_torch.ckpt import CheckpointManager, from_optax_state
from posetpu_torch.ckpt.torch_export import (
    load_reference_checkpoint,
    restore_reference_checkpoint,
    save_reference_checkpoint,
)
from posetpu_torch.configs import named_config
from posetpu_torch.eval import cli as eval_cli
from posetpu_torch.infer import PosePredictor
from posetpu_torch.models import hg
from posetpu_torch.train import cli as train_cli
from posetpu_torch.train.adversarial import JointState
from posetpu_torch.train.state import TrainState, make_optimizer
from posetpu_torch.train.step import make_train_step
from test_torch_variants import CLASSES, DEPTH, FEATS, MEAN, STACKS, _batch, _flax, _port

LAYOUTS = {"unrolled": (1, False), "blocks2": (2, False), "scan": (1, True)}
# (weight_decay, momentum) of the optimizer chain
CHAINS = {"rmsprop": (0.0, 0.0), "decay_momentum": (1e-4, 0.9)}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread (tests/test_torch_experiment.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(layout, chain="rmsprop"):
    blocks, scan = LAYOUTS[layout]
    cfg = named_config("hg2_mpii_mini")
    cfg.model.stacks, cfg.model.feats, cfg.model.depth = STACKS, FEATS, DEPTH
    cfg.model.classes, cfg.model.bf16 = CLASSES, False
    cfg.model.blocks, cfg.model.scan_stacks = blocks, scan
    cfg.aug.inp_res, cfg.aug.out_res = (64, 64), (16, 16)
    cfg.optim.weight_decay, cfg.optim.momentum = CHAINS[chain]
    return cfg


def _ref_optimizer(chain):
    from posetpu.configs.config import OptimConfig as RefOptimConfig
    from posetpu.train.state import make_optimizer as ref_make_optimizer

    wd, mom = CHAINS[chain]
    return ref_make_optimizer(RefOptimConfig(weight_decay=wd, momentum=mom))


def _heatmaps_match(model, ref, variables, x):
    import jax.numpy as jnp

    want = ref.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2),
                                   atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_jax_container_loads_into_the_port(layout, chain, tmp_path):
    import jax
    import jax.numpy as jnp

    from posetpu.ckpt.torch_export import save_torch_checkpoint

    blocks, scan = LAYOUTS[layout]
    ref, v, x = _flax(blocks, scan, seed=7)
    tx = _ref_optimizer(chain)
    rng = np.random.RandomState(8)
    grads = jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape), jnp.float32), v["params"])
    opt_state = tx.init(v["params"])
    update = jax.jit(tx.update)
    for _ in range(3):
        _, opt_state = update(grads, opt_state, v["params"])
    path = str(tmp_path / "checkpoint.pth.tar")
    save_torch_checkpoint(path, v["params"], v["batch_stats"], epoch=4, best_acc=0.25,
                          opt_state=opt_state)

    cfg = _cfg(layout, chain)
    model = _port(blocks, scan)
    opt = make_optimizer(model.parameters(), cfg.optim)
    state = TrainState(model, opt)
    assert restore_reference_checkpoint(state, path, cfg=cfg) == (4, 0.25)
    _heatmaps_match(model, ref, v, x)
    assert opt.count == state.step == 3
    want = from_optax_state(opt_state, num_stacks=STACKS, depth=DEPTH, num_blocks=blocks,
                            scan_stacks=scan)
    for name, p in model.named_parameters():
        assert torch.equal(opt.state[p]["nu"], want["nu"][name]), name
        if CHAINS[chain][1]:
            assert torch.equal(opt.state[p]["trace"], want["trace"][name]), name
        else:
            assert "trace" not in opt.state[p]
    tracked = [b for n, b in model.named_buffers() if n.endswith("num_batches_tracked")]
    assert tracked and all(int(b) == 3 for b in tracked)
    # without an optimizer state: the weights alone
    save_torch_checkpoint(path, v["params"], v["batch_stats"])
    sd, carried, epoch, best = load_reference_checkpoint(
        path, num_stacks=STACKS, num_blocks=blocks, depth=DEPTH, scan_stacks=scan)
    assert carried is None and (epoch, best) == (0, 0.0)
    assert not [k for k in sd if k.endswith("num_batches_tracked")]


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_port_container_loads_into_the_jax_package(layout, chain, tmp_path):
    import jax

    from posetpu.ckpt.torch_export import load_torch_checkpoint

    blocks, scan = LAYOUTS[layout]
    ref, v, x = _flax(blocks, scan, seed=9)
    cfg = _cfg(layout, chain)
    model = _port(blocks, scan, v, remat=scan)
    opt = make_optimizer(model.parameters(), cfg.optim, steps_per_epoch=1)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, cfg.aug, MEAN, device="cpu")
    for t in range(2):  # moments and statistics of the port's own making
        step(state, _batch(900 + t))
    path = str(tmp_path / "checkpoint.pth.tar")
    save_reference_checkpoint(path, state, 1, 0.5, cfg=cfg)

    tx = _ref_optimizer(chain)
    params, stats, epoch, best, opt_state = load_torch_checkpoint(
        path, v["params"], v["batch_stats"], tx.init(v["params"]))
    assert (epoch, best) == (1, 0.5)
    _heatmaps_match(model, ref, {"params": params, "batch_stats": stats}, x)
    carried = from_optax_state(opt_state, num_stacks=STACKS, depth=DEPTH,
                               num_blocks=blocks, scan_stacks=scan)
    assert carried["count"] == opt.count == 2
    for name, p in model.named_parameters():
        assert torch.equal(carried["nu"][name], opt.state[p]["nu"]), name
        if CHAINS[chain][1]:
            assert torch.equal(carried["trace"][name], opt.state[p]["trace"]), name
    assert len(jax.tree.leaves(opt_state)) == len(jax.tree.leaves(tx.init(v["params"])))
    # and back: the port reads its own container bit for bit
    fresh = _port(blocks, scan)
    again = TrainState(fresh, make_optimizer(fresh.parameters(), cfg.optim))
    restore_reference_checkpoint(again, path, cfg=cfg)
    for (n, a), b in zip(model.state_dict().items(), again.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert again.optimizer.count == again.step == 2


def _small_cfg(ckpt):
    cfg = _cfg("unrolled")
    cfg.checkpoint_dir = ckpt
    return cfg


def _state(cfg, marker, joint=False):
    """A train state (or a joint one) whose pose weights carry ``marker``
    in the first conv's bias."""
    model = hg(num_stacks=STACKS, num_classes=CLASSES, num_feats=FEATS, depth=DEPTH,
               dtype=torch.float32)
    with torch.no_grad():
        model.stem[0].bias.fill_(float(marker))
    ts = TrainState(model, make_optimizer(model.parameters(), cfg.optim))
    if not joint:
        return ts
    agent = torch.nn.Linear(2, 2)
    return JointState(ts, TrainState(agent, make_optimizer(agent.parameters(), cfg.optim)))


def _served_marker(cfg, path, **kw):
    p = PosePredictor.from_config(cfg, path, device="cpu", **kw)
    return p.model.stem[0].bias.detach()[0].item()


# (layout of the run directory, best=, the checkpoint served): the rules of
# posetpu/infer.py:125-138
FROM_CONFIG_CASES = {
    "best_wanted_and_present": ({"best", "ckpt"}, True, "best"),
    "latest_wanted": ({"best", "ckpt"}, False, "latest"),
    "best_when_the_only_layout": ({"best"}, False, "best"),
    "latest_when_no_best": ({"ckpt"}, True, "latest"),
    "a_checkpoint_directory": (set(), True, "direct"),
}


@pytest.mark.parametrize("case", sorted(FROM_CONFIG_CASES))
def test_from_config_picks_as_the_reference(case, tmp_path):
    layout, best, want = FROM_CONFIG_CASES[case]
    cfg = _small_cfg(str(tmp_path))
    run = str(tmp_path / "run")
    mgr = CheckpointManager(run)
    if "ckpt" in layout:
        mgr.save(_state(cfg, 1.0), 0, 0.1)
        mgr.save(_state(cfg, 2.0), 1, 0.1)  # the latest
    if "best" in layout:
        mgr.save(_state(cfg, 3.0), 2, 0.9, is_best=True)
        # best/ alone, or best/ beside a ckpt/ whose latest is epoch 1
        shutil.rmtree(os.path.join(run, "ckpt", "" if "ckpt" not in layout else "00002"))
    if want == "direct":
        mgr.save(_state(cfg, 4.0), 7, 0.1)
        path = os.path.join(run, "ckpt", "00007")
    else:
        path = run
    marker = {"best": 3.0, "latest": 2.0, "direct": 4.0}[want]
    assert _served_marker(cfg, path, best=best) == marker


def test_from_config_refuses_what_holds_no_checkpoint(tmp_path):
    cfg = _small_cfg(str(tmp_path))
    run = tmp_path / "run"
    with pytest.raises(FileNotFoundError):
        PosePredictor.from_config(cfg, str(run), device="cpu")
    (run / "ckpt").mkdir(parents=True)
    with pytest.raises(FileNotFoundError):
        PosePredictor.from_config(cfg, str(run), device="cpu")
    assert not os.path.exists(run / "best")


def test_from_config_serves_the_pose_half_of_a_joint_run(tmp_path):
    cfg = _small_cfg(str(tmp_path))
    run = str(tmp_path / "joint")
    CheckpointManager(run).save(_state(cfg, 5.0, joint=True), 0, 0.3, is_best=True)
    assert _served_marker(cfg, run) == 5.0
    assert _served_marker(cfg, run, best=False) == 5.0


def test_from_config_still_takes_a_state_dict():
    cfg = _small_cfg("unused")
    sd = _state(cfg, 6.0).model.state_dict()
    p = PosePredictor.from_config(cfg, sd, device="cpu")
    for k, v in p.model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_cli_round_trip_with_blocks_and_scan(tmp_path):
    """``--blocks 2 --scan-stacks`` through the train command line, then
    the eval command line with the same flags (and ``--best`` where a
    validation improved), and ``from_config`` on the run directory: its
    network is the scanned two-block one, with the run's weights."""
    ckpt = str(tmp_path)
    flags = ["--config", "hg2_mpii_mini", "--blocks", "2", "--scan-stacks", "--stacks", "1",
             "--features", "8", "--cpu", "--synthetic", "--train-batch", "4",
             "--steps-per-epoch", "2", "--checkpoint", ckpt]
    assert train_cli.main(flags + ["--epochs", "1"]) == 0
    run = os.path.join(ckpt, "hg2_mpii_mini")
    best = os.path.isdir(os.path.join(run, "best"))
    pck = eval_cli.main(flags + (["--best"] if best else []))
    assert 0.0 <= pck <= 100.0
    saved = CheckpointManager(run).load()["state"]
    assert saved["count"] == saved["step"] == 2
    assert "fc_.0.weight" in saved["model"] and "res.0.1.conv3.weight" in saved["model"]
    cfg = named_config("hg2_mpii_mini")
    cfg.model.stacks, cfg.model.feats, cfg.model.blocks = 1, 8, 2
    cfg.model.scan_stacks = True
    p = PosePredictor.from_config(cfg, run, best=False, device="cpu")
    assert p.model.scan_stacks and len(p.model.fc_) == 1
    for k, v in p.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
