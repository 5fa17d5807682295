"""posetpu_torch's epoch driver and training CLI on the CPU, at the size
tests/test_integration.py runs the JAX package's (hg2_mpii_mini cut to
``--stacks 1 --features 8 --train-batch 4``): a run trains, validates,
checkpoints and logs; a resumed run restores parameters, statistics,
RMSprop moments, the update count and the step exactly, appends to the log
and starts at the next epoch; ``init_pose_from`` takes the pose weights
only; the joint driver runs an epoch; ``current_lr`` and the ``pad_hw``
auto-sizing equal the reference's; a run with the dispatch options
(``--loader-backend grain --loader-workers 2 --steps-per-dispatch 2
--tensorboard --profile``) writes the log rows and final weights of a run
without them, its TensorBoard scalars equal the log's columns, and its
trace directory holds a trace.  All equalities here are exact."""

import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from posetpu.configs import named_config as ref_named_config
from posetpu.train.loop import Experiment as RefExperiment
from posetpu_torch.ckpt import CheckpointManager
from posetpu_torch.configs import named_config
from posetpu_torch.data import MpiiDataset, make_synthetic_dataset
from posetpu_torch.train import cli
from posetpu_torch.train.loop import Experiment

SMALL = ["--stacks", "1", "--features", "8", "--train-batch", "4"]


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread for this module's CPU training: the suite runs
    several test processes at once, and torch's oversubscribed OpenMP pool
    made these small steps tens of times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("exp_split")
    make_synthetic_dataset(str(root), num_train=8, num_val=6, res=(96, 80), seed=1,
                           head_rects=True)
    return ["--json", str(root / "annotations.json"), "--image-path", str(root / "images")]


@pytest.fixture(scope="module")
def trained(split, tmp_path_factory):
    """A 2-epoch CPU run through the CLI."""
    ckpt = str(tmp_path_factory.mktemp("exp_run"))
    argv = ["--config", "hg2_mpii_mini", "--cpu", "--epochs", "2", "--checkpoint", ckpt,
            *split, *SMALL]
    assert cli.main(argv) == 0
    return ckpt, argv


def _run_dir(ckpt):
    return os.path.join(ckpt, "hg2_mpii_mini")


def _cfg(split, ckpt, **over):
    args = cli.build_parser().parse_args(
        ["--config", "hg2_mpii_mini", "--checkpoint", ckpt, *split, *SMALL])
    from posetpu_torch.configs import apply_overrides

    cfg = apply_overrides(named_config("hg2_mpii_mini"), args)
    for k, v in over.items():
        head, _, leaf = k.partition(".")
        setattr(getattr(cfg, head), leaf, v) if leaf else setattr(cfg, head, v)
    return cfg


def test_cli_run_writes_log_checkpoints_config_and_preds(trained):
    ckpt, _ = trained
    d = _run_dir(ckpt)
    lines = open(os.path.join(d, "log.txt")).read().splitlines()
    assert lines[0] == "Epoch\tLR\tTrain Loss\tVal Loss\tTrain Acc\tVal Acc"
    rows = [ln.split("\t") for ln in lines[1:]]
    assert [r[0] for r in rows] == ["0", "1"] and all(r[1] == "0.000250" for r in rows)
    assert all(np.isfinite(float(x)) for r in rows for x in r)
    assert sorted(os.listdir(os.path.join(d, "ckpt"))) == ["00000", "00001"]
    cfg = json.load(open(os.path.join(d, "config.json")))
    assert cfg["batch_size"] == 4 and cfg["model"]["stacks"] == 1
    assert cfg["pad_hw"] == [256, 256]  # auto-sized: the 96x80 images, rounded up
    best = CheckpointManager(d).load(os.path.join(d, "best"))
    accs = [float(r[5]) for r in rows]
    assert best["best_acc"] == pytest.approx(max(accs), abs=1e-6)
    assert os.path.exists(os.path.join(d, "preds.mat"))
    last = CheckpointManager(d).load()
    assert last["epoch"] == 1 and last["state"]["count"] == last["state"]["step"] == 4


def test_resume_restores_exactly_appends_and_continues(split, trained, tmp_path):
    src, _ = trained
    ckpt = str(tmp_path)
    shutil.copytree(_run_dir(src), _run_dir(ckpt))
    saved = CheckpointManager(_run_dir(ckpt)).load()["state"]
    exp = Experiment(_cfg(split, ckpt, resume="auto", **{"optim.epochs": 3,
                                                          "optim.schedule": (2,)}),
                     device="cpu")
    assert exp.start_epoch == 2
    st = exp.state
    assert st.step == saved["step"] == 4 and st.optimizer.count == saved["count"] == 4
    for k, v in st.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    opt = st.optimizer.state_dict()
    assert opt["state"].keys() == saved["optimizer"]["state"].keys()
    for i, s in saved["optimizer"]["state"].items():
        assert torch.equal(opt["state"][i]["nu"], s["nu"])
    # the schedule resumes at update 4, past its drop at epoch 2 (update
    # 4), not at update 0
    want = float(np.float32(np.float32(2.5e-4) * np.float32(0.1)))
    assert st.optimizer.schedule(st.optimizer.count) == pytest.approx(want, rel=1e-6)
    assert exp.current_lr(2) == pytest.approx(2.5e-5)
    log_before = open(os.path.join(_run_dir(ckpt), "log.txt")).read()
    exp.fit(progress=lambda s: None)
    exp.close()
    log_after = open(os.path.join(_run_dir(ckpt), "log.txt")).read()
    assert log_after.startswith(log_before) and log_after.count("\n") == 4
    last = CheckpointManager(_run_dir(ckpt)).load()
    assert last["epoch"] == 2 and last["state"]["count"] == last["state"]["step"] == 6


def test_init_pose_from_takes_the_pose_weights_only(split, trained, tmp_path):
    src, _ = trained
    exp = Experiment(_cfg(split, str(tmp_path), init_pose_from=_run_dir(src)), device="cpu")
    want = CheckpointManager(_run_dir(src)).load(os.path.join(_run_dir(src), "best"))
    for k, v in exp.model.state_dict().items():
        assert torch.equal(v, want["state"]["model"][k]), k
    assert exp.state.optimizer.count == 0 and exp.state.step == 0
    assert not exp.state.optimizer.state
    assert exp.start_epoch == 0
    exp.close()


def _ref_and_port(ref_cfg, cfg, ds_ref, ds):
    ref = object.__new__(RefExperiment)
    ref.cfg, ref.train_ds = ref_cfg, ds_ref
    port = object.__new__(Experiment)
    port.cfg, port.train_ds = cfg, ds
    return ref, port


@pytest.mark.parametrize("pad_hw,rot_prob,scale_mode", [
    (None, 0.6, "exp"), (None, 0.0, "linear"), ((64, 64), 0.6, "exp"), ((1024, 1024), 0.6, "exp"),
])
def test_current_lr_and_pad_hw_match_reference(split, tmp_path, pad_hw, rot_prob,
                                               scale_mode):
    ann, imgs = split[1], split[3]
    root = tmp_path / "copy"
    shutil.copytree(os.path.dirname(ann), root)
    from posetpu.data import MpiiDataset as RefMpii

    cfg, ref_cfg = named_config("hg2_mpii_mini"), ref_named_config("hg2_mpii_mini")
    for c in (cfg, ref_cfg):
        c.pad_hw = pad_hw
        c.aug.rot_prob = rot_prob
        c.aug.scale_mode = scale_mode
        c.optim.schedule = (2, 4)
    ref, port = _ref_and_port(ref_cfg, cfg, RefMpii(ann, imgs),
                              MpiiDataset(str(root / "annotations.json"),
                                          str(root / "images")))
    assert port._worst_case_box() == ref._worst_case_box()
    with warnings.catch_warnings(record=True) as w_port:
        warnings.simplefilter("always")
        port._check_pad_hw()
    with warnings.catch_warnings(record=True) as w_ref:
        warnings.simplefilter("always")
        ref._check_pad_hw()
    assert tuple(cfg.pad_hw) == tuple(ref_cfg.pad_hw)
    assert len(w_port) == len(w_ref) == (1 if pad_hw == (64, 64) else 0)
    assert [port.current_lr(e) for e in range(6)] == [ref.current_lr(e) for e in range(6)]


def test_joint_driver_runs_an_epoch_and_resumes(split, tmp_path):
    ckpt = str(tmp_path)
    argv = ["--config", "hg8_mpii_asr", "--cpu", "--epochs", "1", "--checkpoint", ckpt,
            *split, *SMALL]
    assert cli.main(argv) == 0
    d = os.path.join(ckpt, "hg8_mpii_asr")
    assert len(open(os.path.join(d, "log.txt")).read().splitlines()) == 2
    st = CheckpointManager(d).load()["state"]
    assert st["step"] == st["pose"]["step"] == st["pose"]["count"] == 2
    assert st["agent"]["step"] == st["agent"]["count"] == 2
    args = cli.build_parser().parse_args(argv + ["--resume", "auto", "--epochs", "2"])
    from posetpu_torch.configs import apply_overrides

    exp = Experiment(apply_overrides(named_config("hg8_mpii_asr"), args), device="cpu")
    assert exp.start_epoch == 1 and exp.state.step == 2
    assert exp.state.agent.optimizer.count == 2 and exp.state.agent.step == 2
    for k, v in exp.state.agent.model.state_dict().items():
        assert torch.equal(v, st["agent"]["model"][k]), k
    exp.close()


def test_fresh_weights_come_from_the_seed(split, tmp_path):
    """The pose network draws from a generator seeded with cfg.seed, the
    agent from cfg.seed + 1, whatever the global RNG's state."""
    def weights(seed, global_seed):
        torch.manual_seed(global_seed)
        cfg = _cfg(split, str(tmp_path), seed=seed)
        cfg.agent.enabled = True
        exp = Experiment(cfg, device="cpu")
        exp.close()
        return exp.model.state_dict(), exp.state.agent.model.state_dict()

    a, b, c = weights(0, 1), weights(0, 2), weights(1, 1)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k
    assert not torch.equal(a[0]["stem.0.weight"], c[0]["stem.0.weight"])
    assert not torch.equal(a[1]["conv0.weight"], c[1]["conv0.weight"])


def test_unknown_and_left_out_flags_are_rejected():
    for flag in ("--agent-step", "--raster-backend", "--warp-table", "--no-probe",
                 "--cpu-devices"):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args([flag, "1"])
    args = cli.build_parser().parse_args(["--schedule", "3", "5", "--no-color-jitter",
                                          "--occ-mode", "parts", "--lr", "0.1",
                                          "--num-devices", "2", "--blocks", "2",
                                          "--scan-stacks"])
    from posetpu_torch.configs import apply_overrides

    cfg = apply_overrides(named_config("hg8_lsp_aho"), args)
    assert cfg.optim.schedule == (3, 5) and not cfg.aug.color_jitter
    assert cfg.agent.occ_mode == "parts" and cfg.optim.lr == 0.1
    assert cfg.num_devices == 2
    assert cfg.model.blocks == 2 and cfg.model.scan_stacks and not cfg.model.remat
    plain = apply_overrides(named_config("hg8_mpii"), cli.build_parser().parse_args([]))
    assert plain.model.blocks == 1 and not plain.model.scan_stacks
    mini = named_config("hg2_mpii_mini")
    assert mini.synthetic and mini.optim.epochs == 10 and mini.batch_size == 6


def test_synthetic_split_is_made_once_and_keyed_by_seed(tmp_path, monkeypatch):
    from posetpu_torch.train.loop import build_dataset

    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    cfg = named_config("hg2_mpii_mini")
    cfg.seed = 11
    ds = build_dataset(cfg, "valid")
    assert cfg.annotations == str(tmp_path / "posetpu_torch_synth_mpii_s11" / "annotations.json")
    assert len(ds) == 16 and len(build_dataset(cfg, "train")) == 64
    assert isinstance(ds, MpiiDataset)
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


DISPATCH_FLAGS = ["--loader-backend", "grain", "--loader-workers", "2",
                  "--steps-per-dispatch", "2", "--tensorboard", "--profile"]


@pytest.fixture(scope="module")
def dispatched(split, trained, tmp_path_factory):
    """The ``trained`` run again with every dispatch option."""
    ckpt = str(tmp_path_factory.mktemp("exp_dispatch"))
    _, argv = trained
    argv = [a for a in argv]
    argv[argv.index("--checkpoint") + 1] = ckpt
    assert cli.main(argv + DISPATCH_FLAGS) == 0
    return ckpt


def test_dispatch_options_keep_the_log_and_the_weights(trained, dispatched):
    src, _ = trained
    want = open(os.path.join(_run_dir(src), "log.txt")).read()
    assert open(os.path.join(_run_dir(dispatched), "log.txt")).read() == want
    a = CheckpointManager(_run_dir(src)).load()["state"]
    b = CheckpointManager(_run_dir(dispatched)).load()["state"]
    assert a["count"] == b["count"] == a["step"] == b["step"] == 4
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        assert torch.equal(st["nu"], b["optimizer"]["state"][i]["nu"]), i
    trace = os.path.join(_run_dir(dispatched), "trace")
    assert [n for n in os.listdir(trace) if n.endswith(".json")]
    cfg = json.load(open(os.path.join(_run_dir(dispatched), "config.json")))
    assert (cfg["loader_backend"], cfg["loader_workers"], cfg["steps_per_dispatch"],
            cfg["tensorboard"]) == ("grain", 2, 2, True)


def test_tensorboard_scalars_equal_the_log_columns(dispatched):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(os.path.join(_run_dir(dispatched), "tb"))
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert tags == {"train/loss", "train/acc", "train/images_per_sec", "lr",
                    "val/loss", "val/acc"}
    rows = [ln.split("\t") for ln in
            open(os.path.join(_run_dir(dispatched), "log.txt")).read().splitlines()[1:]]
    cols = {"lr": 1, "train/loss": 2, "val/loss": 3, "train/acc": 4, "val/acc": 5}
    for tag, col in cols.items():
        events = acc.Scalars(tag)
        assert [e.step for e in events] == [0, 1], tag
        # the log prints %.6f; the event holds the value as float32
        assert [f"{e.value:.6f}" for e in events] == [r[col] for r in rows], tag
    assert all(e.value > 0 for e in acc.Scalars("train/images_per_sec"))


def test_new_flags_land_in_the_config_and_a_bad_backend_raises(split, tmp_path):
    from posetpu_torch.configs import apply_overrides

    args = cli.build_parser().parse_args(["--loader-backend", "grain", "--loader-workers",
                                          "7", "--steps-per-dispatch", "4", "--tensorboard",
                                          "--profile"])
    cfg = apply_overrides(named_config("hg8_mpii"), args)
    assert (cfg.loader_backend, cfg.loader_workers, cfg.steps_per_dispatch,
            cfg.tensorboard) == ("grain", 7, 4, True)
    assert args.profile
    plain = named_config("hg8_mpii")
    assert (plain.loader_backend, plain.loader_workers, plain.steps_per_dispatch,
            plain.tensorboard) == ("host", 0, 1, False)
    with pytest.raises(ValueError, match="loader_backend"):
        Experiment(_cfg(split, str(tmp_path), loader_backend="native"), device="cpu")
