"""posetpu_torch's validation pass, evaluation CLI, protocols, log and
checkpoint files against the JAX package's, on the CPU.

- ``Experiment.validate`` against the reference's ``Experiment.validate``:
  both read the same files through ``annotations``/``images_dir`` on the
  Pillow route, the port on weights carried with ``from_flax_variables``,
  f32 on both sides, hourglass depth 2, 64x64 crops.  Loss and acc within the eval tolerance PR 1 derived
  for the f32 eval step (atol 2e-4, rtol 1e-3), the split's PCK hit and
  count sums equal, predictions within the same tolerance (in pixels).
- The eval CLI prints PCKh@0.5 and writes a ``preds.mat`` that the
  reference's ``load_preds`` reads.
- ``pckh``, ``pck_lsp``, ``head_sizes`` and ``head_sizes_from_pts`` equal
  the reference's exactly (the same float64 numpy).
- ``log.txt`` is byte-equal to the reference ``Logger``'s for the same rows,
  on resume too; checkpoints keep the ``ckpt/``/``best/`` layout and the
  newest 3.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posetpu_torch.native
from posetpu.configs import named_config as ref_named_config
from posetpu.data import HostLoader as RefLoader
from posetpu.data import MpiiDataset as RefMpii
from posetpu.eval.cli import head_sizes as ref_head_sizes
from posetpu.eval.cli import head_sizes_from_pts as ref_head_sizes_from_pts
from posetpu.eval.export import load_preds as ref_load_preds
from posetpu.eval.pck import pck_lsp as ref_pck_lsp
from posetpu.eval.pck import pckh as ref_pckh
from posetpu.models import hg as ref_hg
from posetpu.train.loop import Experiment as RefExperiment
from posetpu.train.state import TrainState as RefTrainState
from posetpu.train.step import make_eval_step as ref_make_eval_step
from posetpu.utils.logger import Logger as RefLogger
from posetpu_torch.ckpt import CheckpointManager, from_flax_variables
from posetpu_torch.configs import named_config
from posetpu_torch.data import MpiiDataset, make_synthetic_dataset
from posetpu_torch.eval import cli as eval_cli
from posetpu_torch.eval import load_preds, pck_lsp, pckh, save_preds
from posetpu_torch.train.loop import Experiment
from posetpu_torch.train.state import TrainState, make_optimizer
from posetpu_torch.utils.logger import Logger

ATOL, RTOL = 2e-4, 1e-3  # the f32 eval step's tolerance (tests/test_torch_slice.py)
SMALL = ["--stacks", "1", "--features", "8", "--train-batch", "4"]


def _no_native(*a, **k):
    raise RuntimeError("the Pillow route only, in these parity tests")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_split")
    make_synthetic_dataset(str(root), num_train=4, num_val=7, res=(96, 80), seed=9,
                           head_rects=True)
    return str(root / "annotations.json"), str(root / "images")


def _configs(split, ckpt):
    ann, imgs = split
    out = []
    for c, name in ((named_config("hg2_mpii_mini"), "port"),
                    (ref_named_config("hg2_mpii_mini"), "ref")):
        c.model.stacks, c.model.feats, c.model.bf16 = 1, 8, False
        c.model.depth = 2
        c.aug.inp_res, c.aug.out_res = (64, 64), (16, 16)
        c.batch_size = 4
        c.annotations, c.images_dir = ann, imgs
        c.checkpoint_dir = os.path.join(ckpt, name)
        out.append(c)
    out[1].num_devices = 1
    return out


def test_validate_matches_reference_on_carried_weights(split, tmp_path, monkeypatch):
    """The reference's ``Experiment.validate`` runs on an instance given just
    what it reads (config, validation loader on the Pillow route, jitted eval
    step, state): its __init__ would spend 16 s in flax's eager init."""
    monkeypatch.setattr(posetpu_torch.native, "NativeDecoder", _no_native)
    cfg, ref_cfg = _configs(split, str(tmp_path))
    exp = Experiment(cfg, device="cpu")
    assert exp.val_loader.backend == "pil"

    ref_cfg.pad_hw = cfg.pad_hw
    model = ref_hg(num_stacks=1, num_classes=16, num_feats=8, depth=2,
                   dtype=jnp.float32)
    v = jax.jit(lambda k: model.init(k, jnp.zeros((1, 64, 64, 3)), train=False))(
        jax.random.PRNGKey(3))
    rng = np.random.RandomState(0)
    v = jax.tree.map(lambda a: a + 0.05 * jnp.asarray(rng.randn(*a.shape), a.dtype), v)
    v["batch_stats"] = jax.tree.map(jnp.abs, v["batch_stats"])
    ref = object.__new__(RefExperiment)
    ref.cfg = ref_cfg
    ref.val_ds = RefMpii(*split, split="valid")
    ref.val_loader = RefLoader(ref.val_ds, ref_cfg.batch_size, pad_hw=tuple(cfg.pad_hw),
                               shuffle=False, drop_last=False, backend="pil")
    ref.state = RefTrainState(params=v["params"], batch_stats=v["batch_stats"],
                              opt_state=None, step=jnp.zeros((), jnp.int32))
    mean = RefMpii(*split, split="train").mean_std()[0]
    np.testing.assert_array_equal(mean, exp.mean)
    step = jax.jit(ref_make_eval_step(model, ref_cfg.aug, mean, None))
    counts = []

    def recording(state, batch):
        m, p = step(state, batch)
        counts.append((np.asarray(m["pck_hit"]), np.asarray(m["pck_cnt"])))
        return m, p

    ref.eval_step = recording
    want, want_preds = ref.validate(0)

    exp.model.load_state_dict(from_flax_variables(
        v["params"], v["batch_stats"], num_stacks=1, depth=2))
    got, preds = exp.validate(0)
    exp.close()
    assert len(counts) == 2  # 7 images at batch 4: one full, one padded batch
    np.testing.assert_array_equal(got["pck_hit"], sum(h for h, _ in counts))
    np.testing.assert_array_equal(got["pck_cnt"], sum(c for _, c in counts))
    assert got["pck_cnt"].sum() > 0
    for k in ("loss", "acc"):
        assert got[k] == pytest.approx(want[k], abs=ATOL, rel=RTOL), k
    assert preds.shape == want_preds.shape == (7, 16, 2)
    np.testing.assert_allclose(preds, want_preds, atol=ATOL, rtol=RTOL)


def test_eval_cli_best_prints_pckh_and_writes_preds_the_reference_reads(split, tmp_path,
                                                                       capsys):
    ann, imgs = split
    common = ["--config", "hg2_mpii_mini", "--cpu", "--json", ann, "--image-path", imgs,
              "--checkpoint", str(tmp_path), *SMALL]
    from posetpu_torch.train import cli

    assert cli.main(common + ["--epochs", "1"]) == 0
    d = tmp_path / "hg2_mpii_mini"
    mgr = CheckpointManager(str(d))
    if not os.path.isdir(mgr.best_path):  # no validation improved on 0.0
        shutil.copytree(mgr.latest_path(), mgr.best_path)
    if (d / "preds.mat").exists():
        os.remove(d / "preds.mat")
    capsys.readouterr()
    pck = eval_cli.main(common + ["--best"])
    out = capsys.readouterr().out
    assert "PCKh@0.5" in out and "restored epoch 0" in out
    assert "keypoint-approximated" not in out  # every sample has a head box
    assert np.isfinite(pck) and 0.0 <= pck <= 100.0
    preds = ref_load_preds(str(d / "preds.mat"))
    assert preds.shape == (7, 16, 2) and np.isfinite(preds).all()
    np.testing.assert_array_equal(load_preds(str(d / "preds.mat")), preds)
    assert eval_cli.entry(common) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_pck_protocols_and_head_sizes_equal_reference(split, seed):
    rng = np.random.RandomState(seed)
    for K in (16, 14):
        gts = rng.uniform(0, 200, (9, K, 2))
        preds = gts + rng.normal(0, 8, gts.shape)
        vis = (rng.rand(9, K) < 0.8).astype(np.float64)
        vis[:, 3] = 0  # a joint with no visible sample: nan per joint
        heads = rng.uniform(10, 40, 9)
        got, want = pckh(preds, gts, heads, vis), ref_pckh(preds, gts, heads, vis)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        got, want = pck_lsp(preds, gts, vis), ref_pck_lsp(preds, gts, vis)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    assert pckh(preds, gts, heads)[0] == ref_pckh(preds, gts, heads)[0]
    ds = MpiiDataset(*split, split="valid")
    gts = np.stack([ds.meta(i)[2] for i in range(len(ds))])
    for dataset in ("mpii", "lsp"):
        np.testing.assert_array_equal(eval_cli.head_sizes_from_pts(gts, dataset),
                                      ref_head_sizes_from_pts(gts, dataset))
    np.testing.assert_array_equal(eval_cli.head_sizes(ds, gts), ref_head_sizes(ds, gts))
    ds.samples[2].head_rect = None  # mixed: the keypoint stand-in for one
    np.testing.assert_array_equal(eval_cli.head_sizes(ds, gts), ref_head_sizes(ds, gts))


@pytest.mark.parametrize("ext", [".mat", ".npz", ""])
def test_save_preds_round_trips_through_the_reference(tmp_path, ext):
    preds = np.random.RandomState(3).uniform(0, 300, (5, 16, 2))
    path = str(tmp_path / f"preds{ext}")
    save_preds(preds, path)
    assert os.path.exists(path)
    np.testing.assert_array_equal(ref_load_preds(path), preds)
    np.testing.assert_array_equal(load_preds(path), preds)


def test_log_txt_byte_equal_to_reference_logger(tmp_path):
    rows = [[0, 2.5e-4, 0.123456789, float("nan"), 0.5, 0.0],
            [1, 2.5e-5, 1e-9, 0.25, 1.0, 0.0625]]
    paths = {}
    for name, cls in (("port", Logger), ("ref", RefLogger)):
        p = str(tmp_path / name / "log.txt")
        lg = cls(p)
        lg.set_names(cls.DEFAULT_NAMES)
        for r in rows:
            lg.append(r)
        lg.close()
        with open(p, "a") as f:
            f.write("2\t0.000025\t0.1")  # a partial line from a crash mid-write
        lg = cls(p, resume=True)
        lg.set_names(cls.DEFAULT_NAMES)  # resumed: the header stays as it is
        lg.append([2, 2.5e-5, 0.5, 0.5, 0.5, 0.5])
        lg.close()
        paths[name] = (p, lg.numbers)
    assert open(paths["port"][0], "rb").read() == open(paths["ref"][0], "rb").read()
    np.testing.assert_array_equal(paths["port"][1]["Val Acc"], paths["ref"][1]["Val Acc"])
    with pytest.raises(ValueError, match="columns"):
        Logger(str(tmp_path / "x.txt")).append([1, 2])


def test_checkpoints_keep_layout_and_newest_three(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    opt = make_optimizer(model.parameters(), named_config("hg8_mpii").optim)
    state = TrainState(model, opt)
    mgr = CheckpointManager(str(tmp_path / "run"))
    for epoch in range(5):
        model.weight.grad = torch.full_like(model.weight, 0.1 * (epoch + 1))
        model.bias.grad = torch.ones_like(model.bias)
        opt.step()
        state.step += 1
        mgr.save(state, epoch, 0.1 * epoch, is_best=epoch in (1, 3))
    root = tmp_path / "run"
    assert sorted(os.listdir(root / "ckpt")) == ["00002", "00003", "00004"]
    assert os.listdir(root / "best") == ["state.pt"]
    # a crash mid-save leaves its own directory behind, never a checkpoint
    os.makedirs(root / "ckpt" / ".00005.tmp-123")
    assert mgr.latest_path() == str(root / "ckpt" / "00004")
    assert mgr.load(mgr.best_path)["epoch"] == 3
    fresh_model = torch.nn.Linear(3, 2)
    fresh = TrainState(fresh_model, make_optimizer(fresh_model.parameters(),
                                                   named_config("hg8_mpii").optim))
    _, epoch, best = mgr.restore(fresh)
    assert (epoch, best) == (4, pytest.approx(0.4))
    assert fresh.step == 5 and fresh.optimizer.count == 5
    assert torch.equal(fresh_model.weight, model.weight)
    assert torch.equal(fresh.optimizer.state[fresh_model.weight]["nu"],
                       opt.state[model.weight]["nu"])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh)
