"""posetpu_torch.tools.duty_cycle and posetpu_torch.tools.visualize, the
counterparts of tools/duty_cycle.py and tools/visualize.py, on the CPU at a
small size: the duty-cycle tool measures the loader-to-step pipeline at K
= 1 and K = 2 over a synthetic 512x384 split of whole K x B groups and
prints the reference's line; the visualizer draws a run's predictions on
its validation images as PNG files, pixel for pixel as the JAX tool draws
them.
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from posetpu_torch.data import load_annotations, make_synthetic_dataset
from posetpu_torch.tools import duty_cycle, visualize
from posetpu_torch.train import cli as train_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"device_step=[0-9.]+ms wall_step=[0-9.]+ms duty_cycle=[0-9.]+% "
                  r"images/sec=[0-9.]+ \(backend=(native|pil), (per-dispatch|K=2/dispatch), "
                  r"decode\+H2D overlap (OK|LIMITED)\)")


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread for this module's CPU training (the suite runs
    several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("K", [1, 2])
def test_duty_cycle_tool_prints_its_line(K, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(duty_cycle, "NUM_IMAGES", 6)
    monkeypatch.setattr(duty_cycle, "split_root", lambda: str(tmp_path / "split"))
    res = duty_cycle.main(["--cpu", "--stacks", "1", "--feats", "8", "--batch", "2",
                           "--res", "64", "--steps", "4", "--k-per-dispatch", str(K)])
    out = capsys.readouterr().out
    assert LINE.search(out), out
    assert 0.0 < res["duty_cycle"] <= 1.0
    assert res["device_step"] > 0 and res["wall_step"] > 0
    assert res["images_per_sec"] == pytest.approx(2 / res["wall_step"])
    ann = load_annotations(str(tmp_path / "split" / "annotations.json"))
    n_train = sum(not s.is_validation for s in ann)
    assert n_train % (2 * K) == 0 and n_train >= 6


def test_duty_cycle_split_is_made_again_when_ragged(tmp_path, monkeypatch):
    monkeypatch.setattr(duty_cycle, "NUM_IMAGES", 4)
    monkeypatch.setattr(duty_cycle, "split_root", lambda: str(tmp_path / "split"))

    def n_train():
        ann = duty_cycle.make_split(unit)
        return sum(not s.is_validation for s in load_annotations(ann))

    unit = 2
    assert n_train() == 4
    unit = 3  # 4 is not whole groups of 3: made again as 6
    assert n_train() == 6


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny train run (1 epoch) on a synthetic split, and its flags."""
    root = tmp_path_factory.mktemp("viz_split")
    make_synthetic_dataset(str(root), num_train=8, num_val=3, res=(96, 80), seed=5)
    ckpt = str(tmp_path_factory.mktemp("viz_ckpt"))
    flags = ["--config", "hg2_mpii_mini", "--cpu", "--stacks", "1", "--features", "8",
             "--train-batch", "4", "--checkpoint", ckpt,
             "--json", str(root / "annotations.json"), "--image-path", str(root / "images")]
    train_cli.main(flags + ["--epochs", "1"])
    return root, flags


def test_visualize_writes_pngs(run, tmp_path):
    from PIL import Image

    root, flags = run
    paths = visualize.main(flags + ["--n", "5", "--out", str(tmp_path)])
    assert [os.path.basename(p) for p in paths] == ["val_000.png", "val_001.png",
                                                     "val_002.png"]  # 3 images
    for p in paths:
        with Image.open(p) as im:
            assert (im.format, im.mode, im.size) == ("PNG", "RGB", (96, 80))


def test_draw_pose_equals_the_jax_tools():
    spec = importlib.util.spec_from_file_location(
        "ref_visualize", os.path.join(REPO, "tools", "visualize.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert visualize.MPII_BONES == ref.MPII_BONES and visualize.LSP_BONES == ref.LSP_BONES
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (60, 70, 3), dtype=np.uint8)
    pts = (rng.rand(16, 2) * 50 + 5).astype(np.float32)
    got = np.asarray(visualize.draw_pose(img, pts, visualize.MPII_BONES, (1, 2, 3)))
    want = np.asarray(ref.draw_pose(img, pts, ref.MPII_BONES, (1, 2, 3)))
    assert np.array_equal(got, want)
    assert not np.array_equal(got, img)
