"""Whole runs of the tiny cells on the CPU (the look for a card skipped),
sound and with the timed path broken underneath: each fault a cell can
have has to turn ``correct`` false."""

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import tiny_cells

SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return tiny_cells(tmp_path_factory.mktemp("faults"))


def run_tiny(cells, workload, seconds=0.3):
    spec, here = cells
    return run.run_cell(spec, workload, SEED, seconds, False, torch.device("cpu"), here=here)


@pytest.mark.parametrize("workload", ["tiny.train", "tiny_asr.joint", "tiny.serve",
                                      "tiny.train_loader"])
def test_sound_run_is_correct(cells, workload):
    line = run_tiny(cells, workload)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("workload", ["tiny.train", "tiny_asr.joint", "tiny.train_loader"])
def test_state_left_unchanged_is_caught(cells, monkeypatch, workload):
    from posetpu_torch.train.state import OptaxRMSprop

    # the update counts but moves nothing
    monkeypatch.setattr(OptaxRMSprop, "step_at", lambda self, count: count.add_(1))
    line = run_tiny(cells, workload)
    assert not line["correct"]
    assert line["checks"]["median_change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["tiny.train", "tiny_asr.joint", "tiny.train_loader"])
def test_half_the_batch_left_out_is_caught(cells, monkeypatch, workload):
    from posetpu_torch.train import adversarial, step

    real = step.per_sample_stacked_mse if "joint" in workload else step.stacked_mse

    def half(outputs, target, *weight):
        # the mean over the first half of the rows, as if the rest were not there
        n = target.shape[0] // 2
        kept = real([o[:n] for o in outputs], target[:n], *weight)
        return kept.repeat(2) if kept.dim() else kept

    if "joint" in workload:
        monkeypatch.setattr(adversarial, "per_sample_stacked_mse", half)
    else:
        monkeypatch.setattr(step, "stacked_mse", half)
    line = run_tiny(cells, workload)
    assert not line["correct"]
    assert line["checks"]["first_loss_gap"]["value"] > 1e-3


@pytest.mark.parametrize("field", ["pred", "conf", "heatmap_coords"])
def test_altered_answer_is_caught(cells, monkeypatch, field):
    from posetpu_torch.infer import PosePredictor

    real = PosePredictor._fetch

    def altered(pending):
        out = real(pending)
        out[field] = out[field].copy()
        out[field][0, 3] += np.float32(1.0 if field != "conf" else 0.5 * abs(out[field][0, 3]) + 1)
        return out

    monkeypatch.setattr(PosePredictor, "_fetch", staticmethod(altered))
    line = run_tiny(cells, "tiny.serve")
    assert not line["correct"], line["checks"]


def test_altered_canvas_is_caught(cells, monkeypatch):
    from posetpu_torch.data import loader

    real = loader.HostLoader.__iter__

    def altered(self):
        for b in real(self):
            b = dict(b)
            b["image"] = b["image"].clone() if hasattr(b["image"], "clone") else b["image"].copy()
            b["image"][..., 5, 7, 0] ^= 1  # one byte of each canvas, where it is made
            yield b

    monkeypatch.setattr(loader.HostLoader, "__iter__", altered)
    line = run_tiny(cells, "tiny.train_loader")
    assert not line["correct"]
    assert line["checks"]["canvas_lsb"]["value"] == 1.0


def test_a_cell_without_limits_is_not_correct(cells, tmp_path):
    spec, here = cells
    import shutil

    bare = tmp_path / "bare"
    shutil.copytree(here, bare)
    (bare / "limits" / "tiny.serve.json").unlink()
    line = run.run_cell(spec, "tiny.serve", SEED, 0.3, False, torch.device("cpu"),
                        here=str(bare))
    assert not line["correct"] and line["checks"] == {}
