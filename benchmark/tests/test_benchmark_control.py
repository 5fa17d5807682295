"""The control of ``correct``: the plain reference computed in fp8 (the
next precision below the configurations' bf16) in the program's place has
to come out as not correct.

On the CPU the tiny cells hold a float32 program to the float32 reference,
and the control reads far above the program there.  On a card (``cuda``
marker) a cell's own size is run once and the control has to fail the
cell's committed limits; ``python3 -m benchmark.calibrate`` gives the same
readings for many seeds (PERF.md keeps them).
"""

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import tiny_cells

SEED = 2**31 + 5150


def calibrate(spec, here, workload, device, seconds=0.3):
    cell, cfg, traffic, limits = run.cell_files(spec, workload, here)
    drv = run.driver(traffic)
    ctx = drv.setup(cfg, traffic, SEED, device)
    if drv.KIND == "serve":
        drv.window(ctx, seconds)
    return drv.calibrate(ctx), limits


@pytest.mark.parametrize("workload", ["tiny.train", "tiny_asr.joint", "tiny.serve",
                                      "tiny.train_loader"])
def test_control_reads_far_above_the_program_on_the_cpu(tmp_path, workload):
    spec, here = tiny_cells(tmp_path)
    got, limits = calibrate(spec, here, workload, torch.device("cpu"))
    assert run.judge(got["program"], limits)[0]
    assert not run.judge(got["control"], limits)[0]
    assert any(got["control"][n] >= 3 * max(got["program"][n], 1e-12) for n in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["hg8_mpii.train", "hg8_mpii_asr.joint",
                                      "hg8_mpii.serve", "hg8_mpii.train_loader"])
def test_control_fails_the_cells_limits_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec = run.manifest()
    got, limits = calibrate(spec, run.HERE, workload, torch.device("cuda", 0), seconds=3.0)
    assert run.judge(got["program"], limits)[0], got["program"]
    assert not run.judge(got["control"], limits)[0], got["control"]
