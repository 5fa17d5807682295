"""The yardstick's arithmetic: the model's operations and the rasterizer's
bytes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts

HG8 = dict(stacks=8, blocks=1, feats=128, classes=16, depth=4)


def test_hg8_forward_is_56_19_gflop_an_image_at_256():
    assert counts.hourglass_forward_flops(HG8, 256) == 56_188_993_536
    assert counts.hourglass_forward_flops(HG8, 384) == 126_425_235_456
    assert counts.train_step_flops(HG8, 256) == 3 * 56_188_993_536


@pytest.mark.parametrize("stacks,blocks,feats,classes,depth,res", [
    (1, 1, 8, 16, 2, 64), (2, 1, 16, 14, 3, 64), (2, 2, 8, 16, 4, 128), (3, 1, 12, 16, 4, 64),
])
def test_count_equals_torch_flop_counter_on_the_program(stacks, blocks, feats, classes,
                                                        depth, res):
    from posetpu_torch.models import hg

    net = hg(num_stacks=stacks, num_blocks=blocks, num_classes=classes, num_feats=feats,
             depth=depth, dtype=torch.float32).eval()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(torch.zeros(1, res, res, 3))
    model = dict(stacks=stacks, blocks=blocks, feats=feats, classes=classes, depth=depth)
    assert counts.hourglass_forward_flops(model, res) == fc.get_total_flops()


def test_rasterizer_bound_is_chip_smokes():
    nbytes = counts.raster_bytes(32, 16, 64, 64)
    assert nbytes == 8_396_800
    assert round(counts.bound_ms(nbytes), 6) == 0.002507
    assert counts.raster_bytes(64, 16, 64, 64) == 2 * nbytes


def test_decode_kernel_bounds_are_chip_smokes():
    idct, ycc = counts.jpeg_420_bytes(32, 1280, 720, (768, 1280))
    assert idct == 88_473_600 + 12_288 + 44_236_800
    assert ycc == 44_236_800 + 94_371_840
    assert round(counts.bound_ms(idct), 6) == 0.039619
    assert round(counts.bound_ms(ycc), 6) == 0.041376


def test_joint_step_counts_the_agent_as_torch_does():
    from posetpu_torch.models.agent import AugAgent

    agent = dict(widths=[32, 64, 128, 256], input_downscale=2, scale_bins=7, rot_bins=7)
    net = AugAgent(input_downscale=2, dtype=torch.float32, device="cpu").eval()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(torch.zeros(1, 256, 256, 3))
    assert counts.agent_forward_flops(agent, 256) == fc.get_total_flops() == 151_919_616
    assert counts.joint_step_flops(HG8, agent, 256) == 4 * 56_188_993_536 + 3 * 151_919_616
