"""posetpu_torch.tools.ycc_canvas_ab on the CPU: another checkout's decode
module loads as a module of its own, and the loader's batch it times is
laid out as the card's decode route lays out its planes.  The timings themselves need a
card."""

import os

import numpy as np
import pytest
import torch

from posetpu_torch.native import jpeg_gpu, ycc
from posetpu_torch.tools import ycc_canvas_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_other_checkout_loads_as_its_own_module():
    mod = ycc_canvas_ab.load_route(REPO)
    assert mod is not jpeg_gpu and mod.YCC_SOURCE == jpeg_gpu.YCC_SOURCE
    assert mod._staging is not jpeg_gpu._staging and mod.DESC_WORDS == jpeg_gpu.DESC_WORDS


def test_loader_batch_is_pitched_like_the_routes_planes():
    pad = (24, 32)
    planes, samplings, windows = ycc_canvas_ab.loader_batch("cpu", n=3, size=(41, 30),
                                                            pad_hw=pad)
    for pl, samp in zip(planes, samplings):
        assert samp == ycc_canvas_ab.SAMPLING
        assert [p.stride(0) % jpeg_gpu.PITCH_ALIGN for p in pl] == [0, 0, 0]
        assert [tuple(p.shape) for p in pl] == [(30, 41), (15, 21), (15, 21)]
    assert windows[:, 2].max() <= pad[1] and windows[:, 3].max() <= pad[0]
    desc = jpeg_gpu._descriptors(planes, samplings, windows, pad, torch.device("cpu"))
    assert (desc[:, 18] == 3).all()
    got = ycc_canvas_ab.load_route(REPO).ycc_canvas(planes, samplings, windows, pad)
    want = torch.stack([ycc.window_canvas(pl, s, w, pad)
                        for pl, s, w in zip(planes, samplings, windows)])
    assert torch.equal(got, want)


def test_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        ycc_canvas_ab.main(["--other", REPO])
