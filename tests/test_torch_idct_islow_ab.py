"""posetpu_torch.tools.idct_islow_ab on the CPU: another checkout's
``islow`` module loads as a module of its own, and the loader's batch it
times is decoded and laid out as the card's decode route lays out its
coefficients and planes.  The timings themselves need a card."""

import os

import numpy as np
import pytest
import torch

from posetpu_torch.native import islow, jpeg_gpu
from posetpu_torch.tools import idct_islow_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_other_checkout_loads_as_its_own_module():
    mod = idct_islow_ab.load_islow(REPO)
    assert mod is not islow and mod.SOURCE == islow.SOURCE
    assert mod._staging is not islow._staging and mod.DESC_WORDS == islow.DESC_WORDS


def test_loader_batch_is_the_routes_layout(tmp_path):
    coefs, desc, sizes = idct_islow_ab.loader_batch("cpu", str(tmp_path), n=2, size=(41, 30))
    assert coefs.dtype is torch.int16 and coefs.dim() == 1
    assert sizes == [(41, 30), (21, 15), (21, 15)] * 2
    assert (desc[:, :2] % islow.ALIGN == 0).all()
    buf, planes = idct_islow_ab.route_planes(sizes, "cpu")
    assert [p.stride(0) % jpeg_gpu.PITCH_ALIGN for p in planes] == [0] * 6
    assert all((p.data_ptr() - buf.data_ptr()) % jpeg_gpu.PITCH_ALIGN == 0 for p in planes)
    mod = idct_islow_ab.load_islow(REPO)
    mod.idct_islow(coefs, coefs, desc, planes)
    want = idct_islow_ab.plain_planes(coefs, desc, sizes)
    assert all(torch.equal(p, w) for p, w in zip(planes, want))
    words, tiles = mod.descriptors(desc, planes)
    assert words.shape == (6, islow.DESC_WORDS)
    # 41 and 21 wide: one tile a block row; 4 and 2 block rows a component
    assert tiles == 2 * (4 + 2 + 2) and words[:, 9].tolist() == [0, 4, 6, 8, 12, 14]
    assert np.all(words[:, 10] == 1)


def test_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        idct_islow_ab.main(["--other", REPO])
