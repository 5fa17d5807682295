"""The card's decode route's worker threads and its canvas on the card
(posetpu_torch/native/jpeg_entropy.cpp, jpeg_gpu.py, islow.py,
data/loader.py), on an NVIDIA GPU: N worker threads against one bit for bit
(planes and canvases, with the decoder's stream idle and held by a sleep
kernel, so that a batch's coefficients are copied late and the two pinned
buffers' turns are tested), the loader's batches decoded into a canvas on the card against the
copy-back route's bit for bit at K = 1 and 3, and a refused file's row
against Pillow's.  The file imports nothing of the JAX package; every case
skips without a card:

    python -m pytest --noconftest tests/test_torch_jpeg_gpu_pool_cuda.py -m cuda
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from posetpu_torch.data import (HostLoader, MpiiDataset, load_sample, make_batch_placer,
                                make_synthetic_dataset)
from posetpu_torch.native import jpeg_gpu
from posetpu_torch.native.jpeg_gpu import GpuJpegDecoder


def _jpeg(path, w, h, seed, **kw):
    rng = np.random.RandomState(seed)
    Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(path, **kw)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Ten 96x72 frames, one of them a PNG (the Pillow row)."""
    root = tmp_path_factory.mktemp("jpeg_gpu_pool_split")
    make_synthetic_dataset(str(root), num_train=10, num_val=0, res=(96, 72), seed=6)
    ann = root / "annotations.json"
    raw = json.loads(ann.read_text())
    frame = Image.open(root / "images" / raw[4]["img_paths"]).convert("RGB")
    frame.save(root / "images" / "as.png")
    raw[4]["img_paths"] = "as.png"
    ann.write_text(json.dumps(raw))
    return str(ann), str(root / "images")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _frames(tmp_path, n=12):
    paths = []
    for k in range(n):
        paths.append(str(tmp_path / f"f{k}.jpg"))
        _jpeg(paths[-1], 160 + 16 * (k % 3), 120 + 8 * (k % 4), k, quality=92,
              subsampling=(2, 1, 0)[k % 3])
    gray = str(tmp_path / "gray.jpg")
    Image.fromarray(np.random.RandomState(9).randint(0, 256, (33, 17)).astype(np.uint8)).save(gray)
    return paths + [gray]


@pytest.mark.cuda
def test_cuda_n_threads_equal_one_thread_bit_for_bit(tmp_path):
    """On the card: planes and canvases (host and device out) at the
    default thread count equal one thread's, with the decoder's stream idle
    and held by a sleep kernel (three batches queued behind it: the pinned
    buffers' turns come round before their copies have run)."""
    _cuda()
    paths = _frames(tmp_path)
    centers = np.array([[50.0, 60.5]] * len(paths), np.float32)
    one, many = GpuJpegDecoder("cuda", num_threads=1), GpuJpegDecoder("cuda")
    assert many.num_threads == jpeg_gpu.default_threads()
    want = [tuple(p.clone() for p in pl) for pl in one.decode_planes(paths)[0]]
    got = many.decode_planes(paths)[0]
    assert all(torch.equal(a, b) for x, y in zip(want, got) for a, b in zip(x, y))
    pad = (128, 144)
    h1 = one.decode_batch(paths, centers, pad)[0].copy()
    with torch.cuda.stream(many.stream):
        torch.cuda._sleep(100_000_000)
    outs = [many.canvas((len(paths), *pad, 3)) for _ in range(3)]
    kept = [many.decode_batch(paths[::-1] if k == 1 else paths, centers, pad, out=o)[0]
            for k, o in enumerate(outs)]
    for k, (images, o) in enumerate(zip(kept, outs)):
        torch.cuda.current_stream().wait_event(images.ready)
        want_k = h1[::-1] if k == 1 else h1
        np.testing.assert_array_equal(o.cpu().numpy(), want_k)
    for pad in ((128, 144), (64, 48)):
        h1 = one.decode_batch(paths, centers, pad)[0].copy()
        hn = many.decode_batch(paths, centers, pad)[0]
        np.testing.assert_array_equal(h1, hn)
        out = many.canvas((len(paths), *pad, 3))
        images = many.decode_batch(paths, centers, pad, out=out)[0]
        torch.cuda.current_stream().wait_event(images.ready)
        np.testing.assert_array_equal(out.cpu().numpy(), h1)
    one.close()
    many.close()


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 3])
def test_cuda_device_canvas_equals_the_copy_back_route(split, group):
    """On the card: the loader's batches decoded into the device canvas
    equal the copy-back route's (decoded into host memory, then placed)
    bit for bit, the PNG's Pillow row included."""
    _cuda()
    ds = MpiiDataset(*split)
    kw = dict(pad_hw=(64, 80), seed=2, group=group)
    card = HostLoader(ds, 3, backend="gpu", place=make_batch_placer("cuda"), **kw)
    host = HostLoader(ds, 3, backend="gpu", device="cuda", **kw)
    assert card._keep_canvas and not host._keep_canvas
    got, want = list(card), list(host)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            assert g[k].is_cuda
            np.testing.assert_array_equal(g[k].cpu().numpy(), np.asarray(v), err_msg=k)


@pytest.mark.cuda
def test_cuda_refused_file_row_equals_pillow(split):
    """On the card: the PNG's row of a device canvas is Pillow's canvas."""
    _cuda()
    ds = MpiiDataset(*split)
    loader = HostLoader(ds, 10, pad_hw=(64, 80), shuffle=False, backend="gpu",
                        place=make_batch_placer("cuda"), group=1)
    (batch,) = list(loader)
    want = load_sample(ds, 4, (64, 80))["image"]
    np.testing.assert_array_equal(batch["image"][0, 4].cpu().numpy(), want)
