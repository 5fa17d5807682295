"""The card's decode route's worker threads and its canvas on the
decoder's device (posetpu_torch/native/jpeg_entropy.cpp, jpeg_gpu.py,
data/loader.py) against the JAX package's pool and Pillow loader.

On the CPU: the layouts of the coefficients and of the planes in the
decoder's buffers; the CPU route at any thread count against the JAX
package's ``load_sample`` and pool (windows and images exactly);
``HostLoader`` on the gpu route with a placer on the decoder's device (the
CPU's: the canvas path the card takes, with the plain kernels), grouped and
padded, against the JAX package's Pillow loader exactly, a PNG through the
Pillow row.  The ctypes signatures are checked in
``tests/test_torch_jpeg_entropy.py``.

The card's cases are in ``tests/test_torch_jpeg_gpu_pool_cuda.py``, which
imports nothing of the JAX package.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from posetpu.data import HostLoader as RefLoader
from posetpu.data import MpiiDataset as RefMpii
from posetpu.data import make_synthetic_dataset as ref_make
from posetpu.data.loader import group_stack as ref_group_stack
from posetpu.data.loader import load_sample as ref_load_sample
from posetpu.data.loader import pad_batch as ref_pad_batch
from posetpu_torch.data import HostLoader, MpiiDataset, make_batch_placer
from posetpu_torch.data.loader import IMAGE_READY, place_field
from posetpu_torch.native import jpeg_gpu, ycc
from posetpu_torch.native.jpeg_gpu import DecodedCanvas, GpuJpegDecoder


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plane_layout_is_disjoint_aligned_and_within_the_buffer(seed):
    """Mixed sizes at every subsampling, grayscale files (one plane) and
    files not decoded: every plane PITCH_ALIGN-aligned at its start and
    pitch, no two overlapping, all inside the buffer."""
    rng = np.random.RandomState(seed)
    samplings = [[(1, 1)], [(1, 1), (1, 1), (1, 1)], [(1, 1), (2, 1), (2, 1)],
                 [(1, 1), (1, 2), (1, 2)], [(1, 1), (2, 2), (2, 2)]]
    sizes, want = [], []
    for _ in range(40):
        if rng.rand() < 0.15:
            sizes.append(None)
            continue
        samp = samplings[rng.randint(len(samplings))]
        W, H = rng.randint(1, 1400), rng.randint(1, 800)
        sizes.append(jpeg_gpu.plane_sizes(samp, W, H))
        want.append((samp, W, H))
    layout, nbytes = jpeg_gpu.plane_layout(sizes)
    regions = []
    for got, planes in zip(layout, sizes):
        if planes is None:
            assert got is None
            continue
        assert len(got) == len(planes) in (1, 3)
        for (w, h, pitch, off), size in zip(got, planes):
            assert (w, h) == size
            assert pitch >= w and pitch % jpeg_gpu.PITCH_ALIGN == 0
            assert off % jpeg_gpu.PITCH_ALIGN == 0
            regions.append((off, off + pitch * h))
    regions.sort()
    assert regions[0][0] >= 0 and regions[-1][1] <= nbytes
    assert all(a[1] <= b[0] for a, b in zip(regions, regions[1:]))
    for samp, W, H in want:
        got = jpeg_gpu.plane_sizes(samp, W, H)
        if len(samp) == 1:
            assert got == [(W, H)]
        else:
            assert got[1:] == [ycc.component_size(W, H, *samp[1])] * 2


def _jpeg(path, w, h, seed, **kw):
    rng = np.random.RandomState(seed)
    Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(path, **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_coefficient_layout_is_disjoint_aligned_and_within_the_buffer(seed):
    """Files of 1 and 3 components and files not decoded: each file's
    tables, then its components' blocks, 64 elements each, every offset a
    multiple of 64 elements, no two overlapping, all inside the buffer."""
    rng = np.random.RandomState(seed)
    grids = [None if rng.rand() < 0.2 else
             [tuple(rng.randint(1, 90, 2)) for _ in range(rng.choice([1, 3]))]
             for _ in range(30)]
    layout, elements = jpeg_gpu.coefficient_layout(grids)
    regions = []
    for got, comps in zip(layout, grids):
        if comps is None:
            assert got is None
            continue
        qt, offs = got
        regions.append((qt, qt + 64 * len(comps)))
        assert len(offs) == len(comps)
        for off, (bw, bh) in zip(offs, comps):
            regions.append((off, off + 64 * bw * bh))
    regions.sort()
    assert all(a % 64 == 0 for a, _ in regions)
    assert regions[0][0] == 0 and regions[-1][1] == elements
    assert all(a[1] == b[0] for a, b in zip(regions, regions[1:]))


@pytest.mark.parametrize("num_threads", [1, 3])
def test_cpu_decoder_at_any_thread_count_equals_pillow_and_the_pool(tmp_path, num_threads):
    """GpuJpegDecoder("cpu", num_threads=n): windows and images equal the
    JAX package's load_sample (Pillow) exactly, and its pool's where that
    pool builds; a PNG reads ok False and zero."""
    from posetpu.native import NativeDecoder as RefDecoder
    from posetpu.native import native_available

    paths = []
    for k, (w, h, sub) in enumerate([(61, 47, 2), (40, 90, 0), (17, 5, 1), (128, 64, 2)]):
        paths.append(str(tmp_path / f"{k}.jpg"))
        _jpeg(paths[-1], w, h, k, quality=90, subsampling=sub)
    paths.append(str(tmp_path / "x.png"))
    _jpeg(paths[-1], 9, 9, 7)
    centers = np.array([[5.5, 40.25], [30.0, 2.5], [16.75, 4.0], [64.0, 32.0], [0, 0]],
                       np.float32)
    dec = GpuJpegDecoder("cpu", num_threads=num_threads)
    assert dec.num_threads == num_threads
    ds = _Files(paths, centers)
    for pad_hw in [(48, 64), (32, 32)]:
        images, wh, offs, ok = dec.decode_batch(paths, centers, pad_hw)
        assert ok.tolist() == [True] * 4 + [False] and not images[4].any()
        for i in range(4):
            want = ref_load_sample(ds, i, pad_hw)
            np.testing.assert_array_equal(wh[i], want["valid_wh"])
            np.testing.assert_array_equal(offs[i], want["offset"])
            np.testing.assert_array_equal(images[i], want["image"])
        if native_available():
            ref = RefDecoder(num_threads=num_threads)
            r_images, r_wh, r_offs, r_ok = ref.decode_batch(paths[:4], centers[:4], pad_hw)
            assert r_ok.all()
            np.testing.assert_array_equal(images[:4], r_images)
            np.testing.assert_array_equal(wh[:4], r_wh)
            np.testing.assert_array_equal(offs[:4], r_offs)
            ref.close()


def test_more_workers_than_cores_decode_as_one(tmp_path):
    """The entropy decoder's pool at 4x the cores, with a short switch
    interval, over batches of mixed files (a refused PNG among them): every
    batch's coefficients, tables and statuses equal one worker's, and the
    decoder refuses work once closed."""
    import sys

    paths = []
    for k in range(24):
        paths.append(str(tmp_path / f"{k}.jpg"))
        _jpeg(paths[-1], 17 + 13 * (k % 5), 9 + 11 * (k % 4), k, quality=70 + k,
              subsampling=k % 3)
    paths.insert(5, str(tmp_path / "x.png"))
    _jpeg(paths[5], 9, 9, 99)
    one = GpuJpegDecoder("cpu", num_threads=1).coefficients(paths)
    many = GpuJpegDecoder("cpu", num_threads=4 * (os.cpu_count() or 4))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            got = many.coefficients(paths)
            assert got.statuses.tolist() == one.statuses.tolist()
            assert got.elements == one.elements
            assert torch.equal(got.buffer[:got.elements], one.buffer[:one.elements])
    finally:
        sys.setswitchinterval(interval)
        many.close()
    with pytest.raises(RuntimeError, match="after close"):
        many.coefficients(paths)


def test_default_threads_is_the_host_pools_rule(monkeypatch):
    assert GpuJpegDecoder("cpu").num_threads == min(16, os.cpu_count() or 4)
    monkeypatch.setattr(os, "cpu_count", lambda: None)
    assert jpeg_gpu.default_threads() == 4
    monkeypatch.setattr(os, "cpu_count", lambda: 64)
    assert jpeg_gpu.default_threads() == 16


class _Files:
    def __init__(self, paths, centers):
        self.paths, self.centers = paths, centers

    def __len__(self):
        return len(self.paths)

    def image_path(self, i):
        return self.paths[i]

    def meta(self, i):
        return self.centers[i].astype(np.float64), 1.0, np.zeros((16, 2)), np.zeros(16)


def test_a_tensor_out_keeps_the_canvas_on_the_decoders_device(tmp_path):
    """decode_batch with a tensor out writes into it and returns it as a
    DecodedCanvas (no event on the CPU), equal to the host array route;
    a row set on it is written; an out on another shape is refused."""
    paths = []
    for k in range(3):
        paths.append(str(tmp_path / f"{k}.jpg"))
        _jpeg(paths[-1], 30 + 7 * k, 20 + 5 * k, k)
    centers = np.array([[10.0, 10.0], [3.0, 30.0], [40.5, 2.5]], np.float32)
    dec = GpuJpegDecoder("cpu")
    host, wh, offs, ok = dec.decode_batch(paths, centers, (24, 32))
    out = torch.full((3, 24, 32, 3), 255, dtype=torch.uint8)
    images, wh2, offs2, ok2 = dec.decode_batch(paths, centers, (24, 32), out=out)
    assert isinstance(images, DecodedCanvas) and images.tensor is out and images.ready is None
    np.testing.assert_array_equal(out.numpy(), host)
    for a, b in ((wh, wh2), (offs, offs2), (ok, ok2)):
        np.testing.assert_array_equal(a, b)
    images[1] = np.full((24, 32, 3), 9, np.uint8)
    assert (out[1] == 9).all() and torch.equal(out[0], torch.from_numpy(host[0]))
    with pytest.raises(ValueError, match="out must be"):
        dec.decode_batch(paths, centers, (24, 32), out=torch.zeros(3, 24, 31, 3, dtype=torch.uint8))
    with pytest.raises(ValueError, match="centers"):
        dec.decode_batch(paths, centers[:2], (24, 32), out=out)


def test_place_field_passes_a_tensor_on_its_device_through():
    """The placer's rule: a field already on the placer's device is the
    batch's as it is, not a copy."""
    t = torch.arange(6, dtype=torch.uint8)
    assert place_field(t, torch.device("cpu")) is t


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Ten 96x72 frames, one of them a PNG (the Pillow row)."""
    root = tmp_path_factory.mktemp("jpeg_gpu_pool_split")
    ref_make(str(root), num_train=10, num_val=0, res=(96, 72), seed=6)
    ann = root / "annotations.json"
    raw = json.loads(ann.read_text())
    frame = Image.open(root / "images" / raw[4]["img_paths"]).convert("RGB")
    frame.save(root / "images" / "as.png")
    raw[4]["img_paths"] = "as.png"
    ann.write_text(json.dumps(raw))
    return str(ann), str(root / "images")


@pytest.mark.parametrize("group,pad", [(1, False), (3, False), (2, True)])
def test_loader_canvas_on_the_decoders_device_equals_the_reference(split, group, pad):
    """HostLoader(backend="gpu") with a placer on the decoder's device
    (the CPU's) decodes each group into one tensor (the card's path, with
    the plain kernel), and equals the JAX package's Pillow loader, padded
    and grouped, key for key, over two epochs; the PNG goes through the
    Pillow row.  The canvas is passed through the placer as decoded."""
    ds, ref = MpiiDataset(*split), RefMpii(*split)
    kw = dict(pad_hw=(64, 80), seed=2, drop_last=not pad)
    port = HostLoader(ds, 3, backend="gpu", place=make_batch_placer("cpu"), group=group,
                      pad=pad, **kw)
    ref_loader = RefLoader(ref, 3, backend="pil", **kw)
    assert port.backend == "gpu" and port._keep_canvas
    canvases = []
    real = port._decoder.canvas

    def recording(shape):
        canvases.append(real(shape))
        return canvases[-1]

    port._decoder.canvas = recording
    seen_png = False
    for _ in range(2):
        batches = list(ref_loader)
        if pad:
            batches = [ref_pad_batch(b, 3) for b in batches]
        want = list(ref_group_stack(iter(batches), group))
        canvases.clear()
        got = list(port)
        assert len(got) == len(want) == len(canvases)
        for g, w, c in zip(got, want, canvases):
            assert list(g) == list(w) and IMAGE_READY not in g
            assert g["image"] is c and tuple(c.shape) == w["image"].shape
            for k, v in w.items():
                assert np.asarray(g[k]).dtype == v.dtype, k
                np.testing.assert_array_equal(np.asarray(g[k]), v, err_msg=k)
            seen_png |= 4 in w["index"]
    assert seen_png
