"""posetpu_torch's host loader against the JAX package's: load_sample,
pad_batch and two epochs of HostLoader batches (the Pillow route exactly,
key for key and dtype for dtype); the port's own C++ decode pool against
the reference's Pillow path within 2.5 LSB (libjpeg's and Pillow's IDCT
round differently, as tests/test_native.py allows); the abandon-safe
prefetch queue; and the pool's first build started by 4 processes at once.

The reference's loaders are built with backend="pil", so these tests never
start the reference's own build of its pool.  The native cases skip only
where g++ or libjpeg's header is missing, a condition fixed before any
build runs.
"""

import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from posetpu.data import HostLoader as RefLoader
from posetpu.data import MpiiDataset as RefMpii
from posetpu.data import make_synthetic_dataset as ref_make
from posetpu.data.loader import load_sample as ref_load_sample
from posetpu.data.loader import pad_batch as ref_pad_batch
from posetpu_torch.data import (
    HostLoader,
    MpiiDataset,
    load_sample,
    make_batch_placer,
    pad_batch,
    threaded_place_iter,
)
from posetpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LSB = 2.5
_JPEGLIB = ("/usr/include/jpeglib.h", "/usr/local/include/jpeglib.h",
            "/usr/include/x86_64-linux-gnu/jpeglib.h",
            "/usr/include/aarch64-linux-gnu/jpeglib.h")


@pytest.fixture
def native():
    """The port's pool module, where g++ and libjpeg's header exist."""
    if shutil.which("g++") is None or not any(os.path.exists(p) for p in _JPEGLIB):
        pytest.skip("no g++ or no libjpeg header: the native pool cannot build")
    from posetpu_torch.native import bindings

    return bindings


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("loader_split")
    ref_make(str(root), num_train=10, num_val=3, res=(96, 72), seed=2)
    return str(root / "annotations.json"), str(root / "images")


@pytest.fixture(scope="module")
def datasets(split):
    return MpiiDataset(*split), RefMpii(*split)


def _same_batch(got, want, exact_images=True):
    assert list(got) == list(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k == "image" and not exact_images:
            assert np.abs(g.astype(np.int16) - w.astype(np.int16)).max() <= LSB
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


# (40, 40): crops every 96x72 image around its person; (72, 96): fits it
# exactly; (64, 128): crops the height only
@pytest.mark.parametrize("pad_hw", [(40, 40), (72, 96), (64, 128)])
def test_load_sample_and_pad_batch_equal_reference(datasets, pad_hw):
    ds, ref = datasets
    items = [load_sample(ds, i, pad_hw) for i in range(3)]
    want = [ref_load_sample(ref, i, pad_hw) for i in range(3)]
    for g, w in zip(items, want):
        _same_batch(g, w)
    if pad_hw == (40, 40):
        assert any(it["offset"].any() for it in items)
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    for size in (3, 5):
        _same_batch(pad_batch(batch, size), ref_pad_batch(batch, size))
    with pytest.raises(ValueError, match="larger than pad target"):
        pad_batch(batch, 2)


def test_crop_window_rounds_half_up(tmp_path):
    """A center on *.5 picks the window the C++ pool picks (int(c + 0.5)),
    not Python's half-to-even round."""
    root = tmp_path / "s"
    ref_make(str(root), num_train=1, num_val=0, res=(96, 72), seed=1)
    ann = root / "annotations.json"
    raw = json.loads(ann.read_text())
    raw[0]["objpos"] = [40.5, 30.5]
    ann.write_text(json.dumps(raw))
    ds = MpiiDataset(str(ann), str(root / "images"))
    ref = RefMpii(str(ann), str(root / "images"))
    got, want = load_sample(ds, 0, (20, 21)), ref_load_sample(ref, 0, (20, 21))
    _same_batch(got, want)
    c = ds.meta(0)[0]
    assert got["offset"][0] == int(c[0] + 0.5) - 10


@pytest.mark.parametrize("shuffle,drop_last,batch", [(True, True, 4), (False, False, 4),
                                                      (True, False, 3)])
def test_two_epochs_equal_reference_pil(datasets, shuffle, drop_last, batch):
    ds, ref = datasets
    kw = dict(pad_hw=(64, 80), shuffle=shuffle, seed=3, drop_last=drop_last)
    port = HostLoader(ds, batch, backend="pil", **kw)
    want_loader = RefLoader(ref, batch, backend="pil", **kw)
    assert port.backend == "pil" and len(port) == len(want_loader)
    orders = []
    for _ in range(2):
        got, want = list(port), list(want_loader)
        assert len(got) == len(want) == len(port)
        for g, w in zip(got, want):
            _same_batch(g, w)
        orders.append(np.concatenate([b["index"] for b in got]))
    assert port.epoch == 2
    if shuffle:  # RandomState(seed + epoch): a new order each epoch
        assert not np.array_equal(orders[0], orders[1])


def test_cpu_placer_yields_tensors_of_the_same_batches(datasets):
    ds, _ = datasets
    host = list(HostLoader(ds, 4, pad_hw=(64, 80), seed=1, backend="pil"))
    placed = list(HostLoader(ds, 4, pad_hw=(64, 80), seed=1, backend="pil",
                             place=make_batch_placer("cpu")))
    for p, h in zip(placed, host):
        assert set(p) == set(h)
        for k, v in h.items():
            assert isinstance(p[k], torch.Tensor)
            np.testing.assert_array_equal(p[k].numpy(), v)


def test_unknown_backend_raises(datasets):
    with pytest.raises(ValueError, match="unknown backend"):
        HostLoader(datasets[0], 2, backend="grain")


@pytest.mark.cuda
def test_cuda_placer_batches_equal_host_batches(datasets):
    """On the card: pinned decode buffers, the copy stream and the event
    hand-off give the host batches exactly, on the consumer's stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ds, _ = datasets
    placer = make_batch_placer("cuda")
    host = list(HostLoader(ds, 4, pad_hw=(64, 80), seed=1, backend="pil"))
    since = profiling.REGISTRY.watermark()
    with profiling.REGISTRY.forced_on():  # each copy a device span of loader.place
        placed = list(HostLoader(ds, 4, pad_hw=(64, 80), seed=1, backend="pil", place=placer))
    for p, h in zip(placed, host):
        for k, v in h.items():
            assert p[k].is_cuda
            np.testing.assert_array_equal(p[k].cpu().numpy(), v)
    copies = [r for r in profiling.records("loader.place", since) if r.device]
    assert len(copies) == len(host) and all(r.ms >= 0 for r in copies)


def test_native_pool_matches_reference_pil(native, datasets, tmp_path):
    ds, ref = datasets
    dec = native.NativeDecoder(num_threads=3)
    paths = [ds.image_path(i) for i in range(4)]
    centers = np.stack([ds.meta(i)[0] for i in range(4)]).astype(np.float32)
    for pad_hw in [(72, 96), (80, 112), (40, 48)]:
        out = np.full((4, *pad_hw, 3), 255, np.uint8)
        images, wh, offs, ok = dec.decode_batch(paths, centers, pad_hw, out=out)
        assert images is out and ok.all()
        for i in range(4):
            want = ref_load_sample(ref, i, pad_hw)
            np.testing.assert_array_equal(wh[i], want["valid_wh"])
            np.testing.assert_array_equal(offs[i], want["offset"])
            d = np.abs(images[i].astype(np.int16) - want["image"].astype(np.int16))
            assert d.max() <= LSB, (pad_hw, i, d.max())
        if pad_hw == (40, 48):  # oversize: cropped around the person
            assert (offs > 0).any()
    # a failed slot reads zero even in an uninitialised buffer, and its
    # neighbours decode
    out = np.full((2, 72, 96, 3), 255, np.uint8)
    bad = tmp_path / "not_a.jpg"
    bad.write_bytes(b"\x89PNG not a jpeg")
    images, wh, offs, ok = dec.decode_batch([str(bad), paths[0]], centers[:2], (72, 96),
                                            out=out)
    assert not ok[0] and ok[1]
    assert (wh[0] == 0).all() and (offs[0] == 0).all() and not images[0].any()
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        dec.decode_batch(paths[:2], centers[:2], (72, 96), out=np.zeros((2, 72, 96, 3)))
    dec.close()
    with pytest.raises(RuntimeError, match="after close"):
        dec.decode_batch(paths[:1], centers[:1], (72, 96))


def test_native_loader_falls_back_to_pil_per_sample(native, tmp_path):
    """A PNG in the split: the pool fails on it, the loader decodes it with
    Pillow in place; both epochs match the reference's Pillow batches
    (images within 2.5 LSB, metadata exactly)."""
    from PIL import Image

    root = tmp_path / "mixed"
    ref_make(str(root), num_train=6, num_val=0, res=(96, 72), seed=6)
    ann = root / "annotations.json"
    raw = json.loads(ann.read_text())
    im = Image.open(root / "images" / raw[2]["img_paths"]).convert("RGB")
    im.save(root / "images" / "as.png")
    raw[2]["img_paths"] = "as.png"
    ann.write_text(json.dumps(raw))
    ds = MpiiDataset(str(ann), str(root / "images"))
    ref = RefMpii(str(ann), str(root / "images"))
    kw = dict(pad_hw=(40, 48), seed=5)
    port = HostLoader(ds, 3, backend="native", **kw)
    want_loader = RefLoader(ref, 3, backend="pil", **kw)
    assert port.backend == "native"
    seen_png = False
    for _ in range(2):
        for g, w in zip(port, want_loader):
            _same_batch(g, w, exact_images=False)
            seen_png |= 2 in g["index"]
    assert seen_png


def test_early_break_releases_the_producer():
    done = threading.Event()
    pulled = []

    def src():
        try:
            for i in range(1000):
                pulled.append(i)
                yield i
        finally:
            done.set()

    it = threaded_place_iter(src(), lambda x: x * 2, prefetch=2)
    got = []
    for x in it:
        got.append(x)
        if len(got) == 3:
            break
    it.close()
    assert got == [0, 2, 4]
    assert done.wait(5.0), "the producer still holds its source"
    assert len(pulled) < 10


def test_producer_exception_reaches_the_consumer():
    def src():
        yield 1
        raise KeyError("bad sample")

    it = threaded_place_iter(src(), lambda x: x)
    assert next(it) == 1
    with pytest.raises(KeyError, match="bad sample"):
        next(it)


def test_loader_break_releases_its_thread(datasets):
    ds, _ = datasets
    before = threading.active_count()
    loader = HostLoader(ds, 2, pad_hw=(64, 80), backend="pil")
    for _ in loader:
        break
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before


_RACE = """
import os, sys, time
import numpy as np
from posetpu_torch.utils import cuda_build
cuda_build.BUILD_DIR = sys.argv[1]
go = sys.argv[2]
while not os.path.exists(go):
    time.sleep(0.005)
from posetpu_torch.native import NativeDecoder
dec = NativeDecoder(num_threads=1)
img, wh, offs, ok = dec.decode_batch([sys.argv[3]], np.zeros((1, 2), np.float32), (72, 96))
assert ok.all() and img.any(), (wh, ok)
print("decoded", wh[0].tolist())
"""


def test_four_processes_racing_the_first_build_all_load(native, tmp_path, datasets):
    build_dir, go = tmp_path / "build", tmp_path / "go"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(build_dir), str(go),
                               datasets[0].image_path(0)],
                              cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(4)]
    go.write_text("go")  # all four start their first build at once
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "decoded [96, 72]" in out
    libs = [n for n in os.listdir(build_dir) if n.endswith(".so")]
    assert len(libs) == 1 and libs[0].startswith("decode_pool-")
    assert not [n for n in os.listdir(build_dir) if n.endswith(".tmp")]
