"""The card's decode route (posetpu_torch/native/jpeg_gpu.py, islow.py,
ycc.py, kernels/idct_islow.cu, kernels/ycc_canvas.cu) against Pillow and the
JAX package's pool.

``ycc.py``'s plain chain on libjpeg's raw planes (``pool_decode_planes`` in
the port's decode pool) gives Pillow's RGB exactly: libjpeg-turbo's fancy
upsampling and its integer YCbCr->RGB conversion.  On the CPU the route's
planes come from its own entropy decoder and the plain IDCT
(tests/test_torch_jpeg_entropy.py holds them to libjpeg's raw planes), so
the target and the tolerance reached is 0: every canvas equals Pillow's and
the JAX package's pool's exactly (the reference's own pool is held to 2.5
LSB, tests/test_native.py).  Crop windows equal the JAX package's
``NativeDecoder`` and ``load_sample`` exactly.

Cases marked ``cuda`` hold the ycc_canvas kernel to its plain version (on
the route's planes, and on random planes of every layout in misaligned
rows), the idct_islow kernel to its plain version (on the route's
coefficients, and on random blocks with the 8-bit data's extremes) and the
card's route to Pillow exactly; they skip without a card:
``python -m pytest --noconftest tests/test_torch_jpeg_gpu.py -m cuda`` on the
card.
"""

import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from posetpu.data import HostLoader as RefLoader
from posetpu.data import MpiiDataset as RefMpii
from posetpu.data import make_synthetic_dataset as ref_make
from posetpu.data.loader import load_sample as ref_load_sample
from posetpu_torch.data import HostLoader, MpiiDataset, make_batch_placer
from posetpu_torch.native import islow, jpeg_gpu, ycc
from posetpu_torch.native.jpeg_gpu import GpuJpegDecoder, jpeg_color_space
from posetpu_torch.utils.profiling import counter

_JPEGLIB = ("/usr/include/jpeglib.h", "/usr/local/include/jpeglib.h",
            "/usr/include/x86_64-linux-gnu/jpeglib.h",
            "/usr/include/aarch64-linux-gnu/jpeglib.h")

# (subsampling, width, height): every subsampling the route takes, odd
# sizes, and chroma 1 or 2 samples wide (libjpeg-turbo replicates those)
FILES = (("444", 97, 131), ("422", 50, 61), ("440", 31, 45), ("420", 161, 121),
         ("420", 160, 120), ("gray", 33, 17), ("420", 3, 2), ("422", 4, 5),
         ("440", 5, 3), ("444", 1, 1))
# the canvas at the files' sizes and beyond, and crops of every file
PADS = ((140, 170), (64, 48), (20, 20), (1, 3))


@pytest.fixture(scope="module")
def libjpeg():
    """Where the port's pool (the CPU route's planes) can build."""
    if shutil.which("g++") is None or not any(os.path.exists(p) for p in _JPEGLIB):
        pytest.skip("no g++ or no libjpeg header: the decode pool cannot build")
    from posetpu_torch.native import bindings

    return bindings


def jpeg_bytes(sub, w, h, seed, quality=92):
    """A w x h JPEG at subsampling ``sub`` (444, 422, 420, 440, gray) from
    seeded smooth content with noise.  Pillow writes no 4:4:0: a 4:2:2 file
    of the transposed image gets its frame header's sizes swapped and its
    luma sampling relabelled 1x2, a valid 4:4:0 stream of the same MCUs."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 7 % 256], -1)
    im = Image.fromarray(np.clip(base + rng.randint(-40, 40, (h, w, 3)), 0, 255)
                         .astype(np.uint8))
    kw = {}
    if sub == "gray":
        im = im.convert("L")
    else:
        kw["subsampling"] = {"444": 0, "422": 1, "420": 2, "440": 1}[sub]
    if sub == "440":
        im = im.transpose(Image.TRANSPOSE)
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=quality, **kw)
    data = bytearray(buf.getvalue())
    if sub == "440":
        i = data.find(b"\xff\xc0")
        data[i + 5:i + 9] = data[i + 7:i + 9] + data[i + 5:i + 7]
        assert data[i + 11] == 0x21
        data[i + 11] = 0x12
    return bytes(data)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpeg_gpu_files")
    paths = []
    for k, (sub, w, h) in enumerate(FILES):
        paths.append(str(d / f"{k}_{sub}_{w}x{h}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(jpeg_bytes(sub, w, h, k))
    return paths


def _centers(paths, k=0):
    """Centers near each corner and edge and inside, a fraction off the
    integers (the pool rounds half up in float32)."""
    out = []
    for i, p in enumerate(paths):
        w, h = Image.open(p).size if os.path.exists(p) else (1, 1)
        fx, fy = [(0.02, 0.02), (0.98, 0.98), (0.5, 0.99), (0.01, 0.5), (0.6, 0.4)][(i + k) % 5]
        out.append([fx * w + 0.25, fy * h + 0.5])
    return np.array(out, np.float32)


class _Files:
    def __init__(self, paths, centers):
        self.paths, self.centers = paths, centers

    def __len__(self):
        return len(self.paths)

    def image_path(self, i):
        return self.paths[i]

    def meta(self, i):
        return self.centers[i].astype(np.float64), 1.0, np.zeros((16, 2)), np.zeros(16)


def test_libjpeg_planes_give_pillows_rgb_exactly(libjpeg, files):
    for sub_wh, path in zip(FILES, files):
        color, factors, planes = libjpeg.read_planes(path)
        hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
        sampling = [(hmax // h, vmax // v) for h, v in factors]
        want_sampling = {"444": (1, 1), "422": (2, 1), "440": (1, 2), "420": (2, 2)}
        if sub_wh[0] == "gray":
            assert color == jpeg_gpu.JCS_GRAYSCALE and sampling == [(1, 1)]
        else:
            assert color == jpeg_gpu.JCS_YCBCR
            assert sampling == [(1, 1)] + [want_sampling[sub_wh[0]]] * 2, sampling
        w, h = sub_wh[1:]
        for p, (hf, vf) in zip(planes, sampling):
            assert p.shape == ycc.component_size(w, h, hf, vf)[::-1]
        got = ycc.planes_rgb([torch.from_numpy(p) for p in planes], sampling).numpy()
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("pad_hw", PADS)
def test_planes_to_canvas_equals_the_reference_pillow_canvas(libjpeg, files, pad_hw):
    centers = _centers(files, k=pad_hw[0])
    ds = _Files(files, centers)
    for i, path in enumerate(files):
        color, factors, planes = libjpeg.read_planes(path)
        hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
        sampling = [(hmax // h, vmax // v) for h, v in factors]
        canvas, wh, off = ycc.planes_to_canvas([torch.from_numpy(p) for p in planes],
                                               sampling, pad_hw, centers[i])
        want = ref_load_sample(ds, i, pad_hw)
        np.testing.assert_array_equal(wh.numpy(), want["valid_wh"])
        np.testing.assert_array_equal(off.numpy(), want["offset"])
        np.testing.assert_array_equal(canvas.numpy(), want["image"], err_msg=path)


def test_ycc_to_rgb_equals_pillow_on_its_own_ycbcr_decode(files):
    for sub_wh, path in zip(FILES, files):
        if sub_wh[0] == "gray":
            continue
        im = Image.open(path)
        im.draft("YCbCr", im.size)
        ycbcr = np.asarray(im)
        assert im.mode == "YCbCr"
        got = ycc.ycc_to_rgb(*(torch.from_numpy(ycbcr[..., c].copy()) for c in range(3)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(Image.open(path).convert("RGB")))


def test_fancy_upsample_edges():
    """The triangle filter's biases and edges on a hand-made plane, and
    libjpeg-turbo's replication of chroma 1 or 2 samples wide."""
    p = torch.tensor([[0, 100, 200], [40, 40, 255]], dtype=torch.uint8)
    # h2v1: (3 * near + far + 1 or 2) >> 2, each edge its own sample
    np.testing.assert_array_equal(
        ycc.fancy_upsample(p, 2, 1, 6, 2).numpy()[0], [0, 25, 75, 125, 175, 200])
    # h1v2: rows 0 and 3 take row 0 and row 1 as their own context
    np.testing.assert_array_equal(
        ycc.fancy_upsample(p, 1, 2, 3, 4).numpy()[:, 0], [0, 10, 30, 40])
    # h2v2 at the corner: (4 * 3 * p + 8) >> 4 keeps the sample
    assert int(ycc.fancy_upsample(p, 2, 2, 6, 4)[0, 0]) == 0
    assert int(ycc.fancy_upsample(p, 2, 2, 6, 4)[3, 5]) == 255
    narrow = torch.tensor([[10, 250]], dtype=torch.uint8)
    np.testing.assert_array_equal(ycc.fancy_upsample(narrow, 2, 2, 4, 2).numpy(),
                                  [[10, 10, 250, 250]] * 2)


def test_jpeg_color_space_follows_libjpeg(libjpeg, files, tmp_path):
    rgb, cmyk = str(tmp_path / "rgb.jpg"), str(tmp_path / "cmyk.jpg")
    Image.fromarray(np.full((9, 11, 3), 77, np.uint8)).save(rgb, keep_rgb=True)
    Image.fromarray(np.full((9, 11, 4), 77, np.uint8), "CMYK").save(cmyk)
    for path in [*files, rgb, cmyk]:
        with open(path, "rb") as f:
            got = jpeg_color_space(f.read())
        assert got == libjpeg.read_planes(path)[0], path
    assert jpeg_color_space(b"\x89PNG\r\n") is None


def test_decoder_matches_the_jax_pool_and_pillow(libjpeg, files, tmp_path):
    """decode_batch's windows and images equal the JAX package's pool's and
    Pillow's exactly; a PNG, an RGB-coded and a CMYK JPEG and a missing file
    read all zero with ok False (the loader's Pillow path takes them), each
    counted as refused."""
    from posetpu.native import NativeDecoder as RefDecoder
    from posetpu.native import native_available

    if not native_available():
        pytest.skip("the JAX package's pool does not build here")
    png, rgb, cmyk = (str(tmp_path / n) for n in ("x.png", "rgb.jpg", "cmyk.jpg"))
    Image.fromarray(np.full((9, 11, 3), 77, np.uint8)).save(png)
    Image.fromarray(np.full((9, 11, 3), 77, np.uint8)).save(rgb, keep_rgb=True)
    Image.fromarray(np.full((9, 11, 4), 77, np.uint8), "CMYK").save(cmyk)
    paths = [*files, png, rgb, str(tmp_path / "missing.jpg"), cmyk]
    dec, ref = GpuJpegDecoder("cpu"), RefDecoder(num_threads=2)
    for pad_hw in PADS:
        centers = _centers(paths, k=pad_hw[1])
        out = np.full((len(paths), *pad_hw, 3), 255, np.uint8)
        images, wh, offs, ok = dec.decode_batch(paths, centers, pad_hw, out=out)
        assert images is out
        assert ok.tolist() == [True] * len(files) + [False] * 4
        assert dec.refused == 4 * (PADS.index(pad_hw) + 1)
        assert not images[len(files):].any() and not wh[len(files):].any()
        r_images, r_wh, r_offs, r_ok = ref.decode_batch(files, centers[:len(files)], pad_hw)
        assert r_ok.all()
        np.testing.assert_array_equal(images[:len(files)], r_images)
        np.testing.assert_array_equal(wh[:len(files)], r_wh)
        np.testing.assert_array_equal(offs[:len(files)], r_offs)
        ds = _Files(paths, centers)
        for i in range(len(files)):
            np.testing.assert_array_equal(images[i], ref_load_sample(ds, i, pad_hw)["image"])
    ref.close()
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        dec.decode_batch(files[:2], _centers(files[:2]), (8, 8), out=np.zeros((2, 8, 8, 3)))
    with pytest.raises(ValueError, match="centers"):
        dec.decode_batch(files[:2], np.zeros((3, 2)), (8, 8))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A split with a PNG among its JPEGs."""
    root = tmp_path_factory.mktemp("jpeg_gpu_split")
    ref_make(str(root), num_train=9, num_val=0, res=(96, 72), seed=4)
    ann = root / "annotations.json"
    raw = json.loads(ann.read_text())
    im = Image.open(root / "images" / raw[2]["img_paths"]).convert("RGB")
    im.save(root / "images" / "as.png")
    raw[2]["img_paths"] = "as.png"
    ann.write_text(json.dumps(raw))
    return str(ann), str(root / "images")


@pytest.mark.parametrize("pad_hw", [(40, 48), (72, 96)])
def test_loader_gpu_cpu_route_equals_the_reference_pillow_loader(split, pad_hw):
    """Two epochs of HostLoader(backend="gpu") on the CPU route against
    the JAX package's HostLoader(backend="pil"), key for key: images
    exactly (the tolerance reached: 0), the PNG through the Pillow path."""
    ds, ref = MpiiDataset(*split), RefMpii(*split)
    kw = dict(pad_hw=pad_hw, seed=5)
    port = HostLoader(ds, 3, backend="gpu", device="cpu", **kw)
    want_loader = RefLoader(ref, 3, backend="pil", **kw)
    assert port.backend == "gpu"
    seen_png = False
    for _ in range(2):
        for g, w in zip(port, want_loader):
            assert list(g) == list(w)
            for k, v in w.items():
                assert np.asarray(g[k]).dtype == v.dtype, k
                np.testing.assert_array_equal(np.asarray(g[k]), v, err_msg=k)
            seen_png |= 2 in g["index"]
    assert seen_png
    placed = HostLoader(ds, 3, backend="gpu", place=make_batch_placer("cpu"), **kw)
    assert placed.backend == "gpu"


def test_a_missing_file_raises_as_the_reference_does(split, tmp_path):
    """A missing file goes to the Pillow path, which raises as the JAX
    package's Pillow loader does."""
    ann, images = split
    raw = json.loads(open(ann).read())
    raw[0]["img_paths"] = "missing.jpg"
    bad = tmp_path / "annotations.json"
    bad.write_text(json.dumps(raw))
    ds, ref = MpiiDataset(str(bad), images), RefMpii(str(bad), images)
    port = HostLoader(ds, 9, pad_hw=(72, 96), shuffle=False, backend="gpu", device="cpu")
    want_loader = RefLoader(ref, 9, pad_hw=(72, 96), shuffle=False, backend="pil")
    with pytest.raises(FileNotFoundError) as want:
        next(iter(want_loader))
    with pytest.raises(FileNotFoundError) as got:
        next(iter(port))
    assert os.path.basename(got.value.filename) == os.path.basename(want.value.filename)


def test_without_cuda_the_route_raises_and_auto_is_unchanged(split, monkeypatch):
    from posetpu_torch.native import bindings

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GpuJpegDecoder()
    ds = MpiiDataset(*split)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HostLoader(ds, 3, backend="gpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HostLoader(ds, 3, backend="auto", device="cuda")
    # no placer, or a CPU one: the pool where it builds, else Pillow
    builds = True
    try:
        bindings.POOL.load()
    except RuntimeError:
        builds = False
    want = "native" if builds else "pil"
    assert HostLoader(ds, 3).backend == want
    assert HostLoader(ds, 3, place=make_batch_placer("cpu")).backend == want
    assert HostLoader(ds, 3, device="cpu").backend == want

    def no_pool(*a, **k):
        raise RuntimeError("no libjpeg")

    monkeypatch.setattr("posetpu_torch.native.NativeDecoder", no_pool)
    assert HostLoader(ds, 3, place=make_batch_placer("cpu")).backend == "pil"
    with pytest.raises(ValueError, match="unknown backend"):
        HostLoader(ds, 3, backend="turbo")


def test_ycc_canvas_cpu_is_the_plain_version_and_refuses_bad_input(libjpeg, files):
    _, factors, planes = libjpeg.read_planes(files[3])
    planes = tuple(torch.from_numpy(p) for p in planes)
    sampling = [(1, 1), (2, 2), (2, 2)]
    H, W = planes[0].shape
    windows = np.array([[3, 5, 40, 30], [0, 0, 0, 0]])
    got = ycc.ycc_canvas([planes, ()], [sampling, ()], windows, (32, 48))
    assert got.shape == (2, 32, 48, 3) and not got[1].any()
    np.testing.assert_array_equal(
        got[0].numpy(), ycc.window_canvas(planes, sampling, windows[0], (32, 48)).numpy())
    assert counter(ycc.YCC_LAUNCHES) == 0  # the plain version launches nothing
    with pytest.raises(ValueError, match="CUDA"):
        ycc.ycc_canvas_cuda([planes], [sampling], windows[:1], (32, 48))


# every component layout the kernel takes: the luma's (1, 1), then each
# chroma plane's (h, v); the last two mix factors between the chroma planes
LAYOUTS = {"444": [(1, 1)] * 3, "422": [(1, 1), (2, 1), (2, 1)],
           "440": [(1, 1), (1, 2), (1, 2)], "420": [(1, 1), (2, 2), (2, 2)],
           "gray": [(1, 1)], "420/440": [(1, 1), (2, 2), (1, 2)],
           "422/444": [(1, 1), (2, 1), (1, 1)]}
# image sizes: chroma 1 or 2 samples wide at h = 2 (replicated), odd sizes,
# wider than the kernel's 256-column tiles
SIZES = ((1, 1), (3, 2), (4, 5), (33, 17), (161, 121), (300, 20), (520, 19))
# canvases: pw a multiple of 16 (rows on 16-byte boundaries), pw % 16 == 8,
# odd (rows off 4-byte alignment), across two and three column tiles
KERNEL_PADS = ((40, 48), (24, 600), (17, 53), (9, 261), (121, 530))


def _plane_in(arr, device, extra=0, base=0):
    """``arr`` (h, w) uint8 in rows of pitch w + ``extra`` bytes, the first
    row ``base`` bytes past an allocation's (16-byte aligned) start: a
    (h, w) view."""
    h, w = arr.shape
    pitch = w + extra
    buf = torch.zeros(base + pitch * h + 16, dtype=torch.uint8, device=device)
    view = buf[base:base + pitch * h].view(h, pitch)[:, :w]
    view.copy_(torch.from_numpy(arr))
    return view


def _random_batch(rng, device, pad_hw, misaligned):
    """Random planes of every layout and size, each with a random window
    inside the image and the canvas (odd offsets among them), then a slot
    with planes and a (0, 0) window and a slot without planes.  With
    ``misaligned`` the rows have odd pitches and bases off 16-byte
    alignment."""
    ph, pw = pad_hw
    planes, samplings, windows = [], [], []
    for samp in LAYOUTS.values():
        for W, H in SIZES:
            pl = []
            for hf, vf in samp:
                w, h = ycc.component_size(W, H, hf, vf)
                # the extremes too, so the conversion clamps
                arr = rng.choice([0, 1, 127, 128, 254, 255, *range(256)], (h, w)).astype(np.uint8)
                pl.append(_plane_in(arr, device, 2 * rng.randint(0, 20) + 1, rng.randint(1, 16))
                          if misaligned else _plane_in(arr, device))
            vw, vh = rng.randint(1, min(W, pw) + 1), rng.randint(1, min(H, ph) + 1)
            planes.append(tuple(pl))
            samplings.append(samp)
            windows.append((rng.randint(0, W - vw + 1), rng.randint(0, H - vh + 1), vw, vh))
    planes += [planes[0], ()]
    samplings += [samplings[0], ()]
    windows += [(0, 0, 0, 0)] * 2
    return planes, samplings, np.array(windows, np.int64)


def test_descriptors_are_the_documented_words():
    """ycc_canvas.cu's descriptor, word for word, for every layout, odd
    pitches and bases, grayscale, and (0, 0) windows (with and without
    planes: an all-zero row)."""
    planes, samplings, windows = _random_batch(np.random.RandomState(3), "cpu", (121, 530),
                                               misaligned=True)
    desc = ycc.descriptors(planes, samplings, windows, (121, 530), torch.device("cpu"))
    assert desc.dtype == np.int64 and desc.shape == (len(planes), ycc.DESC_WORDS)
    assert {len(pl) for pl in planes} == {0, 1, 3}
    assert any(w[0] % 2 and w[1] % 2 for w in windows)
    for d, pl, samp, win in zip(desc, planes, samplings, windows):
        want = [0] * ycc.DESC_WORDS
        if win[2] > 0:
            for c, (p, (hf, vf)) in enumerate(zip(pl, samp)):
                want[c], want[3 + c] = p.data_ptr(), p.stride(0)
                want[6 + c], want[9 + c] = p.shape[1], p.shape[0]
                want[12 + c], want[15 + c] = hf, vf
            want[18] = len(pl)
            want[19:23] = win.tolist()
        assert d.tolist() == want


def test_ycc_canvas_refuses_what_the_kernel_does_not_take():
    """Every input the kernel's wrapper refuses, checked without a card."""
    cpu = torch.device("cpu")
    planes, samplings, windows = _random_batch(np.random.RandomState(4), "cpu", (40, 48), False)
    i = list(LAYOUTS).index("420") * len(SIZES) + SIZES.index((33, 17))
    pl, samp, win = list(planes[i]), samplings[i], windows[i:i + 1]

    def refused(match, pl=pl, samp=samp, win=win, device=cpu):
        with pytest.raises(ValueError, match=match):
            ycc.descriptors([tuple(pl)], [samp], win, (40, 48), device)

    ycc.descriptors([tuple(pl)], [samp], win, (40, 48), cpu)  # the unchanged inputs pass
    refused("bad planes/sampling", pl=pl[:2], samp=samp[:2])
    refused("bad planes/sampling", samp=samp[:2])
    refused("bad planes/sampling", samp=[(2, 1)] + samp[1:])
    refused("one CUDA device", device=torch.device("cuda", 0))
    refused("2-D uint8", pl=[pl[0]] + [pl[1].to(torch.int16), pl[2]])
    refused("2-D uint8", pl=[pl[0][None]] + pl[1:])
    refused("2-D uint8", pl=[pl[0]] + [torch.zeros(9, 34, dtype=torch.uint8)[:, ::2], pl[2]])
    refused("upsampling factors", samp=[(1, 1), (3, 2), (2, 2)])
    refused("component of shape", pl=[pl[0], pl[1][:, :-1], pl[2]])
    for bad in ([-1, 0, 5, 5], [0, 0, 34, 17], [30, 0, 4, 5], [0, 14, 5, 4]):
        refused("outside", win=np.array([bad]))
    # a window inside its image but wider than the canvas
    wide = [torch.zeros(9, 60, dtype=torch.uint8), *(torch.zeros(5, 30, dtype=torch.uint8),) * 2]
    ycc.descriptors([tuple(wide)], [samp], np.array([[0, 0, 48, 9]]), (40, 48), cpu)
    refused("outside", pl=wide, win=np.array([[0, 0, 49, 9]]))
    # a (0, 0) window's planes are not read, so not checked
    ycc.descriptors([(torch.zeros(3, dtype=torch.int16),)], [()], np.zeros((1, 4)), (4, 4), cpu)
    with pytest.raises(ValueError, match="CUDA"):
        ycc.ycc_canvas_cuda([tuple(pl)], [samp], win, (40, 48))
    for out in (torch.zeros(1, 40, 48, 3), torch.zeros(1, 40, 47, 3, dtype=torch.uint8),
                torch.zeros(1, 48, 40, 3, dtype=torch.uint8).transpose(1, 2)):
        with pytest.raises(ValueError, match="out must be"):
            ycc.canvas_out(out, (1, 40, 48, 3), cpu)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("pad_hw", KERNEL_PADS)
def test_cuda_kernel_equals_the_plain_version_on_every_layout_and_alignment(pad_hw):
    """On the card: random planes of every layout and size, in rows with
    and without odd pitches and bases off 16-byte alignment, windows with
    odd offsets and (0, 0) slots, into canvases whose rows start anywhere:
    the kernel against the plain version bit for bit, one launch a batch."""
    _cuda()
    rng = np.random.RandomState(pad_hw[1])
    for misaligned in (False, True):
        planes, samplings, windows = _random_batch(rng, "cuda", pad_hw, misaligned)
        before = counter(ycc.YCC_LAUNCHES)
        got = ycc.ycc_canvas(planes, samplings, windows, pad_hw)
        torch.cuda.synchronize()
        assert counter(ycc.YCC_LAUNCHES) == before + 1
        for i, (pl, samp, win) in enumerate(zip(planes, samplings, windows)):
            want = ycc.window_canvas(pl, samp, win, pad_hw) if pl else torch.zeros_like(got[i])
            assert torch.equal(got[i], want), (i, samp, win.tolist(), misaligned)


@pytest.mark.cuda
def test_cuda_wrapper_reuses_its_pinned_descriptors_safely():
    """On the card: back-to-back calls on a stream held by a sleep kernel,
    and calls from two threads on their own streams, each with its own
    windows: every canvas is its own call's (no slot of pinned descriptors
    is rewritten before its copy and its kernel have run)."""
    import threading

    _cuda()
    pad = (40, 48)
    planes, samplings, windows = _random_batch(np.random.RandomState(7), "cuda", pad, True)
    rng = np.random.RandomState(8)
    calls = []
    for _ in range(6):
        w = windows.copy()
        w[:, 2:] = np.maximum(w[:, 2:] - rng.randint(0, 3, w[:, 2:].shape), 0) * (w[:, 2:] > 0)
        calls.append(w)

    def want(w):
        return torch.stack([ycc.window_canvas(pl, s, x, pad) if pl and x[2] > 0 and x[3] > 0
                            else torch.zeros((*pad, 3), dtype=torch.uint8, device="cuda")
                            for pl, s, x in zip(planes, samplings, w)])

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(50_000_000)
        outs = [ycc.ycc_canvas(planes, samplings, w, pad) for w in calls]
    stream.synchronize()
    for w, got in zip(calls, outs):
        assert torch.equal(got, want(w))

    results = {}

    def worker(k):
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            results[k] = [ycc.ycc_canvas(planes, samplings, w, pad) for w in calls[k::2]]
        s.synchronize()

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k in range(2):
        for w, got in zip(calls[k::2], results[k]):
            assert torch.equal(got, want(w))


@pytest.mark.cuda
def test_cuda_kernel_equals_the_plain_version_on_the_routes_planes(files):
    """On the card: the route's planes of every file, the kernel against the
    plain version on the same planes, bit for bit, one launch a batch."""
    _cuda()
    dec = GpuJpegDecoder("cuda")
    planes, samplings = dec.decode_planes(files)
    assert all(planes)
    for pad_hw in PADS:
        centers = _centers(files, k=pad_hw[0])
        windows = np.array([ycc.crop_window(pl[0].shape[1], pl[0].shape[0], c, pad_hw)
                            for pl, c in zip(planes, centers)])
        before = counter(ycc.YCC_LAUNCHES)
        got = ycc.ycc_canvas(planes, samplings, windows, pad_hw)
        torch.cuda.synchronize()
        assert got.is_cuda and counter(ycc.YCC_LAUNCHES) == before + 1
        want = torch.stack([ycc.planes_to_canvas(pl, s, pad_hw, c)[0]
                            for pl, s, c in zip(planes, samplings, centers)])
        assert torch.equal(got, want)
    dec.close()


def _idct_on_card(coefs, desc, sizes):
    """The kernel's planes of ``coefs`` (a CPU int16 buffer) in rows of odd
    pitch, one launch, and the plain version's on the CPU."""
    dev = coefs.cuda()
    planes = [torch.full((h, w + 3), 7, dtype=torch.uint8, device="cuda")[:, 1:w + 1]
              for w, h in sizes]
    before = counter(islow.IDCT_LAUNCHES)
    islow.idct_islow(dev, dev, desc, planes)
    torch.cuda.synchronize()
    assert counter(islow.IDCT_LAUNCHES) == before + 1
    want = [torch.empty((h, w), dtype=torch.uint8) for w, h in sizes]
    islow.idct_islow(coefs, coefs, desc, want)
    return planes, want


@pytest.mark.cuda
def test_cuda_idct_equals_the_plain_version_on_the_routes_coefficients(files):
    """On the card: every file's coefficients, the kernel against the plain
    version bit for bit, one launch for the batch."""
    _cuda()
    co = GpuJpegDecoder("cpu").coefficients(files)
    got, want = _idct_on_card(co.buffer, co.desc, co.sizes)
    for g, w, f in zip(got, want, co.files):
        assert torch.equal(g.cpu(), w), f


@pytest.mark.cuda
def test_cuda_idct_equals_the_plain_version_on_extreme_blocks():
    """On the card: random blocks with coefficients at +-2047 and all-zero
    AC columns, tables up to 255, grids wider than their planes."""
    _cuda()
    rng = np.random.RandomState(5)
    grids = [(7, 5, 50, 37), (3, 9, 17, 72), (1, 1, 1, 1), (40, 2, 313, 9)]
    sizes, desc, at, chunks = [], [], 0, []
    for bw, bh, w, h in grids:
        q = rng.randint(1, 256, 64)
        blocks = rng.choice([-2047, 2047, 0, 1, -1, *range(-300, 300)], (bw * bh, 64))
        blocks[::2, 8:] = 0
        chunks += [q, blocks.ravel()]
        desc.append((at + 64, at, bw, bh))
        at += 64 + blocks.size
        sizes.append((w, h))
    coefs = torch.from_numpy(np.concatenate(chunks).astype(np.int16))
    got, want = _idct_on_card(coefs, desc, sizes)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_cuda_route_against_pillow(files, tmp_path):
    """On the card: the whole route's windows and images equal Pillow's
    exactly; a PNG reads ok False and is counted."""
    _cuda()
    png = str(tmp_path / "x.png")
    Image.fromarray(np.full((9, 11, 3), 77, np.uint8)).save(png)
    paths = [*files, png]
    dec = GpuJpegDecoder("cuda")
    for pad_hw in PADS:
        centers = _centers(paths, k=pad_hw[1])
        out = torch.empty((len(paths), *pad_hw, 3), dtype=torch.uint8, pin_memory=True)
        images, wh, offs, ok = dec.decode_batch(paths, centers, pad_hw, out=out.numpy())
        assert ok.tolist() == [True] * len(files) + [False]
        ds = _Files(paths, centers)
        for i in range(len(files)):
            want = ref_load_sample(ds, i, pad_hw)
            np.testing.assert_array_equal(wh[i], want["valid_wh"])
            np.testing.assert_array_equal(offs[i], want["offset"])
            np.testing.assert_array_equal(images[i], want["image"], err_msg=paths[i])
        assert not images[-1].any()
    assert dec.refused == len(PADS)
    dec.close()
