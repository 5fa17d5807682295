"""The card route's hand-written entropy decoder
(posetpu_torch/native/jpeg_entropy.cpp) and the plain IDCT
(posetpu_torch/native/islow.py) against libjpeg and the JAX package.

Every file is written by Pillow from seeded numpy arrays.  The hand decoder
plus the plain ``islow`` must give the planes libjpeg's raw output gives
(``bindings.read_planes``: libjpeg-turbo's decode before upsampling and
color conversion) bit for bit, at every subsampling the route takes, odd
sizes, qualities 50 to 100 (a noise image at 100 drives the range limit's
clamps), optimised Huffman tables and restart markers.  Files the route
refuses read ``ok`` False, are counted, and reach the JAX package's Pillow
loader's answer through the port's loader.  The ctypes signatures are
parsed from the C sources.  The plain IDCT is also held to its definition
on hand-made blocks and to its range-limit table.
"""

import ctypes
import io
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch
from PIL import Image, ImageFile

from posetpu.data import HostLoader as RefLoader
from posetpu.data import MpiiDataset as RefMpii
from posetpu.data import make_synthetic_dataset as ref_make
from posetpu.data.loader import load_sample as ref_load_sample
from posetpu_torch.data import HostLoader, MpiiDataset
from posetpu_torch.native import islow, jpeg_gpu
from posetpu_torch.native.jpeg_gpu import GpuJpegDecoder

_JPEGLIB = ("/usr/include/jpeglib.h", "/usr/local/include/jpeglib.h",
            "/usr/include/x86_64-linux-gnu/jpeglib.h",
            "/usr/include/aarch64-linux-gnu/jpeglib.h")

SUBSAMPLINGS = ("444", "422", "440", "420", "gray")
SIZES = ((1, 1), (3, 2), (4, 5), (17, 33), (161, 121))
QUALITIES = (50, 75, 92, 100)


@pytest.fixture(scope="module")
def libjpeg():
    """libjpeg's raw planes, the oracle (the port's pool, g++ and libjpeg)."""
    if shutil.which("g++") is None or not any(os.path.exists(p) for p in _JPEGLIB):
        pytest.skip("no g++ or no libjpeg header: the oracle cannot build")
    from posetpu_torch.native import bindings

    return bindings


@pytest.fixture(scope="module")
def decoder():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the entropy decoder cannot build")
    dec = GpuJpegDecoder("cpu", num_threads=2)
    yield dec
    dec.close()


def jpeg_bytes(sub, w, h, seed, quality=92, noise=False, **kw):
    """A w x h JPEG at subsampling ``sub`` from seeded content: a smooth
    gradient with noise, or (``noise``) uniform noise.  Pillow writes no
    4:4:0: a 4:2:2 file of the transposed image gets its frame header's
    sizes swapped and its luma sampling relabelled 1x2, a valid 4:4:0
    stream of the same MCUs."""
    rng = np.random.RandomState(seed)
    if noise:
        arr = rng.randint(0, 256, (h, w, 3))
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                         (xx + yy) * 7 % 256], -1)
        arr = np.clip(base + rng.randint(-40, 40, (h, w, 3)), 0, 255)
    im = Image.fromarray(arr.astype(np.uint8))
    if sub == "gray":
        im = im.convert("L")
    else:
        kw["subsampling"] = {"444": 0, "422": 1, "420": 2, "440": 1}[sub]
    if sub == "440":
        im = im.transpose(Image.TRANSPOSE)
    buf = io.BytesIO()
    # optimize=True needs the whole stream in Pillow's buffer
    saved = ImageFile.MAXBLOCK
    ImageFile.MAXBLOCK = max(saved, 1 << 22)
    try:
        im.save(buf, "JPEG", quality=quality, **kw)
    finally:
        ImageFile.MAXBLOCK = saved
    data = bytearray(buf.getvalue())
    if sub == "440":
        i = data.find(b"\xff\xc0")
        data[i + 5:i + 9] = data[i + 7:i + 9] + data[i + 5:i + 7]
        assert data[i + 11] == 0x21
        data[i + 11] = 0x12
    return bytes(data)


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _planes(decoder, path):
    """The hand decoder's coefficients through the plain IDCT: the file's
    planes, or its status when the route refuses it."""
    co = decoder.coefficients([path])
    if co.headers[0] is None:
        return int(co.statuses[0])
    planes = [torch.empty((h, w), dtype=torch.uint8) for w, h in co.sizes]
    islow.idct_islow(co.buffer, co.buffer, co.desc, planes)
    return [p.numpy() for p in planes]


def _assert_libjpegs_planes(libjpeg, decoder, path):
    got = _planes(decoder, path)
    assert not isinstance(got, int), f"refused with {jpeg_gpu.JPE_STATUSES[got]}"
    want = libjpeg.read_planes(path)[2]
    assert [p.shape for p in got] == [p.shape for p in want]
    for c, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"component {c}")


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sub", SUBSAMPLINGS)
def test_planes_equal_libjpegs_raw_planes(libjpeg, decoder, tmp_path, sub, size, quality):
    """Every subsampling, size and quality: smooth content with noise, and
    (at quality 100, where the IDCT overshoots the range) uniform noise."""
    w, h = size
    seed = SIZES.index(size) * 10 + QUALITIES.index(quality)
    _assert_libjpegs_planes(libjpeg, decoder,
                            _write(tmp_path, "f.jpg", jpeg_bytes(sub, w, h, seed, quality)))
    if quality == 100:
        _assert_libjpegs_planes(libjpeg, decoder, _write(
            tmp_path, "n.jpg", jpeg_bytes(sub, w, h, seed, quality, noise=True)))


@pytest.mark.parametrize("sub", SUBSAMPLINGS)
@pytest.mark.parametrize("option", [{"optimize": True}, {"restart_marker_blocks": 3},
                                    {"restart_marker_rows": 1}],
                         ids=["optimize", "restart_blocks", "restart_rows"])
def test_optimised_tables_and_restart_markers(libjpeg, decoder, tmp_path, sub, option):
    """Huffman tables of the image's own statistics, and restart intervals
    of 3 MCUs and of one MCU row (the predictors and the bit reader reset
    at each RSTn)."""
    for k, (w, h) in enumerate(((161, 121), (67, 45))):
        data = jpeg_bytes(sub, w, h, 50 + k, 85, noise=k == 1, **option)
        if "optimize" not in option:
            assert data.count(b"\xff\xdd") == 1 and b"\xff\xd1" in data
        _assert_libjpegs_planes(libjpeg, decoder, _write(tmp_path, f"{k}.jpg", data))


def test_16_bit_quantisation_tables(libjpeg, decoder, tmp_path):
    """A DQT rewritten with 16-bit entries of the same values decodes as
    the 8-bit one does."""
    data = bytearray(jpeg_bytes("420", 41, 29, 3, 60))
    i = data.find(b"\xff\xdb")
    length = int.from_bytes(data[i + 2:i + 4], "big")
    seg, out, j = data[i + 4:i + 2 + length], bytearray(), 0
    while j < len(seg):
        out.append(0x10 | (seg[j] & 15))
        out += b"".join(int(v).to_bytes(2, "big") for v in seg[j + 1:j + 65])
        j += 65
    data[i:i + 2 + length] = b"\xff\xdb" + (len(out) + 2).to_bytes(2, "big") + out
    _assert_libjpegs_planes(libjpeg, decoder, _write(tmp_path, "q16.jpg", bytes(data)))


def test_info_words_describe_the_grids_and_planes(decoder):
    """jpe_info's words for a 4:2:0 161x121 file: MCU-padded grids (11 x 8
    MCUs of 16x16), stored plane sizes libjpeg's."""
    data = jpeg_bytes("420", 161, 121, 0)
    info = np.zeros(jpeg_gpu.INFO_WORDS, np.int32)
    st = decoder._lib.jpe_info(data, len(data), info.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    assert st == 0
    assert info.tolist() == [161, 121, 3, 2, 2, 22, 16, 161, 121, 1, 1, 11, 8, 81, 61,
                             1, 1, 11, 8, 81, 61]
    gray = jpeg_bytes("gray", 17, 33, 0)
    st = decoder._lib.jpe_info(gray, len(gray), info.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    assert st == 0 and info.tolist()[:9] == [17, 33, 1, 1, 1, 3, 5, 17, 33]


def _set_sof(data, **fields):
    """``data`` with its SOF0 rewritten: marker, precision, height, width,
    or the sampling byte of component ``k`` (``samp=(k, byte)``)."""
    d = bytearray(data)
    i = d.find(b"\xff\xc0")
    if "marker" in fields:
        d[i + 1] = fields["marker"]
    if "precision" in fields:
        d[i + 4] = fields["precision"]
    if "height" in fields:
        d[i + 5:i + 7] = fields["height"].to_bytes(2, "big")
    if "width" in fields:
        d[i + 7:i + 9] = fields["width"].to_bytes(2, "big")
    if "samp" in fields:
        k, byte = fields["samp"]
        d[i + 11 + 3 * k] = byte
    return bytes(d)


def _refusals():
    """(name, file bytes, status): one file for each way the route refuses."""
    base = jpeg_bytes("420", 40, 30, 7, 90)
    rst = jpeg_bytes("444", 40, 30, 8, 90, restart_marker_blocks=2)
    eoi = base.rindex(b"\xff\xd9")
    buf = io.BytesIO()
    Image.fromarray(np.full((20, 24, 3), 90, np.uint8)).save(buf, "JPEG", progressive=True)
    cmyk = io.BytesIO()
    Image.fromarray(np.full((9, 11, 4), 77, np.uint8), "CMYK").save(cmyk, "JPEG")
    return [
        ("not_jpeg", b"\x89PNG\r\n\x1a\n" + bytes(40), "not_jpeg"),
        ("progressive", buf.getvalue(), "progressive"),
        ("arithmetic", _set_sof(base, marker=0xC9), "arithmetic"),
        ("lossless", _set_sof(base, marker=0xC3), "lossless"),
        ("12_bit", _set_sof(base, precision=12), "precision"),
        ("cmyk", cmyk.getvalue(), "components"),
        ("4_1_1", _set_sof(base, samp=(0, 0x41)), "sampling"),
        ("dnl_height", _set_sof(base, height=0), "dnl"),
        ("forged_size", _set_sof(base, height=60000, width=60000), "dimensions"),
        ("truncated", base[:len(base) // 2], "corrupt"),
        ("no_eoi", base[:eoi], "corrupt"),
        ("extraneous_bytes", base[:eoi] + b"\x00\x00" + base[eoi:], "corrupt"),
        ("restart_out_of_turn", rst.replace(b"\xff\xd1", b"\xff\xd3", 1), "corrupt"),
        ("second_scan", base[:eoi] + base[base.index(b"\xff\xda"):], "scans"),
    ]


@pytest.mark.parametrize("case", range(len(_refusals())),
                         ids=[r[0] for r in _refusals()])
def test_refused_files_have_their_own_status(decoder, tmp_path, case):
    name, data, status = _refusals()[case]
    path = _write(tmp_path, f"{name}.jpg", data)
    before = decoder.refused
    assert _planes(decoder, path) == jpeg_gpu.JPE_STATUSES.index(status)
    assert decoder.refused == before + 1
    images, wh, offs, ok = decoder.decode_batch([path], np.zeros((1, 2), np.float32), (16, 16))
    assert not ok[0] and not images.any() and not wh.any()


def test_forged_size_is_refused_before_anything_is_allocated(decoder):
    """A header that claims more blocks than its bytes can code (2 bits a
    block at least) is refused by jpe_info, which sizes the buffers."""
    data = _set_sof(jpeg_bytes("gray", 16, 16, 0), height=65500, width=65500)
    info = np.zeros(jpeg_gpu.INFO_WORDS, np.int32)
    st = decoder._lib.jpe_info(data, len(data), info.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    assert jpeg_gpu.JPE_STATUSES[st] == "dimensions"


@pytest.fixture(scope="module")
def refused_split(tmp_path_factory):
    """Seven 96x72 frames, then a progressive file, a file whose restart
    markers come out of turn and one with bytes before its EOI (the route
    refuses them; Pillow decodes them), a truncated file and a forged-size
    header (Pillow raises on them)."""
    root = tmp_path_factory.mktemp("refused_split")
    ref_make(str(root), num_train=12, num_val=0, res=(96, 72), seed=3)
    ann = root / "annotations.json"
    raw = json.loads(ann.read_text())
    images = root / "images"
    rng = np.random.RandomState(0)
    frame = Image.fromarray(rng.randint(0, 256, (72, 96, 3)).astype(np.uint8))
    frame.save(images / "prog.jpg", progressive=True)
    refusals = dict((n, d) for n, d, _ in _refusals())
    for k, name in enumerate(("progressive", "restart_out_of_turn", "extraneous_bytes",
                              "truncated", "forged_size")):
        path = "prog.jpg" if name == "progressive" else f"{name}.jpg"
        if name != "progressive":
            (images / path).write_bytes(refusals[name])
        raw[7 + k]["img_paths"] = path
    ann.write_text(json.dumps(raw))
    return str(ann), str(images)


def test_refused_rows_equal_the_reference_pillow_loader(decoder, refused_split):
    """Through HostLoader(backend="gpu") on the CPU route: the three files
    Pillow decodes go through the Pillow row and equal the JAX package's
    Pillow loader key for key; each is counted as refused."""
    ann, images = refused_split
    ds, ref = MpiiDataset(ann, images), RefMpii(ann, images)
    keep = list(range(10))
    kw = dict(pad_hw=(64, 80), shuffle=False, drop_last=False)
    port = HostLoader(_Subset(ds, keep), 5, backend="gpu", device="cpu", **kw)
    want = RefLoader(_Subset(ref, keep), 5, backend="pil", **kw)
    assert port.backend == "gpu"
    got = list(port)
    assert port.decoder.refused == 3
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            np.testing.assert_array_equal(np.asarray(g[k]), v, err_msg=k)


@pytest.mark.parametrize("index", [10, 11])
def test_files_pillow_cannot_decode_raise_as_the_reference_does(decoder, refused_split, index):
    """A truncated file and a forged-size header: refused by the route,
    then the Pillow row raises what the JAX package's Pillow loader
    raises."""
    ann, images = refused_split
    ds, ref = MpiiDataset(ann, images), RefMpii(ann, images)
    kw = dict(pad_hw=(64, 80), shuffle=False, drop_last=False)
    with pytest.raises(Exception) as want:
        next(iter(RefLoader(_Subset(ref, [index]), 1, backend="pil", **kw)))
    with pytest.raises(Exception) as got:
        next(iter(HostLoader(_Subset(ds, [index]), 1, backend="gpu", device="cpu", **kw)))
    assert type(got.value) is type(want.value)


class _Subset:
    """A dataset's items ``keep``, in order."""

    def __init__(self, ds, keep):
        self.ds, self.keep = ds, list(keep)

    def __len__(self):
        return len(self.keep)

    def image_path(self, i):
        return self.ds.image_path(self.keep[i])

    def meta(self, i):
        return self.ds.meta(self.keep[i])


def test_the_cpu_route_equals_the_jax_pool_and_pillow_exactly(decoder, tmp_path):
    """GpuJpegDecoder("cpu") at 1 and 3 threads: images, windows and
    offsets equal the JAX package's pool's and its Pillow load_sample's."""
    from posetpu.native import NativeDecoder as RefDecoder
    from posetpu.native import native_available

    paths = [_write(tmp_path, f"{k}.jpg", jpeg_bytes(sub, w, h, k, q, noise=k % 2 == 1))
             for k, (sub, (w, h), q) in enumerate(zip(SUBSAMPLINGS * 2, SIZES * 2,
                                                      QUALITIES * 3))]
    centers = np.array([[0.3 * w + 0.25, 0.6 * h + 0.5] for w, h in SIZES * 2], np.float32)
    ds = _Files(paths, centers)
    for threads in (1, 3):
        dec = GpuJpegDecoder("cpu", num_threads=threads)
        for pad in ((40, 48), (128, 170)):
            images, wh, offs, ok = dec.decode_batch(paths, centers, pad)
            assert ok.all()
            for i in range(len(paths)):
                want = ref_load_sample(ds, i, pad)
                np.testing.assert_array_equal(images[i], want["image"])
                np.testing.assert_array_equal(wh[i], want["valid_wh"])
                np.testing.assert_array_equal(offs[i], want["offset"])
            if native_available():
                ref = RefDecoder(num_threads=threads)
                r_images, r_wh, r_offs, r_ok = ref.decode_batch(paths, centers, pad)
                ref.close()
                assert r_ok.all()
                for a, b in ((images, r_images), (wh, r_wh), (offs, r_offs)):
                    np.testing.assert_array_equal(a, b)
        dec.close()


class _Files:
    def __init__(self, paths, centers):
        self.paths, self.centers = paths, centers

    def __len__(self):
        return len(self.paths)

    def image_path(self, i):
        return self.paths[i]

    def meta(self, i):
        return self.centers[i].astype(np.float64), 1.0, np.zeros((16, 2)), np.zeros(16)


def test_range_limit_table_is_libjpegs():
    """jdmaster.c's post-IDCT table: x + 128 for x in [-128, 128), 255 up
    to 383, 0 from -512 to -129, and the table's wrap beyond."""
    t = islow.range_limit_table().numpy().astype(int)
    for x, want in ((-128, 0), (-1, 127), (0, 128), (127, 255), (128, 255), (383, 255),
                    (511, 255), (512, 0), (895, 0), (-129, 0), (-512, 0), (-513, 255),
                    (1024 + 5, 133)):
        assert t[x & islow.RANGE_MASK] == want, x


def _reference_idct(coefs, q):
    """jpeg_idct_islow written out in Python integers, one block at a time:
    an independent transcription the plain version must equal."""
    CB, P1 = 13, 2

    def one(x, shift):
        z1 = (x[2] + x[6]) * 4433
        t2, t3 = z1 - x[6] * 15137, z1 + x[2] * 6270
        t0, t1 = (x[0] + x[4]) << CB, (x[0] - x[4]) << CB
        e = (t0 + t3, t1 + t2, t1 - t2, t0 - t3)
        a, b, c, d = x[7], x[5], x[3], x[1]
        z5 = (a + c + b + d) * 9633
        z1, z2 = (a + d) * -7373, (b + c) * -20995
        z3, z4 = (a + c) * -16069 + z5, (b + d) * -3196 + z5
        o = (a * 2446 + z1 + z3, b * 16819 + z2 + z4, c * 25172 + z2 + z3, d * 12299 + z1 + z4)
        r = 1 << (shift - 1)
        return [(v + r) >> shift for v in (e[0] + o[3], e[1] + o[2], e[2] + o[1], e[3] + o[0],
                                           e[3] - o[0], e[2] - o[1], e[1] - o[2], e[0] - o[3])]

    deq = [[int(coefs[8 * r + c]) * int(q[8 * r + c]) for c in range(8)] for r in range(8)]
    ws = [[0] * 8 for _ in range(8)]
    for c in range(8):
        col = [deq[r][c] for r in range(8)]
        out = [col[0] << P1] * 8 if not any(coefs[8 * r + c] for r in range(1, 8)) \
            else one(col, CB - P1)
        for r in range(8):
            ws[r][c] = out[r]
    table = islow.range_limit_table().numpy()
    return np.array([[table[v & 1023] for v in one(ws[r], CB + P1 + 3)] for r in range(8)])


def test_plain_idct_equals_jidctint_written_out():
    """Random blocks (half with all-zero AC columns, the DC-only shortcut;
    some near the 8-bit data's extremes) against a transcription in Python
    integers, which do not wrap: within 32 bits the two are one function."""
    rng = np.random.RandomState(0)
    coefs = rng.randint(-300, 301, (48, 64)).astype(np.int16)
    coefs[::2, 8:] *= (rng.rand(24, 56) < 0.1)
    coefs[::3, 8::8] = 0
    coefs[5, 0], coefs[7, 0] = 1016, -1024
    q = rng.randint(1, 12, 64).astype(np.int16)
    got = islow.idct_blocks(torch.from_numpy(coefs), torch.from_numpy(q)).numpy()
    for k in range(len(coefs)):
        np.testing.assert_array_equal(got[k], _reference_idct(coefs[k], q), err_msg=str(k))


def test_idct_wrapper_refuses_what_neither_version_takes():
    coefs, q = torch.zeros(64 * 6, dtype=torch.int16), torch.ones(64, dtype=torch.int16)
    plane = torch.empty((16, 24), dtype=torch.uint8)
    islow.idct_islow(coefs, q, [[0, 0, 3, 2]], [plane])
    assert (plane == 128).all() and islow.LAUNCHES["idct_islow"] == 0
    for desc, planes, match in (([[0, 0, 2, 2]], [plane], "plane from a grid"),
                                ([[64, 0, 3, 2]], [plane], "past the buffer"),
                                ([[0, 8, 3, 2]], [plane], "table"),
                                ([[0, 0, 3, 2]], [plane[:, ::2]], "unit column stride"),
                                ([[0, 0, 3, 2]] * 2, [plane], "descriptors")):
        with pytest.raises(ValueError, match=match):
            islow.idct_islow(coefs, q, desc, planes)
    with pytest.raises(ValueError, match="int16"):
        islow.idct_islow(coefs.int(), q, [[0, 0, 3, 2]], [plane])
    with pytest.raises(ValueError, match="CUDA"):
        islow.idct_islow_cuda(coefs, q, [[0, 0, 3, 2]], [plane])


_P = ctypes.POINTER
# the C types of the two interfaces and their ctypes
C_TYPES = {"void": None, "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "int*": _P(ctypes.c_int), "size_t": ctypes.c_size_t, "long long": ctypes.c_longlong,
           "const void*": ctypes.c_void_p,
           "const unsigned char*": ctypes.c_char_p,
           "const unsigned char* const*": _P(ctypes.c_char_p),
           "const size_t*": _P(ctypes.c_size_t), "void* const*": _P(ctypes.c_void_p)}


def _declarations(path, prefix):
    """{name: (C return type, [C parameter types])} of the functions named
    ``prefix...`` in ``path``'s extern "C" block."""
    with open(path) as f:
        src = f.read()
    block = src[src.index('extern "C" {'):]
    out = {}
    for ret, name, params in re.findall(rf"^(\w[\w ]*\**)\s*({prefix}\w+)\(([^)]*)\)\s*\{{",
                                        block, re.M):
        types = []
        for p in params.split(","):
            words = " ".join(p.split())
            types.append(re.sub(r"\s*\b\w+$", "", words).replace(" *", "*"))
        out[name] = (ret.strip().replace(" *", "*"), types)
    return out


SOURCES = {"jpeg_entropy": (jpeg_gpu.ENTROPY_SOURCE, "jpe_", jpeg_gpu.SIGNATURES),
           "idct_islow": (islow.SOURCE, "idct_islow_", islow.SIGNATURES)}


@pytest.mark.parametrize("name", sorted([*jpeg_gpu.SIGNATURES, *islow.SIGNATURES]))
def test_ctypes_signatures_match_the_source(name):
    """Each function's restype and argtypes are its C declaration's."""
    path, prefix, signatures = next(v for v in SOURCES.values() if name in v[2])
    decl = _declarations(path, prefix)
    assert set(decl) == set(signatures)
    ret, params = decl[name]
    restype, argtypes = signatures[name]
    assert C_TYPES[ret] is restype, (ret, restype)
    assert [C_TYPES[p] for p in params] == argtypes, params
