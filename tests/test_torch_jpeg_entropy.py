"""The card route's hand-written entropy decoder
(posetpu_torch/native/jpeg_entropy.cpp) and the plain IDCT
(posetpu_torch/native/islow.py) against libjpeg and the JAX package.

Every file is written by Pillow from seeded numpy arrays.  The hand decoder
plus the plain ``islow`` must give the planes libjpeg's raw output gives
(``bindings.read_planes``: libjpeg-turbo's decode before upsampling and
color conversion) bit for bit, at every subsampling the route takes, odd
sizes, qualities 1 to 100 (a noise image at 100 drives the range limit's
clamps), optimised Huffman tables and restart markers.  Where large
dequantised values make libjpeg-turbo's 16-bit SIMD IDCT part from
jidctint.c's int32 arithmetic (tables scaled up to 128x as 16-bit entries,
forged coefficients of +-2047) the route refuses the file as "range"; every
file it takes is libjpeg's bit for bit.  Files the route refuses read
``ok`` False, are counted, and reach the JAX package's Pillow loader's
answer through the port's loader.  The kernel's descriptor and tile
constants are parsed from the sources.  The plain IDCT
is also held to its definition on hand-made blocks and to its range-limit
table.
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
from posetpu_torch.utils.profiling import counter

_JPEGLIB = ("/usr/include/jpeglib.h", "/usr/local/include/jpeglib.h",
            "/usr/include/x86_64-linux-gnu/jpeglib.h",
            "/usr/include/aarch64-linux-gnu/jpeglib.h")

SUBSAMPLINGS = ("444", "422", "440", "420", "gray")
SIZES = ((1, 1), (3, 2), (4, 5), (17, 33), (161, 121))
QUALITIES = (50, 75, 92, 100)
LOW_QUALITIES = (1, 5, 10, 25)
SCALES = (1, 2, 3, 4, 8, 16, 30, 64, 128)


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


def scaled_tables(data, scale):
    """``data`` with every quantisation table multiplied by ``scale``
    (capped at 32767, as ``parse_dqt`` caps) and rewritten as 16-bit
    entries; the coefficients stay those of the original tables."""
    data = bytearray(data)
    i = 0
    while (i := data.find(b"\xff\xdb", i)) >= 0:
        length = int.from_bytes(data[i + 2:i + 4], "big")
        seg, out, j = data[i + 4:i + 2 + length], bytearray(), 0
        while j < len(seg):
            pq = seg[j] >> 4
            vals = ([int.from_bytes(seg[j + 1 + 2 * k:j + 3 + 2 * k], "big") for k in range(64)]
                    if pq else list(seg[j + 1:j + 65]))
            out.append(0x10 | (seg[j] & 15))
            out += b"".join(min(v * scale, 32767).to_bytes(2, "big") for v in vals)
            j += 1 + 64 * (pq + 1)
        seg = b"\xff\xdb" + (len(out) + 2).to_bytes(2, "big") + out
        data[i:i + 2 + length] = seg
        i += len(seg)
    return bytes(data)


def _libjpegs_planes_or_range(libjpeg, decoder, path):
    """True where the route refuses the file as "range", after checking
    that otherwise its planes are libjpeg's bit for bit."""
    got = _planes(decoder, path)
    if isinstance(got, int):
        assert jpeg_gpu.JPE_STATUSES[got] == "range"
        return True
    want = libjpeg.read_planes(path)[2]
    for c, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"component {c}")
    return False


@pytest.mark.parametrize("scale", SCALES)
def test_scaled_tables_are_libjpegs_or_refused(libjpeg, decoder, tmp_path, scale):
    """Pillow's q75 tables times ``scale`` as a 16-bit DQT, on a smooth and
    a noise 161x121 4:2:0 file: where libjpeg-turbo's 16-bit SIMD IDCT
    parts from jidctint.c's int32 arithmetic (from about 4x) the route
    refuses the file; every file it takes is libjpeg's bit for bit."""
    refused = 0
    for k, noise in enumerate((False, True)):
        data = scaled_tables(jpeg_bytes("420", 161, 121, 70 + k, 75, noise=noise), scale)
        refused += _libjpegs_planes_or_range(libjpeg, decoder,
                                             _write(tmp_path, f"s{k}.jpg", data))
    if scale <= 3:
        assert refused == 0
    if scale >= 8:
        assert refused >= 1


@pytest.mark.parametrize("quality", LOW_QUALITIES)
def test_low_qualities_are_not_refused(libjpeg, decoder, tmp_path, quality):
    """Pillow's 8-bit tables at low qualities (entries up to 255), smooth
    and noise at two sizes: nothing refused, libjpeg's planes."""
    for k, ((w, h), noise) in enumerate((((161, 121), False), ((161, 121), True),
                                         ((67, 45), False), ((67, 45), True))):
        data = jpeg_bytes("420", w, h, 80 + k, quality, noise=noise)
        _assert_libjpegs_planes(libjpeg, decoder, _write(tmp_path, f"{k}.jpg", data))


def _bits(value, size):
    """HUFF_EXTEND's inverse: the ``size`` low bits that code ``value``."""
    return value if value >= 0 else value + (1 << size) - 1


# jutils.c's jpeg_natural_order: the zigzag's k-th coefficient's natural
# position (row-major); anti-diagonals in turn, odd ones down
ZIGZAG = [8 * i + (d - i) for d in range(15)
          for i in (range(max(0, d - 7), min(d, 7) + 1) if d % 2 else
                    range(min(d, 7), max(0, d - 7) - 1, -1))]


def _dht(tc, symbols):
    """A DHT segment of table 0 of class ``tc`` coding ``symbols`` in
    codes of one length: 4 bits for up to 15 symbols, else 8."""
    length = 4 if len(symbols) < 16 else 8
    bits = [0] * 16
    bits[length - 1] = len(symbols)
    body = bytes([tc << 4]) + bytes(bits) + bytes(symbols)
    return b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big") + body, length


def baseline_gray(blocks, width, height, table=255):
    """A baseline grayscale JPEG whose quantised blocks ((n, 64) in natural
    order, raster order over ceil(width / 8) x ceil(height / 8)) are
    ``blocks``: one 8-bit table of ``table`` everywhere, and Huffman tables
    of one code length that code every DC size to 11 and every AC run and
    size to 11 (libjpeg decodes any such size; Pillow writes none past 10)."""
    dc_syms = list(range(12))
    ac_syms = [0x00, 0xF0] + [r << 4 | z for r in range(16) for z in range(1, 12)]
    dht_dc, dc_len = _dht(0, dc_syms)
    dht_ac, ac_len = _dht(1, ac_syms)
    out, acc, n = bytearray(), 0, 0

    def put(code, size):
        nonlocal acc, n
        acc, n = (acc << size) | code, n + size
        while n >= 8:
            n -= 8
            byte = (acc >> n) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)

    pred = 0
    for blk in np.asarray(blocks, np.int64):
        diff = int(blk[0]) - pred
        pred = int(blk[0])
        size = abs(diff).bit_length()
        put(dc_syms.index(size), dc_len)
        if size:
            put(_bits(diff, size), size)
        run = 0
        for k in range(1, 64):
            v = int(blk[ZIGZAG[k]])
            if v == 0:
                run += 1
                continue
            while run > 15:
                put(ac_syms.index(0xF0), ac_len)
                run -= 16
            size = abs(v).bit_length()
            put(ac_syms.index(run << 4 | size), ac_len)
            put(_bits(v, size), size)
            run = 0
        if run:
            put(ac_syms.index(0x00), ac_len)
    if n:
        put((1 << (8 - n)) - 1, 8 - n)
    dqt = b"\xff\xdb\x00\x43\x00" + bytes([table] * 64)
    sof = (b"\xff\xc0\x00\x0b\x08" + height.to_bytes(2, "big") + width.to_bytes(2, "big")
           + b"\x01\x01\x11\x00")
    sos = b"\xff\xda\x00\x08\x01\x01\x00\x00\x3f\x00"
    return b"\xff\xd8" + dqt + sof + dht_dc + dht_ac + sos + bytes(out) + b"\xff\xd9"


def mild_blocks(n, rng):
    """(n, 64) blocks whose samples stay in range at a table of 255: DC
    within +-3, three AC terms of +-1."""
    blocks = np.zeros((n, 64), np.int64)
    blocks[:, 0] = rng.randint(-3, 4, n)
    for blk in blocks:
        blk[rng.choice(np.arange(1, 64), 3, replace=False)] = rng.choice([-1, 1], 3)
    return blocks


def wide_coefficients(width, height, seed):
    """A baseline grayscale file of mild blocks at a table of 255, one of
    which holds coefficients of +-2047: dequantised, far past int16."""
    rng = np.random.RandomState(seed)
    blocks = mild_blocks(-(-width // 8) * -(-height // 8), rng)
    blocks[len(blocks) // 2, [0, 1, 9, 63]] = (2044, -2047, 2047, -1)  # DC sizes within 11
    return baseline_gray(blocks, width, height)


def test_forged_wide_coefficients_are_refused(libjpeg, decoder, tmp_path):
    """Coefficients of +-2047 against a table of 255 are valid baseline
    data that libjpeg decodes; the route refuses the file as "range" once
    the exact check has confirmed the block the cheap bound flagged, and
    takes the same file without that block, libjpeg's bit for bit."""
    before = decoder.block_counts()
    path = _write(tmp_path, "wide.jpg", wide_coefficients(40, 30, 0))
    assert libjpeg.read_planes(path) is not None
    assert jpeg_gpu.JPE_STATUSES[_planes(decoder, path)] == "range"
    blocks, flagged = (a - b for a, b in zip(decoder.block_counts(), before))
    assert flagged >= 1 and blocks >= flagged
    mild = baseline_gray(mild_blocks(20, np.random.RandomState(0)), 40, 30)
    _assert_libjpegs_planes(libjpeg, decoder, _write(tmp_path, "mild.jpg", mild))


def test_the_cheap_bound_is_derived_from_jidctint():
    """jpeg_entropy.cpp's kWeight: each input's largest factor in
    jidctint.c's 1-D pass (the plain version's _pass, read off unit inputs
    at a shift that leaves the factors whole), and kRangeBound as its
    comment derives it."""
    src = open(jpeg_gpu.ENTROPY.source).read()
    weights = [int(v) for v in re.search(r"kWeight\[8\] = \{([^}]*)\}", src)[1].split(",")]
    shift = 20
    for k in range(8):
        x = [torch.tensor([(1 << shift) if i == k else 0]) for i in range(8)]
        assert max(abs(int(v)) for v in islow._pass(x, shift)) == weights[k], k
    assert f"kWeightSum = {sum(weights)};" in src
    assert ("kRangeBound = 2048 * ((512ull << 18) - (1ull << 17)) - 1024 * kWeightSum - 1;"
            in src)


def test_info_words_describe_the_grids_and_planes(decoder):
    """jpe_info's words for a 4:2:0 161x121 file: MCU-padded grids (11 x 8
    MCUs of 16x16), stored plane sizes libjpeg's."""
    data = jpeg_bytes("420", 161, 121, 0)
    info = np.zeros(jpeg_gpu.INFO_WORDS, np.int32)
    st = jpeg_gpu.ENTROPY.jpe_info(data, len(data),
                                   info.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    assert st == 0
    assert info.tolist() == [161, 121, 3, 2, 2, 22, 16, 161, 121, 1, 1, 11, 8, 81, 61,
                             1, 1, 11, 8, 81, 61]
    gray = jpeg_bytes("gray", 17, 33, 0)
    st = jpeg_gpu.ENTROPY.jpe_info(gray, len(gray),
                                   info.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
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
        ("wide_coefficients", wide_coefficients(40, 30, 7), "range"),
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
    st = jpeg_gpu.ENTROPY.jpe_info(data, len(data),
                                   info.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    assert jpeg_gpu.JPE_STATUSES[st] == "dimensions"


@pytest.fixture(scope="module")
def refused_split(tmp_path_factory):
    """Seven 96x72 frames, then a progressive file, a file whose restart
    markers come out of turn and one with bytes before its EOI (the route
    refuses them; Pillow decodes them), a truncated file and a forged-size
    header (Pillow raises on them), then a file with coefficients past
    libjpeg-turbo's 16-bit IDCT lanes (the route refuses it as "range";
    Pillow decodes it)."""
    root = tmp_path_factory.mktemp("refused_split")
    ref_make(str(root), num_train=13, num_val=0, res=(96, 72), seed=3)
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
    (images / "wide.jpg").write_bytes(wide_coefficients(96, 72, 3))
    raw[12]["img_paths"] = "wide.jpg"
    ann.write_text(json.dumps(raw))
    return str(ann), str(images)


def test_refused_rows_equal_the_reference_pillow_loader(decoder, refused_split):
    """Through HostLoader(backend="gpu") on the CPU route: the four files
    Pillow decodes go through the Pillow row and equal the JAX package's
    Pillow loader key for key; each is counted as refused."""
    ann, images = refused_split
    ds, ref = MpiiDataset(ann, images), RefMpii(ann, images)
    keep = [*range(10), 12]
    kw = dict(pad_hw=(64, 80), shuffle=False, drop_last=False)
    port = HostLoader(_Subset(ds, keep), 5, backend="gpu", device="cpu", **kw)
    want = RefLoader(_Subset(ref, keep), 5, backend="pil", **kw)
    assert port.backend == "gpu"
    got = list(port)
    assert port.decoder.refused == 4
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


def test_idct_descriptors_are_the_kernels_words():
    """islow.descriptors: the words idct_islow.cu documents, each
    component's first tile and tiles a row at the kernel's tile width."""
    src = open(islow.IDCT.source).read()
    assert f"constexpr int kDescWords = {islow.DESC_WORDS};" in src
    warps = int(re.search(r"constexpr int kConsumers = (\d+);", src)[1])
    rounds = int(re.search(r"constexpr int kRounds = (\d+);", src)[1])
    assert "constexpr int kTileBlocks = 4 * kConsumers * kRounds;" in src
    assert islow.TILE_BLOCKS == 4 * warps * rounds
    t = islow.TILE_BLOCKS
    buf = torch.empty(1 << 16, dtype=torch.uint8)
    planes = [buf[:8 * 600].view(8, 600)[:, :2 * 8 * t + 3], buf[:512 * 40].view(40, 512)[:, :8],
              buf[:256].view(1, 256)[:, :1]]
    desc = np.array([[64, 0, 2 * t + 2, 1], [2048, 0, 1, 5], [4096, 64, 1, 1]], np.int64)
    words, tiles = islow.descriptors(desc, planes)
    assert words.shape == (3, islow.DESC_WORDS)
    assert words[:, :5].tolist() == [[64, 0, 2 * t + 2, 2 * t + 1, 1], [2048, 0, 1, 1, 5],
                                     [4096, 64, 1, 1, 1]]
    assert words[:, 5].tolist() == [p.data_ptr() for p in planes]
    assert words[:, 6:9].tolist() == [[600, 2 * 8 * t + 3, 8], [512, 8, 40], [256, 1, 1]]
    # rows of 2t + 1 blocks: 3 tiles; 5 rows of one block; one block
    assert words[:, 9:].tolist() == [[0, 3], [3, 1], [8, 1]] and tiles == 9


def test_idct_wrapper_refuses_what_neither_version_takes():
    coefs, q = torch.zeros(64 * 6, dtype=torch.int16), torch.ones(64, dtype=torch.int16)
    plane = torch.empty((16, 24), dtype=torch.uint8)
    islow.idct_islow(coefs, q, [[0, 0, 3, 2]], [plane])
    assert (plane == 128).all() and counter(islow.IDCT_LAUNCHES) == 0
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
