"""Time the idct_islow kernel and its wrapper of this checkout against
another checkout's, on a CUDA machine, in one process.

    python -m posetpu_torch.tools.idct_islow_ab --other DIR [--out FILE]

``DIR`` is the root of another checkout of the repo (a commit unpacked with
``git archive``, say, from the commit that added ``native/islow.py`` on).
Each side's ``posetpu_torch/native/islow.py`` is loaded from its own file,
so each builds and launches its own ``kernels/idct_islow.cu`` with its own
descriptors; the rest of the package is this checkout's.  Both take the
loader's batch: the coefficients of 32 synthetic 1280x720 4:2:0 frames
(``make_synthetic_dataset``, Pillow at quality 92, the split chip_smoke.py's
``jpeg_gpu`` phase decodes), entropy-decoded by the route's decoder, into
planes laid out as the route lays them out (``jpeg_gpu.plane_layout``:
256-byte pitches).

In the order other, this, this, other, it times each side's

- ``kernel_ms``: the kernel alone, its descriptors already on the card
  (``launch_fn``), on the device clock;
- ``wrapper_ms``: the wrapper's calls back to back on the device clock, as
  chip_smoke.py's ``cuda_ms`` times them;
- ``wrapper_host_ms``: the host clock of one wrapper call on an idle card,
  as the decoder makes it once a batch.

Every plane must equal the plain version's (``islow.component_plane`` on
the card) bit for bit.  Prints one JSON line (with the batch's blocks and
bytes, the card's SM count and maximum SM clock), then the nvidia-smi name
and power-limit line; ``--out`` also writes the JSON there.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from posetpu_torch.native import islow, jpeg_gpu
from posetpu_torch.tools.ycc_canvas_ab import cuda_ms, host_ms

BATCH, SIZE = 32, (1280, 720)  # the loader's batch of (W, H) frames


def load_islow(root):
    """``root``'s ``posetpu_torch/native/islow.py`` as a module of its own."""
    path = os.path.join(os.path.abspath(root), "posetpu_torch", "native", "islow.py")
    name = f"idct_islow_ab_{abs(hash(path))}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def loader_batch(device, workdir, n=BATCH, size=SIZE, seed=0):
    """(coefs, desc, sizes): the entropy decode of ``n`` synthetic frames of
    ``size`` (W, H) made under ``workdir``, its coefficient buffer on
    ``device``, its descriptors and its planes' (w, h)."""
    from posetpu_torch.data import MpiiDataset, make_synthetic_dataset

    make_synthetic_dataset(workdir, num_train=n, num_val=0, res=size, seed=seed)
    ds = MpiiDataset(os.path.join(workdir, "annotations.json"), os.path.join(workdir, "images"),
                     split="train")
    dec = jpeg_gpu.GpuJpegDecoder("cpu")
    try:
        co = dec.coefficients([ds.image_path(i) for i in range(n)])
    finally:
        dec.close()
    if co.refused:
        raise RuntimeError(f"the route refused {co.refused} of the batch's frames")
    return co.buffer[:co.elements].to(device), co.desc, co.sizes


def route_planes(sizes, device):
    """(buffer, planes): one uint8 buffer on ``device`` and each plane's
    (h, w) view of it, laid out as the route lays them out."""
    layout, nbytes = jpeg_gpu.plane_layout([(w, h)] for w, h in sizes)
    buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)
    return buf, [buf[off:off + pitch * h].view(h, pitch)[:, :w]
                 for ((w, h, pitch, off),) in layout]


def plain_planes(coefs, desc, sizes):
    """The plain version's planes, component by component."""
    return [islow.component_plane(coefs[o:o + bw * bh * 64], coefs[q:q + 64], bw, bh, w, h)
            for (o, q, bw, bh), (w, h) in zip(desc.tolist(), sizes)]


def measure(mod, coefs, desc, sizes, want):
    """One side's three times, after checking its kernel and its wrapper
    against ``want`` bit for bit."""
    buf, planes = route_planes(sizes, coefs.device)
    words, count = mod.descriptors(desc, planes)
    dev_words = torch.from_numpy(words).to(coefs.device)
    fn, stream = mod.launch_fn(), torch.cuda.current_stream().cuda_stream

    def kernel():
        err = fn(dev_words.data_ptr(), len(planes), count, coefs.data_ptr(), coefs.data_ptr(),
                 stream)
        if err:
            raise RuntimeError(f"idct_islow launch failed: CUDA error {err}")

    def wrapper():
        mod.idct_islow(coefs, coefs, desc, planes)

    for launch in (kernel, wrapper):
        buf.fill_(7)
        launch()
        torch.cuda.synchronize()
        if not all(torch.equal(p, w) for p, w in zip(planes, want)):
            raise AssertionError(f"{mod.SOURCE} {launch.__name__}: planes differ")
    return {"kernel_ms": cuda_ms(kernel), "wrapper_ms": cuda_ms(wrapper),
            "wrapper_host_ms": host_ms(wrapper)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("idct_islow_ab runs on a CUDA device only")
    sides = {"other": load_islow(args.other), "this": islow}
    with tempfile.TemporaryDirectory() as workdir:
        coefs, desc, sizes = loader_batch("cuda", workdir)
    want = plain_planes(coefs, desc, sizes)
    runs = [{"side": side, **measure(sides[side], coefs, desc, sizes, want)}
            for side in ("other", "this", "this", "other")]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.split("\n")[0].strip()
    blocks = sum(-(-w // 8) * -(-h // 8) for w, h in sizes)
    result = {"other": os.path.abspath(args.other), "batch": BATCH, "size": list(SIZE),
              "components": len(sizes), "blocks": blocks,
              "coefficient_bytes": 2 * int(coefs.numel()),
              "plane_bytes": int(np.sum([w * h for w, h in sizes])), "runs": runs,
              "sms": torch.cuda.get_device_properties(0).multi_processor_count,
              "sm_clock_max": clock}
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
