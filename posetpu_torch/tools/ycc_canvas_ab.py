"""Time the ycc_canvas kernel and its wrapper of this checkout against
another checkout's, on a CUDA machine, in one process.

    python -m posetpu_torch.tools.ycc_canvas_ab --other DIR [--out FILE]

``DIR`` is the root of another checkout of the repo (a commit unpacked with
``git archive``, say, from the commit that named the route's module
``jpeg_gpu.py`` on).  Each side's ``posetpu_torch/native/jpeg_gpu.py`` is
loaded from its own file, so each builds and launches its own
``kernels/ycc_canvas.cu``; the rest of the package is this checkout's.  Both
take the loader's batch: 32 random 1280x720 4:2:0 images in rows of
the route's 256-byte pitch, cropped into a (768, 1280) canvas.

In the order other, this, this, other, it times each side's

- ``kernel_ms``: the kernel alone, its descriptors already on the card
  (``_ycc_fn``), on the device clock;
- ``wrapper_ms``: the wrapper's calls back to back on the device clock, as
  chip_smoke.py's ``cuda_ms`` times them (20 calls queued behind a sleep
  kernel: a wrapper whose host waits on the card reads its host time);
- ``wrapper_host_ms``: the host clock of one wrapper call on an idle card,
  as the decoder makes it once a batch.

Every canvas must equal the plain version's (``ycc.window_canvas``) bit for
bit.  Prints one JSON line (with the card's SM count and maximum SM clock,
for an issue bound), then the nvidia-smi name and power-limit line;
``--out`` also writes the JSON there.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from posetpu_torch.native import jpeg_gpu, ycc

BATCH, SIZE, PAD = 32, (1280, 720), (768, 1280)  # the loader's (W, H) frames and canvas
SAMPLING = ((1, 1), (2, 2), (2, 2))  # 4:2:0


def load_route(root):
    """``root``'s ``posetpu_torch/native/jpeg_gpu.py`` as a module of its own."""
    path = os.path.join(os.path.abspath(root), "posetpu_torch", "native", "jpeg_gpu.py")
    name = f"ycc_canvas_ab_{abs(hash(path))}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def loader_batch(device, n=BATCH, size=SIZE, pad_hw=PAD, seed=0):
    """(planes, samplings, windows) of ``n`` random 4:2:0 images of ``size``
    (W, H) in rows of the route's pitch, each cropped around a random center
    into ``pad_hw``."""
    rng = np.random.RandomState(seed)
    W, H = size
    planes = []
    for _ in range(n):
        pl = []
        for hf, vf in SAMPLING:
            w, h = ycc.component_size(W, H, hf, vf)
            pitch = -(-w // jpeg_gpu.PITCH_ALIGN) * jpeg_gpu.PITCH_ALIGN
            rows = torch.from_numpy(rng.randint(0, 256, (h, pitch), np.uint8)).to(device)
            pl.append(rows[:, :w])
        planes.append(tuple(pl))
    centers = rng.uniform((0, 0), (W, H), (n, 2)).astype(np.float32)
    windows = np.array([ycc.crop_window(W, H, c, pad_hw) for c in centers], np.int64)
    return planes, [SAMPLING] * n, windows


def cuda_ms(fn, reps=20, samples=25):
    """Median device time of one ``fn()`` call, from CUDA events around
    ``reps`` back-to-back calls queued behind a sleep kernel (chip_smoke.py's
    ``cuda_ms``)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_ms(fn, samples=25):
    """Median host time of one ``fn()`` call made on an idle card."""
    times = []
    for _ in range(samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def measure(mod, planes, samplings, windows, want):
    """One side's three times, after checking its kernel and its wrapper
    against ``want`` bit for bit."""
    out = torch.empty_like(want)
    desc = torch.from_numpy(jpeg_gpu._descriptors(planes, samplings, windows, PAD,
                                                out.device)).to(out.device)
    fn, stream = mod._ycc_fn(), torch.cuda.current_stream().cuda_stream

    def kernel():
        err = fn(desc.data_ptr(), len(planes), *PAD, out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"ycc_canvas launch failed: CUDA error {err}")

    def wrapper():
        mod.ycc_canvas(planes, samplings, windows, PAD, out=out)

    for launch in (kernel, wrapper):
        out.fill_(7)
        launch()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{mod.YCC_SOURCE} {launch.__name__}: canvas differs")
    return {"kernel_ms": cuda_ms(kernel), "wrapper_ms": cuda_ms(wrapper),
            "wrapper_host_ms": host_ms(wrapper)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ycc_canvas_ab runs on a CUDA device only")
    sides = {"other": load_route(args.other), "this": jpeg_gpu}
    if sides["other"].DESC_WORDS != jpeg_gpu.DESC_WORDS:
        raise SystemExit("the two checkouts' descriptors differ")
    planes, samplings, windows = loader_batch("cuda")
    want = torch.stack([ycc.window_canvas(pl, s, w, PAD)
                        for pl, s, w in zip(planes, samplings, windows)])
    runs = [{"side": side, **measure(sides[side], planes, samplings, windows, want)}
            for side in ("other", "this", "this", "other")]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.split("\n")[0].strip()
    result = {"other": os.path.abspath(args.other), "batch": BATCH, "size": list(SIZE),
              "pad_hw": list(PAD), "runs": runs,
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
