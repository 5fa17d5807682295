"""Loader-fed training traffic: the program's ``HostLoader`` reads JPEG
frames written at set-up and feeds the K-step graphed dispatch
(``posetpu_torch.train.make_dispatch_step``) through its batch placer, as
the train command trains from files.  On CUDA the loader takes the card's
decode route (the entropy decoder on host threads, the ``idct_islow`` and
``ycc_canvas`` kernels, the canvas kept on the card).

Traffic keys: ``frames`` (JPEG frames written from the seed under the
temp directory and deleted with the run), ``frame_wh`` (W, H), ``quality``,
``canvas`` (the loader's (H, W)), ``steps_per_dispatch``,
``check_dispatches``, ``steps_per_epoch``.

Set-up runs the first dispatches, each on the loader's next batch.
``check`` holds those batches to the plain reference's own (each frame
decoded by Pillow's libjpeg, cut and padded into the canvas, its
annotation with the MPII adjustment), then follows those steps as the
``graphed_train`` check does.  A batch's wait for the loader is the host's
clock around each ``next()``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import counts
from benchmark.compare import train_numbers
from benchmark.drivers import graphed_train
from benchmark.drivers.common import Clock, Phases, free, port_network, reference_precision
from benchmark.frozen.frames import write_split
from benchmark.reference import pose_train
from benchmark.weights import load_, make_weights

KIND = "loader"
# the reference's per-sample adjustment of an MPII annotation
CENTER_Y_SHIFT, SCALE_INFLATE = 15.0, 1.25


class Ctx:
    pass


def _endless(loader):
    while True:
        yield from loader


def setup(cfg, traffic, seed, device):
    from posetpu_torch.data import HostLoader, MpiiDataset, make_batch_placer

    c = Ctx()
    c.cfg, c.traffic, c.seed, c.device = cfg, traffic, seed, device
    c.phases = Phases(device)
    c.root = tempfile.mkdtemp(prefix="benchmark_frames_")
    ann = write_split(c.root, traffic["frames"], tuple(traffic["frame_wh"]), seed + 5,
                      traffic["quality"])
    c.phases.mark("frames")
    ds = MpiiDataset(ann, os.path.join(c.root, "images"), split="train")
    c.loader = HostLoader(ds, cfg["batch"], pad_hw=tuple(traffic["canvas"]),
                          seed=seed % 2**31, group=traffic["steps_per_dispatch"],
                          place=make_batch_placer(device))
    c.decoder = c.loader.decoder if c.loader.backend == "gpu" else None
    if c.decoder is not None:
        c.decoder.timing = True
    c.it = _endless(c.loader)
    c.model = port_network(cfg, device)
    c.weights = make_weights(c.model, seed, device)
    load_(c.model, c.weights)
    c.params = [n for n, _ in c.model.named_parameters()]
    c.state, c.dispatch = graphed_train.make_step(cfg, traffic, seed, c.model, device)
    res, out = cfg["aug"]["inp_res"][0], cfg["aug"]["out_res"]
    idct, ycc = counts.jpeg_420_bytes(cfg["batch"], *traffic["frame_wh"], traffic["canvas"])
    c.work = {"flops_per_image": counts.train_step_flops(cfg["model"], res),
              "raster_bytes_per_step": [counts.raster_bytes(cfg["batch"],
                                                            cfg["model"]["classes"], *out)],
              "idct_bytes_per_batch": idct, "ycc_bytes_per_batch": ycc}
    named = dict(c.model.named_parameters())
    opt = c.state.optimizer
    opt.init_moments()
    c.phases.mark("built")
    c.batches, losses = [], []
    for i in range(traffic["check_dispatches"]):
        b = next(c.it)
        c.batches.append(b)
        losses.append(c.dispatch(c.state, b)["loss"])
        if i == 0:
            c.first_nu = {n: opt.state[named[n]]["nu"].double() for n in named}
    c.first_loss = torch.cat(losses).double().cpu()
    c.after = {n: named[n].detach().clone() for n in c.params}
    c.phases.mark("dispatched")
    return c


def window(c, seconds):
    """Dispatches fed by the loader, each ended by a fetch, until
    ``seconds`` have passed; the records of the window."""
    clock = Clock(c.device)
    k, batch, n, waits = c.traffic["steps_per_dispatch"], c.cfg["batch"], 0, []
    first_times = len(c.decoder.times) if c.decoder is not None else 0
    t0 = time.perf_counter()
    while True:
        with record_function("bench.next_batch"):
            tw = time.perf_counter()
            b = next(c.it)  # the stream now waits for the batch's copy
            waits.append((time.perf_counter() - tw) * 1e3)
        with record_function("bench.dispatch"):
            clock.start()
            m = c.dispatch(c.state, b)
            clock.stop()
        with record_function("bench.fetch"):
            float(m["loss"][-1])
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    times = c.decoder.times[first_times:] if c.decoder is not None else []
    return {"kind": KIND, "images": n * k * batch, "steps": n * k, "units": n,
            "window_s": window_s, "spans_ms": clock.ms(), "waits_ms": waits,
            "entropy_ms": [t["host_ms"] for t in times], **c.work}


def reference_batch(c, indices):
    """The plain reference's own batch of the dataset samples ``indices``:
    each frame decoded by Pillow, cut to the canvas around the person where
    larger, zero-padded; the annotation with the MPII adjustment."""
    from PIL import Image

    ph, pw = c.traffic["canvas"]
    rows = []
    for i in indices:
        s = c.samples[i]
        img = np.asarray(Image.open(s.img_path).convert("RGB"), np.uint8)
        cx, cy = s.center[0], s.center[1] + CENTER_Y_SHIFT * s.scale
        H, W = img.shape[:2]
        oy = min(max(int(cy + 0.5) - ph // 2, 0), max(H - ph, 0)) if H > ph or W > pw else 0
        ox = min(max(int(cx + 0.5) - pw // 2, 0), max(W - pw, 0)) if H > ph or W > pw else 0
        img = img[oy:oy + ph, ox:ox + pw]
        canvas = np.zeros((ph, pw, 3), np.uint8)
        canvas[:img.shape[0], :img.shape[1]] = img
        rows.append({"image": canvas,
                     "valid_wh": np.array([img.shape[1], img.shape[0]], np.int32),
                     "center": np.array([cx - ox, cy - oy], np.float32),
                     "scale": np.float32(s.scale * SCALE_INFLATE),
                     "pts": (s.pts - [ox, oy]).astype(np.float32),
                     "vis": s.vis.astype(np.float32), "index": np.int32(i)})
    return {f: torch.from_numpy(np.stack([r[f] for r in rows])).to(c.device)
            for f in rows[0]}


def _decode_numbers(got, ref):
    """The largest gap of a canvas byte and of an annotation field."""
    lsb = meta = 0.0
    for b, r in zip(got, ref):
        lsb = max(lsb, float((b["image"].int() - r["image"].int()).abs().max()))
        for f in ("valid_wh", "center", "scale", "pts", "vis"):
            meta = max(meta, float((b[f].double() - r[f].double()).abs().max()))
    return {"canvas_lsb": lsb, "meta_gap": meta}


def _stop(c):
    c.it.close()  # the loader's producer thread
    c.samples = c.loader.dataset.samples
    c.it = c.loader = None


def program_side(c):
    _stop(c)
    prog = (c.first_loss, c.after, c.first_nu)
    c.state = c.dispatch = c.model = None
    free(c.device)
    return prog


def follow(c, refs, **kw):
    reference_precision()
    return pose_train.follow(c.weights, c.params, refs,
                             first=c.traffic["steps_per_dispatch"], seed=c.seed,
                             model=c.cfg["model"], aug=c.cfg["aug"], optim=c.cfg["optim"],
                             mean=c.cfg["mean"], **kw)


def _check_side(c):
    """(the program's readings, its batches' gaps from the reference's,
    the reference's batches, one a step)."""
    # the program's batches, one a step: (K, B, ...) superbatches cut
    got = [{f: torch.as_tensor(v[i]).to(c.device) for f, v in b.items() if f != "offset"}
           for b in c.batches for i in range(c.traffic["steps_per_dispatch"])]
    c.batches = None
    prog = program_side(c)
    # the reference's own batches, read from the files of the samples the
    # program's batches name
    ref = [reference_batch(c, b["index"].tolist()) for b in got]
    shutil.rmtree(c.root, ignore_errors=True)
    return prog, _decode_numbers(got, ref), ref


def check(c):
    prog, decode, steps = _check_side(c)
    start = {n: c.weights[n] for n in c.params}
    numbers, details = train_numbers(prog, follow(c, steps), start)
    return {**decode, **numbers}, {**details, "setup_phases": c.phases}


def calibrate(c):
    """The program's readings, the control's (the reference in fp8 in the
    program's place) and a planted fault's (the reference on the first half
    of each batch)."""
    prog, decode, steps = _check_side(c)
    start = {n: c.weights[n] for n in c.params}
    ref = follow(c, steps)
    out = {}
    for name, side in (("program", prog), ("control", follow(c, steps, quant=True)),
                       ("fault_half_batch", follow(c, steps, rows=c.cfg["batch"] // 2))):
        out[name], out[name + "_details"] = train_numbers(side, ref, start)
    out["program"].update(decode)
    # the control and the fault take the reference's own batches: its decode
    for name in ("control", "fault_half_batch"):
        out[name].update(canvas_lsb=0.0, meta_gap=0.0)
    return out
