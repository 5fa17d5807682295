#!/usr/bin/env python3
"""Drive the posetpu_torch port once on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device     the card's name and its nvidia-smi name/power-limit line
  build      every kernel source of the port compiled with nvcc (all at once)
  kernels    each kernel against its plain PyTorch version on the card
             (exactly, for the rasterizer, on random and edge points), and
             both timed with CUDA events beside the card's write floor at
             the main path's shape and at one beyond the L2
  serve      PosePredictor at the full hg8_mpii width (seeded random
             weights, bf16): predict_iter(depth=2) over 4 batches of 32
  validate   make_eval_step at the same width over 4 batches of 32, its
             targets from the CUDA rasterizer; the kernel launch counts are
             reset just before and read just after
  profile    one validation step under torch.profiler: device time by
             kernel and the idle share of the step
  parity     a small f32 network (TF32 off): the card's validation step
             against the port's CPU path on the same inputs and weights
             (loss, scores, targets, PCK counts and decoded predictions)

Then the kernel summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit, no
final line); without CUDA it exits non-zero at once.  Nothing falls back to
the CPU or to a plain version.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from posetpu_torch.aug import augment_batch, cuda_kernels, neutral_params
from posetpu_torch.aug.heatmap import rasterize_gaussians, rasterize_gaussians_plain
from posetpu_torch.configs import named_config
from posetpu_torch.infer import MPII_MEAN, PosePredictor
from posetpu_torch.models import hg
from posetpu_torch.train.step import make_eval_step
from posetpu_torch.utils import cuda_build

SEED = 0
BATCH = 32
NUM_BATCHES = 4
CANVAS = (384, 384)  # padded host canvas (H, W); true sizes vary per sample

# NVIDIA H100 SXM published peaks (data sheet, dense): HBM3 bandwidth and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# float operations per pixel inside a kept joint's window: 2 sub, 2 mul,
# add, neg, div, exp, 2 abs, 2 compare, 2 mask multiplies, 1 keep multiply;
# every other pixel is a stored zero
RASTER_OPS_PER_ELEMENT = 15
# the rasterizer's timed shapes (B, K, H, W): the main path's, then one whose
# 134 MB of output is beyond the 50 MB L2
RASTER_SHAPES = ((BATCH, 16, 64, 64), (512, 16, 64, 64))
# CPU exp against the card's expf, for the targets of the parity phase; the
# kernel itself is held to its plain version on the card exactly
RASTER_TOL = 1e-6
PARITY_ATOL, PARITY_RTOL = 2e-4, 1e-3

REPO = os.path.dirname(os.path.abspath(__file__))

# kernel-name patterns that sort the profile's device time into kinds; the
# first match wins, anything unmatched is "other elementwise"
PROFILE_KINDS = (
    ("rasterize", ("rasterize",)),
    ("copies", ("Memcpy", "Memset")),
    ("convolution / gemm", ("gemm", "xmma", "nvjet", "conv", "cutlass", "cudnn")),
    ("batch_norm", ("batch_norm",)),
    ("upsample / pool", ("upsample", "pool")),
    ("gather / index (warp, decode)", ("index", "gather")),
    ("reductions", ("reduce",)),
    ("dtype casts", ("_copy_kernel",)),
)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps=20, samples=25):
    """Median device time of one ``fn()`` call, from CUDA events around
    ``reps`` back-to-back calls.  A sleep kernel ahead of each sample
    keeps the card busy while the host enqueues the calls, so the events
    time the device and not the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms at 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it runs on an NVIDIA GPU only",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return smi


def phase_build():
    t0 = time.perf_counter()
    paths = cuda_build.build(cuda_kernels.SOURCES)
    seconds = time.perf_counter() - t0
    ptxas = []
    for lib in paths.values():
        with open(lib + ".log") as f:
            ptxas += [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    emit("build", seconds=seconds,
         libraries=[os.path.relpath(p, REPO) for p in paths.values()],
         ptxas=ptxas)


def _raster_inputs(B, K, seed):
    rng = np.random.RandomState(seed)
    pts = rng.randint(-10, 74, (B, K, 2)).astype(np.float32)
    vis = rng.randint(0, 2, (B, K)).astype(np.float32)
    return torch.from_numpy(pts).cuda(), torch.from_numpy(vis).cuda()


def _edge_inputs(res, frac):
    """(1, n, 2) points on, one pixel beyond, a few pixels beyond and far
    beyond each edge of an H x W map, then two rows of the TPU kernel's
    -1e6 padding (vis 0, as it padded them, and vis 1); (1, n) vis."""
    H, W = res

    def axis(n):
        return [0.0, n - 1.0, *(-float(d) for d in range(1, 9)),
                *(n - 1.0 + d for d in range(1, 9)), -100.0, n + 99.0]

    xs, ys = axis(W), axis(H)
    pts = ([(x, float(H // 2)) for x in xs] + [(float(W // 2), y) for y in ys]
           + list(zip(xs, ys)))
    pts = np.array(pts, np.float32) + (np.float32(0.5) if frac else 0)
    pts = np.concatenate([pts, np.full((2, 2), -1e6, np.float32)])
    vis = np.ones(len(pts), np.float32)
    vis[-2] = 0.0
    return (torch.from_numpy(pts[None]).cuda(), torch.from_numpy(vis[None]).cuda())


def _raster_bound(B, K, H, W, in_window):
    """Least time for the rasterizer's work: each input read once, each
    output written once, against the float operations of the pixels inside
    a kept joint's window (the only ones it computes)."""
    rows, elems = B * K, B * K * H * W
    nbytes = rows * (2 * 4 + 4) + elems * 4 + rows * 4
    ops = in_window * RASTER_OPS_PER_ELEMENT
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return nbytes, ops, max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                                 else "operations")


def phase_kernels():
    """The rasterizer against its plain version, exactly, on random points
    at two widths and on edge points at three map sizes (odd, 16-byte rows
    and the main path's 64x64), for sigma 1, 1.5 and 2.  Then the kernel,
    the plain version and the card's write floor (``zero_`` of an output of
    the same size) timed at each of RASTER_SHAPES."""
    cases, max_err = [], 0.0

    def compare(what, pts, vis, res, sigma):
        nonlocal max_err
        before = cuda_kernels.LAUNCHES["rasterize_gaussians"]
        t_k, v_k = rasterize_gaussians(pts, vis, res, sigma)
        t_p, v_p = rasterize_gaussians_plain(pts, vis, res, sigma)
        torch.cuda.synchronize()
        check(cuda_kernels.LAUNCHES["rasterize_gaussians"] == before + 1,
              "the rasterizer wrapper did not launch its kernel")
        err = (t_k - t_p).abs().max().item()
        label = f"rasterizer {what} {tuple(pts.shape[:2])} {res} sigma={sigma}"
        check(torch.equal(t_k, t_p), f"{label}: max abs err {err}")
        check(torch.equal(v_k, v_p), f"{label}: vis_out")
        check(t_k.max().item() > 0.5, f"{label}: no visible peak was drawn")
        max_err = max(max_err, err)
        cases.append({"points": what, "B": pts.shape[0], "K": pts.shape[1],
                      "res": list(res), "sigma": sigma, "max_abs_err": err})

    for sigma in (1.0, 1.5, 2.0):
        for B, K in ((BATCH, 16), (3, 5)):  # 3*5 rows: not a block multiple
            compare("random", *_raster_inputs(B, K, SEED + B), (64, 64), sigma)
        for res in ((17, 13), (64, 48), (64, 64)):
            for frac in (False, True):
                compare("edges+0.5" if frac else "edges",
                        *_edge_inputs(res, frac), res, sigma)

    shapes = []
    for B, K, H, W in RASTER_SHAPES:
        res = (H, W)
        pts, vis = _raster_inputs(B, K, SEED)
        in_window = int((rasterize_gaussians_plain(pts, vis, res, 1.0)[0] != 0).sum())
        ms = cuda_ms(lambda: rasterize_gaussians(pts, vis, res, 1.0))
        plain_ms = cuda_ms(lambda: rasterize_gaussians_plain(pts, vis, res, 1.0))
        buf = torch.empty((B, K, H, W), dtype=torch.float32, device="cuda")
        floor_ms = cuda_ms(buf.zero_)
        del buf
        nbytes, ops, bound_ms, bound_by = _raster_bound(B, K, H, W, in_window)
        shapes.append({"shape": [B, K, H, W], "sigma": 1.0, "ms": ms,
                       "plain_ms": plain_ms, "write_floor_ms": floor_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "bytes": nbytes, "operations": ops})
    main = shapes[0]
    summary = {
        "name": "rasterize_gaussians",
        "route": "cuda",
        "source": "posetpu_torch/aug/kernels/rasterize.cu",
        "replaces": "posetpu/aug/pallas_kernels.py:65",
        "launches": None,  # filled from the validate phase
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        # no single PyTorch call computes this function; the write floor
        # is a yardstick of the card, not of the function
        "library_ms": None,
        "write_floor_ms": main["write_floor_ms"],
        "shapes": shapes,
    }
    emit("kernels", cases=len(cases), max_abs_err=max_err,
         cases_detail=cases, shapes=shapes)
    return summary


def _serve_batches(rng):
    H, W = CANVAS
    out = []
    for _ in range(NUM_BATCHES):
        vw = rng.randint(W * 2 // 3, W + 1, BATCH)
        vh = rng.randint(H * 2 // 3, H + 1, BATCH)
        valid_wh = np.stack([vw, vh], axis=1).astype(np.int32)
        center = (valid_wh / 2 + rng.uniform(-10, 10, (BATCH, 2))).astype(np.float32)
        scale = (vh / 200.0 * rng.uniform(0.7, 1.0, BATCH)).astype(np.float32)
        images = np.zeros((BATCH, H, W, 3), np.uint8)
        for i in range(BATCH):
            images[i, : vh[i], : vw[i]] = rng.randint(
                0, 256, (vh[i], vw[i], 3), dtype=np.uint8
            )
        out.append((images, valid_wh, center, scale))
    return out


def phase_serve(cfg):
    torch.manual_seed(SEED)
    state_dict = hg(
        num_stacks=cfg.model.stacks, num_classes=cfg.model.classes,
        num_feats=cfg.model.feats, depth=cfg.model.depth,
    ).state_dict()
    predictor = PosePredictor.from_config(cfg, state_dict, mean=MPII_MEAN)
    batches = _serve_batches(np.random.RandomState(SEED))
    predictor(*batches[0])  # first call: cuDNN/cuBLAS set-up, not timed
    torch.cuda.synchronize()

    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    outs = list(predictor.predict_iter(iter(batches), depth=2))
    seconds = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)

    K = cfg.model.classes
    check(len(outs) == NUM_BATCHES, "predict_iter lost a batch")
    for out in outs:
        check(out["pred"].shape == (BATCH, K, 2), f"pred {out['pred'].shape}")
        check(out["conf"].shape == (BATCH, K), f"conf {out['conf'].shape}")
        check(out["heatmap_coords"].shape == (BATCH, K, 2), "heatmap_coords shape")
        for k, v in out.items():
            check(np.isfinite(v).all(), f"non-finite {k}")
    emit("serve", config=cfg.name, stacks=cfg.model.stacks, feats=cfg.model.feats,
         batch=BATCH, batches=NUM_BATCHES, canvas=list(CANVAS), dtype="bfloat16",
         seconds=seconds, img_per_s=BATCH * NUM_BATCHES / seconds,
         launches=launches)
    return predictor


def _eval_batch(rng, B, canvas, K, scale_range=(0.7, 1.0)):
    H, W = canvas
    vw = rng.randint(W * 2 // 3, W + 1, B)
    vh = rng.randint(H * 2 // 3, H + 1, B)
    valid_wh = np.stack([vw, vh], axis=1).astype(np.int32)
    center = (valid_wh / 2 + rng.uniform(-5, 5, (B, 2))).astype(np.float32)
    scale = (vh / 200.0 * rng.uniform(*scale_range, B)).astype(np.float32)
    box = 200.0 * scale
    pts = center[:, None, :] + rng.uniform(-0.4, 0.4, (B, K, 2)) * box[:, None, None]
    return {
        "image": rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8),
        "valid_wh": valid_wh,
        "center": center,
        "scale": scale,
        "pts": pts.astype(np.float32),
        "vis": (rng.rand(B, K) < 0.8).astype(np.float32),
        "mask": np.ones((B,), np.float32),
        "offset": np.zeros((B, 2), np.float32),
    }


def phase_validate(cfg, predictor):
    eval_step = make_eval_step(predictor.model, cfg.aug, MPII_MEAN, device="cuda")
    rng = np.random.RandomState(SEED + 1)
    batches = [
        _eval_batch(rng, BATCH, CANVAS, cfg.model.classes)
        for _ in range(NUM_BATCHES)
    ]
    eval_step(batches[0])  # warm-up, not counted
    torch.cuda.synchronize()

    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    results = [eval_step(b) for b in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    check(launches["rasterize_gaussians"] == NUM_BATCHES,
          f"rasterizer launches in validation: {launches}")

    losses, accs, cnt = [], [], 0
    for metrics, preds in results:
        loss, acc = metrics["loss"].item(), metrics["acc"].item()
        check(math.isfinite(loss), f"loss {loss}")
        check(-1.0 <= acc <= 1.0, f"acc {acc}")
        check(preds.shape == (BATCH, cfg.model.classes, 2), f"preds {preds.shape}")
        check(bool(torch.isfinite(preds).all()), "non-finite preds")
        losses.append(loss)
        accs.append(acc)
        cnt += int(metrics["pck_cnt"].sum())
    check(cnt > 0, "no valid PCK targets")
    emit("validate", config=cfg.name, batch=BATCH, batches=NUM_BATCHES,
         seconds=seconds, img_per_s=BATCH * NUM_BATCHES / seconds,
         loss=losses, acc=accs, pck_cnt=cnt, launches=launches)
    return launches


def phase_profile(cfg, predictor, top=8):
    """Where one full-width validation step spends the card's time:
    kernel time by name from torch.profiler, and the idle share of the
    step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eval_step = make_eval_step(predictor.model, cfg.aug, MPII_MEAN, device="cuda")
    batch = _eval_batch(np.random.RandomState(SEED + 4), BATCH, CANVAS,
                        cfg.model.classes)
    eval_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eval_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    check(busy_ms > 0, "the profiler saw no device time")
    by_kind = {}
    for name, ms in by_name.items():
        kind = next((k for k, keys in PROFILE_KINDS if any(s in name for s in keys)),
                    "other elementwise")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # the framework ops that launched that time (self device time per op)
    ops = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.key.startswith("aten::") and e.self_device_time_total > 0),
        key=lambda t: -t[1],
    )[:top]
    emit("profile", step="validate", wall_ms=wall_ms, device_busy_ms=busy_ms,
         idle_share=max(0.0, 1.0 - busy_ms / wall_ms), kernels=len(by_name),
         by_kind_ms=dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
         top_kernels=[{"name": n[:90], "ms": ms} for n, ms in ranked],
         top_ops=[{"op": k, "ms": ms, "calls": c} for k, ms, c in ops])


def phase_parity():
    """Small f32 network, TF32 off: the card's validation step against the
    port's CPU path (plain rasterizer) on the same batch and weights."""
    cfg = named_config("hg2_mpii_mini")
    cfg.model.feats = 8
    cfg.model.bf16 = False
    cfg.aug.inp_res = (64, 64)
    cfg.aug.out_res = (16, 16)
    K = cfg.model.classes
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        torch.manual_seed(SEED + 2)
        m_cpu = hg(num_stacks=cfg.model.stacks, num_classes=K,
                   num_feats=cfg.model.feats, dtype=torch.float32)
        with torch.no_grad():  # non-trivial BN statistics
            for mod in m_cpu.modules():
                if isinstance(mod, torch.nn.BatchNorm2d):
                    mod.running_mean.normal_(0.0, 0.05)
                    mod.running_var.uniform_(0.8, 1.2)
        m_gpu = copy.deepcopy(m_cpu).cuda()
        batch = _eval_batch(np.random.RandomState(SEED + 3), 8, (96, 128), K)
        batch["mask"][-1] = 0.0
        mc, pc = make_eval_step(m_cpu, cfg.aug, MPII_MEAN, device="cpu")(batch)
        mg, pg = make_eval_step(m_gpu, cfg.aug, MPII_MEAN, device="cuda")(batch)

        scores = {}
        for dev, model in (("cpu", m_cpu), ("cuda", m_gpu)):
            with torch.no_grad():
                aug = augment_batch(
                    batch["image"], batch["valid_wh"], batch["center"],
                    batch["scale"], batch["pts"], batch["vis"],
                    neutral_params(8, dev), inp_res=cfg.aug.inp_res,
                    out_res=cfg.aug.out_res, mean=MPII_MEAN, device=dev,
                )
                scores[dev] = (model.eval()(aug["input"])[-1].cpu(),
                                aug["target"].cpu())
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev

    loss_c, loss_g = mc["loss"].item(), mg["loss"].item()
    check(abs(loss_c - loss_g) <= PARITY_ATOL + PARITY_RTOL * abs(loss_c),
          f"loss cpu {loss_c} vs cuda {loss_g}")
    s_c, s_g = scores["cpu"][0], scores["cuda"][0]
    score_err = (s_c - s_g).abs().max().item()
    check(torch.allclose(s_g, s_c, atol=PARITY_ATOL, rtol=PARITY_RTOL),
          f"scores differ by {score_err}")
    target_err = (scores["cpu"][1] - scores["cuda"][1]).abs().max().item()
    check(target_err <= RASTER_TOL, f"targets differ by {target_err}")
    for k in ("pck_hit", "pck_cnt"):
        check(torch.equal(mc[k], mg[k].cpu()), f"{k} cpu {mc[k]} vs cuda {mg[k]}")
    check(torch.equal(pc, pg.cpu()), "decoded predictions differ between cpu and cuda")
    emit("parity", loss_cpu=loss_c, loss_cuda=loss_g, score_max_abs_err=score_err,
         target_max_abs_err=target_err, pck_cnt=int(mc["pck_cnt"].sum()))


def main():
    smi = phase_device()
    phase_build()
    raster = phase_kernels()
    cfg = named_config("hg8_mpii")
    predictor = phase_serve(cfg)
    launches = phase_validate(cfg, predictor)
    phase_profile(cfg, predictor)
    phase_parity()

    raster["launches"] = launches["rasterize_gaussians"]
    print(json.dumps({"kernels": [raster]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
