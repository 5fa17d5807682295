"""Kernel-level profile of a train or joint step — the counterpart of
``tools/profile_step.py``: ``torch.profiler`` over ``--steps`` steps at full
width, then the top kernels by device time with their counts.

The steps run as the driver runs them, through the CUDA graph of one step
(:func:`posetpu_torch.train.step.make_dispatch_step`,
:func:`posetpu_torch.train.adversarial.make_joint_dispatch_step`), or
eagerly with ``--eager``.  The trace is the Chrome trace that
:func:`posetpu_torch.utils.profiling.trace` writes; ``--parse-only`` reads
one such file.  Device events (kernels, copies, fills) are summed by name;
a trace without them (a CPU run) is summed over its host operators, whose
times include the operators they call.  ``--by-category`` sums by the
kinds of :data:`PROFILE_KINDS` instead.

    python -m posetpu_torch.tools.profile_step [--joint] [--eager]
        [--stacks 8] [--feats 128] [--batch 32] [--steps 3] [--top 20]
        [--trace-dir DIR] [--parse-only TRACE.json] [--by-category]
        [--out FILE] [--cpu]

Runs on CUDA unless ``--cpu``.  :func:`profile_run` is the in-process
counterpart over one call, which ``chip_smoke.py`` reads.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

# kernel-name patterns that sort device time into kinds; the first match
# wins, anything unmatched is "other elementwise"
PROFILE_KINDS = (
    ("rasterize", ("rasterize",)),
    ("copies", ("Memcpy", "Memset")),
    ("convolution / gemm", ("gemm", "xmma", "nvjet", "conv", "cutlass", "cudnn")),
    ("batch_norm", ("batch_norm",)),
    ("upsample / pool", ("upsample", "pool")),
    ("gather / index (warp, decode)", ("index", "gather")),
    ("reductions", ("reduce",)),
    ("optimizer and BN-statistics update (_foreach)", ("multi_tensor_apply",)),
    ("dtype casts", ("_copy_kernel",)),
)
OTHER_KIND = "other elementwise"

# Chrome-trace categories of the device's own events
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CAT = "cpu_op"


def kind_of(name):
    """The :data:`PROFILE_KINDS` kind of a kernel (or operator) name."""
    return next((k for k, keys in PROFILE_KINDS if any(s in name for s in keys)),
                OTHER_KIND)


def profile_run(run, top=8):
    """One call of ``run()`` (already warm) under torch.profiler on the
    card: device time by kernel and kind, the framework ops that launched
    it, and the idle share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        # record_function ranges (torch.optim's "Optimizer.step#...") also
        # land on the device timeline; they are spans over kernels, not work
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    if busy_ms <= 0:
        raise RuntimeError("the profiler saw no device time")
    by_kind = {}
    for name, ms in by_name.items():
        kind = kind_of(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # the framework ops that launched that time (self device time per op)
    ops = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.key.startswith("aten::") and e.self_device_time_total > 0),
        key=lambda t: -t[1],
    )[:top]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=max(0.0, 1.0 - busy_ms / wall_ms), kernels=len(by_name),
                by_kind_ms=dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
                top_kernels=[{"name": n[:90], "ms": ms} for n, ms in ranked],
                top_ops=[{"op": k, "ms": ms, "calls": c} for k, ms, c in ops])


def summarize_trace(path, top=20, by_category=False):
    """``[(track, [(name, ms, count), ...]), ...]`` of a Chrome trace: the
    device's events summed by name (or kind), or, where the trace holds
    none, the host operators (inclusive times), the largest ``top`` (all
    with ``top=None``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tracks = (("device (kernels, copies, fills)", DEVICE_CATS),
              ("host operators (inclusive)", (HOST_CAT,)))
    out = []
    for track, cats in tracks:
        tot, cnt = defaultdict(float), defaultdict(int)
        for ev in events:
            if ev.get("ph") != "X" or ev.get("cat") not in cats:
                continue
            name = kind_of(ev["name"]) if by_category else ev["name"]
            tot[name] += float(ev.get("dur", 0.0)) / 1e3
            cnt[name] += 1
        if tot:
            rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
            out.append((track, [(n, ms, cnt[n]) for n, ms in rows]))
            break  # the host's operators only stand in for a trace without a device
    return out


def format_summary(path, summary):
    lines = [f"[profile] source: {path}"]
    for track, rows in summary:
        lines.append(f"\n== {track}")
        for name, ms, c in rows:
            lines.append(f"  {ms:9.2f} ms  x{c:<5} {name[:95]}")
    return lines


def _batch(B, dev, pad=320):
    """The reference tool's in-memory batch: random pixels on a pad x pad
    canvas, 16 joints."""
    rng = np.random.RandomState(0)
    b = {
        "image": (rng.rand(B, pad, pad, 3) * 255).astype(np.uint8),
        "valid_wh": np.tile([[pad, pad]], (B, 1)).astype(np.int32),
        "center": np.tile([[160.3, 160.2]], (B, 1)).astype(np.float32),
        "scale": np.full((B,), 1.28, np.float32),
        "pts": (rng.rand(B, 16, 2) * 200 + 60).astype(np.float32),
        "vis": np.ones((B, 16), np.float32),
        "index": np.arange(B, dtype=np.int32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def build_step(joint, stacks, feats, batch, eager, dev):
    """``run()``, the tool's step: it takes one step of
    hg8_mpii (or hg8_mpii_asr with ``joint``) at ``stacks``/``feats``, on
    an in-memory batch, through the driver's one-step graph or eagerly."""
    from posetpu_torch.configs import named_config
    from posetpu_torch.models import build_model
    from posetpu_torch.train import (
        JointState,
        TrainState,
        agent_from_config,
        make_dispatch_step,
        make_joint_dispatch_step,
        make_joint_step,
        make_optimizer,
        make_train_step,
    )
    from posetpu_torch.train.loop import seeded_init_

    cfg = named_config("hg8_mpii_asr" if joint else "hg8_mpii")
    mean = (0.44, 0.44, 0.43)
    cfg.model.stacks, cfg.model.feats = stacks, feats
    model = seeded_init_(build_model(cfg.model), 0).to(dev)
    opt = make_optimizer(model.parameters(), cfg.optim, 1000)
    pose = TrainState(model, opt)
    b = _batch(batch, dev)
    if joint:
        agent, agent_opt, kw = agent_from_config(cfg, steps_per_epoch=1000, device="cpu")
        seeded_init_(agent, 1).to(dev)
        state = JointState(pose, TrainState(agent, agent_opt))
        args = (model, agent, opt, agent_opt, cfg.aug, mean)
        step = (make_joint_step(*args, seed=0, device=dev, **kw) if eager else
                make_joint_dispatch_step(*args, seed=0, steps=1, device=dev, **kw))
    else:
        state = pose
        step = (make_train_step(model, opt, cfg.aug, mean, seed=0, device=dev) if eager
                else make_dispatch_step(model, opt, cfg.aug, mean, seed=0, steps=1,
                                        device=dev))
    if not eager:
        b = {k: v[None] for k, v in b.items()}  # a superbatch of one step
    return lambda: step(state, b)


def main(argv=None):
    """Returns ``{"trace": path, "summary": [(track, rows)], "lines": [...]}``."""
    ap = argparse.ArgumentParser(prog="python -m posetpu_torch.tools.profile_step")
    ap.add_argument("--joint", action="store_true")
    ap.add_argument("--eager", action="store_true",
                    help="eager steps instead of the driver's one-step CUDA graph")
    ap.add_argument("--stacks", type=int, default=8)
    ap.add_argument("--feats", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace-dir", default=None,
                    help="default: posetpu_torch_trace in the temp directory")
    ap.add_argument("--parse-only", default=None, help="an existing Chrome trace")
    ap.add_argument("--by-category", action="store_true",
                    help="sum device time by kernel kind instead of kernel name")
    ap.add_argument("--out", default=None, help="also write the table to this file")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    if args.parse_only:
        path = args.parse_only
    else:
        from posetpu_torch.utils.device import resolve_device
        from posetpu_torch.utils.profiling import trace

        dev = resolve_device("cpu" if args.cpu else "cuda")
        trace_dir = args.trace_dir or os.path.join(tempfile.gettempdir(),
                                                   "posetpu_torch_trace")
        run = build_step(args.joint, args.stacks, args.feats, args.batch, args.eager, dev)
        for _ in range(3):  # the graph's capture, cuDNN and cuBLAS set-up
            m = run()
        float(m["loss"].reshape(-1)[-1])
        with trace(trace_dir):
            for _ in range(args.steps):
                m = run()
            float(m["loss"].reshape(-1)[-1])
        path = os.path.join(trace_dir, f"trace_{os.getpid()}.json")
        print(f"[profile] trace: {path}")

    summary = summarize_trace(path, args.top, args.by_category)
    lines = format_summary(path, summary)
    print("\n".join(lines))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"[profile] summary written: {args.out}")
    return {"trace": path, "summary": summary, "lines": lines}


if __name__ == "__main__":
    main()
