"""Duty cycle of the real training pipeline — the counterpart of
``tools/duty_cycle.py``: a synthetic split at 512x384, decoded by
:class:`posetpu_torch.data.HostLoader` and placed on the card by
:func:`posetpu_torch.data.make_batch_placer` (as
:class:`posetpu_torch.train.loop.Experiment` wires them), into the train
step through the driver's CUDA graph of K steps.

    python -m posetpu_torch.tools.duty_cycle [--stacks 8] [--feats 128]
        [--batch 16] [--res 256] [--steps 30] [--backend auto|native|pil|gpu]
        [--k-per-dispatch K] [--trace DIR] [--cpu]

Prints ``device_step``, ``wall_step``, ``duty_cycle`` and ``images/sec``
(:func:`posetpu_torch.utils.profiling.measure_duty_cycle`, or
:func:`~posetpu_torch.utils.profiling.measure_duty_cycle_fused` for K > 1).
The split lives in ``posetpu_torch_duty_synth`` under the temp directory,
sized to whole K x B groups, and is made again when the one there is not.
Runs on CUDA unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

# images of the split before it is rounded up to whole K x B groups
NUM_IMAGES = 256
IMAGE_RES = (512, 384)  # (W, H) of the synthetic frames
MEAN = (0.44, 0.44, 0.43)


def split_root():
    return os.path.join(tempfile.gettempdir(), "posetpu_torch_duty_synth")


def make_split(unit):
    """The annotation file of the train split, whole ``unit``-image groups
    of at least :data:`NUM_IMAGES` (:func:`posetpu_torch.data.synthetic.whole_group_split`)."""
    from posetpu_torch.data.synthetic import whole_group_split

    return whole_group_split(split_root(), NUM_IMAGES, unit, IMAGE_RES)


def main(argv=None):
    """Returns ``{"device_step", "wall_step", "duty_cycle",
    "images_per_sec"}`` (seconds a step, the duty as a fraction)."""
    ap = argparse.ArgumentParser(prog="python -m posetpu_torch.tools.duty_cycle")
    ap.add_argument("--stacks", type=int, default=8)
    ap.add_argument("--feats", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--backend", default="auto")
    ap.add_argument(
        "--k-per-dispatch", type=int, default=1,
        help="measure the steps_per_dispatch=K path (K batches a CUDA graph)",
    )
    ap.add_argument("--trace", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from posetpu_torch.configs import named_config
    from posetpu_torch.data import HostLoader, MpiiDataset, make_batch_placer
    from posetpu_torch.models import build_model
    from posetpu_torch.train import TrainState, make_dispatch_step, make_optimizer
    from posetpu_torch.train.loop import seeded_init_
    from posetpu_torch.utils.device import resolve_device
    from posetpu_torch.utils.profiling import (
        DEVICE_STEPS,
        measure_duty_cycle,
        measure_duty_cycle_fused,
        trace,
    )

    dev = resolve_device("cpu" if args.cpu else "cuda")
    K = max(1, args.k_per_dispatch)
    json_path = make_split(args.batch * K)
    ds = MpiiDataset(json_path, os.path.join(split_root(), "images"), split="train")
    loader = HostLoader(
        ds, args.batch, pad_hw=(IMAGE_RES[1], IMAGE_RES[0]), backend=args.backend,
        prefetch=4, place=make_batch_placer(dev), group=K,
    )

    cfg = named_config("hg8_mpii")
    cfg.aug.inp_res = (args.res, args.res)
    cfg.aug.out_res = (args.res // 4, args.res // 4)
    cfg.model.stacks, cfg.model.feats = args.stacks, args.feats
    model = seeded_init_(build_model(cfg.model), 0).to(dev)
    opt = make_optimizer(model.parameters(), cfg.optim, 1000)
    state = TrainState(model, opt)

    def dispatch_of(steps):
        return make_dispatch_step(model, opt, cfg.aug, MEAN, seed=0, steps=steps,
                                  device=dev)

    step, device_dispatch = dispatch_of(K), dispatch_of(DEVICE_STEPS)
    if K > 1:
        def run():
            return measure_duty_cycle_fused(step, device_dispatch, state, loader,
                                            max_dispatches=max(1, args.steps // K))
    else:
        def run():
            return measure_duty_cycle(step, device_dispatch, state, loader, args.steps)
    if args.trace:
        with trace(args.trace):
            duty, t_dev, t_wall = run()
    else:
        duty, t_dev, t_wall = run()
    ips = args.batch / t_wall
    mode = f"K={K}/dispatch" if K > 1 else "per-dispatch"
    print(
        f"device_step={t_dev*1e3:.2f}ms wall_step={t_wall*1e3:.2f}ms "
        f"duty_cycle={duty*100:.1f}% images/sec={ips:.1f} "
        f"(backend={loader.backend}, {mode}, decode+H2D overlap "
        f"{'OK' if duty >= 0.95 else 'LIMITED'})",
        flush=True,
    )
    return {"device_step": t_dev, "wall_step": t_wall, "duty_cycle": duty,
            "images_per_sec": ips, "backend": loader.backend,
            "device_captures": device_dispatch.captures, "captures": step.captures}


if __name__ == "__main__":
    main()
