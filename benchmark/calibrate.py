"""The readings that a cell's limits of ``correct`` are set from.

    python3 -m benchmark.calibrate --workload <name> --seeds <n> [<n> ...]
        [--out FILE]

For each seed: the cell's set-up (which runs the steps or the batches that
the check compares; no measured window for training, a short one of
``--seconds`` for serving), then the driver's ``calibrate``: the
program's numbers against the plain reference, the control's (the
reference computed in the next precision below the configuration's, fp8
for bf16, in the program's place) and each planted fault's.  One JSON
line a seed goes to stdout (and to ``--out``); the run's own runs never
call this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import run


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.cache_env()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell, cfg, traffic, _ = run.cell_files(run.manifest(), args.workload)
    drv = run.driver(traffic)
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = drv.setup(cfg, traffic, seed, dev)
        if drv.KIND == "serve":
            drv.window(ctx, args.seconds)
        got = drv.calibrate(ctx)
        line = {"workload": args.workload, "seed": seed, **got,
                "seconds": time.perf_counter() - t0}
        del ctx
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
