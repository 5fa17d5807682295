"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``; everything else is found by name:

- its configuration: ``benchmark/configs/<config>.json``;
- its traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``driver``
  names the general driver that reads it (``benchmark/drivers/``);
- its limits of ``correct``: ``benchmark/limits/<workload>.json``;
- each metric: a reader ``benchmark/metrics/<metric>.py`` whose
  ``read(records)`` returns the number, or None where it finds nothing to
  read (the metric is then left out of the line).

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` the window runs under ``torch.profiler`` and the line
holds the per-layer metrics, ``device.busy_s``, ``device.window_s`` and a
``breakdown``.  ``setup_s`` runs from the start of this process to the end
of the driver's set-up (imports, CUDA, the kernels' builds, weights,
inputs, captures).  After the window the peak memory is read, the
program's state freed, and the driver compares what the timed path
produced with the plain reference: each number beside its limit goes to
stderr as the last lines and under ``checks``, the line's last key.

It exits with 2, and prints no result, without CUDA or with fewer cards
than the cell asks for, and with 3 if ``jax``, ``jaxlib``, ``flax`` or
the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "posetpu")


def cache_env():
    """Every build and kernel cache at a fixed directory of the checkout."""
    cache = os.path.join(HERE, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest(root=ROOT):
    return load_json(root, "BENCHMARK.json")


def cell_files(spec, workload, here=HERE):
    """(cell, configuration, traffic, limits) of ``workload``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg = load_json(here, "configs", cell["config"] + ".json")
    traffic = load_json(here, "traffic", cell["traffic"] + ".json")
    limits_path = os.path.join(here, "limits", workload + ".json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else None
    return cell, cfg, traffic, limits


def driver(traffic):
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def reader(name, here=HERE):
    """The ``read`` function of metric ``name``'s own file."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec, workload, group):
    """The entries of ``group`` that ``workload`` reports."""
    return [m for m in spec[group] if workload in m.get("workloads", [workload])]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(numbers, limits):
    """(correct, {number: {value, limit}}) of the numbers the cell's
    limits hold: correct where each is at or under its limit.  A cell
    without limits, or a limit without its number, is not correct."""
    checks = {n: {"value": numbers.get(n), "limit": lim} for n, lim in (limits or {}).items()}
    ok = bool(checks) and all(c["value"] is not None and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks


def run_cell(spec, workload, seed, seconds, trace, device, t0=T0, here=HERE):
    """One run of ``workload`` on ``device``: the result line's dict."""
    import torch

    cell, cfg, traffic, limits = cell_files(spec, workload, here)
    drv = driver(traffic)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()
    started = time.perf_counter() - t0  # the process, the imports and CUDA
    ctx = drv.setup(cfg, traffic, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from benchmark.trace import summarize

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                rec = drv.window(ctx, seconds)
            if cuda:
                torch.cuda.synchronize(device)
        rec["profile"] = summarize(prof) if cuda else None
        del prof
    else:
        rec = drv.window(ctx, seconds)
    rec["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    numbers, details = drv.check(ctx)
    correct, checks = judge(numbers, limits)
    metrics = {}
    for m in cell_metrics(spec, workload, "per_layer" if trace else "end_to_end"):
        v = reader(m["name"], here)(rec)
        if v is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": rec["units"], "failed": 0,
            "metrics": metrics, "device": dev}
    prof = rec.get("profile")
    if prof:
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    line["details"] = {**details, "setup_started_s": started,
                       "not_held": {n: v for n, v in numbers.items() if n not in checks}}
    line["checks"] = checks
    return line


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cache_env()
    spec = manifest()
    cell = cell_files(spec, args.workload)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr,
              flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
