"""Pipelined serving traffic: one client hands request batches to the
program's ``PosePredictor.predict_iter`` (one CUDA graph a shape, at most
``depth`` + 1 batches launched and not yet fetched) in a closed loop, from
a pool of distinct batches in host memory, cycled.

Traffic keys: ``batch`` (requests a batch), ``canvas`` (the square uint8
canvas's side), ``pool`` (distinct batches), ``depth``, ``check_batches``
(the window's batches, drawn from the seed, that ``check`` holds to the
plain reference, ``benchmark/reference/pose_serve.py``).

A batch's latency runs from the moment the client's generator hands it to
``predict_iter`` to the moment its results are on the host.
"""

from __future__ import annotations

import time
from collections import deque

import torch
from torch.profiler import record_function

from benchmark import counts
from benchmark.compare import serve_numbers
from benchmark.drivers.common import Clock, Phases, free, port_network, reference_precision
from benchmark.frozen.synthetic import generator, serve_pool
from benchmark.reference import pose_serve
from benchmark.weights import load_, make_weights

KIND = "serve"
FIELDS = ("images", "valid_wh", "center", "scale")


class Ctx:
    pass


def setup(cfg, traffic, seed, device):
    from posetpu_torch.infer import PosePredictor

    c = Ctx()
    c.cfg, c.traffic, c.seed, c.device = cfg, traffic, seed, device
    c.phases = Phases(device)
    model = port_network(cfg, device)
    c.weights = make_weights(model, seed, device)
    load_(model, c.weights)
    c.predictor = PosePredictor(model, mean=tuple(cfg["mean"]),
                                inp_res=tuple(cfg["aug"]["inp_res"]),
                                out_res=tuple(cfg["aug"]["out_res"]), device=device)
    pool = serve_pool(seed + 1, traffic["pool"], traffic["batch"], traffic["canvas"], device)
    c.pool = pool
    c.host = [tuple(pool[f][i].cpu().numpy() for f in FIELDS)
              for i in range(traffic["pool"])]
    c.phases.mark("built")
    # the capture, then the pipeline's own buffers
    c.predictor(*c.host[0])
    c.phases.mark("captured")
    for _ in c.predictor.predict_iter(iter(c.host), depth=traffic["depth"]):
        pass
    return c


def window(c, seconds):
    """Batches handed to ``predict_iter`` until ``seconds`` have passed,
    the ones in flight then drained; the records of the window."""
    clock = Clock(c.device)
    if c.predictor.graphs is not None:
        c.predictor.graphs.timer = clock  # each batch's copies in and replay
    handed, lat, c.served = deque(), [], []
    pool = len(c.host)
    t0 = time.perf_counter()

    def client():
        i = 0
        while time.perf_counter() - t0 < seconds:
            handed.append((time.perf_counter(), i % pool))
            yield c.host[i % pool]
            i += 1

    with record_function("bench.serve"):
        for out in c.predictor.predict_iter(client(), depth=c.traffic["depth"]):
            t, i = handed.popleft()
            lat.append((time.perf_counter() - t) * 1e3)
            c.served.append((i, out))
    window_s = time.perf_counter() - t0
    if c.predictor.graphs is not None:
        c.predictor.graphs.timer = None
    res = c.cfg["aug"]["inp_res"][0]
    return {"kind": KIND, "images": len(lat) * c.traffic["batch"], "units": len(lat),
            "window_s": window_s, "latencies_ms": lat, "spans_ms": clock.ms(),
            "flops_per_image": counts.hourglass_forward_flops(c.cfg["model"], res)}


def _sample(c):
    """The served batches the check compares, drawn from the seed."""
    n = len(c.served)
    take = min(c.traffic["check_batches"], n)
    g = generator(c.seed + 2, "cpu")
    return [c.served[int(j)] for j in torch.randperm(n, generator=g)[:take]]


def _reference(c, i, quant=False):
    cfg = c.cfg
    return pose_serve.heatmaps(c.weights, c.pool["images"][i], c.pool["center"][i],
                               c.pool["scale"][i], model=cfg["model"],
                               inp_res=cfg["aug"]["inp_res"], mean=cfg["mean"],
                               quant=quant)


def _numbers(c, outs):
    """The worst of each number over ``outs``: (pool index, outputs)."""
    worst = {}
    for i, out in outs:
        heat = _reference(c, i)
        got = serve_numbers({k: torch.as_tensor(out[k], device=c.device)
                             for k in ("pred", "conf", "heatmap_coords")},
                            heat, c.pool["center"][i], c.pool["scale"][i],
                            c.cfg["aug"]["out_res"])
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def program_side(c):
    outs = _sample(c)
    c.predictor = None
    free(c.device)
    reference_precision()
    return outs


def check(c):
    outs = program_side(c)
    return _numbers(c, outs), {"batches": len(outs), "served": len(c.served),
                               "setup_phases": c.phases}


def calibrate(c):
    """The program's readings, the control's (the reference in fp8 in the
    program's place) and a planted fault's (one joint's keypoint of each
    batch moved by a source pixel where it is produced)."""
    outs = program_side(c)
    out_res = c.cfg["aug"]["out_res"]
    control = []
    for i, _ in outs:
        heat = _reference(c, i, quant=True)
        control.append((i, pose_serve.decode(heat, c.pool["center"][i],
                                             c.pool["scale"][i], out_res)))
    moved = []
    for i, out in outs:
        out = dict(out)
        out["pred"] = out["pred"].copy()
        out["pred"][0, 0, 0] += 1.0
        moved.append((i, out))
    return {"program": _numbers(c, outs),
            "control": _numbers(c, [(i, {k: v.cpu().numpy() for k, v in o.items()})
                                    for i, o in control]),
            "fault_moved_keypoint": _numbers(c, moved)}
