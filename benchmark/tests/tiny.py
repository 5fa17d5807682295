"""Tiny copies of the benchmark's cells for the CPU tests: the committed
configuration, traffic and metric files copied into a temporary directory
and cut to a size a CPU test holds (two stacks of width 16, two hourglass
levels, float32, 64x64 crops, batches of 4), with limits of their own."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

# limits of the tiny float32 cells: both sides compute the same float32
# operations but for the order of some sums, so the first loss agrees to
# round-off; RMSprop's first update is about +-10 lr whatever the
# gradient's size, so an element whose gradient's sign differs by round-off
# moves the other way, and the median leaf's change over two steps drifts
# by up to 0.03 (CPU, three seeds); a step that leaves the state unchanged
# reads 1
TINY_LIMITS = {
    "tiny.train": {"first_loss_gap": 1e-4, "median_change_gap": 0.2},
    "tiny.serve": {"score_gap": 1e-4, "conf_gap": 1e-4, "pred_px": 0.0},
    "tiny_asr.joint": {"first_loss_gap": 1e-4, "median_change_gap": 0.2},
    "tiny.train_loader": {"canvas_lsb": 0.0, "meta_gap": 0.0, "first_loss_gap": 1e-4,
                          "median_change_gap": 0.2},
}


def _dump(obj, *parts):
    with open(os.path.join(*parts), "w") as f:
        json.dump(obj, f)


def tiny_cells(tmp):
    """(manifest, directory) of the tiny cells ``tiny.train``,
    ``tiny_asr.joint``, ``tiny.serve`` and ``tiny.train_loader`` under
    ``tmp``."""
    here = os.path.join(str(tmp), "bench")
    for d in ("metrics", "configs", "traffic"):
        shutil.copytree(os.path.join(HERE, d), os.path.join(here, d))
    os.makedirs(os.path.join(here, "limits"))
    for src, name in (("hg8_mpii", "tiny"), ("hg8_mpii_asr", "tiny_asr")):
        with open(os.path.join(HERE, "configs", src + ".json")) as f:
            cfg = json.load(f)
        cfg["model"].update(stacks=2, feats=8, depth=2, bf16=False)
        cfg["aug"].update(inp_res=[64, 64], out_res=[16, 16])
        cfg["batch"] = 4
        _dump(cfg, here, "configs", name + ".json")
    for src, name in (("train_k1", "tiny_train"), ("joint_k1", "tiny_joint")):
        with open(os.path.join(HERE, "traffic", src + ".json")) as f:
            train = json.load(f)
        train.update(pool=4)
        _dump(train, here, "traffic", name + ".json")
    with open(os.path.join(HERE, "traffic", "serve_depth2.json")) as f:
        serve = json.load(f)
    serve.update(batch=4, canvas=80, pool=3, check_batches=2)
    _dump(serve, here, "traffic", "tiny_serve.json")
    with open(os.path.join(HERE, "traffic", "loader_k1.json")) as f:
        loader = json.load(f)
    loader.update(frames=16, frame_wh=[160, 120], canvas=[128, 160])
    _dump(loader, here, "traffic", "tiny_loader.json")
    for name, lim in TINY_LIMITS.items():
        _dump(lim, here, "limits", name + ".json")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    rename = {"hg8_mpii.train": "tiny.train", "hg8_mpii.serve": "tiny.serve",
              "hg8_mpii_asr.joint": "tiny_asr.joint",
              "hg8_mpii.train_loader": "tiny.train_loader"}
    spec["workloads"] = [dict(w, name=rename[w["name"]], config="tiny" + w["config"][8:],
                              traffic="tiny_" + w["traffic"].split("_")[0])
                         for w in spec["workloads"] if w["name"] in rename]
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            if "workloads" in m:
                m["workloads"] = [rename.get(w, w) for w in m["workloads"]]
    return spec, here
