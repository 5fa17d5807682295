"""The harness is driven by data: a new configuration, traffic mix and
metric are added as files in a directory of their own, and a run finds
them by name with no file edited."""

import json
import os

import torch

from benchmark import run
from benchmark.tests.tiny import tiny_cells

SEED = 2**31 + 1717


def test_new_configuration_traffic_and_metric_from_files_alone(tmp_path):
    spec, here = tiny_cells(tmp_path)
    with open(os.path.join(here, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny_wide"
    cfg["model"]["feats"] = 12
    with open(os.path.join(here, "configs", "tiny_wide.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(here, "traffic", "tiny_serve.json")) as f:
        traffic = json.load(f)
    traffic.update(batch=2, depth=0)
    with open(os.path.join(here, "traffic", "tiny_serve_sequential.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(here, "metrics", "batches_served.serve.py"), "w") as f:
        f.write("def read(rec):\n    return rec['units'] if rec.get('kind') == 'serve' else None\n")
    with open(os.path.join(here, "limits", "tiny_wide.serve.json"), "w") as f:
        json.dump({"score_gap": 1e-4, "conf_gap": 1e-4, "pred_px": 0.0}, f)
    spec["workloads"].append({"name": "tiny_wide.serve", "config": "tiny_wide",
                              "traffic": "tiny_serve_sequential", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("serve_img_s", "serve_p95_ms"):
            m["workloads"].append("tiny_wide.serve")
    spec["per_layer"].append({"name": "batches_served.serve", "unit": "batches",
                              "better": "higher", "source": "host_clock", "layer": "device",
                              "moves": "serve_img_s", "workloads": ["tiny_wide.serve"]})
    line = run.run_cell(spec, "tiny_wide.serve", SEED, 0.3, True, torch.device("cpu"),
                        here=here)
    assert line["correct"], line["checks"]
    assert line["metrics"]["batches_served.serve"]["value"] == line["attempted"] > 0
    line = run.run_cell(spec, "tiny_wide.serve", SEED, 0.3, False, torch.device("cpu"),
                        here=here)
    assert set(line["metrics"]) == {"serve_img_s", "serve_p95_ms", "setup_s"}


def test_a_reader_that_finds_nothing_leaves_its_metric_out(tmp_path):
    spec, here = tiny_cells(tmp_path)
    # the per-layer metrics of a traced CPU run: the device spans and the
    # profile of the card are absent, the operation counts are there
    line = run.run_cell(spec, "tiny.train", SEED, 0.3, True, torch.device("cpu"), here=here)
    assert set(line["metrics"]) == {"mfu.train"}
    assert 0 < line["metrics"]["mfu.train"]["value"]
