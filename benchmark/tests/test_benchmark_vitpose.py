"""The ViTPose cell: the operation counts against
``torch.utils.flop_counter``, the weights drawn for every state entry, the
cell found by name, the benchmark's reference against the tests'
(``tests/torch_vitpose_reference.py``), and whole tiny runs on the CPU,
sound and with faults planted underneath."""

import importlib.util
import json
import os

import pytest
import torch
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts_vitpose, run
from benchmark.reference.vitpose import Net, keep_scales
from benchmark.tests.tiny import HERE, ROOT, tiny_cells
from benchmark.weights_vit import make_weights

SEED = 2**31 + 2121
TINY_MODEL = dict(embed_dim=64, vit_depth=2, num_heads=4, img_size=64, bf16=False)
# float32 on both sides; AdamW's first update is +-lr whatever the
# gradient's size, so a leaf's change moves by round-off where a
# gradient's sign does; a state left unchanged reads 1, half a batch
# moves the first loss by far more than 1e-4
TINY_LIMITS = {"first_loss_gap": 1e-4, "median_grad_gap": 1e-3, "median_change_gap": 0.2}


def _config():
    with open(os.path.join(HERE, "configs", "vitpose_h_mpii.json")) as f:
        return json.load(f)


def _tiny_net():
    from posetpu_torch.configs import ViTConfig
    from posetpu_torch.models import build_model

    return build_model(ViTConfig(**TINY_MODEL))


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The tiny cells of ``tiny.py`` and ``tiny_vit.train``."""
    spec, here = tiny_cells(tmp_path_factory.mktemp("vit"))
    cfg = _config()
    cfg["model"].update(TINY_MODEL)
    cfg["aug"].update(inp_res=[64, 64], out_res=[16, 16])
    cfg["batch"] = 4
    with open(os.path.join(here, "configs", "tiny_vit.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(HERE, "traffic", "vit_train_k1.json")) as f:
        traffic = json.load(f)
    traffic.update(pool=4)
    with open(os.path.join(here, "traffic", "tiny_vit_train.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(here, "limits", "tiny_vit.train.json"), "w") as f:
        json.dump(TINY_LIMITS, f)
    spec["workloads"].append({"name": "tiny_vit.train", "config": "tiny_vit",
                              "traffic": "tiny_vit_train", "chips": 1, "why": "test"})
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            if "workloads" in m:
                m["workloads"] = [{"vitpose_h_mpii.train": "tiny_vit.train"}.get(w, w)
                                  for w in m["workloads"]]
    return spec, here


def run_tiny(cells, workload, trace=False, seconds=0.3):
    spec, here = cells
    return run.run_cell(spec, workload, SEED, seconds, trace, torch.device("cpu"), here=here)


def test_vitpose_flops_equal_the_flop_counter():
    cfg = _config()
    m = dict(cfg["model"], **TINY_MODEL)
    net = _tiny_net().eval()
    with sdpa_kernel(SDPBackend.MATH), FlopCounterMode(display=False) as fc:
        net(torch.zeros(2, 64, 64, 3))
    assert fc.get_total_flops() == 2 * counts_vitpose.vitpose_flops(m, 64)
    assert counts_vitpose.vitpose_flops(cfg["model"], 256) == 338_228_674_560


def test_published_flops_on_the_meta_device():
    from benchmark.drivers.graphed_vit_train import port_configs
    from posetpu_torch.models import build_model

    cfg = _config()
    with torch.device("meta"):
        net = build_model(port_configs(cfg)[0]).eval()
        x = torch.zeros(1, 256, 256, 3)
    with sdpa_kernel(SDPBackend.MATH), FlopCounterMode(display=False) as fc:
        net(x)
    assert fc.get_total_flops() == counts_vitpose.vitpose_flops(cfg["model"], 256)
    # a step's attention: 2.06 TFLOP at batch 64 over 32 layers
    assert 32 * counts_vitpose.attention_ops(64, 16, 256, 80) == 2_061_584_302_080


def test_weights_draw_every_state_entry():
    net = _tiny_net()
    w = make_weights(net, SEED, torch.device("cpu"))
    assert set(w) == set(net.state_dict())
    assert torch.equal(w["pos_embed"], make_weights(net, SEED, torch.device("cpu"))["pos_embed"])
    assert float(w["pos_embed"].abs().max()) <= 0.02 * 3 ** 0.5


def test_the_new_cell_is_found_by_name():
    spec = run.manifest()
    cell, cfg, traffic, limits = run.cell_files(spec, "vitpose_h_mpii.train")
    assert traffic["driver"] == "graphed_vit_train" and limits and cell["chips"] == 1
    assert run.driver(traffic).KIND == "train"
    assert cfg["parameters"] == 637_290_512 and cfg["reduced"] == [] and cfg["batch"] == 64
    names = {m["name"] for m in run.cell_metrics(spec, "vitpose_h_mpii.train", "per_layer")}
    assert {"attention_roofline.vit", "optim_device_ms.vit", "mfu.train"} <= names


def _tests_reference():
    path = os.path.join(ROOT, "tests", "torch_vitpose_reference.py")
    spec = importlib.util.spec_from_file_location("torch_vitpose_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("train", [False, True])
def test_the_benchmark_reference_equals_the_tests_reference(train):
    ref = _tests_reference()
    net = _tiny_net()
    w = make_weights(net, SEED, torch.device("cpu"))
    x = torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    index = torch.tensor([5, 77, 2**31 - 9])
    m = dict(_config()["model"], **TINY_MODEL)
    keep = keep_scales(SEED, 4, index, m["vit_depth"], m["drop_path_rate"]) if train else None
    got = Net(w, m, train=train)(x, keep)
    want = ref.forward(w, x, depth=2, heads=4, patch=16, padding=2, rate=0.55, train=train,
                       keys=(SEED, 4, index))
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_sound_run_is_correct(cells):
    line = run_tiny(cells, "tiny_vit.train")
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"train_img_s", "setup_s"}
    assert len(line["details"]["grad_norms"]) == 3


def test_traced_cpu_run_reads_what_it_can(cells):
    line = run_tiny(cells, "tiny_vit.train", trace=True)
    # no device trace on the CPU: the rooflines and device ms read nothing
    assert set(line["metrics"]) == {"mfu.train"}
    assert line["details"]["optim.param_groups"] == 8


def test_state_left_unchanged_is_caught(cells, monkeypatch):
    from posetpu_torch.train.state import LayerDecayAdamW

    monkeypatch.setattr(LayerDecayAdamW, "step_at", lambda self, count: count.add_(1))
    line = run_tiny(cells, "tiny_vit.train")
    assert not line["correct"]
    assert line["checks"]["median_change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_caught(cells, monkeypatch):
    from posetpu_torch.train import step

    real = step.stacked_mse

    def half(outputs, target, *weight):
        n = target.shape[0] // 2
        return real([o[:n] for o in outputs], target[:n],
                    *(None if w is None else w[:n] for w in weight))

    monkeypatch.setattr(step, "stacked_mse", half)
    line = run_tiny(cells, "tiny_vit.train")
    assert not line["correct"]
