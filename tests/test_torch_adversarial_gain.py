"""posetpu_torch.tools.adversarial_gain against tools/adversarial_gain.py.

``build_cfg`` sets every field the JAX tool's sets, to the same values, for
phase 1 and both arms (the JAX tool is loaded from ``tools/`` here only).
The reuse guards end the run: a split made with other arguments, and a
reused arm A that trained another number of epochs than arm B would get.
``--quick --cpu`` runs the protocol end to end and writes ``result.json``
with the JAX tool's fields (and ``scored`` where an arm was scored from
its latest checkpoint, which only ``--quick`` allows); a sweep with
``--skip-phase1 --skip-arm-a --arm-b-tag`` reuses phase 1 and arm A (arm
A's PCKh read again equal).
"""

import argparse
import ast
import dataclasses
import importlib.util
import json
import os

import pytest
import torch

from posetpu_torch.tools import adversarial_gain as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_TOOL = os.path.join(REPO, "tools", "adversarial_gain.py")


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread for this module's CPU training (the suite runs
    several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_tool():
    spec = importlib.util.spec_from_file_location("ref_adversarial_gain", REF_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(**kw):
    base = dict(stacks=2, feats=128, res=256, batch=16, seed=3, epochs1=40, epochs2=60,
                pose_ref_weight=0.0, no_occlusion=False)
    base.update(kw)
    return argparse.Namespace(**base)


def _same_fields(port, ref, path=""):
    """Every field of the port's config equals the JAX config's."""
    for k, v in port.items():
        assert k in ref, f"{path}{k} missing from the JAX config"
        if isinstance(v, dict):
            _same_fields(v, ref[k], f"{path}{k}.")
        elif isinstance(v, (list, tuple)):
            assert list(v) == list(ref[k]), f"{path}{k}: {v} vs {ref[k]}"
        else:
            assert v == ref[k] and type(v) is type(ref[k]), f"{path}{k}: {v!r} vs {ref[k]!r}"


@pytest.mark.parametrize("name,adversarial,init,kw", [
    ("phase1", False, "", {}),
    ("armA_baseline", False, "out/phase1", {}),
    ("armB_adversarial", True, "out/phase1", {}),
    ("armB_adversarial_w05", True, "out/phase1", dict(pose_ref_weight=0.5)),
    ("armB_adversarial_noocc", True, "out/phase1", dict(no_occlusion=True)),
])
def test_build_cfg_equals_the_jax_tools(name, adversarial, init, kw):
    args = _args(**kw)
    port = tool.build_cfg(name, "a.json", "imgs", "out", args, adversarial=adversarial,
                          init_from=init)
    ref = _ref_tool().build_cfg(name, "a.json", "imgs", "out", args,
                                adversarial=adversarial, init_from=init)
    _same_fields(dataclasses.asdict(port), dataclasses.asdict(ref))
    assert port.agent.enabled == adversarial
    assert port.init_pose_from == init


def _ref_result_keys():
    """The keys of the ``result`` dict the JAX tool writes (read from its
    source: running it would jit the whole protocol)."""
    with open(REF_TOOL) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "result" and isinstance(node.value, ast.Dict)):
            keys = {}
            for k, v in zip(node.value.keys, node.value.values):
                keys[k.value] = ({kk.value for kk in v.keys}
                                 if isinstance(v, ast.Dict) else None)
            return keys
    raise AssertionError("no result dict in the JAX tool")


@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("adv_gain"))
    result = tool.main(["--quick", "--cpu", "--out", out])
    return out, result


def test_quick_run_writes_the_jax_tools_result(quick):
    out, result = quick
    with open(os.path.join(out, "result.json")) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(result))
    ref = _ref_result_keys()
    # the JAX tool's keys, and ``scored`` only where --quick scored an arm
    # that wrote no best/ from its latest checkpoint
    scored = written.pop("scored", {})
    assert set(written) == set(ref)
    assert set(scored) <= {"armA_baseline", "armB_adversarial"}
    for arm in ("armA_baseline", "armB_adversarial"):
        wrote_best = os.path.isdir(os.path.join(out, arm, "best"))
        assert scored.get(arm, "best") == ("best" if wrote_best else "latest"), arm
    for k, sub in ref.items():
        if sub is not None:
            assert set(written[k]) == sub, k
    assert written["epochs"] == [2, 2] and written["occlusion"] is True
    assert written["reused_phase1"] is False and written["reused_arm_a"] is False
    for arm in ("armA_baseline", "armB_adversarial"):
        assert 0.0 <= written[arm]["pckh"] <= 100.0
    for run in ("phase1", "armA_baseline", "armB_adversarial"):
        assert tool.trained_epochs(os.path.join(out, run)) == 2
    with open(os.path.join(out, "armB_adversarial", "config.json")) as f:
        cfg = json.load(f)
    assert cfg["init_pose_from"] == os.path.join(out, "phase1")
    assert cfg["agent"]["occ_mode"] == "parts" and cfg["agent"]["occ_nodes"] == 9


def test_sweep_reuses_phase1_and_arm_a(quick):
    out, result = quick
    swept = tool.main(["--quick", "--cpu", "--out", out, "--skip-phase1", "--skip-arm-a",
                       "--arm-b-tag", "w05", "--pose-ref-weight", "0.5"])
    with open(os.path.join(out, "result_w05.json")) as f:
        assert json.load(f) == json.loads(json.dumps(swept))
    assert swept["reused_phase1"] is True and swept["reused_arm_a"] is True
    assert swept["pose_ref_weight"] == 0.5
    assert swept["armA_baseline"] == result["armA_baseline"]
    assert os.path.isdir(os.path.join(out, "armB_adversarial_w05"))


def test_reused_arm_a_of_another_budget_ends_the_run(quick):
    out, _ = quick
    quick_args = ["--stacks", "1", "--feats", "16", "--res", "64", "--num-train", "16",
                  "--num-val", "8", "--batch", "8", "--epochs1", "2"]  # --quick's
    with pytest.raises(SystemExit, match="equal budget"):
        tool.main(["--cpu", "--out", out, "--skip-phase1", "--skip-arm-a", "--epochs2", "3",
                   *quick_args])


def test_split_of_other_arguments_ends_the_run(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    (data / "annotations.json").write_text("[]")
    (data / "meta.json").write_text(json.dumps(
        {"seed": 1, "num_train": 16, "num_val": 8, "hard_val": True}))
    with pytest.raises(SystemExit, match="holds a split made with"):
        tool.main(["--quick", "--cpu", "--out", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["data"]  # nothing trained


@pytest.mark.parametrize("quick", [False, True])
def test_an_arm_without_a_best_checkpoint(tmp_path, quick):
    """Scored from ``best/`` when it exists; without one, the run ends as
    the JAX tool's does, unless --quick, which scores the latest."""
    from types import SimpleNamespace

    from posetpu_torch.ckpt.manager import CheckpointManager

    exp = SimpleNamespace(ckpt=CheckpointManager(str(tmp_path / "arm")))
    if quick:
        assert tool.scored_checkpoint(exp, quick) == (None, "latest")
    else:
        with pytest.raises(SystemExit, match="no best/ checkpoint"):
            tool.scored_checkpoint(exp, quick)
    os.makedirs(exp.ckpt.best_path)
    assert tool.scored_checkpoint(exp, quick) == (exp.ckpt.best_path, "best")

