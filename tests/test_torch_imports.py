"""posetpu_torch stands alone: it imports neither JAX nor the JAX package
(nor flax, optax, orbax, grain or clu), no module imports Pillow at its top
(so the native decode route works without it), and its entry points refuse
to run on a machine without CUDA unless asked for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import posetpu_torch
from posetpu_torch.models import hg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "grain", "clu", "posetpu")


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(posetpu_torch.__path__, "posetpu_torch.")
    )


def test_importing_every_module_loads_no_jax():
    mods = _port_modules()
    assert "posetpu_torch.infer" in mods and "posetpu_torch.aug.cuda_kernels" in mods
    assert {"posetpu_torch.aug.keyed", "posetpu_torch.train.state",
            "posetpu_torch.train.step", "posetpu_torch.models.agent",
            "posetpu_torch.models.batchnorm", "posetpu_torch.train.adversarial"} <= set(mods)
    assert {"posetpu_torch.configs.config", "posetpu_torch.data.schema",
            "posetpu_torch.data.datasets", "posetpu_torch.data.synthetic",
            "posetpu_torch.native.bindings", "posetpu_torch.data.loader",
            "posetpu_torch.utils.logger", "posetpu_torch.eval.pck",
            "posetpu_torch.eval.export", "posetpu_torch.ckpt.manager",
            "posetpu_torch.train.loop", "posetpu_torch.train.cli",
            "posetpu_torch.eval.cli", "posetpu_torch.data.worker_loader",
            "posetpu_torch.utils.profiling", "posetpu_torch.parallel",
            "posetpu_torch.parallel.dp", "posetpu_torch.parallel.launch",
            "posetpu_torch.ckpt.torch_export", "posetpu_torch.ckpt.transplant",
            "posetpu_torch.utils.graphs", "posetpu_torch.tools.adversarial_gain",
            "posetpu_torch.tools.duty_cycle", "posetpu_torch.tools.profile_step",
            "posetpu_torch.tools.visualize"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN + ('PIL',)!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def _python_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "posetpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_no_source_imports_jax_or_the_jax_package():
    files = _python_files()
    assert len(files) > 10
    assert {os.path.join(REPO, "posetpu_torch", "parallel", n)
            for n in ("__init__.py", "dp.py", "launch.py")} <= set(files)
    assert os.path.join(REPO, "posetpu_torch", "ckpt", "torch_export.py") in files
    assert {os.path.join(REPO, "posetpu_torch", "tools", n) for n in (
        "adversarial_gain.py", "duty_cycle.py", "profile_step.py", "visualize.py")} <= set(files)
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path} imports {n}"


def test_no_source_unpickles_with_weights_only_false():
    """Every ``torch.load`` of the port and of chip_smoke passes
    ``weights_only=True``: a checkpoint, the JAX package's container
    included, is read without running what it pickled."""
    loads = 0
    for path in _python_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "load"
                    and isinstance(node.func.value, ast.Name) and node.func.value.id == "torch"):
                loads += 1
                kw = {k.arg: k.value for k in node.keywords}
                assert "weights_only" in kw, f"{path}:{node.lineno} torch.load without weights_only"
                value = kw["weights_only"]
                assert isinstance(value, ast.Constant) and value.value is True, \
                    f"{path}:{node.lineno} torch.load with weights_only not True"
    assert loads >= 2  # the run directory's checkpoints and the container


def test_no_module_imports_pillow_at_its_top():
    """Pillow is imported inside the functions that decode or draw, never
    in a module body (where an ``if`` or ``try`` at top level counts too)."""
    for path in _python_files():
        if os.path.basename(path) == "chip_smoke.py":
            continue
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        todo = list(tree.body)
        while todo:
            node = todo.pop()
            if isinstance(node, (ast.If, ast.Try, ast.With)):
                todo += [n for n in ast.iter_child_nodes(node) if isinstance(n, ast.stmt)]
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names if n.split(".")[0] == "PIL"], \
                f"{path} imports Pillow at module level"


def test_data_and_driver_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from posetpu_torch.data import make_batch_placer
    from posetpu_torch.eval import cli as eval_cli
    from posetpu_torch.train import cli as train_cli
    from posetpu_torch.train.loop import Experiment
    from posetpu_torch.configs import named_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_batch_placer()
    assert callable(make_batch_placer("cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Experiment(named_config("hg2_mpii_mini"))
    argv = ["--config", "hg2_mpii_mini", "--synthetic", "--checkpoint", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_cli.main(argv)
    assert not os.listdir(tmp_path)  # refused before touching the run directory


def test_default_device_without_cuda_raises(monkeypatch):
    from posetpu_torch.aug import augment_batch, flip_permutation, neutral_params
    from posetpu_torch.configs import named_config
    from posetpu_torch.infer import MPII_MEAN, PosePredictor
    from posetpu_torch.train.state import make_optimizer
    from posetpu_torch.train.step import (
        make_eval_step,
        make_graphed_eval_step,
        make_train_step,
    )
    from posetpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = hg(num_stacks=1, num_feats=8, num_classes=4, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PosePredictor(model)
    cfg = named_config("hg2_mpii_mini")
    cfg.model.feats = 8
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PosePredictor.from_config(cfg, hg(num_stacks=2, num_feats=8).state_dict())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_eval_step(model, cfg.aug, MPII_MEAN)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_graphed_eval_step(model, cfg.aug, MPII_MEAN)
    opt = make_optimizer(model.parameters(), cfg.optim)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(model, opt, cfg.aug, MPII_MEAN)
    assert next(model.parameters()).device.type == "cpu"
    from posetpu_torch.models.agent import AugAgent, rotation_bin_table, scale_bin_table
    from posetpu_torch.train.adversarial import (
        agent_from_config,
        make_joint_dispatch_step,
        make_joint_step,
    )

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AugAgent(widths=(8,))
    agent = AugAgent(widths=(8,), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_joint_step(model, agent, opt, make_optimizer(agent.parameters(), cfg.optim),
                        cfg.aug, MPII_MEAN, scale_table=scale_bin_table(),
                        rot_table=rotation_bin_table())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_joint_dispatch_step(model, agent, opt,
                                 make_optimizer(agent.parameters(), cfg.optim), cfg.aug,
                                 MPII_MEAN, scale_table=scale_bin_table(),
                                 rot_table=rotation_bin_table())
    assert next(agent.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        agent_from_config(named_config("hg8_mpii_asr"), widths=(8,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        neutral_params(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flip_permutation(16, "mpii")
    B, K = 2, 16
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        augment_batch(
            np.zeros((B, 8, 8, 3), np.uint8), np.full((B, 2), 8, np.int32),
            np.full((B, 2), 4.0, np.float32), np.ones((B,), np.float32),
            np.zeros((B, K, 2), np.float32), np.ones((B, K), np.float32),
            neutral_params(B, "cpu"),
        )
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
