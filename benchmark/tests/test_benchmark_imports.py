"""Nothing the harness loads is JAX or the JAX package, compared by whole
top-level module names: ``posetpu_torch`` passes, ``posetpu`` does not."""

import os
import subprocess
import sys

from benchmark import run
from benchmark.tests.tiny import ROOT

MODULES = ["benchmark.run", "benchmark.calibrate", "benchmark.drivers.graphed_train",
           "benchmark.drivers.pipelined_serve", "benchmark.trace"]


def test_the_harness_loads_no_jax(tmp_path):
    code = ("import importlib, sys, torch\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "from benchmark import run\n"
            "for name in ('posetpu_torch.train', 'posetpu_torch.infer', 'posetpu_torch.models'):\n"
            "    importlib.import_module(name)\n"
            "print(','.join(run.forbidden_modules()) or 'none')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "none"


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "posetpu_torch_like", sys)
    assert "posetpu" not in run.forbidden_modules() or "posetpu" in {
        m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "posetpu", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    found = run.forbidden_modules()
    assert "posetpu" in found and "jax" in found
    assert "posetpu_torch" not in found and "posetpu_torch_like" not in found


def test_no_source_under_benchmark_imports_jax_or_the_jax_package():
    here = os.path.join(ROOT, "benchmark")
    for dirpath, _, files in os.walk(here):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                for line in f:
                    words = line.split()
                    if words[:1] in (["import"], ["from"]) and len(words) > 1:
                        top = words[1].split(".")[0].rstrip(",")
                        assert top not in run.FORBIDDEN, (name, line)
