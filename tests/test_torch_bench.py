"""posetpu_torch.bench against the JAX package's bench.py: the synthetic
batch and the serving requests draw for draw, each mode's preset and
metric string as bench.py's ``main`` sets them, every mode of
chip_smoke's bench phase run here at ``--quick --cpu`` (one JSON line
with every key), the refusal without a card, and the serving mode's
predictor against the JAX package's on the bench's own request batch
(both in float32: the bench serves in bf16, whose two roundings differ by
more than any elementwise tolerance)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as ref_bench
import chip_smoke
from posetpu.infer import PosePredictor as RefPredictor
from posetpu.models import hg as ref_hg
from posetpu_torch import bench
from posetpu_torch.ckpt import from_flax_variables
from posetpu_torch.models import hg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread for this module's CPU training: the suite runs
    several test processes at once, and torch's oversubscribed OpenMP pool
    made small steps tens of times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("batch,res,classes,seed",
                         [(4, 64, 16, 0), (3, 96, 14, 1), (32, 256, 16, 0), (2, 384, 16, 7)])
def test_synthetic_batch_equals_the_reference(batch, res, classes, seed):
    want = ref_bench._synthetic_batch(batch, res, classes=classes, seed=seed)
    got = bench.synthetic_batch(batch, res, classes=classes, seed=seed)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("batch", [4, 64])
def test_serve_requests_equal_the_reference(monkeypatch, batch):
    """The requests ``run_bench_serve`` serves, caught at its first call
    (its network and predictor stubbed out)."""
    import posetpu.infer
    import posetpu.models

    class Model:
        def init(self, *a, **k):
            return {"params": None, "batch_stats": None}

    seen = []

    class Predictor:
        def __init__(self, *a, **k):
            pass

        def __call__(self, *request):
            seen.append(request)
            raise _Stop

    monkeypatch.setattr(posetpu.models, "hg", lambda **k: Model())
    monkeypatch.setattr(posetpu.infer, "PosePredictor", Predictor)
    monkeypatch.setattr(ref_bench, "watchdog", lambda **k: _NoWatchdog())
    with pytest.raises(_Stop):
        ref_bench.run_bench_serve(batch=batch, stacks=1, feats=16, res=64)
    want = seen[0]
    got = bench.serve_requests(batch)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


class _NoWatchdog:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


PRESET_ARGV = [
    [], ["--scan-stacks"], ["--trials", "5"], ["--steps", "8", "--warmup", "0"],
    ["--batch", "16", "--stacks", "2", "--res", "128"],
    ["--serve"], ["--serve", "--pipeline", "2"], ["--serve", "--batch", "16"],
    ["--joint"], ["--joint", "--fused"], ["--joint", "--fused", "--trials", "2"],
    ["--joint", "--fused", "--config", "hg8_lsp_aho"],
    ["--joint", "--config", "hg8_mpii_384_dp8", "--res", "384"],
    ["--loader", "host"], ["--loader", "host", "--k-per-dispatch", "4"],
    ["--loader", "grain", "--loader-workers", "4"],
    ["--quick"], ["--quick", "--serve"], ["--quick", "--joint", "--fused"],
]
RUNS = {"run_bench": "default", "run_bench_joint": "joint", "run_bench_serve": "serve",
        "run_bench_loader": "loader"}


def _reference_preset(monkeypatch, capsys, argv):
    """(run function, its keyword arguments, the metric string) that
    bench.py's ``main`` gives for ``argv``, its run functions stubbed."""
    import posetpu.utils.xla_cache

    called = []
    for fn in RUNS:
        monkeypatch.setattr(ref_bench, fn,
                            lambda fn=fn, **kw: called.append((fn, kw)) or 1.0)
    monkeypatch.setattr(posetpu.utils.xla_cache, "enable_persistent_cache", lambda: None)
    monkeypatch.setattr(sys, "argv", ["bench.py", "--no-probe", *argv])
    ref_bench.main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (fn, kw), = called
    for knob in ("warp_table", "raster_backend"):  # TPU layout knobs, not ported
        kw.pop(knob, None)
    return RUNS[fn], kw, line["metric"]


@pytest.mark.parametrize("argv", PRESET_ARGV, ids=lambda a: " ".join(a) or "default")
def test_presets_and_metrics_equal_the_reference(monkeypatch, capsys, argv):
    mode, want_kw, want_metric = _reference_preset(monkeypatch, capsys, argv)
    args = bench.parse_args(argv)
    kw = bench.presets(args)
    assert kw == want_kw
    assert bench.metric_name(args, kw["stacks"]) == want_metric
    got_mode = ("loader" if args.loader else "joint" if args.joint
                else "serve" if args.serve else "default")
    assert got_mode == mode


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_split"))


@pytest.mark.parametrize("name,argv", chip_smoke.BENCH_MODES,
                         ids=[n for n, _ in chip_smoke.BENCH_MODES])
def test_every_smoke_mode_prints_one_line(monkeypatch, capsys, split_dir, name, argv):
    monkeypatch.setattr(bench, "split_root", lambda: split_dir)
    bench.main([*argv, "--quick", "--cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    loader = name.startswith("loader")
    want = chip_smoke.BENCH_KEYS | (chip_smoke.BENCH_LOADER_KEYS if loader else set())
    assert want <= set(line)
    assert line["unit"] == "images/sec/chip" and line["value"] > 0
    assert line["value"] == pytest.approx(float(np.median(line["trials"])))
    assert line["vs_baseline"] == pytest.approx(line["value"] / 12.0)
    # the CPU's clock is no device metric
    assert line["device"] == "cpu"
    assert line["device_ms"] is line["idle"] is line["peak_gb"] is line["gpu"] is None
    assert line["device_clock"] is None
    assert line["capture_s"] is None
    assert (line["batch"], line["stacks"], line["feats"]) == (4, 1, 16)
    assert line["launches"] == {"rasterize_gaussians": 0, "idct_islow": 0, "ycc_canvas": 0}
    if loader:
        assert line["loader_batches"] == line["steps"] > 0 and line["loader_wait_ms"] >= 0
        assert line["prefetch"] == 2
        assert line["host_ms"] is line["canvas_ms"] is line["copy_ms"] is None
        assert line["copy_in_ms"] is line["idct_ms"] is line["refused"] is None


def test_the_window_counts_both_kernels_from_zero():
    """The line's launches are the wrappers' own counts, all reset at the
    timed window's start."""
    from posetpu_torch.aug import cuda_kernels
    from posetpu_torch.native import islow
    from posetpu_torch.native.ycc import YCC_LAUNCHES
    from posetpu_torch.utils import profiling

    raster, idct, ycc = (cuda_kernels.RASTERIZE_LAUNCHES, islow.IDCT_LAUNCHES, YCC_LAUNCHES)
    profiling.count(raster, 7)
    profiling.count(idct, 4)
    profiling.count(ycc, 5)
    bench._reset_launches()
    assert bench._launches() == {"rasterize_gaussians": 0, "idct_islow": 0, "ycc_canvas": 0}
    profiling.count(raster, 2)
    profiling.count(idct, 3)
    profiling.count(ycc, 3)
    assert bench._launches() == {"rasterize_gaussians": 2, "idct_islow": 3, "ycc_canvas": 3}
    bench._reset_launches()


def test_without_a_card_it_exits_non_zero_and_prints_no_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    run = subprocess.run([sys.executable, "-m", "posetpu_torch.bench", "--quick"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert run.stdout.strip() == ""
    assert "CUDA is not available" in run.stderr


@pytest.fixture(scope="module")
def serve_pair():
    """The JAX bench's serving network at ``--quick``, its weights from
    ``model.init(PRNGKey(0))`` as ``run_bench_serve`` makes them, and the
    port's network carrying them (both float32)."""
    ref_model = ref_hg(num_stacks=1, num_blocks=1, num_classes=16, num_feats=16,
                       dtype=jnp.float32)
    v = ref_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=True)
    model = hg(num_stacks=1, num_blocks=1, num_classes=16, num_feats=16,
               dtype=torch.float32)
    model.load_state_dict(from_flax_variables(v["params"], v["batch_stats"], num_stacks=1))
    ref_p = RefPredictor(ref_model, v["params"], v["batch_stats"], inp_res=(64, 64),
                         out_res=(16, 16))
    return ref_p, bench.serve_predictor(model, 64, torch.device("cpu"))


@pytest.mark.parametrize("depth", [0, 2])
def test_serve_predictor_equals_the_reference(serve_pair, depth):
    ref_p, p = serve_pair
    requests = bench.serve_requests(4)
    want = ref_p(*requests)
    if depth:
        got, = list(p.predict_iter(iter([requests]), depth=depth))
    else:
        got = p(*requests)
    assert set(got) == set(want) == {"pred", "conf", "heatmap_coords"}
    np.testing.assert_allclose(got["conf"], want["conf"], atol=2e-4)
    np.testing.assert_array_equal(got["pred"], want["pred"])
    np.testing.assert_array_equal(got["heatmap_coords"], want["heatmap_coords"])
