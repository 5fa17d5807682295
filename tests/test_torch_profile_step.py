"""posetpu_torch.tools.profile_step, the counterpart of tools/profile_step.py.

``--parse-only`` reads a Chrome trace that
``posetpu_torch.utils.profiling.trace`` wrote around a tiny CPU train step:
a trace without device events is summed over its host operators, by name
or by kind, and ``--out`` writes the table printed.  The kind table sorts
kernel names as chip_smoke's profiles read them, and a trace that holds
device events (kernels, copies) is summed over those alone.  The tool runs
end to end on the CPU through the one-step graph's CPU route.
"""

import json
import os

import numpy as np
import pytest
import torch

from posetpu_torch.tools import profile_step
from posetpu_torch.utils.profiling import trace


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread for this module's CPU training (the suite runs
    several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    """A trace of one small train step on the CPU, written by ``trace``."""
    run = profile_step.build_step(False, 1, 8, 2, True, torch.device("cpu"))
    run()
    d = str(tmp_path_factory.mktemp("trace"))
    with trace(d):
        float(run()["loss"])
    (name,) = os.listdir(d)
    return os.path.join(d, name)


def test_parse_only_sums_the_host_operators(cpu_trace, tmp_path, capsys):
    out_file = str(tmp_path / "table.txt")
    out = profile_step.main(["--parse-only", cpu_trace, "--top", "5", "--out", out_file])
    ((track, rows),) = out["summary"]
    assert track.startswith("host operators")
    assert len(rows) == 5
    assert all(ms >= 0 and c >= 1 for _, ms, c in rows)
    assert [ms for _, ms, _ in rows] == sorted((ms for _, ms, _ in rows), reverse=True)
    assert any("conv" in n for n, _, _ in rows)
    with open(out_file) as f:
        assert f.read() == "\n".join(out["lines"]) + "\n"
    assert "\n".join(out["lines"]) in capsys.readouterr().out


def test_parse_only_by_category(cpu_trace):
    by_name = profile_step.main(["--parse-only", cpu_trace, "--top", "100000"])
    by_kind = profile_step.main(["--parse-only", cpu_trace, "--by-category"])
    ((_, rows),) = by_kind["summary"]
    kinds = {k for k, _ in profile_step.PROFILE_KINDS} | {profile_step.OTHER_KIND}
    assert {n for n, _, _ in rows} <= kinds
    assert "convolution / gemm" in {n for n, _, _ in rows}
    ((_, name_rows),) = by_name["summary"]
    assert sum(c for _, _, c in rows) == sum(c for _, _, c in name_rows)
    assert np.isclose(sum(ms for _, ms, _ in rows), sum(ms for _, ms, _ in name_rows))


@pytest.mark.parametrize("name,kind", [
    ("void rasterize_gaussians_kernel<true>(float const*, ...)", "rasterize"),
    ("Memcpy HtoD (Pinned -> Device)", "copies"),
    ("Memset (Device)", "copies"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "convolution / gemm"),
    ("nvjet_tst_128x64_64x8_1x1_v_bz_coopA_NNT", "convolution / gemm"),
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512>", "convolution / gemm"),
    ("void at::native::batch_norm_collect_statistics_kernel<...>", "batch_norm"),
    ("void at::native::upsample_nearest2d_out_frame<c10::BFloat16>", "upsample / pool"),
    ("void at::native::max_pool_forward_nchw<float>", "upsample / pool"),
    ("void at::native::index_elementwise_kernel<128, 4>", "gather / index (warp, decode)"),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float>>", "reductions"),
    ("void at::native::multi_tensor_apply_kernel<TensorListMetadata<3>>",
     "optimizer and BN-statistics update (_foreach)"),
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>", "dtype casts"),
    ("void at::native::vectorized_elementwise_kernel<4, bfloat16_copy_kernel_cuda>",
     "dtype casts"),
    ("void at::native::vectorized_elementwise_kernel<4, AddFunctor<float>>",
     "other elementwise"),
])
def test_kind_table(name, kind):
    assert profile_step.kind_of(name) == kind


def test_device_events_are_summed_alone(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "void rasterize_gaussians_kernel", "dur": 4.0},
        {"ph": "X", "cat": "kernel", "name": "void rasterize_gaussians_kernel", "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm", "dur": 300.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "dur": 9000.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step", "dur": 900.0},
        {"ph": "i", "cat": "kernel", "name": "marker"},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    ((track, rows),) = profile_step.summarize_trace(str(path))
    assert track.startswith("device")
    assert [(n, c) for n, _, c in rows] == [
        ("sm90_xmma_gemm", 1), ("Memcpy HtoD (Pinned -> Device)", 1),
        ("void rasterize_gaussians_kernel", 2)]
    assert [ms for _, ms, _ in rows] == pytest.approx([0.3, 0.02, 0.009])
    ((_, kinds),) = profile_step.summarize_trace(str(path), by_category=True)
    assert [(n, c) for n, _, c in kinds] == [("convolution / gemm", 1), ("copies", 1),
                                             ("rasterize", 2)]
    assert [ms for _, ms, _ in kinds] == pytest.approx([0.3, 0.02, 0.009])


def test_tool_profiles_the_one_step_graph_route_on_the_cpu(tmp_path, capsys):
    out = profile_step.main(["--cpu", "--stacks", "1", "--feats", "8", "--batch", "2",
                             "--steps", "1", "--top", "4",
                             "--trace-dir", str(tmp_path / "trace")])
    assert os.path.dirname(out["trace"]) == str(tmp_path / "trace")
    ((track, rows),) = out["summary"]
    assert track.startswith("host operators") and len(rows) == 4
    assert "[profile] trace:" in capsys.readouterr().out
