"""norm_device_ms.train on synthetic records: the profiler's time in
kernels named ``batch_norm`` over the window's steps, and nothing to read
without such kernels, steps or a training window."""

import pytest

from benchmark import run

TORCH_KERNELS = {
    "void at::native::batch_norm_collect_statistics_channels_last_kernel<at::native::Var, "
    "c10::BFloat16, float, 4>(...)": [3540, 3.53],
    "void at::native::batch_norm_backward_reduce_channels_last_kernel<4, c10::BFloat16, "
    "float, float>(...)": [3540, 2.72],
}
OTHER_KERNELS = {
    "void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::"
    "clamp_min_kernel_cuda(...)": [3540, 1.16],
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc": [3780, 9.0],
}
PORT_KERNELS = {
    "void (anonymous namespace)::batch_norm_relu_stats_kernel<__nv_bfloat16, 8>(...)":
        [1000, 1.5],
    "void (anonymous namespace)::batch_norm_relu_cluster_kernel<__nv_bfloat16, 8>(...)":
        [500, 0.25],
}


def _rec(kernels, steps=366, kind="train"):
    return {"kind": kind, "steps": steps,
            "profile": {"window_s": 40.0, "busy_s": 35.9, "kernels": kernels,
                        "device_ops": [], "idle_gaps": []}}


def test_sums_the_batch_norm_kernels_over_the_steps():
    read = run.reader("norm_device_ms.train")
    assert read(_rec({**TORCH_KERNELS, **OTHER_KERNELS})) == pytest.approx(
        1e3 * (3.53 + 2.72) / 366)
    assert read(_rec({**PORT_KERNELS, **OTHER_KERNELS}, steps=100)) == pytest.approx(17.5)


@pytest.mark.parametrize("rec", [
    _rec(OTHER_KERNELS),
    _rec(TORCH_KERNELS, steps=0),
    _rec(TORCH_KERNELS, kind="serve"),
    {"kind": "train", "steps": 10, "profile": None},
    {"kind": "train", "steps": 10},
])
def test_nothing_to_read(rec):
    assert run.reader("norm_device_ms.train")(rec) is None


def test_reported_in_both_hg8_training_cells():
    spec = run.manifest()
    for cell in ("hg8_mpii.train", "hg8_mpii_asr.joint"):
        names = {m["name"] for m in run.cell_metrics(spec, cell, "per_layer")}
        assert "norm_device_ms.train" in names
    for cell in ("vitpose_h_mpii.train", "hg8_mpii.serve", "hg8_mpii.train_loader"):
        names = {m["name"] for m in run.cell_metrics(spec, cell, "per_layer")}
        assert "norm_device_ms.train" not in names
