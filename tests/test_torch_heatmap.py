"""posetpu_torch's rasterizer: the plain version against the JAX package's
XLA rasterizer and its Pallas kernel (interpret mode), and — on a machine
with an NVIDIA GPU only — the CUDA kernel against the plain version.

The JAX package is imported inside the tests that use it, so the CUDA
tests also run on a GPU machine without JAX:
``python -m pytest --noconftest tests/test_torch_heatmap.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from posetpu_torch.aug import AugParams, augment_batch, cuda_kernels
from posetpu_torch.aug import heatmap as port
from posetpu_torch.utils.profiling import counter


def _inputs(seed, B, K, frac=False):
    rng = np.random.RandomState(seed)
    pts = rng.randint(-10, 74, size=(B, K, 2)).astype(np.float32)
    if frac:
        pts += rng.uniform(0, 1, size=pts.shape).astype(np.float32)
    vis = rng.randint(0, 2, size=(B, K)).astype(np.float32)
    return pts, vis


def _edge_inputs(res, frac):
    """(1, n, 2) points on, one pixel beyond, a few pixels beyond and far
    beyond each edge of an H x W map, then two rows of the TPU kernel's
    -1e6 padding (``pallas_kernels.py:78``; vis 0 as it padded them, and
    vis 1); (1, n) vis.  ``frac`` moves every point by +0.5."""
    H, W = res

    def axis(n):
        return [0.0, n - 1.0, *(-float(d) for d in range(1, 9)),
                *(n - 1.0 + d for d in range(1, 9)), -100.0, n + 99.0]

    xs, ys = axis(W), axis(H)
    pts = ([(x, float(H // 2)) for x in xs] + [(float(W // 2), y) for y in ys]
           + list(zip(xs, ys)))
    pts = np.array(pts, np.float32) + (np.float32(0.5) if frac else 0)
    pts = np.concatenate([pts, np.full((2, 2), -1e6, np.float32)])
    vis = np.ones(len(pts), np.float32)
    vis[-2] = 0.0
    return pts[None], vis[None]


def _xla(pts, vis, res, sigma):
    from posetpu.aug.heatmap import rasterize_gaussians

    return rasterize_gaussians(pts, vis, res, sigma, backend="xla")


@pytest.mark.parametrize("shape", [(3, 16), (2, 3)])  # B*K = 48, 6
@pytest.mark.parametrize("sigma", [1.0, 2.0])
def test_plain_matches_xla_and_pallas(sigma, shape):
    from posetpu.aug.pallas_kernels import rasterize_gaussians_pallas

    pts, vis = _inputs(0, *shape)
    t, v = port.rasterize_gaussians(torch.from_numpy(pts), torch.from_numpy(vis),
                                    (64, 64), sigma)
    for name, (rt, rv) in {
        "xla": _xla(pts, vis, (64, 64), sigma),
        "pallas": rasterize_gaussians_pallas(pts, vis, (64, 64), sigma, interpret=True),
    }.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(rt), atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv), err_msg=name)


@pytest.mark.parametrize("sigma", [1.0, 1.5, 2.0])
def test_plain_matches_xla_non_integer_window(sigma):
    """3*sigma = 4.5 is not an integer: the mask uses 4.5, the visibility
    rule int(4.5) = 4; points near the border tell them apart."""
    pts, vis = _inputs(1, 4, 16, frac=True)
    pts[0, :4] = [[-5.0, 10.0], [68.0, 10.0], [10.0, -4.0], [10.0, 67.0]]
    vis[0, :4] = 1.0
    t, v = port.rasterize_gaussians(torch.from_numpy(pts), torch.from_numpy(vis),
                                    (64, 64), sigma)
    rt, rv = _xla(pts, vis, (64, 64), sigma)
    np.testing.assert_allclose(t.numpy(), np.asarray(rt), atol=1e-6)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


@pytest.mark.parametrize("frac", [False, True])
@pytest.mark.parametrize("sigma", [1.0, 1.5, 2.0])
def test_plain_matches_xla_and_pallas_at_edges(sigma, frac):
    """An odd (17, 13) map with points on, just beyond and far beyond each
    edge, and -1e6 padding rows: every branch the CUDA kernel has.  The
    Pallas kernel takes integer points only (it does not truncate for its
    visibility rule), so it sees the integer case."""
    from posetpu.aug.pallas_kernels import rasterize_gaussians_pallas

    res = (17, 13)
    pts, vis = _edge_inputs(res, frac)
    t, v = port.rasterize_gaussians(torch.from_numpy(pts), torch.from_numpy(vis),
                                    res, sigma)
    refs = {"xla": _xla(pts, vis, res, sigma)}
    if not frac:
        refs["pallas"] = rasterize_gaussians_pallas(pts, vis, res, sigma,
                                                    interpret=True)
    assert 0 < v.sum() < v.numel()  # some rows kept, some dropped
    for name, (rt, rv) in refs.items():
        rt = np.asarray(rt)
        np.testing.assert_array_equal(t.numpy() != 0, rt != 0, err_msg=name)
        np.testing.assert_allclose(t.numpy(), rt, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv), err_msg=name)


def test_cpu_dispatch_never_builds_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CPU tensors must not reach the CUDA kernel")

    monkeypatch.setattr(cuda_kernels, "rasterize_gaussians_cuda", boom)
    pts, vis = _inputs(2, 2, 3)
    t, _ = port.rasterize_gaussians(torch.from_numpy(pts), torch.from_numpy(vis), (16, 16))
    assert t.shape == (2, 3, 16, 16)


def test_cuda_wrapper_rejects_cpu_tensors():
    pts, vis = _inputs(3, 2, 3)
    with pytest.raises(ValueError):
        cuda_kernels.rasterize_gaussians_cuda(
            torch.from_numpy(pts), torch.from_numpy(vis), (16, 16),
            *port.raster_constants(1.0),
        )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_vs_plain(pts, vis, res, sigma, device):
    pts_d = torch.as_tensor(pts).to(device)
    vis_d = torch.as_tensor(vis).to(device)
    before = counter(cuda_kernels.RASTERIZE_LAUNCHES)
    t, v = port.rasterize_gaussians(pts_d, vis_d, res, sigma)
    tp, vp = port.rasterize_gaussians_plain(pts_d, vis_d, res, sigma)
    torch.cuda.synchronize()
    assert counter(cuda_kernels.RASTERIZE_LAUNCHES) == before + 1
    np.testing.assert_array_equal(t.cpu().numpy(), tp.cpu().numpy())
    np.testing.assert_array_equal(v.cpu().numpy(), vp.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("frac", [False, True])
@pytest.mark.parametrize("shape", [(32, 16), (3, 5)])
@pytest.mark.parametrize("sigma", [1.0, 1.5, 2.0])
def test_cuda_kernel_matches_plain(cuda, sigma, shape, frac):
    pts, vis = _inputs(4, *shape, frac=frac)
    _kernel_vs_plain(pts, vis, (64, 64), sigma, cuda)


@pytest.mark.cuda
def test_cuda_kernel_rows_beyond_one_grid(cuda):
    """More rows than a grid's y extent (65535): rows lie on blockIdx.x."""
    pts, vis = _inputs(5, 70_001, 1)
    _kernel_vs_plain(np.clip(pts, -2, 9), vis, (8, 8), 1.0, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("frac", [False, True])
@pytest.mark.parametrize("sigma", [1.0, 1.5, 2.0])
@pytest.mark.parametrize("res", [(17, 13), (64, 48), (64, 64)])
def test_cuda_kernel_matches_plain_at_edges(cuda, res, sigma, frac):
    """The odd map takes the kernel's scalar stores, the others its 16-byte
    stores; edge and -1e6 points cross every window test."""
    _kernel_vs_plain(*_edge_inputs(res, frac), res, sigma, cuda)


@pytest.mark.cuda
def test_cuda_kernel_strided_inputs(cuda):
    pts, vis = _inputs(6, 16, 8)
    _kernel_vs_plain(torch.from_numpy(pts).transpose(0, 1), torch.from_numpy(vis).T,
                     (64, 48), 1.0, cuda)


@pytest.mark.cuda
def test_augment_batch_on_cuda_uses_the_kernel(cuda):
    """The pipeline's targets on the card come from the kernel and equal the
    CPU pipeline's (plain rasterizer) targets."""
    rng = np.random.RandomState(7)
    B, K = 4, 16
    images = torch.from_numpy(rng.randint(0, 256, (B, 96, 128, 3), dtype=np.uint8))
    valid_wh = torch.tensor([[128, 96]] * B, dtype=torch.int32)
    center = torch.tensor([[64.0, 48.0]] * B)
    scale = torch.full((B,), 0.45)
    pts = center[:, None, :] + torch.from_numpy(rng.uniform(-40, 40, (B, K, 2)).astype(np.float32))
    vis = torch.from_numpy((rng.rand(B, K) < 0.8).astype(np.float32))
    params = AugParams(torch.ones(B), torch.tensor([0.0, 10.0, -20.0, 5.0]),
                       torch.tensor([False, True, False, True]))
    args = (images, valid_wh, center, scale, pts, vis, params)
    kw = dict(inp_res=(64, 64), out_res=(16, 16))
    cpu = augment_batch(*args, device="cpu", **kw)
    before = counter(cuda_kernels.RASTERIZE_LAUNCHES)
    gpu = augment_batch(*args, device=cuda, **kw)
    torch.cuda.synchronize()
    assert counter(cuda_kernels.RASTERIZE_LAUNCHES) == before + 1
    np.testing.assert_allclose(gpu["target"].cpu().numpy(), cpu["target"].numpy(), atol=1e-6)
    np.testing.assert_array_equal(gpu["target_weight"].cpu().numpy(), cpu["target_weight"].numpy())
    np.testing.assert_array_equal(gpu["tpts"].cpu().numpy(), cpu["tpts"].numpy())
