"""The hourglass's BatchNorm and ReLU as one op (``posetpu_torch/models/bn_relu.py``).

On the CPU:
- :class:`BatchNormReLU`'s plain path is ``F.relu`` of the port's
  ``BatchNorm2d`` bit for bit, in train and eval mode, and leaves flax's
  running variance after ``flax_train_forward``;
- the op's route (its kernels replaced by their plain versions) against
  torch's pair: output, statistics, running statistics, the batch count,
  gradients, ``gradcheck`` in float64; eval with autograd refused;
  ``recomputing()`` leaves the statistics alone on both routes;
- hg8's 354 norms, each followed by its ReLU, read 66,519,040 elements an
  image at 256² in 11 shapes; the state-dict names are the torch
  baseline's; the kernels' grid and refusals.

On the card (``cuda`` marker; skips here; no JAX import, so
``python -m pytest --noconftest tests/test_torch_bn_relu.py -m cuda`` runs
them there), at every hg8 norm shape at batch 32 and two odd ones, bf16
and float32: the statistics within float32 summation error of float64;
the output bit for bit torch's transform and ReLU given the kernel's
statistics, and torch's own pair wherever the two sets of statistics are
equal; the running statistics; the gradients held to float64 by the bf16
ratio rule against torch's own error, deterministic across runs; the eval
forward torch's bit for bit; captured replays equal eager ones; graphed
train steps equal eager ones and count once a replay; the module's routes
and refusals.
"""

import copy
import importlib.util
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from posetpu_torch.models import bn_relu, hg
from posetpu_torch.models.batchnorm import BatchNorm2d, flax_train_forward, recomputing
from posetpu_torch.models.bn_relu import (
    GRAD_LAUNCHES,
    LAUNCHES,
    BatchNormReLU,
    backward_plain,
    bn_relu_train,
    eval_plain,
    forward_plain,
    grid,
    rows_of,
)
from posetpu_torch.utils import cuda_build, profiling
from posetpu_torch.utils.profiling import counter, reset_counters

CL = torch.channels_last
# (C, H, W) of the inputs of hg8's norms at 256²
HG8_SHAPES = ((64, 128, 128), (128, 64, 64), (256, 64, 64), (128, 32, 32), (256, 32, 32),
              (128, 16, 16), (256, 16, 16), (128, 8, 8), (256, 8, 8), (128, 4, 4),
              (256, 4, 4))
HG8_NORMS, HG8_NORM_ELEMENTS = 354, 66_519_040
H100_SMS = 132
EPS, MOMENTUM = 1e-5, 0.1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tensor(shape, dtype, fmt, seed, device="cpu", scale=1.0, shift=0.0):
    g = torch.Generator().manual_seed(seed)
    t = torch.randn(shape, generator=g, dtype=torch.float64) * scale + shift
    return t.to(dtype).to(device).contiguous(memory_format=fmt)


def _norm(C, seed, device="cpu"):
    """A BatchNormReLU with drawn weight, bias and running statistics."""
    bn = BatchNormReLU(C).to(device)
    with torch.no_grad():
        bn.weight.copy_(_tensor((C,), torch.float32, torch.contiguous_format, seed) + 1)
        bn.bias.copy_(_tensor((C,), torch.float32, torch.contiguous_format, seed + 1) * 0.5)
        bn.running_mean.copy_(_tensor((C,), torch.float32, torch.contiguous_format, seed + 2))
        bn.running_var.copy_(
            _tensor((C,), torch.float32, torch.contiguous_format, seed + 3).abs() + 0.5)
    return bn


def _as_plain_pair(bn):
    """The same norm as the port's BatchNorm2d (ReLU applied by the caller)."""
    plain = copy.deepcopy(bn)
    plain.__class__ = BatchNorm2d
    return plain


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_plain_path_is_relu_of_the_norm(training, dtype):
    """On the CPU the module is F.relu of the port's BatchNorm2d: output,
    gradients, running statistics and batch count bit for bit."""
    bn = _norm(16, 1).to(torch.float64 if dtype == torch.float64 else torch.float32)
    plain = _as_plain_pair(bn)
    bn.train(training), plain.train(training)
    x = _tensor((4, 16, 5, 7), dtype, CL, 2).requires_grad_()
    xp = x.detach().clone().requires_grad_()
    got, want = bn(x), F.relu(plain(xp))
    assert got.dtype == dtype and torch.equal(got, want)
    up = _tensor(got.shape, dtype, CL, 3)
    (got * up).sum().backward()
    (want * up).sum().backward()
    assert torch.equal(x.grad, xp.grad)
    assert torch.equal(bn.weight.grad, plain.weight.grad)
    for a, b in zip(bn.buffers(), plain.buffers()):
        assert torch.equal(a, b)
    assert bn.batch_count == plain.batch_count


def test_flax_running_variance_after_flax_train_forward():
    """Through flax_train_forward the running variance is flax's
    0.9 rv + 0.1 var_biased, on both routes (the kernel route with its
    kernels' plain versions)."""
    for route in (False, True):
        bn = _norm(8, 4).double()
        rv = bn.running_var.clone()
        x = _tensor((3, 8, 4, 6), torch.float64, CL, 5)
        with pytest.MonkeyPatch.context() as mp:
            if route:
                _patch_plain_kernels(mp, [])
            with torch.no_grad():
                flax_train_forward([bn], bn, x)
        var = x.var((0, 2, 3), unbiased=False)
        torch.testing.assert_close(bn.running_var, 0.9 * rv + 0.1 * var, rtol=1e-12, atol=0)
        assert int(bn.num_batches_tracked) == 1 and bn.batch_count == 3 * 4 * 6


def _patch_plain_kernels(mp, seen):
    """The op's kernels replaced by their plain versions, each first taking
    the checks its kernel takes (for bf16 and float32; float64 runs
    gradcheck), and the kernel route taken on the CPU."""

    def check(x):
        if x.dtype != torch.float64:
            rows_of(x)

    def fwd(x, *a):
        check(x)
        seen.append("forward")
        return forward_plain(x, *a)

    def bwd(g, x, *a):
        check(g)
        seen.append("backward")
        return backward_plain(g, x, *a)

    def ev(x, *a):
        check(x)
        seen.append("eval")
        return eval_plain(x, *a)

    mp.setattr(bn_relu, "forward_cuda", fwd)
    mp.setattr(bn_relu, "backward_cuda", bwd)
    mp.setattr(bn_relu, "eval_cuda", ev)
    mp.setattr(bn_relu, "kernel_route", lambda x, group: group is None)


@pytest.fixture
def plain_kernels(monkeypatch):
    seen = []
    _patch_plain_kernels(monkeypatch, seen)
    return seen


def test_op_route_against_torch_pair(plain_kernels):
    """The op's route in float32: its output, statistics and gradients
    within float32 rounding of torch's pair, the running statistics as
    torch updates them, one batch counted, the gradient made channels-last."""
    bn = _norm(16, 6)
    ref = _as_plain_pair(bn)
    x = _tensor((4, 16, 6, 5), torch.float32, CL, 7, scale=2.0, shift=0.5).requires_grad_()
    xr = x.detach().clone().requires_grad_()
    got = bn(x)
    want = F.relu(ref(xr))
    assert plain_kernels == ["forward"] and got.is_contiguous(memory_format=CL)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.running_mean, ref.running_mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn.running_var, ref.running_var, rtol=1e-6, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1 and bn.batch_count == 4 * 6 * 5
    up = _tensor(got.shape, torch.float32, torch.contiguous_format, 8)
    (got * up).sum().backward()
    (want * up).sum().backward()
    assert plain_kernels == ["forward", "backward"]
    for a, b in ((x.grad, xr.grad), (bn.weight.grad, ref.weight.grad),
                 (bn.bias.grad, ref.bias.grad)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_op_route_eval_and_its_refusal(plain_kernels):
    bn = _norm(8, 9).eval()
    x = _tensor((2, 8, 3, 3), torch.float32, CL, 10)
    with torch.no_grad():
        got = bn(x)
        want = F.relu(_as_plain_pair(bn)(x))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert plain_kernels == ["eval"]
    with pytest.raises(RuntimeError, match="no backward"):
        bn(x)


def _recompute_leaves_statistics(bn, x):
    """A train-mode forward moves the buffers; one inside recomputing()
    gives the same output and leaves them (and the batch count) alone."""
    before = [t.clone() for t in bn.buffers()]
    with torch.no_grad():
        first = bn(x)
        after = [t.clone() for t in bn.buffers()]
        with recomputing():
            again = bn(x)
    assert torch.equal(again, first)
    assert all(torch.equal(a, c) for a, c in zip(bn.buffers(), after))
    assert not all(torch.equal(a, c) for a, c in zip(after, before))
    assert int(bn.num_batches_tracked) == 1


def test_recomputing_leaves_the_statistics_alone_on_the_op_route(plain_kernels):
    _recompute_leaves_statistics(_norm(8, 12), _tensor((3, 8, 4, 4), torch.float32, CL, 11))
    assert plain_kernels == ["forward", "forward"]


def test_recomputing_leaves_the_statistics_alone_on_the_plain_route():
    _recompute_leaves_statistics(_norm(8, 12), _tensor((3, 8, 4, 4), torch.float32, CL, 11))


@pytest.mark.parametrize("shape", [(2, 8, 3, 4), (3, 16, 1, 1)])
def test_gradcheck_float64(plain_kernels, shape):
    x = _tensor(shape, torch.float64, CL, 13, shift=0.3).requires_grad_()
    w = (_tensor(shape[1:2], torch.float64, torch.contiguous_format, 14) + 1).requires_grad_()
    b = _tensor(shape[1:2], torch.float64, torch.contiguous_format, 15).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, w, b: bn_relu_train(x, w, b, None, None, None, MOMENTUM, EPS), (x, w, b))


def test_backward_plain_is_autograd_of_the_pair():
    """The plain backward (the kernels' arithmetic) against autograd of
    torch's pair in float64: the same function."""
    x = _tensor((4, 8, 5, 5), torch.float64, CL, 16).requires_grad_()
    w = (_tensor((8,), torch.float64, torch.contiguous_format, 17) + 1).requires_grad_()
    b = _tensor((8,), torch.float64, torch.contiguous_format, 18).requires_grad_()
    y = F.relu(F.batch_norm(x, None, None, w, b, True, MOMENTUM, EPS))
    g = _tensor(y.shape, torch.float64, CL, 19)
    want = torch.autograd.grad(y, (x, w, b), g)
    out, mean, invstd = forward_plain(x.detach(), w.detach(), b.detach(), None, None, None,
                                      MOMENTUM, EPS)
    torch.testing.assert_close(out, y.detach(), rtol=1e-12, atol=1e-12)
    got = backward_plain(g, x.detach(), w.detach(), b.detach(), mean, invstd)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-10, atol=1e-12)


def _baseline_hourglass(stacks, feats, classes):
    path = os.path.join(ROOT, "tools", "torch_baseline.py")
    spec = importlib.util.spec_from_file_location("torch_baseline_for_bn_relu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_torch_hourglass(stacks, feats, classes)


def test_state_dict_names_are_the_baselines():
    """Every norm is a BatchNormReLU, and the state dict (names, shapes, the
    Sequentials' indices) is that of the torch baseline built with torch's
    BatchNorm2d and ReLU modules."""
    model = hg(num_stacks=2, num_feats=16, num_classes=4)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert norms and all(isinstance(m, BatchNormReLU) for m in norms)
    base = _baseline_hourglass(2, 16, 4)
    assert [(k, v.shape) for k, v in model.state_dict().items()] == \
        [(k, v.shape) for k, v in base.state_dict().items()]
    assert isinstance(model.stem[2], torch.nn.Identity)
    assert isinstance(model.fc[1][2], torch.nn.Identity)


def test_hg8_norms_and_elements():
    """354 norms an hg8 forward, each followed by its ReLU, over 66,519,040
    elements an image at 256², in 11 shapes: the widths the card tests and
    chip_smoke hold the kernels at."""
    model = hg().eval()
    seen = []
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_hook(lambda mod, i, o: seen.append(tuple(i[0].shape[1:])))
    with torch.no_grad():
        model(torch.zeros(1, 256, 256, 3))
    assert len(seen) == HG8_NORMS
    assert sum(math.prod(s) for s in seen) == HG8_NORM_ELEMENTS
    assert set(seen) == set(HG8_SHAPES)


@pytest.mark.parametrize("C,H", [(c, h) for c, h, _ in HG8_SHAPES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grid(C, H, dtype):
    """One cluster where the activations fit 256 KiB (hg8's 4² norms in
    bf16 at batch 32); else at least ROWS_PER_THREAD rows a thread on at
    most one block an SM, the sums' threads reading 8-byte vectors."""
    size = torch.empty((), dtype=dtype).element_size()
    rows = 32 * H * H
    blocks, cluster = grid(rows, C, size, H100_SMS)
    assert cluster == (rows * C * size <= bn_relu.CLUSTER_BYTES)
    if dtype == torch.bfloat16:
        assert cluster == (H <= 4)
    if cluster:
        assert blocks == bn_relu.CLUSTER
    else:
        tile = C // (8 // size)
        at_once = 1 << (bn_relu.SUM_THREADS // tile).bit_length() - 1
        assert 1 <= blocks <= H100_SMS
        assert blocks == H100_SMS or blocks == math.ceil(
            rows / (at_once * bn_relu.ROWS_PER_THREAD))


def test_grid_wide_rows_take_tiles():
    """More channels than a cluster takes, and more vectors than a block
    covers: two tiles, at most one block an SM across them."""
    tiles = 16384 // 4 // bn_relu.SUM_THREADS
    assert tiles > 1
    assert grid(100_000, 16384, 2, H100_SMS) == (H100_SMS // tiles, False)
    assert grid(16, 1024, 2, H100_SMS)[1] is False


@pytest.mark.parametrize("bad", ["contiguous", "float64", "float16", "channels", "3d",
                                 "misaligned", "empty"])
def test_refusals(bad):
    x = torch.zeros(2, 16, 4, 4, dtype=torch.bfloat16).contiguous(memory_format=CL)
    err = ValueError
    if bad == "contiguous":
        x = x.contiguous()
    elif bad in ("float64", "float16"):
        x, err = x.to(getattr(torch, bad)), TypeError
    elif bad == "channels":
        x = torch.zeros(2, 12, 4, 4, dtype=torch.bfloat16).contiguous(memory_format=CL)
    elif bad == "3d":
        x = x[0]
    elif bad == "misaligned":
        flat = torch.zeros(2 * 16 * 16 + 1, dtype=torch.bfloat16)[1:]
        x = flat.view(2, 4, 4, 16).permute(0, 3, 1, 2)
    elif bad == "empty":
        x = torch.zeros(0, 16, 4, 4, dtype=torch.bfloat16).contiguous(memory_format=CL)
    with pytest.raises(err):
        rows_of(x)


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 8, 2, 2).contiguous(memory_format=CL)
    p = torch.ones(8)
    with pytest.raises(ValueError, match="CUDA"):
        bn_relu.forward_cuda(x, p, p, None, None, None, MOMENTUM, EPS)
    with pytest.raises(ValueError, match="CUDA"):
        bn_relu.eval_cuda(x, p, p, p, p, EPS)
    with pytest.raises(ValueError, match="float32"):
        bn_relu.eval_cuda(x, p.double(), p, p, p, EPS)
    assert {LAUNCHES, GRAD_LAUNCHES} <= set(profiling._launch_counters)


# ---- on the card ----------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _cases():
    """(dtype, (N, C, H, W)): hg8's norms at batch 32, a row count that is no
    power of two, and 24 channels (three bf16 vectors a row)."""
    shapes = [(32, *s) for s in HG8_SHAPES] + [(3, 64, 7, 9), (5, 24, 3, 3)]
    return [(d, s) for d in (torch.bfloat16, torch.float32) for s in shapes]


def _inputs(dtype, shape, seed):
    N, C, H, W = shape
    x = _tensor(shape, dtype, CL, seed, "cuda", scale=2.0, shift=0.7)
    w = _tensor((C,), torch.float32, torch.contiguous_format, seed + 1, "cuda") + 1
    b = _tensor((C,), torch.float32, torch.contiguous_format, seed + 2, "cuda") * 0.5
    rm = _tensor((C,), torch.float32, torch.contiguous_format, seed + 3, "cuda")
    rv = _tensor((C,), torch.float32, torch.contiguous_format, seed + 4, "cuda").abs() + 0.5
    return x, w, b, rm, rv


@pytest.mark.cuda
def test_cuda_forward_against_torch():
    """Statistics within float32 summation error of float64 (relative to the
    channel's spread); the output bit for bit torch's channels-last
    transform and ReLU given the kernel's statistics, and torch's own pair
    on every channel whose statistics equal torch's; the running
    statistics as torch updates them; one batch counted."""
    _need_cuda()
    for dtype, shape in _cases():
        x, w, b, rm, rv = _inputs(dtype, shape, shape[1] + shape[2])
        rm_t, rv_t = rm.clone(), rv.clone()
        nbt = torch.zeros((), dtype=torch.int64, device="cuda")
        reset_counters(LAUNCHES)
        out, mean, invstd = bn_relu.forward_cuda(x, w, b, rm, rv, nbt, MOMENTUM, EPS)
        assert counter(LAUNCHES) == 1 and int(nbt) == 1 and out.dtype == dtype
        assert out.is_contiguous(memory_format=CL)
        x64 = x.double()
        mean64, var64 = x64.mean((0, 2, 3)), x64.var((0, 2, 3), unbiased=False)
        spread = var64.sqrt()
        label = (dtype, shape)
        assert ((mean.double() - mean64).abs() <= 1e-5 * spread).all(), label
        inv64 = (var64 + EPS).rsqrt()
        assert ((invstd.double() - inv64).abs() <= 1e-5 * inv64).all(), label
        want = F.relu(torch.batch_norm_elemt(x, w, b, mean, invstd, EPS))
        assert torch.equal(out, want), label
        t_out, t_mean, t_inv = torch.native_batch_norm(x, w, b, rm_t, rv_t, True, MOMENTUM,
                                                       EPS)
        same = (t_mean == mean) & (t_inv == invstd)
        assert torch.equal(out[:, same], F.relu(t_out)[:, same]), label
        torch.testing.assert_close(rm, rm_t, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(rv, rv_t, rtol=1e-5, atol=1e-6)
        again, m2, i2 = bn_relu.forward_cuda(x, w, b, None, None, None, MOMENTUM, EPS)
        assert torch.equal(again, out) and torch.equal(m2, mean) and torch.equal(i2, invstd)


def _mean_gap(a, b):
    return float((a.double() - b.double()).abs().mean())


def _float64_grads(x, w, b, dz):
    """Gradients of the train-mode norm alone in float64 for the gradient
    ``dz`` of its output: a ReLU's mask applied to ``dz`` first."""
    x64, w64, b64 = (t.detach().double().requires_grad_() for t in (x, w, b))
    y = F.batch_norm(x64, None, None, w64, b64, True, MOMENTUM, EPS)
    return torch.autograd.grad(y, (x64, w64, b64), dz.double())


@pytest.mark.cuda
def test_cuda_backward_against_float64_and_torch():
    """dx, dw and db lie as close to float64 as torch's own pair does (the
    bf16 ratio rule: within 2x torch's mean error, beside float32's
    rounding of the largest value), each held to the float64 backward of
    the norm under its own ReLU mask (r > 0: an element whose z lies within
    rounding of 0 may fall either way, and one such element moves dw by
    |dr * (x - mean)|); two runs give the same bits."""
    _need_cuda()
    for dtype, shape in _cases():
        x, w, b, _, _ = _inputs(dtype, shape, 3 * shape[1] + shape[3])
        dr = _tensor(shape, dtype, CL, shape[2] + 5, "cuda")
        out, mean, invstd = bn_relu.forward_cuda(x, w, b, None, None, None, MOMENTUM, EPS)
        reset_counters(GRAD_LAUNCHES)
        got = bn_relu.backward_cuda(dr, x, w, b, mean, invstd)
        assert counter(GRAD_LAUNCHES) == 1
        twice = bn_relu.backward_cuda(dr, x, w, b, mean, invstd)
        assert all(torch.equal(a, c) for a, c in zip(got, twice)), (dtype, shape)
        xt, wt, bt = (t.detach().clone().requires_grad_() for t in (x, w, b))
        yt = F.relu(F.batch_norm(xt, None, None, wt, bt, True, MOMENTUM, EPS))
        torch_grads = torch.autograd.grad(yt, (xt, wt, bt), dr)
        ours_ref = _float64_grads(x, w, b, dr * (out > 0))
        torch_ref = _float64_grads(x, w, b, dr * (yt.detach() > 0))
        for name, a, t, r, rt in zip(("dx", "dw", "db"), got, torch_grads, ours_ref, torch_ref):
            assert a.dtype == t.dtype and a.shape == t.shape
            room = 2 * _mean_gap(t, rt) + 2.0**-24 * float(r.abs().max())
            assert _mean_gap(a, r) <= room, (name, dtype, shape, _mean_gap(a, r), room)


@pytest.mark.cuda
def test_cuda_eval_equals_torch():
    """The eval forward is torch's native eval norm and ReLU bit for bit: no
    element differs.  In bf16 with float32 parameters (the main path's
    types) that is ``F.relu(F.batch_norm(..., training=False))``; a float32
    ``F.batch_norm`` goes to cuDNN, which rounds otherwise."""
    _need_cuda()
    for dtype, shape in _cases():
        x, w, b, rm, rv = _inputs(dtype, shape, shape[1] + 7)
        reset_counters(LAUNCHES)
        got = bn_relu.eval_cuda(x, w, b, rm, rv, EPS)
        assert counter(LAUNCHES) == 1 and got.is_contiguous(memory_format=CL)
        want = F.relu(torch.native_batch_norm(x, w, b, rm, rv, False, MOMENTUM, EPS)[0])
        differ = int((got != want).sum())
        assert differ == 0, (dtype, shape, differ)
        if dtype == torch.bfloat16:
            assert torch.equal(got, F.relu(F.batch_norm(x, rm, rv, w, b, False, MOMENTUM, EPS)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 256, 32, 32), (32, 256, 4, 4)])
def test_cuda_replays_equal_eager(shape):
    """Blocks with a ticket (32²) and one cluster (4²): three replays of a
    captured forward and backward equal the eager ones, and the counters
    count once a replay."""
    _need_cuda()
    x, w, b, rm, rv = _inputs(torch.bfloat16, shape, 21)
    dr = _tensor(shape, torch.bfloat16, CL, 22, "cuda")
    N, C, H, W = shape
    assert grid(N * H * W, C, 2, cuda_build.sm_count("cuda"))[1] == (H == 4)

    def run():
        out, mean, invstd = bn_relu.forward_cuda(x, w, b, None, None, None, MOMENTUM, EPS)
        return (out, *bn_relu.backward_cuda(dr, x, w, b, mean, invstd))

    want = run()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # warm-up on the capture's stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with profiling.counted_as_replays() as recorded:
        with torch.cuda.graph(graph):
            outs = run()
    reset_counters(LAUNCHES, GRAD_LAUNCHES)
    results = []
    for _ in range(3):
        graph.replay()
        profiling.add_replay(recorded)
        results.append([o.clone() for o in outs])
    torch.cuda.synchronize()
    assert counter(LAUNCHES) == counter(GRAD_LAUNCHES) == 3
    for r in results:
        assert all(torch.equal(a, c) for a, c in zip(r, want))


@pytest.mark.cuda
def test_cuda_module_routes_and_refusals():
    """On CUDA the module launches in train and eval mode, counts its batch,
    leaves its statistics alone in a recompute, refuses an eval forward
    autograd would differentiate, and input the kernels do not take; a
    float64 norm (a reference's) is F.relu of torch's norm, no launch."""
    _need_cuda()
    bn = _norm(64, 30, "cuda")
    x = _tensor((4, 64, 8, 8), torch.bfloat16, CL, 31, "cuda")
    reset_counters(LAUNCHES)
    bn(x)
    assert counter(LAUNCHES) == 1 and int(bn.num_batches_tracked) == 1
    assert bn.batch_count == 4 * 8 * 8
    kept = [t.clone() for t in bn.buffers()]
    with recomputing():
        bn(x)
    assert all(torch.equal(a, c) for a, c in zip(bn.buffers(), kept))
    bn.eval()
    with torch.no_grad():
        got = bn(x)
    assert counter(LAUNCHES) == 3
    with torch.no_grad():
        want = F.relu(F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                   False, MOMENTUM, EPS))
    assert torch.equal(got, want)
    with pytest.raises(RuntimeError, match="no backward"):
        bn(x)
    with pytest.raises(ValueError, match="channels-last"), torch.no_grad():
        bn(x.contiguous())
    with pytest.raises(ValueError, match="multiple of 8"), torch.no_grad():
        _norm(12, 32, "cuda").eval()(_tensor((2, 12, 4, 4), torch.bfloat16, CL, 33, "cuda"))
    with pytest.raises(TypeError):
        bn_relu.forward_cuda(x.double(), bn.weight, bn.bias, None, None, None, MOMENTUM, EPS)
    ref = copy.deepcopy(bn).double().train()
    x64 = x.double()
    want64 = F.relu(_as_plain_pair(ref)(x64))
    assert torch.equal(ref(x64), want64) and counter(LAUNCHES) == 3


@pytest.mark.cuda
def test_cuda_graphed_steps_equal_eager_and_count_once_a_replay():
    """f32, TF32 off, deterministic algorithms: two graphed dispatches of
    K = 2 equal 4 eager steps bit for bit; each replayed step counts one
    forward and one backward a norm, as the warm-up's steps do."""
    _need_cuda()
    from test_torch_conv_bias import _batch, _small_cfg

    from posetpu_torch.models import build_model
    from posetpu_torch.train.state import TrainState, make_optimizer
    from posetpu_torch.train.step import WARMUP_STEPS, make_dispatch_step, make_train_step

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    mean = (0.4404, 0.4440, 0.4327)
    try:
        cfg = _small_cfg()
        torch.manual_seed(0)
        base = build_model(cfg.model)
        norms = sum(isinstance(m, BatchNormReLU) for m in base.modules())
        batches = [_batch(50 + i) for i in range(4)]
        runs = {}
        for how in ("eager", "graph"):
            model = copy.deepcopy(base).cuda()
            opt = make_optimizer(model.parameters(), cfg.optim, steps_per_epoch=2)
            state = TrainState(model, opt)
            if how == "eager":
                step = make_train_step(model, opt, cfg.aug, mean, seed=3, device="cuda")
                reset_counters(LAUNCHES, GRAD_LAUNCHES)
                for b in batches:
                    step(state, b)
                torch.cuda.synchronize()
                assert counter(LAUNCHES) == counter(GRAD_LAUNCHES) == 4 * norms
            else:
                dispatch = make_dispatch_step(model, opt, cfg.aug, mean, seed=3, steps=2,
                                              device="cuda")
                reset_counters(LAUNCHES, GRAD_LAUNCHES)
                for i in (0, 2):
                    dispatch(state, {k: np.stack([b[k] for b in batches[i:i + 2]])
                                     for k in batches[0]})
                torch.cuda.synchronize()
                assert dispatch.captures == 1
                want = (4 + WARMUP_STEPS) * norms
                assert counter(LAUNCHES) == counter(GRAD_LAUNCHES) == want
            runs[how] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev[:2]
        torch.use_deterministic_algorithms(prev[2])
    for k in runs["eager"]:
        assert torch.equal(runs["eager"][k], runs["graph"][k]), k
