"""The hourglass's convolution bias (``posetpu_torch/models/conv_bias.py``).

On the CPU:
- the op's plain version equals torch's ``out.add_(b.view(1, C, 1, 1))``
  bit for bit in every type and layout, and so does the op under autograd
  (its kernels replaced by the plain versions) on channels-last outputs;
  it refuses any other layout;
- its bias gradient lies within float32 summation error of a float64 sum,
  the incoming gradient made channels-last first, and
  ``torch.autograd.gradcheck`` passes in float64;
- the kernels' arguments (vector width, grid, summation depth) and their
  refusals; the gradient's error bound takes torch's sum and fails a zero
  result and one with a block's partial row lost;
- :class:`HourglassNet` keeps its state-dict names and 25,594,624
  parameters, its 378 biased convolutions put out 86,441,984 elements an
  image at 256², and a tiny network's forward and backward on the CPU are
  bit for bit those of the same network built with torch's ``nn.Conv2d``.

On the card (``cuda`` marker; skips here; no JAX import, so
``python -m pytest --noconftest tests/test_torch_conv_bias.py -m cuda``
runs them there): the add against its plain version bit for bit at every
(C, H, W) hg8 puts out, in bf16 and float32 (float64, a reference's type,
runs torch's conv with its bias); the gradient within the
kernel's float32 error bound of float64 and within one bf16 ulp of
torch's, and the bound failing the planted faults; contiguous tensors
refused; two replays of a captured backward equal; a tiny network's
graphed train steps equal its eager ones; the launch counters count once
a replay.
"""

import copy
import math

import numpy as np
import pytest
import torch
import torch.nn as nn

from posetpu_torch.models import conv_bias, hg, hourglass
from posetpu_torch.models.conv_bias import (
    ADD_LAUNCHES,
    GRAD_LAUNCHES,
    Conv2d,
    add_args,
    add_conv_bias_,
    bias_add_plain_,
    bias_grad_plain,
    grad_grid,
    gradient_misses,
    rows_of,
    sum_depth,
)
from posetpu_torch.utils import cuda_build
from posetpu_torch.utils.profiling import counter, reset_counters

DTYPES = (torch.bfloat16, torch.float32, torch.float64)
LAYOUTS = (torch.channels_last, torch.contiguous_format)
CL = torch.channels_last
# (C, H, W) of hg8's conv outputs at 256^2 (the float32 score head's C is 16)
HG8_SHAPES = ((64, 128, 128), (128, 128, 128), (128, 64, 64), (256, 64, 64),
              (128, 32, 32), (256, 32, 32), (128, 16, 16), (256, 16, 16),
              (128, 8, 8), (256, 8, 8), (128, 4, 4), (256, 4, 4))
SCORE_SHAPE = (16, 64, 64)
HG8_CONVS, HG8_ELEMENTS, HG8_PARAMS = 378, 86_441_984, 25_594_624
H100_SMS = 132


def _tensor(shape, dtype, fmt, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    t = torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    return t.to(device).contiguous(memory_format=fmt)


@pytest.fixture
def plain_kernels(monkeypatch):
    """The op's autograd on the CPU: its two kernels replaced by their
    plain versions, each first refusing a layout the kernel refuses (in any
    type, so that gradcheck runs in float64).  Yields the gradients the
    backward passed on."""
    seen = []

    def add(out, bias):
        rows_of(out)
        return bias_add_plain_(out, bias)

    def grad(g):
        rows_of(g)
        seen.append(g)
        return bias_grad_plain(g)

    monkeypatch.setattr(conv_bias, "bias_add_cuda_", add)
    monkeypatch.setattr(conv_bias, "bias_grad_cuda", grad)
    return seen


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", LAYOUTS)
@pytest.mark.parametrize("shape", [(2, 16, 5, 7), (3, 3, 4, 4), (1, 64, 1, 1)])
def test_plain_add_is_torch_add_bit_for_bit(plain_kernels, dtype, fmt, shape):
    out = _tensor(shape, dtype, fmt, 1)
    bias = _tensor((shape[1],), dtype, torch.contiguous_format, 2)
    want = out.clone().add_(bias.view(1, shape[1], 1, 1))
    got = bias_add_plain_(out.clone(), bias)
    assert got.dtype == dtype and torch.equal(got, want)
    if out.is_contiguous(memory_format=CL):  # one pixel: both layouts at once
        assert torch.equal(add_conv_bias_(out.clone(), bias), want)
    else:
        with pytest.raises(ValueError, match="channels-last"):
            add_conv_bias_(out.clone(), bias)


def _f32_sum_bound(g64):
    """|float32 sum - exact| <= (n - 1) * eps / 2 / (1 - (n - 1) * eps / 2)
    * sum |x| for a sum of n terms in any order (Higham, Accuracy and
    Stability of Numerical Algorithms, (4.4)): torch's CPU sum, whose
    order is not the kernel's."""
    n = g64[:, 0].numel()
    u = (n - 1) * 2.0 ** -24
    return u / (1 - u) * g64.abs().sum((0, 2, 3))


@pytest.mark.parametrize("fmt", LAYOUTS)
def test_gradient_within_float32_summation_error(plain_kernels, fmt):
    """The incoming gradient in either layout reaches the kernel dense and
    channels-last; the output's gradient passes unchanged."""
    x = _tensor((4, 32, 9, 11), torch.float32, CL, 3).requires_grad_()
    bias = _tensor((32,), torch.float32, torch.contiguous_format, 4).requires_grad_()
    up = _tensor((4, 32, 9, 11), torch.float32, fmt, 5)
    y = add_conv_bias_(x * 1.0, bias)
    (y * up).sum().backward()
    g64 = up.double()
    exact = g64.sum((0, 2, 3))
    assert torch.equal(x.grad, up)
    (seen,) = plain_kernels
    assert seen.is_contiguous(memory_format=CL) and torch.equal(seen, up)
    assert ((bias.grad.double() - exact).abs() <= _f32_sum_bound(g64)).all()
    assert torch.equal(bias_grad_plain(up), up.sum((0, 2, 3)))


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (1, 8, 1, 1)])
def test_gradcheck_float64(plain_kernels, shape):
    x = _tensor(shape, torch.float64, CL, 6).requires_grad_()
    bias = _tensor(shape[1:2], torch.float64, torch.contiguous_format, 7).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: add_conv_bias_(a * 1.0, b), (x, bias))


@pytest.mark.parametrize("fmt", LAYOUTS)
def test_layout(fmt):
    t = torch.zeros(2, 8, 3, 5).contiguous(memory_format=fmt)
    if fmt == CL:
        assert rows_of(t) == 2 * 3 * 5
    else:
        with pytest.raises(ValueError, match="channels-last"):
            rows_of(t)
    # one pixel: both layouts hold, and the two index alike
    assert rows_of(torch.zeros(2, 8, 1, 1).contiguous(memory_format=fmt)) == 2


@pytest.mark.parametrize("bad", ["strided", "contiguous", "3d", "float16", "float64",
                                 "bias_type", "bias_shape", "huge"])
def test_refusals(bad):
    out = torch.zeros(2, 8, 4, 4, dtype=torch.bfloat16).contiguous(memory_format=CL)
    bias = torch.zeros(8, dtype=torch.bfloat16)
    if bad == "strided":
        out = torch.zeros(2, 4, 8, 8, dtype=torch.bfloat16).permute(0, 3, 1, 2)[..., ::2]
    elif bad == "contiguous":
        out = out.contiguous()
    elif bad == "3d":
        out = out[0]
    elif bad == "float16":
        out, bias = out.half(), bias.half()
    elif bad == "float64":
        out, bias = out.double(), bias.double()
    elif bad == "bias_type":
        bias = bias.float()
    elif bad == "bias_shape":
        bias = torch.zeros(9, dtype=torch.bfloat16)
    elif bad == "huge":  # 2^31 elements, on no storage
        out = torch.empty((2**21, 8, 16, 8), dtype=torch.bfloat16,
                          device="meta").contiguous(memory_format=CL)
    with pytest.raises((TypeError, ValueError)):
        add_args(out, bias)


def test_cuda_wrappers_refuse_cpu_tensors():
    out, bias = torch.zeros(1, 8, 2, 2), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        conv_bias.bias_add_cuda_(out, bias)
    with pytest.raises(ValueError, match="CUDA"):
        conv_bias.bias_grad_cuda(out)


@pytest.mark.parametrize("dtype,C,vec", [
    (torch.bfloat16, 64, 8),
    (torch.bfloat16, 12, 1),
    (torch.bfloat16, 3, 1),
    (torch.float32, 16, 4),
    (torch.float32, 6, 1),
    (torch.float32, 8, 4),
    (torch.bfloat16, 72, 8),
])
def test_vector_width(dtype, C, vec):
    out = torch.zeros(2, C, 8, 8, dtype=dtype).contiguous(memory_format=CL)
    bias = torch.zeros(C, dtype=dtype)
    assert add_args(out, bias) == (out.numel(), C, conv_bias.DTYPES[dtype], vec)
    # a start off 16 bytes takes one element a thread, of the output or the bias
    flat = torch.zeros(out.numel() + 1, dtype=dtype)[1:]
    assert add_args(flat.view(2, 8, 8, C).permute(0, 3, 1, 2), bias)[3] == 1
    assert add_args(out, torch.zeros(C + 1, dtype=dtype)[1:])[3] == 1


def _vec(C, dtype):
    v = 16 // torch.empty((), dtype=dtype).element_size()
    return v if C % v == 0 else 1


@pytest.mark.parametrize("C,H", [(c, h) for c, h, _ in HG8_SHAPES] + [SCORE_SHAPE[:2], (3, 5)])
@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_grad_grid(C, H, sms):
    dtype = torch.float32 if (C, H) == SCORE_SHAPE[:2] else torch.bfloat16
    vec = _vec(C, dtype)
    rows = 32 * H * H
    blocks, tile, cluster = grad_grid(rows, C, vec, sms)
    assert tile == C // vec and tile * vec <= conv_bias.SUM_THREADS  # one tile each
    at_once = conv_bias.SUM_THREADS // tile
    per_thread = math.ceil(rows / (blocks * at_once))
    if cluster:
        assert blocks == conv_bias.CLUSTER
        assert per_thread <= conv_bias.CLUSTER_ROWS_PER_THREAD
    else:
        assert rows > conv_bias.CLUSTER * at_once * conv_bias.CLUSTER_ROWS_PER_THREAD
        assert 1 <= blocks <= sms // 2
        # at least ROWS_PER_THREAD rows a thread unless the grid is full
        assert blocks == sms // 2 or blocks == math.ceil(
            rows / (at_once * conv_bias.ROWS_PER_THREAD))
    # a thread's rows, then its block's, then the partial rows (or blocks)
    assert sum_depth(rows, C, vec, sms) == per_thread + at_once + blocks


def test_grad_grid_wide_rows_take_tiles():
    """More column vectors than a block covers: grid y walks the tiles and
    no cluster runs them."""
    blocks, tile, cluster = grad_grid(100_000, 4096, 8, H100_SMS)
    assert (tile, cluster) == (128, False) and blocks == H100_SMS // 2 // 4


def _lost_partial(g, sms):
    """What the gradient kernel would give for channels-last ``g`` with
    block 0's partial row lost: the exact column sums less the rows block 0
    sums (row r where r mod (blocks * R) < R), rounded to ``g``'s type."""
    N, C, H, W = g.shape
    rows = N * H * W
    blocks, tile, _ = grad_grid(rows, C, _vec(C, g.dtype), sms)
    R = conv_bias.SUM_THREADS // tile
    m = g.permute(0, 2, 3, 1).reshape(rows, C).double()
    lost = torch.arange(rows, device=g.device) % (blocks * R) < R
    return (m.sum(0) - m[lost].sum(0)).to(g.dtype)


def _planted_faults_fail(g, sms):
    """The gradient bound fails a zero result and a lost partial row."""
    zeros = torch.zeros(g.shape[1], dtype=g.dtype, device=g.device)
    return (bool(gradient_misses(zeros, g, sms).any())
            and bool(gradient_misses(_lost_partial(g, sms), g, sms).any()))


@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (32, 128, 16, 16)),  # blocks with a ticket
    (torch.bfloat16, (4, 64, 128, 128)),  # 66 blocks of 8 rows a thread
    (torch.bfloat16, (32, 128, 8, 8)),  # one cluster
    (torch.float32, (8, 16, 64, 64)),  # the float32 score head
])
def test_gradient_bound_takes_torch_sum_and_fails_planted_faults(dtype, shape):
    """The kernel's error bound (its own summation depth, not the rows')
    holds torch's float sum in another order, and no room in it lets a
    zero gradient or one with a block's partial row lost through."""
    g = _tensor(shape, dtype, CL, shape[1] + shape[2])
    assert not gradient_misses(bias_grad_plain(g), g, H100_SMS).any()
    if dtype == torch.bfloat16:
        plain = bias_grad_plain(g)
        assert not gradient_misses(plain, g, H100_SMS, torch_sum=plain).any()
    assert _planted_faults_fail(g, H100_SMS)


def _as_torch_convs(model):
    """``model`` with every port ``Conv2d`` turned into torch's own."""
    model = copy.deepcopy(model)
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.__class__ = nn.Conv2d
    return model


def test_state_dict_and_parameters_unchanged(monkeypatch):
    model = hg()
    assert sum(p.numel() for p in model.parameters()) == HG8_PARAMS
    monkeypatch.setattr(hourglass, "Conv2d", nn.Conv2d)
    before = hg()
    assert not any(isinstance(m, Conv2d) for m in before.modules())
    assert list(model.state_dict()) == list(before.state_dict())
    assert [(k, v.shape) for k, v in model.state_dict().items()] == \
        [(k, v.shape) for k, v in before.state_dict().items()]


def test_hg8_convs_and_output_elements():
    """378 biased convolutions an hg8 forward, 86,441,984 output elements an
    image at 256², at the widths the card tests and chip_smoke hold the
    kernels at."""
    model = hg().eval()
    seen = []
    for m in model.modules():
        if isinstance(m, Conv2d):
            assert m.bias is not None
            m.register_forward_hook(lambda mod, i, o: seen.append((tuple(o.shape[1:]),
                                                                   o.dtype)))
    with torch.no_grad():
        model(torch.zeros(1, 256, 256, 3))
    assert len(seen) == HG8_CONVS
    assert sum(math.prod(s) for s, _ in seen) == HG8_ELEMENTS
    assert {s for s, d in seen if d == torch.bfloat16} == set(HG8_SHAPES)
    assert {s for s, d in seen if d == torch.float32} == {SCORE_SHAPE}


def _tiny(dtype):
    torch.manual_seed(0)
    model = hg(num_stacks=2, num_classes=4, num_feats=8, depth=2, dtype=dtype).train()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv2d):
                m.bias.normal_()
    return model


def _forward_backward(model, x):
    out = model(x)
    sum((o * (i + 1)).sum() for i, o in enumerate(out)).backward()
    return ([o.detach() for o in out],
            {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            {n: b.clone() for n, b in model.named_buffers()})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_route_is_torch_conv(dtype):
    """On the CPU the port's Conv2d is torch's conv with its bias: forward,
    gradients and BatchNorm statistics bit for bit."""
    model = _tiny(dtype)
    ref = _as_torch_convs(model)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32))
    reset_counters(ADD_LAUNCHES, GRAD_LAUNCHES)
    got, want = _forward_backward(model, x), _forward_backward(ref, x)
    assert counter(ADD_LAUNCHES) == counter(GRAD_LAUNCHES) == 0
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for part in (1, 2):
        assert got[part].keys() == want[part].keys()
        for k in got[part]:
            assert torch.equal(got[part][k], want[part][k]), k


# ---- on the card ----------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def _cases():
    """(dtype, (C, H, W)) of every conv output hg8 puts out, and odd widths
    that take one element a thread."""
    cases = [(torch.bfloat16, s) for s in HG8_SHAPES]
    cases += [(torch.float32, s) for s in HG8_SHAPES[::3]] + [(torch.float32, SCORE_SHAPE)]
    cases += [(torch.bfloat16, (3, 5, 7)), (torch.float32, (13, 3, 3))]
    return cases


@pytest.mark.cuda
def test_cuda_add_bit_for_bit():
    _need_cuda()
    for dtype, (C, H, W) in _cases():
        for N in (2, 3):
            out = _tensor((N, C, H, W), dtype, CL, C + H, "cuda")
            bias = _tensor((C,), dtype, torch.contiguous_format, C, "cuda")
            want = bias_add_plain_(out.clone(), bias)
            reset_counters(ADD_LAUNCHES)
            got = conv_bias.bias_add_cuda_(out, bias)
            assert got is out and counter(ADD_LAUNCHES) == 1
            assert torch.equal(got, want), (dtype, C, H, W, N)
            assert got.is_contiguous(memory_format=CL)
            with pytest.raises(ValueError, match="channels-last"):
                conv_bias.bias_add_cuda_(out.contiguous(), bias)
    # starts off 16 bytes: one element a thread
    flat = _tensor((2 * 64 * 8 * 8 + 1,), torch.bfloat16, torch.contiguous_format, 9, "cuda")
    out = flat[1:].view(2, 8, 8, 64).permute(0, 3, 1, 2)
    bias = _tensor((64,), torch.bfloat16, torch.contiguous_format, 10, "cuda")
    want = bias_add_plain_(out.clone(), bias)
    assert torch.equal(conv_bias.bias_add_cuda_(out, bias), want)
    # float64, a reference's type, is torch's conv with its bias: no launch
    with pytest.raises(TypeError):
        conv_bias.bias_add_cuda_(out.double(), bias.double())
    torch.manual_seed(0)
    conv = Conv2d(8, 16, 3, padding=1).double().cuda()
    x = _tensor((2, 8, 5, 5), torch.float64, CL, 12, "cuda")
    reset_counters(ADD_LAUNCHES)
    assert torch.equal(conv(x), nn.Conv2d.forward(conv, x)) and counter(ADD_LAUNCHES) == 0


@pytest.mark.cuda
def test_cuda_gradient_against_float64_and_torch():
    """At batch 32, as the train step runs them: within the kernel's error
    bound of the float64 sum (its summation depth, not the rows'), and in
    bf16 within one bf16 ulp of torch's sum beside the float sums' error;
    a zero result and a lost partial row fail the same bound."""
    _need_cuda()
    sms = cuda_build.sm_count("cuda")
    for dtype, (C, H, W) in _cases():
        g = _tensor((32, C, H, W), dtype, CL, C * H, "cuda")
        reset_counters(GRAD_LAUNCHES)
        got = conv_bias.bias_grad_cuda(g)
        assert counter(GRAD_LAUNCHES) == 1 and got.dtype == dtype and got.shape == (C,)
        assert not gradient_misses(got, g, sms).any(), (dtype, C, H, W)
        if dtype == torch.bfloat16:
            plain = bias_grad_plain(g)
            assert not gradient_misses(got, g, sms, torch_sum=plain).any(), (C, H, W)
        assert _planted_faults_fail(g, sms), (dtype, C, H, W)
        with pytest.raises(ValueError, match="channels-last"):
            conv_bias.bias_grad_cuda(g.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 256, 16, 16), (32, 128, 8, 8)])
def test_cuda_replays_give_identical_gradients(shape):
    """Blocks with a ticket (16², 256 channels) and one cluster (8², 128
    channels): three replays of a captured gradient equal the eager one."""
    _need_cuda()
    g = _tensor(shape, torch.bfloat16, CL, 11, "cuda")
    N, C, H, W = shape
    assert grad_grid(N * H * W, C, 8, cuda_build.sm_count("cuda"))[2] == (H == 8)
    want = conv_bias.bias_grad_cuda(g)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        conv_bias.bias_grad_cuda(g)  # warm-up on the capture's stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = conv_bias.bias_grad_cuda(g)
    results = []
    for _ in range(3):
        graph.replay()
        results.append(out.clone())
    torch.cuda.synchronize()
    for r in results:
        assert torch.equal(r, want)


def _small_cfg():
    from posetpu_torch.configs import named_config

    cfg = named_config("hg2_mpii_mini")
    cfg.model.feats, cfg.model.depth, cfg.model.bf16 = 8, 2, False
    cfg.aug.inp_res, cfg.aug.out_res = (64, 64), (16, 16)
    return cfg


def _batch(seed, B=4, K=16, hw=(72, 96)):
    rng = np.random.RandomState(seed)
    H, W = hw
    valid_wh = np.stack([rng.randint(W - 20, W + 1, B), rng.randint(H - 10, H + 1, B)],
                        axis=1).astype(np.int32)
    center = (valid_wh / 2 + rng.uniform(-5, 5, (B, 2))).astype(np.float32)
    return {
        "image": rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8),
        "valid_wh": valid_wh,
        "center": center,
        "scale": (valid_wh[:, 1] / 200.0 * rng.uniform(0.8, 1.2, B)).astype(np.float32),
        "pts": (center[:, None, :] + rng.uniform(-30, 30, (B, K, 2))).astype(np.float32),
        "vis": (rng.rand(B, K) < 0.8).astype(np.float32),
        "index": rng.choice(10_000, B, replace=False).astype(np.int32),
    }


@pytest.mark.cuda
def test_cuda_graphed_steps_equal_eager_and_count_once_a_replay():
    """f32, TF32 off, deterministic algorithms: two graphed dispatches of
    K = 2 equal 4 eager steps bit for bit; each replayed step counts one add
    and one gradient a biased conv, as the warm-up's steps do."""
    _need_cuda()
    import os

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
        convs = sum(isinstance(m, Conv2d) for m in base.modules())
        batches = [_batch(40 + i) for i in range(4)]
        runs = {}
        for how in ("eager", "graph"):
            model = copy.deepcopy(base).cuda()
            opt = make_optimizer(model.parameters(), cfg.optim, steps_per_epoch=2)
            state = TrainState(model, opt)
            if how == "eager":
                step = make_train_step(model, opt, cfg.aug, mean, seed=3, device="cuda")
                reset_counters(ADD_LAUNCHES, GRAD_LAUNCHES)
                for b in batches:
                    step(state, b)
                torch.cuda.synchronize()
                assert counter(ADD_LAUNCHES) == counter(GRAD_LAUNCHES) == 4 * convs
            else:
                dispatch = make_dispatch_step(model, opt, cfg.aug, mean, seed=3, steps=2,
                                              device="cuda")
                reset_counters(ADD_LAUNCHES, GRAD_LAUNCHES)
                for i in (0, 2):
                    dispatch(state, {k: np.stack([b[k] for b in batches[i:i + 2]])
                                     for k in batches[0]})
                torch.cuda.synchronize()
                assert dispatch.captures == 1
                want = (4 + WARMUP_STEPS) * convs
                assert counter(ADD_LAUNCHES) == counter(GRAD_LAUNCHES) == want
            runs[how] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev[:2]
        torch.use_deterministic_algorithms(prev[2])
    for k in runs["eager"]:
        assert torch.equal(runs["eager"][k], runs["graph"][k]), k
