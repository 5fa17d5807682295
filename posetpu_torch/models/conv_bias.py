"""The stacked hourglass's convolution bias as one hand-written op.

On cuDNN, torch's convolution runs without its bias and adds it afterwards,
``output.add_(bias.reshape(1, C, 1, 1))``.  The broadcast operand sends
that add to TensorIterator's legacy kernel, which moves one element a
thread with an offset computed for each, and ``convolution_backward``
takes the bias gradient as ``grad_output.sum((0, 2, 3))``, a column
reduction over the channels-last gradient.  :class:`Conv2d` runs the
convolution without its bias on CUDA and then :func:`add_conv_bias_`: an
in-place add in 16-byte vectors, and in the backward pass the bias
gradient in one deterministic launch (``models/kernels/conv_bias.cu``).
Elsewhere (the CPU, which every parity test against the JAX package runs
on, and float64, the precision of the references that run the network on
the card) :class:`Conv2d` is torch's module as it is.

The add computes ``out = T(float(out) + float(bias))`` with the bias
already in the activations' type ``T`` (the caller casts it, as autocast
casts a convolution's bias), which is torch's ``add_`` bit for bit.  The
gradient is the float32 column sum rounded once to ``T``, as torch's bf16
``sum`` rounds its float sum once; the incoming
gradient is made dense channels-last first, and the gradient of
the convolution's output passes through unchanged.

The kernels take channels-last bf16 and float32 tensors of shape
(N, C, H, W) (the add under 2^31 elements), the layout of every bf16 or
float32 convolution output of the hourglass on the card, whose forward
permutes an NHWC input; they raise on anything else.  (torch's float64
convolution on the card, which cuDNN does not run, puts out contiguous
NCHW.)  Each wrapper launches on the
current stream without synchronising, raises if the launch was refused,
and adds one to its counter in :data:`posetpu_torch.utils.profiling.REGISTRY`:
``launches.conv_bias`` (:data:`ADD_LAUNCHES`) and
``launches.conv_bias_grad`` (:data:`GRAD_LAUNCHES`), counted once a replay
where a CUDA graph captured them.  :func:`bias_add_plain_` and
:func:`bias_grad_plain` are their plain versions, and
:func:`gradient_misses` holds a gradient to the kernel's error bound.  The
kernels build at first use (:mod:`posetpu_torch.utils.cuda_build`); nothing
here runs at import.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch
import torch.nn as nn

from posetpu_torch.utils import cuda_build, profiling

CONV_BIAS = cuda_build.Library(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels", "conv_bias.cu"),
    {"conv_bias_add_launch": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p,
                                             ctypes.c_longlong] + [ctypes.c_int] * 4
                              + [ctypes.c_void_p]),
     "conv_bias_grad_launch": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_longlong]
                               + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
                               + [ctypes.c_int, ctypes.c_void_p])},
)

ADD_LAUNCHES = profiling.launch_counter("launches.conv_bias")
GRAD_LAUNCHES = profiling.launch_counter("launches.conv_bias_grad")
COUNTERS = (ADD_LAUNCHES, GRAD_LAUNCHES)

# the kernels' element types, by their dtype code
DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# the gradient kernel's block and its cluster (conv_bias.cu)
SUM_THREADS = 1024
CLUSTER = 8
# channels-last gradients whose threads sum at most this many rows in one
# cluster of CLUSTER blocks take the cluster kernel
CLUSTER_ROWS_PER_THREAD = 16
# else each thread sums at least this many rows, on at most half the SMs (a
# block an SM: fewer partial rows for the last block to add; measured on an
# H100, PERF.md)
ROWS_PER_THREAD = 4


def bias_add_plain_(out, bias):
    """``out += bias`` over the channels of (N, C, H, W) ``out``, in place:
    torch's own add."""
    return out.add_(bias.view(1, -1, 1, 1))


def bias_grad_plain(grad):
    """The bias gradient of (N, C, H, W) ``grad``: its sum over N, H, W in
    its own type, as torch's convolution backward takes it."""
    return grad.sum((0, 2, 3))


def rows_of(t):
    """N*H*W, the rows of (N, C, H, W) ``t`` as the kernels read it: a dense
    (rows, C) matrix.  Raises unless ``t`` is channels-last."""
    if t.dim() != 4:
        raise ValueError(f"the conv bias takes (N, C, H, W) tensors, got {tuple(t.shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"the conv bias takes channels-last tensors, got strides "
                         f"{t.stride()} for shape {tuple(t.shape)}")
    N, C, H, W = t.shape
    return N * H * W


def _dtype_code(t):
    if t.dtype not in DTYPES:
        raise TypeError(f"the conv bias kernels take bf16 or float32, got {t.dtype}")
    return DTYPES[t.dtype]


def _width(t):
    """The kernels' vector width for channels-last ``t``: 16 bytes of
    elements where a row of channels holds whole vectors and ``t`` starts
    on 16 bytes, else 1."""
    vec = 16 // t.element_size()
    return 1 if t.shape[1] % vec or t.data_ptr() % 16 else vec


def add_args(out, bias):
    """The add kernel's (numel, C, dtype code, vector width) for ``out``
    and ``bias``; raises on what the kernel does not take."""
    code = _dtype_code(out)
    if out.numel() >= 2**31:
        raise ValueError(f"the conv bias add takes under 2^31 elements, got {out.numel()}")
    rows_of(out)
    C = out.shape[1]
    if bias.dtype != out.dtype:
        raise TypeError(f"the bias ({bias.dtype}) must be in the output's type ({out.dtype})")
    if bias.shape != (C,) or bias.stride() != (1,):
        raise ValueError(f"the bias must be a dense ({C},) vector, got {tuple(bias.shape)}")
    vec = 1 if bias.data_ptr() % 16 else _width(out)
    return out.numel(), C, code, vec


def grad_grid(rows, C, vec, sms):
    """The gradient kernel's (blocks in x, column vectors a block covers,
    whether one cluster runs it) for a (rows, C) gradient: a small gradient
    of one tile takes one cluster of :data:`CLUSTER` blocks; any other,
    blocks of at least :data:`ROWS_PER_THREAD` rows a thread on at most half
    the SMs, grid y walking the tiles."""
    tile = min(C // vec, SUM_THREADS // vec)
    tiles = math.ceil(C // vec / tile)
    rows_at_once = SUM_THREADS // tile
    if tiles == 1 and rows <= CLUSTER * rows_at_once * CLUSTER_ROWS_PER_THREAD:
        return CLUSTER, tile, True
    want = math.ceil(rows / (rows_at_once * ROWS_PER_THREAD))
    return max(1, min(want, sms // 2 // tiles)), tile, False


def sum_depth(rows, C, vec, sms):
    """At least the float additions any element of a (rows, C) gradient
    passes through in the gradient kernel: the rows a thread sums, the
    SUM_THREADS / tile rows its block adds, and the partial rows (or cluster
    blocks) added last."""
    blocks, tile, _ = grad_grid(rows, C, vec, sms)
    at_once = SUM_THREADS // tile
    return math.ceil(rows / (blocks * at_once)) + at_once + blocks


def _gamma(n, unit):
    u = n * unit
    return u / (1 - u)


def ulp(x, dtype):
    """The spacing of ``dtype``'s numbers in the binade of each |x|."""
    bits = round(-math.log2(torch.finfo(dtype).eps)) + 1
    return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - bits)


def gradient_misses(got, g, sms, torch_sum=None):
    """Where ``got``, the gradient kernel's (C,) result for channels-last
    ``g`` on a card of ``sms`` SMs, lies outside the kernel's error bound:
    a (C,) bool tensor.  The kernel's float32 sum, a tree of depth d =
    :func:`sum_depth`, lies within gamma_d * sum |x| of the exact sum
    (Higham, Accuracy and Stability of Numerical Algorithms, (4.4));
    a bf16 result, that sum rounded once, lies besides within one bf16 ulp
    of the exact sum rounded to bf16.  The exact sum is taken in float64,
    with room for its own error.  With ``torch_sum`` (torch's own
    ``sum((0, 2, 3))`` of bf16 ``g``), ``got`` is held within one bf16 ulp
    of it instead, beside room for the two float sums' errors at depth d."""
    N, C, H, W = g.shape
    rows = rows_of(g)
    g64 = g.double()
    mass = g64.abs().sum((0, 2, 3))
    room = (_gamma(sum_depth(rows, C, _width(g), sms), 2.0 ** -24)
            + _gamma(rows, 2.0 ** -53)) * mass
    got = got.double()
    if torch_sum is None:
        want = g64.sum((0, 2, 3))
    else:
        want, room = torch_sum.double(), 2 * room
    if g.dtype == torch.bfloat16:
        want = want.to(g.dtype).double()
        room = room + ulp(torch.maximum(got.abs(), want.abs()), g.dtype)
    return (got - want).abs() > room


def _check_cuda(*ts):
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError("the conv bias kernels take CUDA tensors on one device")


def bias_add_cuda_(out, bias):
    """Kernel counterpart of :func:`bias_add_plain_`: ``out`` (N, C, H, W),
    channels-last, bf16 or float32 on CUDA, gets ``bias`` (C,) of its own
    type added in place; returns ``out``."""
    _check_cuda(out, bias)
    numel, C, code, vec = add_args(out, bias)
    dev = out.device
    with torch.cuda.device(dev):
        err = CONV_BIAS.conv_bias_add_launch(out.data_ptr(), bias.data_ptr(), numel, C, code,
                                             vec, cuda_build.sm_count(dev),
                                             torch.cuda.current_stream().cuda_stream)
    cuda_build.count_launch(err, "conv_bias_add", ADD_LAUNCHES)
    return out


def bias_grad_cuda(grad):
    """Kernel counterpart of :func:`bias_grad_plain` for a channels-last
    ``grad`` (bf16 or float32 on CUDA): (C,) in ``grad``'s type."""
    _check_cuda(grad)
    code = _dtype_code(grad)
    rows, C, vec = rows_of(grad), grad.shape[1], _width(grad)
    dev = grad.device
    gx, tile, cluster = grad_grid(rows, C, vec, cuda_build.sm_count(dev))
    # a cluster adds its blocks' sums in shared memory: no partial rows
    partial = None if cluster else torch.empty(gx * C, dtype=torch.float32, device=dev)
    out = torch.empty(C, dtype=grad.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = CONV_BIAS.conv_bias_grad_launch(grad.data_ptr(), rows, C, code, vec, gx, tile,
                                              int(cluster),
                                              None if cluster else partial.data_ptr(),
                                              out.data_ptr(),
                                              cuda_build.ticket_slot(dev.index, stream), stream)
    cuda_build.count_launch(err, "conv_bias_grad", GRAD_LAUNCHES)
    return out


class _ConvBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, bias):
        ctx.mark_dirty(out)
        return bias_add_cuda_(out, bias)

    @staticmethod
    def backward(ctx, grad):
        grad_bias = None
        if ctx.needs_input_grad[1]:
            grad_bias = bias_grad_cuda(grad.contiguous(memory_format=torch.channels_last))
        return grad, grad_bias


def add_conv_bias_(out, bias):
    """``out`` (N, C, H, W), a convolution's channels-last output on CUDA,
    with ``bias`` (C,) of its type added in place, under autograd: the
    bias's gradient is the column sum of the incoming one, made dense
    channels-last first, which passes on to ``out``'s producer unchanged."""
    return _ConvBias.apply(out, bias)


class Conv2d(nn.Conv2d):
    """torch's ``nn.Conv2d`` (its parameters, buffers and state-dict names)
    whose bias, on CUDA, is added by :func:`add_conv_bias_` after the
    convolution runs without it, cast first to the output's type as
    autocast casts it for the convolution.  Elsewhere, without a bias, and
    with float64 parameters (a reference's), it is torch's module as it
    is."""

    def forward(self, x):
        if x.device.type != "cuda" or self.bias is None or self.weight.dtype not in DTYPES:
            return super().forward(x)
        out = self._conv_forward(x, self.weight, None)
        return add_conv_bias_(out, self.bias.to(out.dtype))
