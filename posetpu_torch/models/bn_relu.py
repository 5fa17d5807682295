"""The stacked hourglass's BatchNorm and the ReLU after it, as one op.

Every norm of :class:`posetpu_torch.models.hourglass.HourglassNet` is
followed by a ReLU.  On the card torch runs the pair as four channels-last
``batch_norm_*`` kernels (statistics, transform, backward reduce, backward
elementwise) and two ReLU passes (its clamp, ``threshold_backward``), each
over the whole activation.  :class:`BatchNormReLU` is torch's
``BatchNorm2d`` (its parameters, buffers and state-dict names, and the
running-variance record of :class:`posetpu_torch.models.batchnorm.BatchNorm2d`)
whose forward, on CUDA, is one hand-written op
(``models/kernels/bn_relu.cu``):

- train mode: the batch's float32 statistics (Welford and Chan's rule, a
  deterministic merge), the running statistics updated as torch updates
  them (unbiased variance, ``momentum``) and ``num_batches_tracked`` counted
  in the same launch, then ``r = relu(T(w * (x - mean) * invstd + b))``,
  which given equal statistics is torch's ``F.relu(F.batch_norm(x, ...))``
  bit for bit; its backward saves ``x``, the mean and invstd, rebuilds the
  ReLU's mask as ``T(z) > 0`` and takes the weight, bias and input
  gradients in two passes;
- eval mode: one pass with ``invstd = rsqrt(running_var + eps)``, as
  torch's eval norm computes it.  It has no backward: an eval-mode forward
  that autograd would differentiate raises.

Elsewhere (the CPU, which every parity test against the JAX package runs
on, float64, the precision of the references that run the network on the
card) and with a cross-replica ``group`` set (a different function, whose
statistics are the group's) its forward is ``F.relu(BatchNorm2d.forward(x))``
as before.  Inside :func:`posetpu_torch.models.batchnorm.recomputing` the
op leaves the running statistics and ``num_batches_tracked`` alone, as the
plain norm does.

The kernels take channels-last bf16 and float32 tensors of shape (N, C, H,
W), C a multiple of 8, starting on 16 bytes, with float32 weight, bias and
running statistics; the wrappers raise on anything else.  Each launches on
the current stream without synchronising, raises if a launch was refused,
and adds one a call to its counter in
:data:`posetpu_torch.utils.profiling.REGISTRY`: ``launches.bn_relu``
(:data:`LAUNCHES`, a forward of either mode) and ``launches.bn_relu_grad``
(:data:`GRAD_LAUNCHES`), counted once a replay where a CUDA graph captured
them.  :func:`forward_plain`, :func:`eval_plain` and :func:`backward_plain`
are their plain versions, :func:`bn_relu_plain` torch's own pair.  The
kernels build at first use (:mod:`posetpu_torch.utils.cuda_build`);
nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch
import torch.nn.functional as F

from posetpu_torch.models.batchnorm import BatchNorm2d, is_recomputing
from posetpu_torch.utils import cuda_build, profiling

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
BN_RELU = cuda_build.Library(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels", "bn_relu.cu"),
    {"bn_relu_forward_launch": (_I, [_P] * 9 + [_F] * 3 + [ctypes.c_longlong] + [_I] * 4
                                + [_P, _I, _P]),
     "bn_relu_eval_launch": (_I, [_P] * 6 + [_F, ctypes.c_longlong] + [_I] * 3 + [_P]),
     "bn_relu_backward_launch": (_I, [_P] * 10 + [ctypes.c_longlong] + [_I] * 4
                                 + [_P, _I, _P])},
)

LAUNCHES = profiling.launch_counter("launches.bn_relu")
GRAD_LAUNCHES = profiling.launch_counter("launches.bn_relu_grad")
COUNTERS = (LAUNCHES, GRAD_LAUNCHES)

# the kernels' element types, by their dtype code
DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# the statistics' and gradient sums' block, the elementwise passes' block
# and the cluster (bn_relu.cu)
SUM_THREADS = 512
APPLY_THREADS = 512
CLUSTER = 8
# norms whose activations are at most this many bytes, of at most
# CLUSTER_CHANNELS channels, run as one cluster: hg8's 4² norms at batch 32,
# where one launch beats two (H100: 9.2-10.3 against 13.5-14.3 us forward,
# 7.2-8.7 against 11.8 backward); at 8² the cluster's eight SMs lost to the
# grid (backward 22.9-35.6 against 19.8 us)
CLUSTER_BYTES = 1 << 18
CLUSTER_CHANNELS = 256
# else each statistics thread takes at least this many rows, on at most one
# block an SM (fewer partial rows for the last block to merge)
ROWS_PER_THREAD = 8


def bn_relu_plain(x, weight, bias, running_mean, running_var, training, momentum, eps):
    """torch's own pair, ``F.relu(F.batch_norm(x, ...))``."""
    return F.relu(F.batch_norm(x, running_mean, running_var, weight, bias, training, momentum,
                               eps))


def _pre_relu(x, mean, invstd, weight, bias):
    """z = w * (x - mean) * invstd + b in float32 (float64 for a float64
    ``x``), in the kernels' order (which round the last multiply and the
    add once, an FMA: within an ulp of this)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    view = (1, -1, 1, 1)
    xf = x.to(acc)
    return ((weight.to(acc).view(view) * (xf - mean.to(acc).view(view)))
            * invstd.to(acc).view(view) + bias.to(acc).view(view))


def forward_plain(x, weight, bias, running_mean, running_var, batches, momentum, eps):
    """The train-mode forward kernel's function in torch ops: (r, mean,
    invstd), the running statistics and ``batches`` updated in place unless
    they are None."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    n = x.numel() // x.shape[1]
    mean = xf.mean((0, 2, 3))
    var = (xf - mean.view(1, -1, 1, 1)).square().mean((0, 2, 3))
    invstd = torch.rsqrt(var + eps)
    if running_mean is not None:
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(momentum * mean.to(running_mean.dtype))
            running_var.mul_(1 - momentum).add_(
                momentum * (var * (n / (n - 1))).to(running_var.dtype))
            batches.add_(1)
    return F.relu(_pre_relu(x, mean, invstd, weight, bias).to(x.dtype)), mean, invstd


def eval_plain(x, weight, bias, running_mean, running_var, eps):
    """The eval-mode kernel's function in torch ops."""
    invstd = torch.rsqrt(running_var + eps)
    return F.relu(_pre_relu(x, running_mean, invstd, weight, bias).to(x.dtype))


def backward_plain(grad, x, weight, bias, mean, invstd):
    """The backward kernels' function in torch ops: (dx, grad_weight,
    grad_bias) for the gradient ``grad`` of r, the mask rebuilt as
    ``T(z) > 0``."""
    acc = torch.promote_types(x.dtype, torch.float32)
    view = (1, -1, 1, 1)
    keep = _pre_relu(x, mean, invstd, weight, bias).to(x.dtype) > 0
    dz = torch.where(keep, grad.to(acc), torch.zeros((), dtype=acc, device=x.device))
    xmu = x.to(acc) - mean.to(acc).view(view)
    n = x.numel() // x.shape[1]
    s1, s2 = dz.sum((0, 2, 3)), (dz * xmu).sum((0, 2, 3))
    inv = invstd.to(acc)
    f1 = inv * inv * s2 / n
    dx = (dz - (s1 / n).view(view) - xmu * f1.view(view)) * (weight.to(acc) * inv).view(view)
    return dx.to(x.dtype), (s2 * inv).to(weight.dtype), s1.to(bias.dtype)


def rows_of(t):
    """N*H*W, the rows of (N, C, H, W) ``t`` as the kernels read it: a dense
    (rows, C) matrix.  Raises on what the kernels do not take."""
    if t.dim() != 4:
        raise ValueError(f"bn_relu takes (N, C, H, W) tensors, got {tuple(t.shape)}")
    if t.dtype not in DTYPES:
        raise TypeError(f"bn_relu takes bf16 or float32 activations, got {t.dtype}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"bn_relu takes channels-last tensors, got strides {t.stride()} "
                         f"for shape {tuple(t.shape)}")
    N, C, H, W = t.shape
    if C % 8:
        raise ValueError(f"bn_relu takes a multiple of 8 channels, got {C}")
    if t.data_ptr() % 16:
        raise ValueError("bn_relu takes tensors that start on 16 bytes")
    if N * H * W == 0:
        raise ValueError(f"bn_relu takes a non-empty batch, got {tuple(t.shape)}")
    return N * H * W


def row_blocks(rows, C, element_size, sms):
    """The sums' row blocks for a (rows, C) norm: its threads read 8-byte
    vectors, a tile of up to :data:`SUM_THREADS` vectors a block; blocks of
    at least :data:`ROWS_PER_THREAD` rows a thread, at most one an SM
    across the tiles.  The statistics take as many row blocks over their
    tiles of 16-byte vectors, the elementwise passes 4x as many over their
    own tiles (``bn_relu.cu``: Grid)."""
    cvecs = C // (8 // element_size)
    tile = min(cvecs, SUM_THREADS)
    tiles = math.ceil(cvecs / tile)
    at_once = 1 << (SUM_THREADS // tile).bit_length() - 1
    want = math.ceil(rows / (at_once * ROWS_PER_THREAD))
    return max(1, min(want, sms // tiles))


def grid(rows, C, element_size, sms):
    """The train-mode kernels' (row blocks, whether one cluster runs them)
    for a (rows, C) norm: one cluster of :data:`CLUSTER` blocks where its
    activations fit :data:`CLUSTER_BYTES` and it has at most
    :data:`CLUSTER_CHANNELS`, else :func:`row_blocks`."""
    if C <= CLUSTER_CHANNELS and rows * C * element_size <= CLUSTER_BYTES:
        return CLUSTER, True
    return row_blocks(rows, C, element_size, sms), False


def _check_params(x, *params):
    for p in params:
        if p.dtype != torch.float32 or p.shape != (x.shape[1],) or not p.is_contiguous():
            raise ValueError(f"bn_relu takes dense float32 ({x.shape[1]},) parameters and "
                             f"statistics, got {p.dtype} {tuple(p.shape)}")
    if not all(t.is_cuda and t.device == x.device for t in (x, *params)):
        raise ValueError("bn_relu's kernels take CUDA tensors on one device")


def _launch_args(x):
    rows = rows_of(x)
    C = x.shape[1]
    return (rows, C, DTYPES[x.dtype], *grid(rows, C, x.element_size(), cuda_build.sm_count(x.device)))


def _ptr(t):
    return None if t is None else t.data_ptr()


def forward_cuda(x, weight, bias, running_mean, running_var, batches, momentum, eps):
    """Kernel counterpart of :func:`forward_plain` for channels-last ``x``
    (bf16 or float32 on CUDA): (r, mean, invstd).  ``running_mean``,
    ``running_var`` and ``batches`` (int64) are all given, and updated in
    place, or all None."""
    running = [t for t in (running_mean, running_var, batches) if t is not None]
    if len(running) not in (0, 3):
        raise ValueError("bn_relu takes the running statistics and their count together")
    _check_params(x, weight, bias, *running[:2])
    if batches is not None and (batches.dtype != torch.int64 or batches.device != x.device):
        raise ValueError("bn_relu counts batches in an int64 tensor on the input's device")
    rows, C, code, blocks, cluster = _launch_args(x)
    dev = x.device
    out = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty(C, dtype=torch.float32, device=dev)
    invstd = torch.empty(C, dtype=torch.float32, device=dev)
    # per row block a partial row of means and of m2s and a count
    partial = None if cluster else torch.empty(blocks * (2 * C + 1), dtype=torch.float32,
                                               device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = BN_RELU.bn_relu_forward_launch(
            x.data_ptr(), out.data_ptr(), weight.data_ptr(), bias.data_ptr(), mean.data_ptr(),
            invstd.data_ptr(), _ptr(running_mean), _ptr(running_var), _ptr(batches), momentum,
            eps, rows / (rows - 1) if rows > 1 else 1.0, rows, C, code, blocks, int(cluster),
            _ptr(partial), cuda_build.ticket_slot(dev.index, stream), stream)
    cuda_build.count_launch(err, "bn_relu_forward", LAUNCHES)
    return out, mean, invstd


def eval_cuda(x, weight, bias, running_mean, running_var, eps):
    """Kernel counterpart of :func:`eval_plain`."""
    _check_params(x, weight, bias, running_mean, running_var)
    rows = rows_of(x)
    C = x.shape[1]
    blocks = row_blocks(rows, C, x.element_size(), cuda_build.sm_count(x.device))
    out = torch.empty_like(x, memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        err = BN_RELU.bn_relu_eval_launch(
            x.data_ptr(), out.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), eps, rows, C, DTYPES[x.dtype],
            blocks, torch.cuda.current_stream().cuda_stream)
    cuda_build.count_launch(err, "bn_relu_eval", LAUNCHES)
    return out


def backward_cuda(grad, x, weight, bias, mean, invstd):
    """Kernel counterpart of :func:`backward_plain` for channels-last
    ``grad`` and ``x`` of one type: (dx, grad_weight, grad_bias)."""
    if grad.shape != x.shape or grad.dtype != x.dtype:
        raise ValueError(f"bn_relu's backward takes a gradient like its input, got "
                         f"{grad.dtype} {tuple(grad.shape)} for {x.dtype} {tuple(x.shape)}")
    rows_of(grad)
    _check_params(x, weight, bias, mean, invstd)
    rows, C, code, blocks, cluster = _launch_args(x)
    dev = x.device
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    grad_w = torch.empty(C, dtype=torch.float32, device=dev)
    grad_b = torch.empty(C, dtype=torch.float32, device=dev)
    coef = torch.empty(3 * C, dtype=torch.float32, device=dev)
    partial = None if cluster else torch.empty(2 * blocks * C, dtype=torch.float32,
                                               device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = BN_RELU.bn_relu_backward_launch(
            grad.data_ptr(), x.data_ptr(), dx.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), invstd.data_ptr(), grad_w.data_ptr(), grad_b.data_ptr(),
            coef.data_ptr(), rows, C, code, blocks, int(cluster), _ptr(partial),
            cuda_build.ticket_slot(dev.index, stream), stream)
    cuda_build.count_launch(err, "bn_relu_backward", GRAD_LAUNCHES)
    return dx, grad_w, grad_b


class _BnRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, batches, momentum, eps):
        out, mean, invstd = forward_cuda(x, weight, bias, running_mean, running_var, batches,
                                         momentum, eps)
        ctx.save_for_backward(x, weight, bias, mean, invstd)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias, mean, invstd = ctx.saved_tensors
        dx, grad_w, grad_b = backward_cuda(grad.contiguous(memory_format=torch.channels_last),
                                           x, weight, bias, mean, invstd)
        return dx, grad_w, grad_b, None, None, None, None, None


def bn_relu_train(x, weight, bias, running_mean, running_var, batches, momentum, eps):
    """``relu(batch_norm(x))`` in train mode on CUDA, under autograd; the
    running statistics and ``batches`` (or None, all three) updated."""
    return _BnRelu.apply(x, weight, bias, running_mean, running_var, batches, momentum, eps)


def bn_relu_eval(x, weight, bias, running_mean, running_var, eps):
    """``relu(batch_norm(x))`` in eval mode on CUDA.  It has no backward:
    raises where autograd would need one."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError("bn_relu's eval forward has no backward: run it under no_grad, "
                           "or the norm in train mode")
    return eval_cuda(x, weight, bias, running_mean, running_var, eps)


def kernel_route(x, group):
    """Whether a norm of cross-replica ``group`` runs the kernels on input
    ``x``: on CUDA, unless in float64 or across replicas."""
    return x.device.type == "cuda" and x.dtype != torch.float64 and group is None


class BatchNormReLU(BatchNorm2d):
    """:class:`posetpu_torch.models.batchnorm.BatchNorm2d` followed by a
    ReLU: on CUDA in bf16 or float32, one hand-written op in either mode
    (it raises on input the kernels do not take); on the CPU, in float64 or
    with a cross-replica ``group``, ``F.relu(BatchNorm2d.forward(x))``.
    Parameters, buffers and state-dict names are torch's."""

    def forward(self, x):
        if not kernel_route(x, self.group):
            return F.relu(super().forward(x))
        if self.momentum is None or not self.track_running_stats:
            raise ValueError("bn_relu takes a norm with running statistics and a momentum")
        if not self.training:
            return bn_relu_eval(x, self.weight, self.bias, self.running_mean, self.running_var,
                                self.eps)
        if is_recomputing():
            return bn_relu_train(x, self.weight, self.bias, None, None, None, self.momentum,
                                 self.eps)
        self.batch_count = x.numel() // x.shape[1]
        return bn_relu_train(x, self.weight, self.bias, self.running_mean, self.running_var,
                             self.num_batches_tracked, self.momentum, self.eps)
