#!/usr/bin/env python3
"""Drive the posetpu_torch port once on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device     the card's name and its nvidia-smi name/power-limit line
  build      every native source of the port compiled at once: the
             rasterizer, the conv-bias, idct_islow and ycc_canvas kernels
             (nvcc) and the decode route's entropy decoder (g++)
  kernels    each kernel against its plain PyTorch version on the card
             (exactly, for the rasterizer, on random and edge points), and
             both timed with CUDA events beside the card's write floor at
             the main path's shape and at one beyond the L2
  conv_bias  the hourglass's conv-bias kernels at every conv-output shape
             of hg8_mpii at batch 32, channels-last: the add bit for bit
             against torch's add_, the gradient within the kernel's error
             bound (its summation depth) of a float64 sum and within one
             bf16 ulp of torch's sum, and the bound failing a zero gradient
             and one with a block's partial row lost; each timed beside
             torch's call and its bytes bound.  Their launches are checked
             on every main path below: 378 adds a forward (a serving or
             validation batch, a train step; two forwards a joint step) and
             378 gradients a backward, counted once a replay
  bn_relu    the hourglass's fused BatchNorm-ReLU kernels at every norm
             shape of hg8_mpii at batch 32, channels-last: the train
             forward's statistics within float32 summation error of float64
             and its output bit for bit torch's transform and ReLU given
             them, the eval forward bit for bit torch's eval pair (its
             differing elements counted), the backward as close to float64
             as torch's own pair (the bf16 ratio rule); each timed beside
             its plain version, torch's pair and its bytes bound.  Their
             launches are checked on every main path below with the conv
             bias's: 354 forwards a forward pass (a joint step's reward
             forward in eval mode among them) and 354 backwards a backward
  bench      every mode of python -m posetpu_torch.bench at full width with
             fewer steps and trials (the default K steps a graph,
             --scan-stacks, --serve and --serve --pipeline 2, --joint,
             --joint --fused at hg8_mpii_asr and hg8_lsp_aho, --loader host
             at K = 1 and 4, --loader grain with 4 workers), each in a
             process of its own: one JSON line and the last, every key, a
             positive rate, 0 <= idle < 1, the device phase's nvidia-smi
             line; the rasterizer launched in every mode's timed window but
             serving's, and on the host loader one idct_islow and one
             ycc_canvas launch in the window for every batch it took, give
             or take the loader's prefetch
  jpeg_gpu   the card's decode route on 32 of the loader phase's 1280x720
             frames (quality 92, 4:2:0) and small odd-sized files at 4:4:4,
             4:2:2, 4:4:0, 4:2:0 and gray, one with restart markers and one
             progressive file (the one refused): the route's planes,
             upsampled by the plain version, equal to Pillow's YCbCr decode
             (gap 0); the decoder at its default worker threads (N) against
             one thread, planes and canvases (host and device) bit for bit,
             and the planes and canvases unchanged with the decoder's
             stream held by a sleep kernel, at 1 and at N threads; the
             idct_islow kernel against its plain version on the route's
             coefficients and on random blocks with the 8-bit data's
             extremes, exactly, one launch a batch; the ycc_canvas kernel
             against its plain version on the route's own planes, exactly,
             one launch a batch, at the loader's canvas and at crops with
             centers near every edge, then on the planes copied into
             misaligned rows of odd pitch, at odd window offsets and with
             (0, 0) slots (also into a canvas of odd width); the whole
             route against Pillow's load_sample (images and windows
             exactly, the progressive file ok False and counted, and its
             row Pillow's through the loader onto the card); both kernels
             alone and through their wrappers timed beside their bounds,
             the plain versions and the write floor, the decode of a batch
             into a canvas on the card and into pinned memory (read, host,
             copy-in, IDCT, wrapper, canvas and copy-back ms, img/s), and
             the route's img/s into the card's canvas at 1, 2, 4, 8 and N
             threads beside the host's CPU count and affinity
  serve      PosePredictor at the full hg8_mpii width (seeded random
             weights, bf16): predict_iter(depth=2) over 4 batches of 32
             through the CUDA graph of their shape, bit for bit equal to the
             eager body on the same batches; graphed and eager img/s and
             idle shares, captures, the pool; predict_single (a graph per
             shape) and weights loaded in place (read by the graphs)
  validate   make_graphed_eval_step (Experiment's validation step, one CUDA
             graph per batch signature) at the same width over 4 batches of
             32, its targets from the CUDA rasterizer, bit for bit equal to
             make_eval_step's eager step; every batch keeps its own
             predictions; the kernel launch counts are reset just before the
             graphed batches (the main path) and read just after
  profile    one validation step under torch.profiler, graphed and eager:
             device time by kernel and the idle share of the step
  parity     a small f32 network (TF32 off): the card's validation step
             against the port's CPU path on the same inputs and weights
             (loss, scores, targets, PCK counts and decoded predictions)
  train      make_train_step at the full hg8_mpii width (seeded weights,
             bf16, color jitter): one warm-up step, then 4 timed steps of
             batch 32; the launch counts are reset just before and read
             just after; loss, PCK, peak memory
  train_profile  one full-width train step under torch.profiler
  train_parity   hg2_mpii_mini at feats 8, f32, TF32 off: three train
             steps, each taken on the card and on the CPU from the CPU's
             state (draws, loss, gradients, update, BatchNorm statistics)
  joint      make_joint_step with the adversarial agent at full width,
             bf16, batch 32, color jitter: hg8_mpii_asr (one warm-up, 4
             timed steps), then hg8_lsp_aho (tree occlusion over 22 nodes,
             14 joints; one warm-up, 2 timed steps); img/s, peak memory,
             the five metrics, the rasterizer's launches, the agent moved
  joint_profile  one full-width hg8_mpii_asr joint step under torch.profiler
  joint_parity   hg2 at feats 8, agent widths (8, 16), f32, TF32 off: no
             occlusion, tree, parts, flat, and tree with update_every=2
             and pose_ref_weight=0.25, two joint steps each, each taken on
             the card and on the CPU from the CPU's state (draws equal,
             metrics, both updates and statistics within derived bounds,
             the agent unchanged on its non-update step)
  host       what the machine decodes with: Pillow, libjpeg (header and
             library), CPU count, matplotlib; the decode routes this run
             takes ("gpu" must start)
  loader     a synthetic MPII split at MPII's image size (64 JPEGs of
             1280x720): one epoch of HostLoader at batch 32 per decode route,
             host-only (decode ms a batch), then through
             make_batch_placer("cuda") (img/s, copy ms a batch on the copy
             stream, bytes a batch; the gpu route keeps its canvas on the
             card); the placed batches equal the host ones exactly, and the
             routes agree with Pillow (images within 2.5 LSB, the gpu
             route's exactly; metadata exactly)
  fit_jpeg_gpu  the train CLI at full hg8_mpii width, bf16, batch 32, one epoch
             over the loader phase's 64 frames at 1280x720 (its 16
             validation frames validate) in the (768, 1280) canvas, decoded
             by the card's route: img/s beside the loader's Pillow and
             WorkerLoader rates; every train batch decoded into a canvas on
             the card (none copied back to the host, no image stacked
             there); idct_islow and ycc_canvas launch once a decoded batch
  fit        posetpu_torch.train.cli.main at full hg8_mpii width, bf16,
             batch 32 on the synthetic split (2 train steps, each a CUDA
             graph of one step, and 1 padded validation batch an epoch): 2
             epochs, then --resume auto to 3, then posetpu_torch.eval.cli.main;
             log rows, checkpoint layout, the resumed update count and step,
             preds.mat, and the rasterizer's launches (train steps +
             validation batches + each run's warm-up steps before its
             capture); every Experiment of a host-loader run decodes through
             the gpu route (train and validation loaders), a worker-loader run
             (fit_dispatch, fit_joint_dispatch) with Pillow in its workers
  fit_joint  one epoch each of hg8_mpii_asr and hg8_lsp_aho (a synthetic LSP
             split, 14 joints) through the same CLI, each joint step a CUDA
             graph of one step; launches 2 per joint step and per warm-up
             step + validation batches
  dispatch   make_dispatch_step at full hg8_mpii width, bf16, batch 32, K = 4
             train steps a CUDA graph: two eager runs of 4 steps and one
             graphed dispatch from one state (the graph within twice the
             eager runs' gap of each other), the capture's seconds and the
             first dispatch's launches (warm-up steps + K) on a line of its
             own, then 3 timed dispatches (img/s, peak memory, the
             rasterizer's launches = steps replayed) and one under
             torch.profiler (device busy ms a step, idle share)
  dispatch_parity  hg2_mpii_mini at feats 8, f32, TF32 off, deterministic
             algorithms: graphed dispatches of K = 2 (one after a state load,
             which captures again) and a short eager group equal 7 eager
             steps exactly (parameters, moments, statistics, metrics);
             launches 7 eager, 7 + 2 captures x 2 warm-up steps graphed
  fit_dispatch  the train CLI at full hg8_mpii width with --steps-per-dispatch
             2 --loader-backend grain --loader-workers 4 --tensorboard
             --profile: log rows, launches (the traced epoch's steps counted
             once more, and the capture's warm-up steps), the trace file,
             the event file

  joint_dispatch_parity  make_joint_dispatch_step at hg2 feats 8, f32, TF32
             off, deterministic algorithms: three graphed dispatches of K = 2
             equal 6 make_joint_step calls bit for bit (both networks,
             moments, statistics, every step and count, metrics) for scale
             and rotation, tree occlusion on 14 joints, body parts,
             update_every=3 (three update patterns, three graphs; the one
             without an update leaves the agent as it was) and
             pose_ref_weight=0.3; a state load captures again
  joint_dispatch  make_joint_dispatch_step with hg8_mpii_asr at full width,
             bf16, batch 32, K = 4: two eager runs and the graph from one
             state (the graph within twice the eager runs' gap), the
             capture's seconds and memory, 3 timed dispatches (graphed and
             eager img/s, launches 2 a replayed step), one under
             torch.profiler (busy ms a step, idle share); then hg8_lsp_aho
             at K = 1
  fit_joint_dispatch  the train CLI with hg8_mpii_asr, batch 16,
             --steps-per-dispatch 2 capped at 3 steps an epoch (a graphed
             dispatch and a trimmed one), the worker loader, TensorBoard and
             --profile, 2 epochs, then --resume auto to 3: log rows,
             checkpoints (the agent's step and count), launches, trace and
             event files

  dp_nccl1   NCCL at world size 1 in this process: make_dispatch_step with
             the group, K = 2, hg2 feats 8, f32, TF32 off, deterministic:
             every all-reduce of the captured steps issued while the stream
             captures, and the result equal to the group-less graph's bit
             for bit (parameters, statistics, moments, metrics); the same
             for the joint graph (4 all-reduces a captured step)
  dp_gloo2   two gloo ranks sharing the card (CUDA tensors), each with half
             of a global batch of 8: the train, joint and eval steps
             against one process on the same batch and weights, in f32 at
             hg2 feats 8 (TF32 off; the averaged pose gradients against
             the float64 gradients of the same loss) and in bf16 at full
             hg8 width (by the ratio to the one process's bf16-vs-f32 gap);
             the ranks end equal
  dp_config  hg8_mpii_384_dp8 at full width (8 stacks, 128 features, 384²
             crops, 96² heatmaps, the agent, bf16, global batch 48) through
             Experiment with num_devices 1 and --steps-per-dispatch 2 on the
             synthetic split: epochs of joint steps and a validation pass
             (launches 2 a step and 1 a validation batch), then graphed
             dispatches of 2 steps on one placed batch (img/s, CUDA-event
             ms, device busy ms, idle share, peak memory, capture seconds)
  variants   hg8_mpii at full width, bf16, batch 32, with 1 and then 2
             residual blocks a site (--blocks 2): eager make_train_step steps,
             then make_dispatch_step at K = 1 (Experiment's graph): img/s,
             loss, device busy ms a step, peak memory, launches; the state
             saved as a run directory and served through
             PosePredictor.from_config(cfg, run_dir) (predictions equal those
             of the trained network)
  remat      one state, one train step with remat off (twice) and on, and on
             through the K = 1 graph: hg8_mpii at batch 32 and
             hg8_mpii_384_dp8's one-card shapes (384² crops, batch 48) in
             bf16 (loss, statistics and state within twice the remat-off
             runs' own gap, num_batches_tracked equal; peak memory and busy ms
             each), then hg8_mpii in float32 with TF32 off (equal bit for bit)
  ckpt_interop  the train CLI at hg8_mpii width with --blocks 2 --scan-stacks
             (one epoch), PosePredictor.from_config(cfg, run_dir) against the
             checkpoint's state dict, the JAX package's torch container written
             from the run's state and read back bit for bit (parameters,
             buffers, moments, count, step), and from_config on fit_joint's
             hg8_mpii_asr run directory (its pose network)
  profiling  posetpu_torch.tools.duty_cycle at full hg8_mpii width, batch 16,
             on a synthetic 512x384 split: measure_duty_cycle (K = 1) and
             measure_duty_cycle_fused (K = 4), the device timed by
             time_device_step (a CUDA graph of 10 steps); then
             posetpu_torch.tools.profile_step over the train graph and the
             joint graph (3 steps each); launches of every step run
  adv_gain   posetpu_torch.tools.adversarial_gain at its full width (2 stacks,
             128 features, 256², batch 16) on 32 train and 16 hard
             validation images, 2 + 2 epochs, arm B with parts occlusion:
             result.json, the runs' logs and checkpoints, both arms started
             from phase 1's checkpoint, the rasterizer's launches
  visualize  posetpu_torch.tools.visualize on adv_gain's arm A run: 4 PNGs

The loader phase also times WorkerLoader at 0, 4 and 7 worker processes
over the same JPEGs (its batches equal HostLoader's Pillow batches
exactly), and its steady rate over an epoch of 320 (the 64 cycled), after
the first batch; the host phase reports TensorBoard and /dev/shm.

Then ``processes``: the worker loaders' server and resource tracker are
stopped (the script waits for both), and anything else the run started
that still runs is ended and fails the run.  Then the kernel summary line
(the rasterizer's launches from validate, the conv-bias kernels' from the
graphed train dispatch, idct_islow's and ycc_canvas's from fit_jpeg_gpu,
and each by path, the bench's modes as bench_<mode>),
the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure
raises (non-zero exit, no final line); without CUDA it exits non-zero at
once.  Nothing falls back to the CPU or to a plain version.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from collections import deque

import numpy as np
import torch

import posetpu_torch.train.adversarial as adversarial
from posetpu_torch.aug import (
    augment_batch,
    neutral_params,
    sample_aug_params_ps,
)
from posetpu_torch.aug.cuda_kernels import RASTERIZE_LAUNCHES as RASTER
from posetpu_torch.aug.heatmap import rasterize_gaussians, rasterize_gaussians_plain
from posetpu_torch.ckpt.manager import CheckpointManager
from posetpu_torch.configs import named_config
from posetpu_torch.data import (
    HostLoader,
    MpiiDataset,
    WorkerLoader,
    make_batch_placer,
    make_synthetic_dataset,
)
from posetpu_torch.data.loader import load_sample
from posetpu_torch.data.worker_loader import (
    START_METHOD as WORKER_START_METHOD,
    stop_worker_server,
)
from posetpu_torch.eval import cli as eval_cli
from posetpu_torch.eval.export import load_preds
from posetpu_torch.infer import MPII_MEAN, PosePredictor
from posetpu_torch.libraries import LIBRARIES
from posetpu_torch.native import GpuJpegDecoder, bindings, islow, jpeg_gpu, ycc
from posetpu_torch.models import bn_relu, conv_bias, hg
from posetpu_torch.models.batchnorm import BatchNorm2d, convert_cross_replica_
from posetpu_torch.parallel import (
    RankPool,
    free_port,
    gather_rows,
    init_process_group,
    ranks_equal,
    shard_slice,
)
from posetpu_torch.parallel.launch import to_numpy
from posetpu_torch.train.adversarial import (
    JointState,
    agent_from_config,
    make_joint_dispatch_step,
    make_joint_step,
)
from posetpu_torch.train.state import TrainState, make_optimizer
from posetpu_torch.train import cli as train_cli
from posetpu_torch.train.step import (
    WARMUP_STEPS,
    make_dispatch_step,
    make_eval_step,
    make_graphed_eval_step,
    make_train_step,
    stacked_mse,
)
from posetpu_torch.tools.profile_step import profile_run
from posetpu_torch.utils import cuda_build
from posetpu_torch.utils.graphs import WARMUP_CALLS
from posetpu_torch.utils.profiling import REGISTRY, counter, reset_counters

SEED = 0
BATCH = 32
NUM_BATCHES = 4
CANVAS = (384, 384)  # padded host canvas (H, W); true sizes vary per sample

# NVIDIA H100 SXM published peaks (data sheet, dense): HBM3 bandwidth and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# float operations per pixel inside a kept joint's window: 2 sub, 2 mul,
# add, neg, div, exp, 2 abs, 2 compare, 2 mask multiplies, 1 keep multiply;
# every other pixel is a stored zero
RASTER_OPS_PER_ELEMENT = 15
# the rasterizer's timed shapes (B, K, H, W): the main path's, one whose
# 134 MB of output is beyond the 50 MB L2, and the joint step's pair of
# crops (adversarial + reference) for MPII's 16 joints and LSP's 14
RASTER_SHAPES = ((BATCH, 16, 64, 64), (512, 16, 64, 64), (2 * BATCH, 16, 64, 64),
                 (2 * BATCH, 14, 64, 64), (48, 16, 96, 96), (96, 16, 96, 96))
# hg8_mpii_384_dp8's shapes on one card: its eval batch of 48 at 96x96
# heatmaps and its joint step's pair of crops (48 adversarial + 48 reference)
DP8_RASTER = ((48, 16, (96, 96)), (96, 16, (96, 96)))
# CPU exp against the card's expf, for the targets of the parity phase; the
# kernel itself is held to its plain version on the card exactly
RASTER_TOL = 1e-6
PARITY_ATOL, PARITY_RTOL = 2e-4, 1e-3

# train_parity: each step starts on both devices from the same state (the
# CPU's), so each comparison is of one step.  Derivations (they follow
# tests/test_torch_train_step.py, with cuDNN's rounding in place of flax's):
# - the loss of a step from one state: PARITY_ATOL + PARITY_RTOL * loss, the
#   tolerance of the f32 forward above;
# - gradients: the two f32 forwards round differently by about 1e-5
#   relative; a value before a ReLU that close to 0 lands on opposite sides
#   of the kink, and its whole gradient moves to or from every layer below
#   (5.1e-4 read between the CPU port and the JAX package);
TRAIN_GRAD_ATOL = 4e-3
# - an update: RMSprop moves p by u = -lr*g/sqrt(d*nu + (1-d)*g^2 + eps),
#   whose derivative in g is at most lr/sqrt(d*nu + eps) (lr/sqrt(eps) =
#   2.5 from zero moments), and |u| <= lr/sqrt(1-d) = 10*lr on each side, so
#   |dp| <= min(lr*TRAIN_GRAD_ATOL/sqrt(d*nu + eps), 2*10*lr) + 2 ulps of |p|;
# - the card's update against the port's CPU optimizer applied to the
#   card's own gradients from the same moments: the same float32 operations
#   but rsqrt (CUDA's rsqrtf is within 2 ulps of the true value, the CPU's
#   1/sqrt within 1.5: at most 4 apart), the two products after it (one ulp
#   each), and the sum into p, which rounds each side by half an ulp of its
#   result: |dp| <= 6 ulps of |u| + 2 ulps of |p| (half of which is taken
#   where two updates round p + u to neighbouring floats);
# - BatchNorm statistics after a step from one state: 0.1 times the gap of
#   the batch statistics, themselves f32 forward values (as PARITY_ATOL):
TRAIN_STATS_ATOL, TRAIN_STATS_RTOL = 5e-4, 1e-3
TRAIN_PARITY_STEPS = 3
MPII_TRAIN_SAMPLES = 22246  # the hourglass MPII train split: steps per epoch
OPT_CFG = named_config("hg2_mpii_mini").optim  # the parity phase's optimizer

# joint: timed steps of hg8_mpii_asr and of hg8_lsp_aho, after one warm-up
JOINT_STEPS = {"hg8_mpii_asr": NUM_BATCHES, "hg8_lsp_aho": 2}
# rasterizer launches of one joint step: the neutral crop's targets
# (computed with the crop, read by nothing) and the 2B targets of the
# adversarial and reference crops, rasterized in one launch
JOINT_RASTER_LAUNCHES = 2
# rasterizer launches added by the capture of a validation graph: its
# warm-up calls run the step (each Experiment captures at its first batch)
EVAL_WARMUP = WARMUP_CALLS
# joint_parity: (name, agent config fields, make_joint_step options) at
# occlusion levels (1, 2) over 64² crops: 6 grid nodes, 9 body-part nodes
JOINT_PARITY_CASES = (
    ("none", {}, {}),
    ("tree", dict(occ_nodes=6, occ_mode="tree"), {}),
    ("parts", dict(occ_nodes=9, occ_mode="parts"), {}),
    ("flat", dict(occ_nodes=6, occ_mode="flat"), {}),
    ("tree_every2_mixed", dict(occ_nodes=6, occ_mode="tree"),
     dict(update_every=2, pose_ref_weight=0.25)),
)
JOINT_PARITY_STEPS = 2
# joint_parity's gradients: the adversarial crops reach off the canvas
# (scale bins to 2^0.4, rotations to 30 degrees) and under occluders, and
# across such a constant region a ReLU kink or a BatchNorm rounding flips
# for the whole region at once, where TRAIN_GRAD_ATOL's derivation counts
# single values.  The card (H100 80GB HBM3, 700 W) and the CPU read 4.8e-3
# apart on gradients up to 0.15 without occlusion; the JAX package's own
# float32 gradient lies 3.9e-3 from its float64 one in such a batch
# (tests/torch_joint_harness.py).  Twice the larger reading:
JOINT_GRAD_ATOL = 1e-2

REPO = os.path.dirname(os.path.abspath(__file__))

def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps=20, samples=25):
    """Median device time of one ``fn()`` call, from CUDA events around
    ``reps`` back-to-back calls.  A sleep kernel ahead of each sample
    keeps the card busy while the host enqueues the calls, so the events
    time the device and not the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms at 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it runs on an NVIDIA GPU only",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return smi


def phase_build():
    """Every native library of the port (``LIBRARIES``) at once, one
    compiler process each, all started together.  The host pool is left to
    the host phase's route probe, which builds it where libjpeg is: a
    machine without libjpeg lacks that route and no other."""
    t0 = time.perf_counter()
    paths = cuda_build.build([lib for lib in LIBRARIES if lib is not bindings.POOL])
    seconds = time.perf_counter() - t0
    ptxas = []
    for lib in paths.values():
        with open(lib + ".log") as f:
            ptxas += [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    emit("build", seconds=seconds,
         libraries=[os.path.relpath(p, REPO) for p in paths.values()],
         ptxas=ptxas)


def _raster_inputs(B, K, seed, side=64):
    rng = np.random.RandomState(seed)
    pts = rng.randint(-10, side + 10, (B, K, 2)).astype(np.float32)
    vis = rng.randint(0, 2, (B, K)).astype(np.float32)
    return torch.from_numpy(pts).cuda(), torch.from_numpy(vis).cuda()


def _edge_inputs(res, frac):
    """(1, n, 2) points on, one pixel beyond, a few pixels beyond and far
    beyond each edge of an H x W map, then two rows of the TPU kernel's
    -1e6 padding (vis 0, as it padded them, and vis 1); (1, n) vis."""
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
    return (torch.from_numpy(pts[None]).cuda(), torch.from_numpy(vis[None]).cuda())


def _raster_bound(B, K, H, W, in_window):
    """Least time for the rasterizer's work: each input read once, each
    output written once, against the float operations of the pixels inside
    a kept joint's window (the only ones it computes)."""
    rows, elems = B * K, B * K * H * W
    nbytes = rows * (2 * 4 + 4) + elems * 4 + rows * 4
    ops = in_window * RASTER_OPS_PER_ELEMENT
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return nbytes, ops, max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                                 else "operations")


def phase_kernels():
    """The rasterizer against its plain version, exactly, on random points
    at the main paths' shapes (and hg8_mpii_384_dp8's 96x96 maps at 48
    and 96 rows) and on edge points at four map sizes (odd, 16-byte rows,
    the main path's 64x64 and 96x96), for sigma 1, 1.5 and 2.  Then the kernel,
    the plain version and the card's write floor (``zero_`` of an output of
    the same size) timed at each of RASTER_SHAPES."""
    cases, max_err = [], 0.0

    def compare(what, pts, vis, res, sigma):
        nonlocal max_err
        before = counter(RASTER)
        t_k, v_k = rasterize_gaussians(pts, vis, res, sigma)
        t_p, v_p = rasterize_gaussians_plain(pts, vis, res, sigma)
        torch.cuda.synchronize()
        check(counter(RASTER) == before + 1,
              "the rasterizer wrapper did not launch its kernel")
        err = (t_k - t_p).abs().max().item()
        label = f"rasterizer {what} {tuple(pts.shape[:2])} {res} sigma={sigma}"
        check(torch.equal(t_k, t_p), f"{label}: max abs err {err}")
        check(torch.equal(v_k, v_p), f"{label}: vis_out")
        check(t_k.max().item() > 0.5, f"{label}: no visible peak was drawn")
        max_err = max(max_err, err)
        cases.append({"points": what, "B": pts.shape[0], "K": pts.shape[1],
                      "res": list(res), "sigma": sigma, "max_abs_err": err})

    for sigma in (1.0, 1.5, 2.0):
        # 3*5 rows: not a block multiple; 2*BATCH: the joint step's pairs
        for B, K in ((BATCH, 16), (3, 5), (2 * BATCH, 16), (2 * BATCH, 14)):
            compare("random", *_raster_inputs(B, K, SEED + B), (64, 64), sigma)
        for B, K, res in DP8_RASTER:
            compare("random", *_raster_inputs(B, K, SEED + B, res[0]), res, sigma)
        for res in ((17, 13), (64, 48), (64, 64), (96, 96)):
            for frac in (False, True):
                compare("edges+0.5" if frac else "edges",
                        *_edge_inputs(res, frac), res, sigma)

    shapes = []
    for B, K, H, W in RASTER_SHAPES:
        res = (H, W)
        pts, vis = _raster_inputs(B, K, SEED, H)
        in_window = int((rasterize_gaussians_plain(pts, vis, res, 1.0)[0] != 0).sum())
        ms = cuda_ms(lambda: rasterize_gaussians(pts, vis, res, 1.0))
        plain_ms = cuda_ms(lambda: rasterize_gaussians_plain(pts, vis, res, 1.0))
        buf = torch.empty((B, K, H, W), dtype=torch.float32, device="cuda")
        floor_ms = cuda_ms(buf.zero_)
        del buf
        nbytes, ops, bound_ms, bound_by = _raster_bound(B, K, H, W, in_window)
        shapes.append({"shape": [B, K, H, W], "sigma": 1.0, "ms": ms,
                       "plain_ms": plain_ms, "write_floor_ms": floor_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "bytes": nbytes, "operations": ops})
    main = shapes[0]
    summary = {
        "name": "rasterize_gaussians",
        "route": "cuda",
        "source": "posetpu_torch/aug/kernels/rasterize.cu",
        "replaces": "posetpu/aug/pallas_kernels.py:65",
        "launches": None,  # filled from the validate phase
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        # no single PyTorch call computes this function; the write floor
        # is a yardstick of the card, not of the function
        "library_ms": None,
        "write_floor_ms": main["write_floor_ms"],
        "shapes": shapes,
    }
    emit("kernels", cases=len(cases), max_abs_err=max_err,
         cases_detail=cases, shapes=shapes)
    return summary


def _hg8_conv_outputs():
    """{(C, H, W, dtype): convolutions an image} of hg8_mpii's forward at
    256² on the card, from hooks on its biased convolutions."""
    model = hg().cuda().eval()
    seen = {}

    def hook(mod, inp, out):
        key = (*out.shape[1:], out.dtype)
        seen[key] = seen.get(key, 0) + 1

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, conv_bias.Conv2d)]
    with torch.no_grad():
        model(torch.zeros(1, 256, 256, 3, device="cuda"))
    for h in hooks:
        h.remove()
    return seen


# biased convolutions of an hg8 network: one conv-bias add each a forward,
# one gradient each a backward
HG8_CONVS = 378


# norms of an hg8 network, each with its ReLU: one bn_relu forward each a
# forward pass, one backward each a backward
HG8_NORMS = 354
# the counters of the hourglass's hand ops, reset around each main path
HAND_OP_COUNTERS = (*conv_bias.COUNTERS, *bn_relu.COUNTERS)


def _hand_op_launches():
    return {"conv_bias": counter(conv_bias.ADD_LAUNCHES),
            "conv_bias_grad": counter(conv_bias.GRAD_LAUNCHES),
            "bn_relu": counter(bn_relu.LAUNCHES),
            "bn_relu_grad": counter(bn_relu.GRAD_LAUNCHES)}


def _check_hand_ops(label, launches, forwards, backwards):
    """``launches`` holds HG8_CONVS conv-bias adds and HG8_NORMS bn_relu
    forwards a forward pass, and as many gradients a backward."""
    want = {"conv_bias": HG8_CONVS * forwards, "conv_bias_grad": HG8_CONVS * backwards,
            "bn_relu": HG8_NORMS * forwards, "bn_relu_grad": HG8_NORMS * backwards}
    got = {k: launches[k] for k in want}
    check(got == want, f"{label}: hand-op launches {got}, want {want} "
                       f"({forwards} forwards, {backwards} backwards)")


def _lost_partial(g, sms):
    """What the gradient kernel would give for channels-last ``g`` with
    block 0's partial row lost: the exact column sums less the rows block 0
    sums (row r where r mod (blocks * R) < R), rounded to ``g``'s type."""
    N, C, H, W = g.shape
    rows = N * H * W
    vec = 16 // g.element_size()
    blocks, tile, _ = conv_bias.grad_grid(rows, C, vec if C % vec == 0 else 1, sms)
    R = conv_bias.SUM_THREADS // tile
    m = g.permute(0, 2, 3, 1).reshape(rows, C).double()
    lost = torch.arange(rows, device=g.device) % (blocks * R) < R
    return (m.sum(0) - m[lost].sum(0)).to(g.dtype)


def phase_conv_bias():
    """The conv-bias kernels at hg8_mpii's conv outputs, batch 32,
    channels-last as the main path runs them: the add against its plain
    version (torch's ``add_``) exactly; the gradient within the kernel's
    error bound of a float64 sum (``conv_bias.gradient_misses``: its own
    summation depth, not the rows') and within one bf16 ulp of torch's
    ``sum((0, 2, 3))`` beside the two float sums' error; the same bound
    fails a zero gradient and one with a block's partial row lost.  Each is
    timed beside its plain version and its bytes bound, and the shapes'
    times summed over the convolutions of one train step.  Returns the two
    kernels' summaries; their launches come from the main paths' phases."""
    sms = cuda_build.sm_count("cuda")
    shapes, totals = [], dict.fromkeys(
        ("add_ms", "add_plain_ms", "add_bound_ms", "grad_ms", "grad_plain_ms",
         "grad_bound_ms"), 0.0)
    for (C, H, W, dtype), n in sorted(_hg8_conv_outputs().items(), key=str):
        gen = torch.Generator(device="cuda").manual_seed(SEED + C + H)
        x, g = (torch.randn(BATCH, C, H, W, device="cuda", generator=gen).to(dtype)
                .contiguous(memory_format=torch.channels_last) for _ in range(2))
        b = torch.randn(C, device="cuda", generator=gen).to(dtype)
        label = f"conv_bias ({BATCH}, {C}, {H}, {W}) {dtype}"
        before = counter(conv_bias.ADD_LAUNCHES)
        got = conv_bias.bias_add_cuda_(x.clone(), b)
        check(counter(conv_bias.ADD_LAUNCHES) == before + 1, f"{label}: no add launch")
        check(torch.equal(got, conv_bias.bias_add_plain_(x.clone(), b)), f"{label}: add")
        kernel = conv_bias.bias_grad_cuda(g)
        plain = conv_bias.bias_grad_plain(g)
        check(not conv_bias.gradient_misses(kernel, g, sms).any(),
              f"{label}: gradient beyond the kernel's float32 error bound")
        if dtype == torch.bfloat16:
            check(not conv_bias.gradient_misses(kernel, g, sms, torch_sum=plain).any(),
                  f"{label}: gradient beyond one bf16 ulp of torch's")
        zeros = torch.zeros_like(kernel)
        check(bool(conv_bias.gradient_misses(zeros, g, sms).any())
              and bool(conv_bias.gradient_misses(_lost_partial(g, sms), g, sms).any()),
              f"{label}: the gradient bound lets a planted fault through")
        exact = g.double().sum((0, 2, 3))
        nbytes = x.numel() * x.element_size()
        row = {"shape": [BATCH, C, H, W], "dtype": str(dtype).split(".")[1],
               "convs_an_image": n,
               "sum_depth": conv_bias.sum_depth(BATCH * H * W, C, 16 // x.element_size(),
                                                sms),
               "grad_max_rel_err": float(((kernel.double() - exact).abs()
                                          / exact.abs().clamp_min(1e-3)).max()),
               "add_ms": cuda_ms(lambda: conv_bias.bias_add_cuda_(x, b)),
               "add_plain_ms": cuda_ms(lambda: conv_bias.bias_add_plain_(x, b)),
               "add_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
               "grad_ms": cuda_ms(lambda: conv_bias.bias_grad_cuda(g)),
               "grad_plain_ms": cuda_ms(lambda: conv_bias.bias_grad_plain(g)),
               "grad_bound_ms": (nbytes + C * x.element_size()) / HBM_BYTES_PER_S * 1e3}
        shapes.append(row)
        for k in totals:
            totals[k] += n * row[k]
    convs = sum(r["convs_an_image"] for r in shapes)
    check(convs == HG8_CONVS, f"hg8_mpii has {convs} biased convolutions, not {HG8_CONVS}")
    emit("conv_bias", convs=convs, step_ms=totals, shapes=shapes)
    common = {"route": "cuda", "source": "posetpu_torch/models/kernels/conv_bias.cu",
              "shapes": shapes}
    return [{"name": "conv_bias_add", "counter": "conv_bias",
             "replaces": "torch _convolution's output.add_(bias)",
             "ms": totals["add_ms"], "plain_ms": totals["add_plain_ms"],
             "bound_ms": totals["add_bound_ms"], "bound_by": "bytes",
             # the plain version is torch's own add: the library path it replaced
             "library_ms": totals["add_plain_ms"], **common},
            {"name": "conv_bias_grad", "counter": "conv_bias_grad",
             "replaces": "torch convolution_backward's grad_output.sum((0, 2, 3))",
             "ms": totals["grad_ms"], "plain_ms": totals["grad_plain_ms"],
             "bound_ms": totals["grad_bound_ms"], "bound_by": "bytes",
             "library_ms": totals["grad_plain_ms"], **common}]


def _hg8_norm_inputs():
    """{(C, H, W, dtype): norms an image} of hg8_mpii's forward at 256² on
    the card, from hooks on its norms."""
    model = hg().cuda().eval()
    seen = {}

    def hook(mod, inp, out):
        key = (*inp[0].shape[1:], inp[0].dtype)
        seen[key] = seen.get(key, 0) + 1

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, bn_relu.BatchNormReLU)]
    with torch.no_grad():
        model(torch.zeros(1, 256, 256, 3, device="cuda"))
    for h in hooks:
        h.remove()
    return seen


def _mean_abs_gap(a, b):
    return float((a.double() - b.double()).abs().mean())


def _float64_norm_grads(x, w, b, dz, momentum, eps):
    """Gradients of the train-mode norm alone in float64 for the gradient
    ``dz`` of its output (a ReLU's mask applied to it first)."""
    x6, w6, b6 = (t.detach().double().requires_grad_() for t in (x, w, b))
    y = torch.nn.functional.batch_norm(x6, None, None, w6, b6, True, momentum, eps)
    return torch.autograd.grad(y, (x6, w6, b6), dz.double())


def _grid_route_ms(x, dr, w, b, rm, rv, nbt, mean, invstd, momentum, eps):
    """The train forward and backward of a norm that runs as one cluster,
    timed as they would run on the blocks-and-ticket route: the two routes
    side by side where the wrapper picks the cluster."""
    cluster_grid = bn_relu.grid
    bn_relu.grid = lambda rows, C, size, sms: (bn_relu.row_blocks(rows, C, size, sms), False)
    try:
        return {"fwd_grid_ms": cuda_ms(lambda: bn_relu.forward_cuda(x, w, b, rm, rv, nbt,
                                                                   momentum, eps)),
                "grad_grid_ms": cuda_ms(lambda: bn_relu.backward_cuda(dr, x, w, b, mean,
                                                                      invstd))}
    finally:
        bn_relu.grid = cluster_grid


def phase_bn_relu():
    """The fused BatchNorm-ReLU kernels at hg8_mpii's norm inputs, batch 32,
    channels-last as the main path runs them (eps 1e-5, momentum 0.1):

    - the train forward's mean and invstd within 1e-5 (of the channel's
      spread, of invstd) of float64, and its output bit for bit
      ``F.relu(torch.batch_norm_elemt(...))`` given its statistics, torch's
      channels-last transform; the elements where torch's own pair differs
      counted (torch's statistics round otherwise);
    - the eval forward against ``F.relu(F.batch_norm(..., False))``: no
      element differs;
    - dx, dw and db as close to float64 as torch's own pair (the bf16 ratio
      rule: a mean error within 2x torch's, beside float32's rounding of
      the largest value).

    Each pass is timed beside its plain version, torch's pair (the
    library path it replaced), at the norms that run as one cluster the
    same passes on the blocks-and-ticket route (``fwd_grid_ms``,
    ``grad_grid_ms``), and two byte counts at 3.35 TB/s:
    ``bound_ms``, each input read once and each output written once (the
    train forward 2 B an element in bf16 and back, the backward 3x), and
    ``passes_ms``, what the kernels' passes move (the forward reads x
    twice, the backward x and dr twice).  Summed over a train step's
    norms (and a serving batch's eval forwards at batch 32).  Returns the
    three summaries; their launches come from the main paths' phases."""
    eps, momentum = 1e-5, 0.1
    shapes = []
    totals = dict.fromkeys(
        ("fwd_ms", "fwd_plain_ms", "fwd_library_ms", "fwd_bound_ms", "fwd_passes_ms",
         "eval_ms", "eval_plain_ms", "eval_library_ms", "eval_bound_ms",
         "grad_ms", "grad_plain_ms", "grad_library_ms", "grad_bound_ms", "grad_passes_ms"),
        0.0)
    for (C, H, W, dtype), n in sorted(_hg8_norm_inputs().items(), key=str):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3 * C + H)
        x, dr = (torch.randn(BATCH, C, H, W, device="cuda", generator=gen).mul(2).add(0.3)
                 .to(dtype).contiguous(memory_format=torch.channels_last) for _ in range(2))
        w = torch.randn(C, device="cuda", generator=gen) + 1
        b = torch.randn(C, device="cuda", generator=gen) * 0.5
        rm = torch.randn(C, device="cuda", generator=gen) * 0.1
        rv = torch.rand(C, device="cuda", generator=gen) + 0.5
        nbt = torch.zeros((), dtype=torch.int64, device="cuda")
        label = f"bn_relu ({BATCH}, {C}, {H}, {W}) {dtype}"
        before = counter(bn_relu.LAUNCHES)
        out, mean, invstd = bn_relu.forward_cuda(x, w, b, rm.clone(), rv.clone(), nbt,
                                                 momentum, eps)
        check(counter(bn_relu.LAUNCHES) == before + 1 and int(nbt) == 1,
              f"{label}: no forward launch or batch count")
        x64 = x.double()
        var64 = x64.var((0, 2, 3), unbiased=False)
        mean_err = float(((mean.double() - x64.mean((0, 2, 3))).abs() / var64.sqrt()).max())
        inv64 = (var64 + eps).rsqrt()
        inv_err = float(((invstd.double() - inv64).abs() / inv64).max())
        check(mean_err <= 1e-5 and inv_err <= 1e-5,
              f"{label}: statistics {mean_err}, {inv_err} from float64")
        check(torch.equal(out, torch.relu(torch.batch_norm_elemt(x, w, b, mean, invstd, eps))),
              f"{label}: forward is not torch's transform and ReLU on its statistics")
        t_out = bn_relu.bn_relu_plain(x, w, b, rm.clone(), rv.clone(), True, momentum, eps)
        ev = bn_relu.eval_cuda(x, w, b, rm, rv, eps)
        eval_differ = int((ev != bn_relu.bn_relu_plain(x, w, b, rm, rv, False, momentum,
                                                       eps)).sum())
        check(eval_differ == 0, f"{label}: {eval_differ} eval elements differ from torch's")
        got = bn_relu.backward_cuda(dr, x, w, b, mean, invstd)
        xt, wt, bt = (t.detach().clone().requires_grad_() for t in (x, w, b))
        yt = bn_relu.bn_relu_plain(xt, wt, bt, None, None, True, momentum, eps)
        library = torch.autograd.grad(yt, (xt, wt, bt), dr, retain_graph=True)
        grad_gaps = {}
        # each held to the float64 backward of the norm under its own ReLU
        # mask: an element whose z lies within rounding of 0 may fall either
        # way, and moves dw by |dr * (x - mean)|
        refs = [_float64_norm_grads(x, w, b, dr * (r > 0), momentum, eps)
                for r in (out, yt.detach())]
        for i, name in enumerate(("dx", "dw", "db")):
            r, rt = refs[0][i], refs[1][i]
            gap, torch_gap = _mean_abs_gap(got[i], r), _mean_abs_gap(library[i], rt)
            grad_gaps[name] = [gap, torch_gap]
            check(gap <= 2 * torch_gap + 2.0**-24 * float(r.abs().max()),
                  f"{label}: {name} {gap} from float64, torch's {torch_gap}")
        nbytes = x.numel() * x.element_size()
        mean_p, inv_p = mean.clone(), invstd.clone()
        row = {"shape": [BATCH, C, H, W], "dtype": str(dtype).split(".")[1],
               "norms_an_image": n,
               "cluster": bn_relu.grid(BATCH * H * W, C, x.element_size(),
                                       cuda_build.sm_count("cuda"))[1],
               "mean_err": mean_err, "invstd_err": inv_err,
               "torch_pair_differ": int((out != t_out).sum()), "eval_differ": eval_differ,
               "grad_gaps": grad_gaps,
               "fwd_ms": cuda_ms(lambda: bn_relu.forward_cuda(x, w, b, rm, rv, nbt, momentum,
                                                              eps)),
               "fwd_plain_ms": cuda_ms(lambda: bn_relu.forward_plain(x, w, b, rm, rv, nbt,
                                                                     momentum, eps)),
               "fwd_library_ms": cuda_ms(lambda: bn_relu.bn_relu_plain(x, w, b, rm, rv, True,
                                                                       momentum, eps)),
               "fwd_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
               "fwd_passes_ms": 3 * nbytes / HBM_BYTES_PER_S * 1e3,
               "eval_ms": cuda_ms(lambda: bn_relu.eval_cuda(x, w, b, rm, rv, eps)),
               "eval_plain_ms": cuda_ms(lambda: bn_relu.eval_plain(x, w, b, rm, rv, eps)),
               "eval_library_ms": cuda_ms(lambda: bn_relu.bn_relu_plain(x, w, b, rm, rv, False,
                                                                        momentum, eps)),
               "eval_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
               "grad_ms": cuda_ms(lambda: bn_relu.backward_cuda(dr, x, w, b, mean_p, inv_p)),
               "grad_plain_ms": cuda_ms(lambda: bn_relu.backward_plain(dr, x, w, b, mean_p,
                                                                       inv_p)),
               "grad_library_ms": cuda_ms(lambda: torch.autograd.grad(
                   yt, (xt, wt, bt), dr, retain_graph=True)),
               "grad_bound_ms": 3 * nbytes / HBM_BYTES_PER_S * 1e3,
               "grad_passes_ms": 5 * nbytes / HBM_BYTES_PER_S * 1e3}
        if row["cluster"]:
            row.update(_grid_route_ms(x, dr, w, b, rm, rv, nbt, mean_p, inv_p, momentum, eps))
        shapes.append(row)
        for k in totals:
            totals[k] += n * row[k]
    norms = sum(r["norms_an_image"] for r in shapes)
    check(norms == HG8_NORMS, f"hg8_mpii has {norms} norms, not {HG8_NORMS}")
    emit("bn_relu", norms=norms, step_ms=totals, shapes=shapes)
    common = {"route": "cuda", "source": "posetpu_torch/models/kernels/bn_relu.cu",
              "bound_by": "bytes", "shapes": shapes}
    return [{"name": "bn_relu", "counter": "bn_relu",
             "replaces": "torch's batch_norm_collect_statistics and batch_norm_transform_input "
                         "(channels-last) and the ReLU's clamp",
             "ms": totals["fwd_ms"], "plain_ms": totals["fwd_plain_ms"],
             "library_ms": totals["fwd_library_ms"], "bound_ms": totals["fwd_bound_ms"],
             "passes_ms": totals["fwd_passes_ms"], **common},
            {"name": "bn_relu_eval", "counter": "bn_relu",
             "replaces": "torch's eval batch_norm_transform_input (channels-last) and the "
                         "ReLU's clamp",
             "ms": totals["eval_ms"], "plain_ms": totals["eval_plain_ms"],
             "library_ms": totals["eval_library_ms"], "bound_ms": totals["eval_bound_ms"],
             **common},
            {"name": "bn_relu_grad", "counter": "bn_relu_grad",
             "replaces": "torch's batch_norm_backward_reduce and batch_norm_backward_elemt "
                         "(channels-last) and threshold_backward",
             "ms": totals["grad_ms"], "plain_ms": totals["grad_plain_ms"],
             "library_ms": totals["grad_library_ms"], "bound_ms": totals["grad_bound_ms"],
             "passes_ms": totals["grad_passes_ms"], **common}]


# bench: every mode of python -m posetpu_torch.bench at full width, with
# fewer steps and trials than its defaults, each in a process of its own
BENCH_MODES = (
    ("default", ["--steps", "4", "--trials", "1"]),
    ("scan_stacks", ["--scan-stacks", "--steps", "2", "--trials", "1"]),
    ("serve", ["--serve", "--steps", "5", "--warmup", "1"]),
    ("serve_pipeline", ["--serve", "--pipeline", "2", "--steps", "5", "--warmup", "1"]),
    ("joint", ["--joint", "--steps", "2", "--warmup", "1"]),
    ("joint_fused", ["--joint", "--fused", "--steps", "2", "--trials", "1"]),
    ("joint_fused_lsp", ["--joint", "--fused", "--config", "hg8_lsp_aho", "--steps", "2",
                         "--trials", "1"]),
    ("loader_host", ["--loader", "host", "--steps", "8", "--warmup", "1"]),
    ("loader_host_k4", ["--loader", "host", "--k-per-dispatch", "4", "--steps", "20",
                        "--warmup", "1"]),
    ("loader_grain", ["--loader", "grain", "--loader-workers", "4", "--steps", "4",
                      "--warmup", "1"]),
)
BENCH_TIMEOUT = 180  # seconds a mode's process may take
# the keys of the bench's line in every mode (the loader modes add theirs)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "trials", "device_ms", "idle",
              "device_clock", "peak_gb", "capture_s", "batch", "stacks", "feats", "res",
              "steps", "K", "config", "launches", "device", "gpu"}
BENCH_LOADER_KEYS = {"backend", "workers", "loader_batches", "prefetch", "loader_wait_ms",
                     "loader_wait_s", "threads", "read_ms", "info_ms", "host_ms",
                     "copy_in_ms", "idct_ms", "canvas_ms", "copy_ms", "refused"}


def _bench_line(stdout):
    """The bench's result: the last line of its standard output, the only
    one that is a JSON object."""
    lines = stdout.strip().splitlines()
    objects = []
    for ln in lines:
        with contextlib.suppress(ValueError):
            if isinstance(json.loads(ln), dict):
                objects.append(ln)
    check(len(objects) == 1 and lines and objects[0] == lines[-1],
          f"bench printed {len(objects)} JSON lines, the last line {lines[-1:]}")
    return json.loads(lines[-1])


def phase_bench(smi, workdir):
    """Every mode of ``python -m posetpu_torch.bench`` (BENCH_MODES) in a
    process of its own, its temp directory (the loader modes' synthetic
    split) in ``workdir``: exit code 0, one JSON line and the last, every
    key, a positive rate, 0 <= idle < 1, the card's nvidia-smi line, the
    rasterizer launched in the timed window of every mode but serving
    (none there), and on the host loader the window's idct_islow and
    ycc_canvas launches within the superbatches decoded ahead (``prefetch``
    + 1) of the batches it took, and no file refused.  Returns {mode: launches}."""
    torch.cuda.empty_cache()  # the modes' processes share the card with this one
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    env["TMPDIR"] = workdir
    out = {}
    for name, argv in BENCH_MODES:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "posetpu_torch.bench", *argv], cwd=REPO,
                             env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
        seconds = time.perf_counter() - t0
        check(run.returncode == 0,
              f"bench {name} exited {run.returncode}: {run.stderr[-3000:]}")
        line = _bench_line(run.stdout)
        emit("bench", mode=name, argv=argv, seconds=seconds, line=line,
             stderr=run.stderr.strip().splitlines()[-4:])
        loader = name.startswith("loader")
        missing = (BENCH_KEYS | (BENCH_LOADER_KEYS if loader else set())) - set(line)
        check(not missing, f"bench {name}: keys missing {sorted(missing)}")
        check(line["value"] > 0 and line["unit"] == "images/sec/chip",
              f"bench {name}: {line['value']} {line['unit']}")
        check(0 <= line["idle"] < 1, f"bench {name}: idle {line['idle']}")
        check(line["gpu"] == smi, f"bench {name}: gpu {line['gpu']!r}, want {smi!r}")
        raster = line["launches"]["rasterize_gaussians"]
        if name.startswith("serve"):
            check(raster == 0, f"bench {name}: the rasterizer launched {raster} times")
        else:
            check(raster > 0, f"bench {name}: the rasterizer never launched")
        if name.startswith("loader_host"):
            check(line["backend"] == "gpu", f"bench {name}: decoded by {line['backend']}")
            # the decoder's default workers, and the canvas kept on the card
            check(line["threads"] == jpeg_gpu.default_threads() and line["copy_ms"] == 0
                  and line["refused"] == 0,
                  f"bench {name}: {line['threads']} threads, copy back {line['copy_ms']} ms")
            # the window's launches: one a batch decoded in it, which is a
            # batch it took, give or take the superbatches decoded ahead
            ahead = (line["prefetch"] + 1) * line["K"]
            taken = line["loader_batches"]
            for kernel in ("idct_islow", "ycc_canvas"):
                n = line["launches"][kernel]
                check(taken - ahead > 0 and taken - ahead <= n <= taken + ahead,
                      f"bench {name}: {n} {kernel} launches for {taken} batches taken, "
                      f"{ahead} decoded ahead at most")
        out[name] = line["launches"]
    return out


# the decode route's kernels, as the launch counts name them
DECODE_KERNELS = ("idct_islow", "ycc_canvas")

# loader: MPII's own image size and a synthetic split of it; the pre-pad
# window the driver's auto-sizing picks for such a split (the whole frame:
# the worst-case crop box of its largest person exceeds the image)
LOADER_RES = (1280, 720)
LOADER_IMAGES = 64
LOADER_VAL = 16
LOADER_PAD = (768, 1280)
LOADER_LSB = 2.5  # libjpeg against Pillow's IDCT rounding (tests/test_native.py)
LOADER_WORKERS = (0, 4, 7)  # WorkerLoader's processes, beside the Pillow route
# WorkerLoader's steady rate: one epoch of 10 batches over the same JPEGs,
# timed after its first batch (which waits for the workers' start)
LOADER_STEADY_IMAGES = 320
# fit: the synthetic split's 64 train and 16 validation images at batch 32
FIT_EPOCHS, FIT_RESUME_EPOCHS = 2, 3
FIT_STEPS, FIT_VAL_BATCHES = 64 // BATCH, 1


# jpeg_gpu: the card's decode route.  Its hand entropy decoder, the
# idct_islow kernel (libjpeg's jpeg_idct_islow) and the ycc_canvas kernel
# give libjpeg's decode with its defaults: the planes equal Pillow's YCbCr
# decode and every canvas equals Pillow's load_sample exactly, so the
# route's bound against Pillow is 0 LSB (LOADER_LSB, 2.5, stays the bound
# of the other routes).
JPEG_LSB = 0
# the phase's files: 32 of the loader phase's 1280x720 frames (Pillow,
# quality 92, 4:2:0), and small odd-sized ones at every subsampling the
# route takes (4:4:0 by relabelling a 4:2:2 file's frame header: Pillow
# writes no 4:4:0), one with restart markers every 3 MCUs, one 4:2:0 file
# whose luma rows are 38 blocks (more than one of idct_islow's tiles, the
# last ragged), and the two the route refuses: a progressive file, and a
# quality-75 file whose tables are multiplied by 8 and rewritten as 16-bit
# entries (past libjpeg-turbo's 16-bit IDCT lanes, status "range")
JPEG_SMALL = (("444", 97, 131), ("422", 50, 61), ("440", 31, 45), ("420", 161, 121),
              ("gray", 33, 17), ("420", 3, 2), ("422", 4, 5), ("restart", 77, 53),
              ("420", 301, 9), ("progressive", 41, 29), ("scaled8", 161, 121))
JPEG_REFUSED = ("progressive", "scaled8")
JPEG_SCALE = 8  # the scaled file's table factor
JPEG_PADS = (LOADER_PAD, (400, 600), (64, 48))  # the loader's, then crops
# a canvas whose rows start at every byte offset (pw * 3 = 999 bytes)
JPEG_ODD_PAD = (45, 333)
# integer operations of one output pixel of a 3-component file: two h2v2
# upsamplings (2 column sums of a multiply and an add, 3 more ops to
# combine, a shift: 8 each), the two -128s, and the conversion (R 6, G 8,
# B 6, each with its add, shift and two-sided clamp)
YCC_OPS_PER_PIXEL = 38
# integer operations of one 8x8 block of idct_islow: 64 dequantising
# multiplies, 16 one-dimensional passes of 12 multiplies, 32 adds and
# subtracts, 2 shifts left, 8 rounding adds and 8 shifts right (62), and
# the range limit of 64 samples (a mask and 3 compares each)
IDCT_OPS_PER_BLOCK = 64 + 16 * 62 + 64 * 4
JPEG_TIMED = 3  # decoded batches timed, after one
JPEG_BUSY_CYCLES = 100_000_000  # ~50 ms of a sleep kernel at 2 GHz
JPEG_THREADS = (1, 2, 4, 8)  # the route's img/s at each, and at the default


def _scaled_tables(data, scale):
    """``data`` with every quantisation table multiplied by ``scale``
    (capped at 32767) and rewritten as 16-bit entries; the coefficients stay
    those of the original tables."""
    data = bytearray(data)
    i = 0
    while (i := data.find(b"\xff\xdb", i)) >= 0:
        length = int.from_bytes(data[i + 2:i + 4], "big")
        seg, out, j = data[i + 4:i + 2 + length], bytearray(), 0
        while j < len(seg):
            pq = seg[j] >> 4
            vals = ([int.from_bytes(seg[j + 1 + 2 * k:j + 3 + 2 * k], "big") for k in range(64)]
                    if pq else list(seg[j + 1:j + 65]))
            out.append(0x10 | (seg[j] & 15))
            out += b"".join(min(v * scale, 32767).to_bytes(2, "big") for v in vals)
            j += 1 + 64 * (pq + 1)
        seg = b"\xff\xdb" + (len(out) + 2).to_bytes(2, "big") + out
        data[i:i + 2 + length] = seg
        i += len(seg)
    return bytes(data)


def _small_jpeg(sub, w, h, seed):
    """A w x h JPEG's bytes at subsampling ``sub`` (444, 422, 420, 440 or
    gray; restart: 4:2:0 with a restart interval of 3 MCUs; progressive:
    4:2:0 progressive; scaled8: 4:2:0 at quality 75, its tables times
    JPEG_SCALE as 16-bit entries) from seeded smooth content with noise, at
    quality 92 unless said."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 7 % 256], -1)
    im = Image.fromarray(np.clip(base + rng.randint(-40, 40, (h, w, 3)), 0, 255)
                         .astype(np.uint8))
    kw = {"subsampling": {"444": 0, "422": 1, "440": 1}.get(sub, 2)}
    if sub == "restart":
        kw["restart_marker_blocks"] = 3
    if sub == "progressive":
        kw["progressive"] = True
    if sub == "gray":
        im, kw = im.convert("L"), {}
    if sub == "440":
        im = im.transpose(Image.TRANSPOSE)
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=75 if sub == "scaled8" else 92, **kw)
    if sub == "scaled8":
        return _scaled_tables(buf.getvalue(), JPEG_SCALE)
    data = bytearray(buf.getvalue())
    if sub == "440":
        # SOF0: length, precision, height, width, count, then (id, HV, table)
        i = data.find(b"\xff\xc0")
        data[i + 5:i + 9] = data[i + 7:i + 9] + data[i + 5:i + 7]
        check(data[i + 11] == 0x21, "4:2:2 luma sampling byte")
        data[i + 11] = 0x12
    if sub == "restart":
        check(b"\xff\xdd" in data and b"\xff\xd0" in data, "restart markers written")
    return bytes(data)


class _Files:
    """A dataset of ``paths`` with the given centers (load_sample's view)."""

    def __init__(self, paths, centers):
        self.paths, self.centers = paths, centers

    def __len__(self):
        return len(self.paths)

    def image_path(self, i):
        return self.paths[i]

    def meta(self, i):
        return (self.centers[i].astype(np.float64), 1.0, np.zeros((16, 2)), np.zeros(16))


def _jpeg_size(path):
    """A JPEG's (width, height) from its header, as Pillow reads it."""
    from PIL import Image

    with Image.open(path) as im:
        return im.size


def _pillow_planes(path):
    """Pillow's YCbCr decode (libjpeg upsampled, not converted), or its
    grayscale one, as a list of planes."""
    from PIL import Image

    im = Image.open(path)
    if im.mode == "L":
        return [np.asarray(im)]
    im.draft("YCbCr", im.size)
    arr = np.asarray(im)
    check(im.mode == "YCbCr", f"{path}: draft mode {im.mode}")
    return [arr[..., c] for c in range(3)]


def _misaligned(p):
    """Plane ``p`` copied into rows of an odd pitch that start 1 byte past a
    16-byte boundary: a (h, w) view."""
    h, w = p.shape
    pitch = w + 1 + (w % 2)  # odd
    buf = torch.empty(1 + pitch * h, dtype=torch.uint8, device=p.device)
    view = buf[1:].view(h, pitch)[:, :w]
    view.copy_(p)
    check(view.data_ptr() % 16 == 1 and view.stride(0) % 2 == 1, "misaligned plane layout")
    return view


def _odd_window(rng, w, h, pad_hw):
    """A window of a w x h image at odd offsets (x and y, where the image
    has room), inside the canvas."""
    ox = 2 * rng.randint(0, (w - 2) // 2 + 1) + 1 if w > 1 else 0
    oy = 2 * rng.randint(0, (h - 2) // 2 + 1) + 1 if h > 1 else 0
    return ox, oy, min(w - ox, pad_hw[1]), min(h - oy, pad_hw[0])


def _ycc_bound(planes, n, pad_hw, valid_pixels):
    """Least time for ycc_canvas's work: the planes read once and the
    canvas written once, against its integer operations at the card's
    float32 rate (the table's nearest entry)."""
    nbytes = sum(p.shape[0] * p.shape[1] for pl in planes for p in pl) + n * pad_hw[0] * pad_hw[1] * 3
    ops = valid_pixels * YCC_OPS_PER_PIXEL
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return nbytes, ops, max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _idct_bound(blocks, plane_bytes, tables):
    """Least time for idct_islow's work: the coefficients of the blocks
    that cover the planes (128 bytes each) and the tables (128 bytes a
    component) read once, the planes written once, against its integer
    operations at the card's float32 rate (the table's nearest entry)."""
    nbytes = blocks * 128 + tables * 128 + plane_bytes
    ops = blocks * IDCT_OPS_PER_BLOCK
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return nbytes, ops, max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _planes_equal(a, b):
    return all(len(x) == len(y) and all(torch.equal(p, q) for p, q in zip(x, y))
               for x, y in zip(a, b))


def _busy_stream_equal(dec, sets):
    """The route's planes and canvases with the decoder's stream held by a
    sleep kernel, against those of an idle stream: three batches queued
    behind the sleep, so each of the two pinned coefficient buffers comes
    round again before its copy has run."""
    pad = JPEG_PADS[-1]
    batches = [sets["frames"], sets["small"], sets["frames"]]
    centers = [np.array([[0.4 * i, 0.3 * i]] * len(b), np.float32) for i, b in
               enumerate(batches)]
    idle_planes = [tuple(p.clone() for p in pl) for pl in dec.decode_planes(sets["frames"])[0]]
    idle = [dec.decode_batch(b, c, pad)[0].copy() for b, c in zip(batches, centers)]
    with torch.cuda.stream(dec.stream):
        torch.cuda._sleep(JPEG_BUSY_CYCLES)
    kept = [dec.decode_batch(b, c, pad, out=dec.canvas((len(b), *pad, 3)))[0]
            for b, c in zip(batches, centers)]
    for k in kept:
        torch.cuda.current_stream().wait_event(k.ready)
    canvases = all(np.array_equal(k.tensor.cpu().numpy(), i) for k, i in zip(kept, idle))
    with torch.cuda.stream(dec.stream):
        torch.cuda._sleep(JPEG_BUSY_CYCLES)
    planes = _planes_equal(idle_planes, dec.decode_planes(sets["frames"])[0])
    return {"planes": planes, "canvases": canvases}


# a decode's device spans, by the keys of _route_times
ROUTE_STAGES = {"loader.copy_in": "copy_in_ms", "loader.idct": "idct_ms",
                "loader.canvas": "canvas_ms", "loader.copy_out": "copy_ms"}


def _route_times(dec, frames, centers, pad, keep):
    """JPEG_TIMED decodes of ``frames`` timed after one, traced: into a new
    tensor on the card each (``keep``, the loader's path) or into one
    pinned host buffer.  Returns a dict a timed decode: its ``dec.times``
    (the host's stages), the card's ms of each stage from its device spans
    (``copy_ms`` 0 for ``keep``), and ``total_ms``, the call until its
    canvas is done on the card."""
    pinned = None if keep else torch.empty((len(frames), *pad, 3), dtype=torch.uint8,
                                            pin_memory=True)
    dec.times.clear()
    out_times = []
    with REGISTRY.forced_on():
        for i in range(JPEG_TIMED + 1):
            out = dec.canvas((len(frames), *pad, 3)) if keep else pinned.numpy()
            since = REGISTRY.watermark()
            t0 = time.perf_counter()
            dec.decode_batch(frames, centers, pad, out=out)
            dec.stream.synchronize()
            total_ms = 1e3 * (time.perf_counter() - t0)
            stages = {ROUTE_STAGES[r.name]: r.ms for r in REGISTRY.records(since=since)
                      if r.device and r.name in ROUTE_STAGES}
            if i:
                out_times.append({"copy_ms": 0.0, **dec.times[-1], **stages,
                                  "total_ms": total_ms})
    return out_times


def _idct_on_card(coefs):
    """The idct_islow wrapper on a batch's coefficients (``coefs``, a
    jpeg_gpu.Coefficients on the CPU) moved to the card, into planes laid
    out as the route lays them out, one launch; and the plain version's
    planes on the CPU.  Returns (card planes, plain planes, max abs err)."""
    dev = coefs.buffer.cuda()
    layout, nbytes = jpeg_gpu.plane_layout([(w, h)] for w, h in coefs.sizes)
    buf = torch.full((max(nbytes, 1),), 7, dtype=torch.uint8, device="cuda")
    planes = [buf[off:off + pitch * h].view(h, pitch)[:, :w]
              for ((w, h, pitch, off),) in layout]
    before = counter(islow.IDCT_LAUNCHES)
    islow.idct_islow(dev, dev, coefs.desc, planes)
    torch.cuda.synchronize()
    check(counter(islow.IDCT_LAUNCHES) == before + 1,
          "the idct_islow wrapper did not launch its kernel once")
    want = [torch.empty((h, w), dtype=torch.uint8) for w, h in coefs.sizes]
    islow.idct_islow(coefs.buffer, coefs.buffer, coefs.desc, want)
    err = max(int((g.cpu().int() - p.int()).abs().max()) for g, p in zip(planes, want))
    return planes, want, err


def _tile_shapes(coefs):
    """How a batch's components meet idct_islow's tiles: components whose
    block rows are not whole tiles, whose rows hold more than one tile, and
    whose grid is wider than the blocks that cover the plane."""
    nbw = [-(-w // 8) for w, _ in coefs.sizes]
    grid = [int(bw) for bw in coefs.desc[:, 2]]
    return {"ragged_rows": sum(b % islow.TILE_BLOCKS != 0 for b in nbw),
            "multi_tile_rows": sum(b > islow.TILE_BLOCKS for b in nbw),
            "padded_grids": sum(g > b for g, b in zip(grid, nbw))}


def _noise_jpeg(w, h, seed):
    """A w x h 4:2:0 JPEG of uniform noise at quality 100."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)
                    ).save(buf, "JPEG", quality=100, subsampling=2)
    return buf.getvalue()


def _extreme_coefficients(rng):
    """A jpeg_gpu.Coefficients-like batch of random blocks over four grids
    (coefficients at +-2047 among random ones, every other block with
    all-zero AC columns, tables up to 255, grids wider than their
    planes)."""
    grids = [(32, 40, 250, 317), (16, 32, 121, 256), (1, 1, 1, 1), (64, 23, 509, 183)]
    chunks, desc, sizes, at = [], [], [], 0
    for bw, bh, w, h in grids:
        blocks = rng.choice([-2047, 2047, 0, 1, -1, *range(-300, 300)], (bw * bh, 64))
        blocks[::2, 8:] = 0
        chunks += [rng.randint(1, 256, 64), blocks.ravel()]
        desc.append((at + 64, at, bw, bh))
        at += 64 + blocks.size
        sizes.append((w, h))

    class Batch:
        pass

    b = Batch()
    b.buffer = torch.from_numpy(np.concatenate(chunks).astype(np.int16))
    b.desc, b.sizes = np.array(desc, np.int64), sizes
    return b


def phase_jpeg_gpu(workdir):
    """The card's decode route: its planes against Pillow's YCbCr decode
    (exactly), N worker threads against one (planes and canvases exactly)
    and the decoder's stream held busy, the idct_islow kernel against its
    plain version on the route's coefficients and on extreme random blocks
    (exactly, one launch a batch; block rows that are not whole tiles, rows
    of several tiles, MCU-padded grids), the share of blocks the entropy
    decoder's check of libjpeg-turbo's 16-bit lanes flags on the loader's
    frames and on a quality-100 noise frame, the ycc_canvas kernel against
    its plain version on the route's planes and on misaligned rows, odd
    offsets and (0, 0) slots (exactly, one launch a batch), the whole route
    against Pillow's load_sample (exactly, windows too, the progressive and
    the scaled-table file refused, counted and filled by the loader's
    Pillow row), then both kernels timed beside their bounds and the write
    floor, and the decode of the loader's batch (read, host, copy-in, IDCT,
    canvas and copy-back ms, img/s) at 1, 2, 4, 8 and N threads."""
    root = os.path.join(workdir, "jpeg_gpu")
    make_synthetic_dataset(root, num_train=BATCH, num_val=0, res=LOADER_RES, seed=SEED)
    ds = MpiiDataset(os.path.join(root, "annotations.json"), os.path.join(root, "images"),
                     split="train")
    frames = [ds.image_path(i) for i in range(BATCH)]
    small = []
    for k, (sub, w, h) in enumerate(JPEG_SMALL):
        small.append(os.path.join(root, f"small_{k}_{sub}.jpg"))
        with open(small[-1], "wb") as f:
            f.write(_small_jpeg(sub, w, h, SEED + k))
    refused_want = [sub in JPEG_REFUSED for sub, _, _ in JPEG_SMALL]
    dec = GpuJpegDecoder("cuda", timing=True)  # default_threads() workers
    one = GpuJpegDecoder("cuda", num_threads=1)

    # the planes, upsampled by the plain version, against Pillow's
    sets = {"frames": frames, "small": small}
    plane_gap, plane_samples, sizes, refused = 0, 0, {}, {}
    for name, batch in sets.items():
        planes, samplings = dec.decode_planes(batch)
        sizes[name] = [(pl[0].shape[1], pl[0].shape[0]) if pl else None for pl in planes]
        refused[name] = [not pl for pl in planes]
        for path, pl, samp in zip(batch, planes, samplings):
            if not pl:
                continue
            H, W = pl[0].shape
            got = [pl[0]] + [ycc.fancy_upsample(p, *s, W, H) for p, s in zip(pl[1:], samp[1:])]
            for g, want in zip(got, _pillow_planes(path)):
                d = (g.cpu().numpy().astype(np.int16) - want.astype(np.int16))
                plane_gap = max(plane_gap, int(np.abs(d).max()))
                plane_samples += d.size
    check(refused["frames"] == [False] * BATCH and refused["small"] == refused_want,
          f"refused files {refused}, want only {JPEG_REFUSED}")
    check(plane_gap == 0, f"the route's planes {plane_gap} from Pillow's")
    sizes["small"] = [s or _jpeg_size(p) for s, p in zip(sizes["small"], small)]

    # N worker threads against one: the planes, then the canvases into host
    # memory and into a tensor on the card, bit for bit
    threads_equal = True
    for name, batch in sets.items():
        want = [tuple(p.clone() for p in pl) for pl in one.decode_planes(batch)[0]]
        threads_equal &= _planes_equal(want, dec.decode_planes(batch)[0])
        for pad in (JPEG_PADS[0], JPEG_PADS[-1]):
            centers = np.array([[0.4 * w, 0.6 * h] for w, h in sizes[name]], np.float32)
            host_one = one.decode_batch(batch, centers, pad)[0]
            host_n = dec.decode_batch(batch, centers, pad)[0]
            kept = dec.decode_batch(batch, centers, pad, out=dec.canvas((len(batch), *pad, 3)))[0]
            torch.cuda.current_stream().wait_event(kept.ready)
            threads_equal &= (np.array_equal(host_one, host_n)
                              and np.array_equal(kept.tensor.cpu().numpy(), host_one))
        del want
    check(threads_equal, f"{dec.num_threads} worker threads and one decode differently")

    # the decoder's stream held by a sleep kernel: the planes and canvases
    # must be those of an idle stream, at one thread and at N
    busy_equal = {t: _busy_stream_equal(d, sets) for t, d in ((1, one), (dec.num_threads, dec))}
    check(all(all(v.values()) for v in busy_equal.values()),
          f"the route's output changes on a busy stream: {busy_equal}")
    one.close()

    # idct_islow against its plain version on the route's coefficients (the
    # small files give block rows that are not whole tiles, rows of more than
    # one tile, and grids wider than their planes: MCU-padded 4:2:0) and on
    # extreme random blocks
    idct_cases = []
    for name, batch in sets.items():
        co = dec.coefficients(batch)
        _, _, err = _idct_on_card(co)
        check(err == 0, f"idct_islow on the {name} coefficients: max abs err {err}")
        idct_cases.append({"files": name, "components": len(co.sizes), "max_abs_err": err,
                           "refused": co.refused, **_tile_shapes(co)})
    check(all(idct_cases[1][k] > 0 for k in ("ragged_rows", "multi_tile_rows", "padded_grids")),
          f"the small files miss a tiling case: {idct_cases[1]}")
    extreme = _extreme_coefficients(np.random.RandomState(SEED))
    _, _, err = _idct_on_card(extreme)
    check(err == 0, f"idct_islow on extreme blocks: max abs err {err}")
    idct_cases.append({"files": "extreme_random", "max_abs_err": err, **_tile_shapes(extreme)})

    # libjpeg-turbo's 16-bit lanes: the share of blocks over the entropy
    # decoder's cheap bound (each then takes its exact check) on the
    # loader's frames and on a quality-100 noise frame
    noise = os.path.join(root, "noise_q100.jpg")
    with open(noise, "wb") as f:
        f.write(_noise_jpeg(*LOADER_RES, SEED))
    range_check = {}
    for name, batch in (("frames", frames), ("noise_q100", [noise])):
        before = dec.block_counts()
        co = dec.coefficients(batch)
        blocks, flagged = (a - b for a, b in zip(dec.block_counts(), before))
        range_check[name] = {"blocks": blocks, "flagged": flagged, "share": flagged / blocks,
                             "refused": co.refused}
    check(range_check["frames"]["refused"] == 0 and range_check["noise_q100"]["refused"] == 0,
          f"the lanes' check refused a Pillow-written file: {range_check}")

    # ycc_canvas against its plain version on the route's own planes
    cases = []
    for name, batch in sets.items():
        planes, samplings = dec.decode_planes(batch)
        rng = np.random.RandomState(SEED)
        for pad in JPEG_PADS:
            # centers near each corner and edge, and inside
            centers = np.array([[(0.01, 0.99, 0.5, 0.01, 0.99)[i % 5] * w,
                                 (0.01, 0.99, 0.99, 0.5, 0.01)[i % 5] * h]
                                for i, (w, h) in enumerate(sizes[name])], np.float32)
            centers += rng.uniform(-0.5, 0.5, centers.shape).astype(np.float32)
            windows = np.array([ycc.crop_window(w, h, c, pad) if pl else (0, 0, 0, 0)
                                for (w, h), c, pl in zip(sizes[name], centers, planes)],
                               np.int64)
            before = counter(ycc.YCC_LAUNCHES)
            got = ycc.ycc_canvas(planes, samplings, windows, pad)
            torch.cuda.synchronize()
            check(counter(ycc.YCC_LAUNCHES) == before + 1,
                  "the ycc_canvas wrapper did not launch its kernel once")
            want = torch.stack([ycc.planes_to_canvas(pl, s, pad, c)[0] if pl else
                                torch.zeros((*pad, 3), dtype=torch.uint8, device="cuda")
                                for pl, s, c in zip(planes, samplings, centers)])
            err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
            check(torch.equal(got, want), f"ycc_canvas {name} {pad}: max abs err {err}")
            cases.append({"files": name, "pad_hw": list(pad), "max_abs_err": err,
                          "cropped": int((windows[:, :2] > 0).any(axis=1).sum())})

    # ycc_canvas where rows, windows and slots are not the decoder's: planes
    # in rows of odd pitch from a base 1 byte off a 16-byte boundary,
    # windows at odd offsets, (0, 0) slots (every third, with and without
    # planes), at every pad and at one whose rows start at every byte offset
    for name, batch in sets.items():
        planes, samplings = dec.decode_planes(batch)
        moved = [tuple(_misaligned(p) for p in pl) for pl in planes]
        rng = np.random.RandomState(SEED + 1)
        for pad in (*JPEG_PADS, JPEG_ODD_PAD):
            centers = np.array([[0.3 * w, 0.7 * h] for w, h in sizes[name]], np.float32)
            crops = np.array([ycc.crop_window(w, h, c, pad) if pl else (0, 0, 0, 0)
                              for (w, h), c, pl in zip(sizes[name], centers, planes)], np.int64)
            odd = np.array([_odd_window(rng, w, h, pad) if pl else (0, 0, 0, 0)
                            for (w, h), pl in zip(sizes[name], planes)], np.int64)
            zero = odd.copy()
            zero[::3] = 0
            holes = [() if i % 6 == 3 else pl for i, pl in enumerate(moved)]
            for variant, pl_set, wins in (("misaligned_rows", moved, crops),
                                          ("odd_offsets", planes, odd),
                                          ("zero_slots", holes, zero)):
                wins = np.where(np.array([bool(p) for p in pl_set])[:, None], wins, 0)
                before = counter(ycc.YCC_LAUNCHES)
                got = ycc.ycc_canvas(pl_set, samplings, wins, pad)
                torch.cuda.synchronize()
                check(counter(ycc.YCC_LAUNCHES) == before + 1,
                      "the ycc_canvas wrapper did not launch its kernel once")
                want = torch.stack([ycc.window_canvas(pl, s, w, pad) if pl
                                    else torch.zeros((*pad, 3), dtype=torch.uint8, device="cuda")
                                    for pl, s, w in zip(pl_set, samplings, wins)])
                err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
                check(torch.equal(got, want), f"ycc_canvas {name} {pad} {variant}: "
                                              f"max abs err {err}")
                cases.append({"files": name, "pad_hw": list(pad), "variant": variant,
                              "max_abs_err": err, "zero_slots": int((wins[:, 2] == 0).sum())})
        del moved, holes

    # the whole route against Pillow's canvas, exactly; the refused file
    # reads ok False and is counted
    route_lsb, refused_rows = 0, 0
    for name, batch in sets.items():
        for pad in JPEG_PADS:
            centers = np.array([[0.9 * w, 0.1 * h] for w, h in sizes[name]], np.float32)
            counted = dec.refused
            images, wh, offs, ok = dec.decode_batch(batch, centers, pad)
            check(ok.tolist() == [not r for r in refused[name]]
                  and dec.refused - counted == sum(refused[name]),
                  f"{name} {pad}: ok {ok.tolist()}, {dec.refused - counted} counted refused")
            refused_rows += int((~ok).sum())
            files = _Files(batch, centers)
            for i in np.flatnonzero(ok).tolist():
                want = load_sample(files, i, pad)
                check(np.array_equal(wh[i], want["valid_wh"])
                      and np.array_equal(offs[i], want["offset"]),
                      f"{batch[i]} {pad}: window {wh[i]} {offs[i]}")
                route_lsb = max(route_lsb, int(np.abs(images[i].astype(np.int16)
                                                      - want["image"].astype(np.int16)).max()))
    check(route_lsb <= JPEG_LSB, f"the card's route {route_lsb} LSB from Pillow")
    # through the loader onto the card: the refused file's row is Pillow's
    centers = np.array([[0.5 * w, 0.5 * h] for w, h in sizes["small"]], np.float32)
    files = _Files(small, centers)
    (batch,) = list(HostLoader(files, len(small), pad_hw=JPEG_PADS[-1], shuffle=False,
                               backend="gpu", place=make_batch_placer("cuda"), group=1))
    for i in range(len(small)):
        want = load_sample(files, i, JPEG_PADS[-1])["image"]
        check(np.array_equal(batch["image"][0, i].cpu().numpy(), want),
              f"the loader's row of {small[i]} is not Pillow's")

    # idct_islow at the loader's batch: alone, through its wrapper, the
    # plain version, the write floor, the bound
    co = dec.coefficients(frames)
    dev = co.buffer[:co.elements].cuda()
    layout, nbytes = jpeg_gpu.plane_layout([(w, h)] for w, h in co.sizes)
    buf = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    planes = [buf[off:off + pitch * h].view(h, pitch)[:, :w] for ((w, h, pitch, off),) in layout]
    words, tiles = islow.descriptors(co.desc, planes)
    blocks = sum(-(-w // 8) * -(-h // 8) for w, h in co.sizes)
    dev_words = torch.from_numpy(words).cuda()
    fn, stream = islow.IDCT.idct_islow_launch, torch.cuda.current_stream().cuda_stream
    check(fn(dev_words.data_ptr(), len(planes), tiles, dev.data_ptr(), dev.data_ptr(),
             stream) == 0, "idct_islow launch")
    alone = buf.clone()
    idct_ms = cuda_ms(lambda: fn(dev_words.data_ptr(), len(planes), tiles, dev.data_ptr(),
                                 dev.data_ptr(), stream))
    before = counter(islow.IDCT_LAUNCHES)
    idct_wrapper_ms = cuda_ms(lambda: islow.idct_islow(dev, dev, co.desc, planes))
    check(counter(islow.IDCT_LAUNCHES) > before, "idct_islow did not launch")
    check(torch.equal(buf, alone), "idct_islow alone and through its wrapper differ")
    idct_plain_ms = cuda_ms(lambda: [islow.component_plane(
        dev[o:o + bw * bh * 64], dev[q:q + 64], bw, bh, w, h)
        for (o, q, bw, bh), (w, h) in zip(co.desc.tolist(), co.sizes)], reps=2, samples=5)
    plane_bytes = sum(w * h for w, h in co.sizes)
    idct_floor_ms = cuda_ms(buf.zero_)
    idct_bytes, idct_ops, idct_bound_ms, idct_bound_by = _idct_bound(blocks, plane_bytes,
                                                                     len(co.sizes))
    coefficient_bytes = 2 * co.elements
    del dev, buf, alone, planes, dev_words

    # ycc_canvas at the loader's batch: its time, its bound, the write floor
    pad = LOADER_PAD
    planes, samplings = dec.decode_planes(frames)
    planes = [tuple(p.clone() for p in pl) for pl in planes]  # outlive the buffer
    centers = np.array([[0.5 * pl[0].shape[1], 0.5 * pl[0].shape[0]] for pl in planes],
                       np.float32)
    windows = np.array([ycc.crop_window(pl[0].shape[1], pl[0].shape[0], c, pad)
                        for pl, c in zip(planes, centers)], np.int64)
    out = torch.empty((BATCH, *pad, 3), dtype=torch.uint8, device="cuda")
    # the kernel alone, its descriptors already on the card
    desc = torch.from_numpy(ycc.descriptors(planes, samplings, windows, pad, out.device)).cuda()
    fn, stream = ycc.YCC.ycc_canvas_launch, torch.cuda.current_stream().cuda_stream
    out.fill_(7)
    check(fn(desc.data_ptr(), BATCH, *pad, out.data_ptr(), stream) == 0, "ycc_canvas launch")
    alone = out.clone()
    ms = cuda_ms(lambda: fn(desc.data_ptr(), BATCH, *pad, out.data_ptr(), stream))
    # the wrapper: its checks, the descriptors, their staging and copy, the
    # launch (a call's host waits for the kernel of the call STAGING_SLOTS
    # before it, so back to back this reads the host's time where it is longer)
    before = counter(ycc.YCC_LAUNCHES)
    wrapper_ms = cuda_ms(lambda: ycc.ycc_canvas(planes, samplings, windows, pad, out=out))
    check(counter(ycc.YCC_LAUNCHES) > before, "ycc_canvas did not launch")
    check(torch.equal(out, alone), "the kernel alone and through its wrapper differ")
    plain_ms = cuda_ms(lambda: torch.stack([ycc.window_canvas(pl, s, w, pad) for pl, s, w
                                            in zip(planes, samplings, windows)]),
                       reps=2, samples=5)
    floor_ms = cuda_ms(out.zero_)
    valid = int(windows[:, 2].astype(np.int64) @ windows[:, 3])
    nbytes, ops, bound_ms, bound_by = _ycc_bound(planes, BATCH, pad, valid)
    del out, planes, desc, alone

    # the route at the loader's batch: into the card's canvas (the loader's
    # path) and into pinned memory (the copy back); then into the card's
    # canvas at each thread count
    kept = _route_times(dec, frames, centers, pad, keep=True)
    timed = _route_times(dec, frames, centers, pad, keep=False)
    sweep = []
    for t in sorted({*JPEG_THREADS, dec.num_threads}):
        d = dec if t == dec.num_threads else GpuJpegDecoder("cuda", timing=True, num_threads=t)
        times = _route_times(d, frames, centers, pad, keep=True)
        sweep.append({"threads": t, "img_per_s": [BATCH * 1e3 / x["total_ms"] for x in times],
                      **{k: [x[k] for x in times] for k in ("read_ms", "info_ms", "host_ms",
                                                            "copy_in_ms", "idct_ms",
                                                            "total_ms")}})
        if d is not dec:
            d.close()
    dec.close()
    emit("jpeg_gpu", files=len(frames) + len(small), frame_res=list(LOADER_RES),
         small=[list(c) for c in JPEG_SMALL], refused=refused["small"],
         refused_rows=refused_rows,
         plane_gap_max=plane_gap, plane_samples=plane_samples,
         threads=dec.num_threads, cpu_count=os.cpu_count(),
         affinity=len(os.sched_getaffinity(0)), threads_equal_one=threads_equal,
         busy_stream_equal=busy_equal,
         route_max_lsb_vs_pillow=route_lsb, route_bound_lsb=JPEG_LSB,
         idct_cases=idct_cases, kernel_cases=cases,
         range_check=range_check,
         idct={"batch": BATCH, "blocks": blocks, "tiles": tiles, "components": len(co.sizes),
               "coefficient_bytes": coefficient_bytes, "ms": idct_ms,
               "wrapper_ms": idct_wrapper_ms, "plain_ms": idct_plain_ms,
               "write_floor_ms": idct_floor_ms, "bound_ms": idct_bound_ms,
               "bound_by": idct_bound_by, "share_of_bound": idct_bound_ms / idct_ms,
               "gb_per_s": idct_bytes / idct_ms / 1e6, "bytes": idct_bytes,
               "operations": idct_ops},
         kernel={"batch": BATCH, "pad_hw": list(pad), "ms": ms, "wrapper_ms": wrapper_ms,
                 "plain_ms": plain_ms, "write_floor_ms": floor_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                 "gb_per_s": nbytes / ms / 1e6, "bytes": nbytes, "operations": ops},
         decode_ms_per_batch=[t["total_ms"] for t in kept],
         read_ms_per_batch=[t["read_ms"] for t in kept],
         info_ms_per_batch=[t["info_ms"] for t in kept],
         host_ms_per_batch=[t["host_ms"] for t in kept],
         copy_in_ms_per_batch=[t["copy_in_ms"] for t in kept],
         idct_ms_per_batch=[t["idct_ms"] for t in kept],
         desc_ms_per_batch=[t["desc_ms"] for t in kept],
         canvas_ms_per_batch=[t["canvas_ms"] for t in kept],
         img_per_s=[BATCH * 1e3 / t["total_ms"] for t in kept],
         pinned={"decode_ms_per_batch": [t["total_ms"] for t in timed],
                 "host_ms_per_batch": [t["host_ms"] for t in timed],
                 "copy_in_ms_per_batch": [t["copy_in_ms"] for t in timed],
                 "idct_ms_per_batch": [t["idct_ms"] for t in timed],
                 "canvas_ms_per_batch": [t["canvas_ms"] for t in timed],
                 "copy_back_ms_per_batch": [t["copy_ms"] for t in timed],
                 "img_per_s": [BATCH * 1e3 / t["total_ms"] for t in timed]},
         thread_sweep=sweep)
    ycc_entry = {
        "name": "ycc_canvas",
        "route": "cuda",
        "source": "posetpu_torch/native/kernels/ycc_canvas.cu",
        # no TPU kernel: libjpeg's upsampling and conversion inside the pool
        "replaces": "posetpu/native/decode_pool.cpp:81",
        "launches": None,  # filled from fit_jpeg_gpu
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": ms,
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        # no single PyTorch call upsamples as libjpeg does and converts
        # with its integer arithmetic (F.interpolate computes another function)
        "library_ms": None,
        "write_floor_ms": floor_ms,
    }
    idct_entry = {
        "name": "idct_islow",
        "route": "cuda",
        "source": "posetpu_torch/native/kernels/idct_islow.cu",
        # no TPU kernel: libjpeg's IDCT inside the pool's jpeg_read_scanlines
        "replaces": "posetpu/native/decode_pool.cpp:81",
        "launches": None,  # filled from fit_jpeg_gpu
        "max_abs_err": max(c["max_abs_err"] for c in idct_cases),
        "ms": idct_ms,
        "wrapper_ms": idct_wrapper_ms,
        "plain_ms": idct_plain_ms,
        "bound_ms": idct_bound_ms,
        "bound_by": idct_bound_by,
        # no PyTorch call computes libjpeg's integer IDCT
        "library_ms": None,
        "write_floor_ms": idct_floor_ms,
    }
    return ycc_entry, idct_entry


def _serve_batches(rng):
    H, W = CANVAS
    out = []
    for _ in range(NUM_BATCHES):
        vw = rng.randint(W * 2 // 3, W + 1, BATCH)
        vh = rng.randint(H * 2 // 3, H + 1, BATCH)
        valid_wh = np.stack([vw, vh], axis=1).astype(np.int32)
        center = (valid_wh / 2 + rng.uniform(-10, 10, (BATCH, 2))).astype(np.float32)
        scale = (vh / 200.0 * rng.uniform(0.7, 1.0, BATCH)).astype(np.float32)
        images = np.zeros((BATCH, H, W, 3), np.uint8)
        for i in range(BATCH):
            images[i, : vh[i], : vw[i]] = rng.randint(
                0, 256, (vh[i], vw[i], 3), dtype=np.uint8
            )
        out.append((images, valid_wh, center, scale))
    return out


def _serve_eager(predictor, batch):
    """The predictor's eager body (``_forward``, the parity reference of its
    graphs) on one ``(images, valid_wh, center, scale)`` batch: copied to
    the card, run, read back."""
    dev = predictor.device
    images, valid_wh, center, scale = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                       for a in batch)
    with torch.no_grad():
        out = predictor._forward(images, valid_wh, center, scale)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _serve_eager_iter(predictor, batches, depth=2):
    """The eager body served as ``predict_iter(depth)`` served it before
    its graphs: each batch pinned afresh and copied without blocking,
    ``_forward`` enqueued, its outputs copied to pinned host buffers behind
    an event, ``depth`` batches in flight.  The graph's yardstick."""
    dev = predictor.device

    def launch(batch):
        args = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(dev, non_blocking=True)
                for a in batch]
        with torch.no_grad():
            out = predictor._forward(*args)
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(
            v, non_blocking=True) for k, v in out.items()}
        done = torch.cuda.Event()
        done.record()
        return host, done, None

    inflight = deque()
    for batch in batches:
        inflight.append(launch(batch))
        if len(inflight) > depth:
            yield predictor._fetch(inflight.popleft())
    while inflight:
        yield predictor._fetch(inflight.popleft())


def _same_outputs(label, got, want):
    for k in want:
        err = float(np.abs(got[k].astype(np.float64) - want[k]).max())
        check(np.array_equal(got[k], want[k]), f"{label} {k}: graph vs eager {err}")


def _single(image, center, scale):
    """predict_single's padded batch of one image (multiples of 64)."""
    H, W = image.shape[:2]
    padded = np.zeros((1, -(-H // 64) * 64, -(-W // 64) * 64, 3), np.uint8)
    padded[0, :H, :W] = image
    return (padded, np.array([[W, H]], np.int32), np.asarray([center], np.float32),
            np.asarray([scale], np.float32))


def _serve_weights(cfg, seed):
    torch.manual_seed(seed)
    return hg(num_stacks=cfg.model.stacks, num_classes=cfg.model.classes,
              num_feats=cfg.model.feats, depth=cfg.model.depth).state_dict()


def phase_serve(cfg):
    """PosePredictor at the full hg8_mpii width (seeded weights, bf16):
    predict_iter(depth=2) over NUM_BATCHES batches of 32 through the CUDA
    graph of their (32, 384, 384) shape, against the eager body on the same
    batches and weights, bit for bit; img/s both ways and the profiler's
    idle share of both, in this call (the eager body pipelined as
    predict_iter(depth=2) ran it before the graphs: ``_serve_eager_iter``);
    captures and the pool.  Then one
    image through predict_single (a graph of its own shape; a second image
    of that size replays it), and other weights loaded in place (the
    graphs read them: no capture, equal to the eager body)."""
    predictor = PosePredictor.from_config(cfg, _serve_weights(cfg, SEED), mean=MPII_MEAN)
    batches = _serve_batches(np.random.RandomState(SEED))
    predictor(*batches[0])  # captures the graph, not timed
    _serve_eager(predictor, batches[0])  # the eager body's cuDNN set-up
    torch.cuda.synchronize()
    check(predictor.graphs.captures == 1, f"captures {predictor.graphs.captures}")

    reset_counters(RASTER, *HAND_OP_COUNTERS)
    t0 = time.perf_counter()
    outs = list(predictor.predict_iter(iter(batches), depth=2))
    seconds = time.perf_counter() - t0
    launches = {"rasterize_gaussians": counter(RASTER), **_hand_op_launches()}
    _check_hand_ops("serve graph", launches, NUM_BATCHES, 0)
    t0 = time.perf_counter()
    eager = list(_serve_eager_iter(predictor, iter(batches), depth=2))
    eager_s = time.perf_counter() - t0

    K = cfg.model.classes
    check(len(outs) == NUM_BATCHES, "predict_iter lost a batch")
    for i, (out, ref) in enumerate(zip(outs, eager)):
        check(out["pred"].shape == (BATCH, K, 2), f"pred {out['pred'].shape}")
        check(out["conf"].shape == (BATCH, K), f"conf {out['conf'].shape}")
        check(out["heatmap_coords"].shape == (BATCH, K, 2), "heatmap_coords shape")
        for k, v in out.items():
            check(np.isfinite(v).all(), f"non-finite {k}")
        _same_outputs(f"serve batch {i}", out, ref)
    check(not any(np.array_equal(outs[i]["conf"], outs[i + 1]["conf"])
                  for i in range(NUM_BATCHES - 1)), "two batches served the same output")
    prof = profile_run(lambda: list(predictor.predict_iter(iter(batches), depth=2)))
    prof_eager = profile_run(lambda: list(_serve_eager_iter(predictor, iter(batches), depth=2)))

    rng = np.random.RandomState(SEED + 30)
    singles = []
    for _ in range(2):  # one (300, 410) image size: one graph of (1, 320, 448)
        image = rng.randint(0, 256, (300, 410, 3), dtype=np.uint8)
        center, scale = (205.0, 150.0), 1.2
        pred, conf = predictor.predict_single(image, center, scale)
        ref = _serve_eager(predictor, _single(image, center, scale))
        _same_outputs("predict_single", {"pred": pred[None], "conf": conf[None]},
                      {"pred": ref["pred"], "conf": ref["conf"]})
        singles.append(predictor.graphs.captures)
    check(singles == [2, 2], f"captures after each predict_single: {singles}")
    predictor.model.load_state_dict(_serve_weights(cfg, SEED + 31))
    reloaded = predictor(*batches[0])
    _same_outputs("after load_state_dict", reloaded, _serve_eager(predictor, batches[0]))
    check(predictor.graphs.captures == 2, "load_state_dict (in place) captured again")
    check(not np.array_equal(reloaded["conf"], outs[0]["conf"]),
          "the graph did not read the weights loaded in place")
    emit("serve", config=cfg.name, stacks=cfg.model.stacks, feats=cfg.model.feats,
         batch=BATCH, batches=NUM_BATCHES, canvas=list(CANVAS), dtype="bfloat16",
         seconds=seconds, img_per_s=BATCH * NUM_BATCHES / seconds,
         eager_seconds=eager_s, eager_img_per_s=BATCH * NUM_BATCHES / eager_s,
         eager_path="pipelined, depth 2",
         graph_vs_eager="equal", captures=predictor.graphs.captures,
         capture_seconds=predictor.graphs.capture_seconds,
         pool_bytes=predictor.graphs.pool_bytes,
         device_busy_ms_per_batch=prof["device_busy_ms"] / NUM_BATCHES,
         idle_share=prof["idle_share"],
         eager_device_busy_ms_per_batch=prof_eager["device_busy_ms"] / NUM_BATCHES,
         eager_idle_share=prof_eager["idle_share"], launches=launches)
    return predictor, launches


def _eval_batch(rng, B, canvas, K, scale_range=(0.7, 1.0)):
    H, W = canvas
    vw = rng.randint(W * 2 // 3, W + 1, B)
    vh = rng.randint(H * 2 // 3, H + 1, B)
    valid_wh = np.stack([vw, vh], axis=1).astype(np.int32)
    center = (valid_wh / 2 + rng.uniform(-5, 5, (B, 2))).astype(np.float32)
    scale = (vh / 200.0 * rng.uniform(*scale_range, B)).astype(np.float32)
    box = 200.0 * scale
    pts = center[:, None, :] + rng.uniform(-0.4, 0.4, (B, K, 2)) * box[:, None, None]
    return {
        "image": rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8),
        "valid_wh": valid_wh,
        "center": center,
        "scale": scale,
        "pts": pts.astype(np.float32),
        "vis": (rng.rand(B, K) < 0.8).astype(np.float32),
        "mask": np.ones((B,), np.float32),
        "offset": np.zeros((B, 2), np.float32),
    }


def _same_eval(label, got, want):
    (mg, pg), (me, pe) = got, want
    for k in me:
        check(torch.equal(mg[k], me[k]), f"{label} {k}: graph {mg[k]} vs eager {me[k]}")
    err = (pg - pe).abs().max().item()
    check(torch.equal(pg, pe), f"{label} preds: graph vs eager {err}")


def phase_validate(cfg, predictor):
    """make_graphed_eval_step (Experiment's validation step) at the same
    width over NUM_BATCHES batches of 32, its targets from the CUDA
    rasterizer, against make_eval_step's eager step on the same batches and
    weights, bit for bit (metrics and predictions); every batch keeps its
    own predictions after the replays that follow it (the batches differ,
    so must they); img/s both ways; captures and the pool.  The launch
    counts are reset just before the graphed batches (the main path) and
    read just after, then again for the eager ones."""
    graphed = make_graphed_eval_step(predictor.model, cfg.aug, MPII_MEAN, device="cuda")
    eager = make_eval_step(predictor.model, cfg.aug, MPII_MEAN, device="cuda")
    rng = np.random.RandomState(SEED + 1)
    batches = [
        _eval_batch(rng, BATCH, CANVAS, cfg.model.classes)
        for _ in range(NUM_BATCHES)
    ]
    graphed(batches[0])  # captures the graph, not counted
    eager(batches[0])  # the eager step's cuDNN set-up
    torch.cuda.synchronize()

    reset_counters(RASTER, *HAND_OP_COUNTERS)
    t0 = time.perf_counter()
    results = [graphed(b) for b in batches]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"rasterize_gaussians": counter(RASTER), **_hand_op_launches()}
    check(launches["rasterize_gaussians"] == NUM_BATCHES,
          f"rasterizer launches in graphed validation: {launches}")
    _check_hand_ops("graphed validation", launches, NUM_BATCHES, 0)
    reset_counters(RASTER, *HAND_OP_COUNTERS)
    t0 = time.perf_counter()
    refs = [eager(b) for b in batches]
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager_launches = {"rasterize_gaussians": counter(RASTER), **_hand_op_launches()}
    check(eager_launches["rasterize_gaussians"] == NUM_BATCHES,
          f"rasterizer launches in eager validation: {eager_launches}")
    _check_hand_ops("eager validation", eager_launches, NUM_BATCHES, 0)
    check(graphed.graphs.captures == 1, f"captures {graphed.graphs.captures}")

    losses, accs, cnt = [], [], 0
    for i, (got, want) in enumerate(zip(results, refs)):
        _same_eval(f"validate batch {i}", got, want)
        metrics, preds = got
        loss, acc = metrics["loss"].item(), metrics["acc"].item()
        check(math.isfinite(loss), f"loss {loss}")
        check(-1.0 <= acc <= 1.0, f"acc {acc}")
        check(preds.shape == (BATCH, cfg.model.classes, 2), f"preds {preds.shape}")
        check(bool(torch.isfinite(preds).all()), "non-finite preds")
        losses.append(loss)
        accs.append(acc)
        cnt += int(metrics["pck_cnt"].sum())
    check(cnt > 0, "no valid PCK targets")
    check(not any(torch.equal(results[i][1], results[i + 1][1])
                  for i in range(NUM_BATCHES - 1)),
          "two validation batches kept the same predictions")
    emit("validate", config=cfg.name, batch=BATCH, batches=NUM_BATCHES,
         seconds=seconds, img_per_s=BATCH * NUM_BATCHES / seconds,
         eager_seconds=eager_s, eager_img_per_s=BATCH * NUM_BATCHES / eager_s,
         graph_vs_eager="equal", captures=graphed.graphs.captures,
         capture_seconds=graphed.graphs.capture_seconds,
         pool_bytes=graphed.graphs.pool_bytes, loss=losses, acc=accs, pck_cnt=cnt,
         launches=launches, eager_launches=eager_launches)
    return launches, eager_launches, graphed, eager


def phase_profile(cfg, graphed, eager):
    """Where one full-width validation step spends the card's time, through
    its graph and eagerly."""
    batch = _eval_batch(np.random.RandomState(SEED + 4), BATCH, CANVAS,
                        cfg.model.classes)
    graphed(batch)
    eager(batch)
    emit("profile", step="validate", graph=profile_run(lambda: graphed(batch)),
         eager=profile_run(lambda: eager(batch)))


def phase_parity():
    """Small f32 network, TF32 off: the card's validation step against the
    port's CPU path (plain rasterizer) on the same batch and weights."""
    cfg = named_config("hg2_mpii_mini")
    cfg.model.feats = 8
    cfg.model.bf16 = False
    cfg.aug.inp_res = (64, 64)
    cfg.aug.out_res = (16, 16)
    K = cfg.model.classes
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        torch.manual_seed(SEED + 2)
        m_cpu = hg(num_stacks=cfg.model.stacks, num_classes=K,
                   num_feats=cfg.model.feats, dtype=torch.float32)
        with torch.no_grad():  # non-trivial BN statistics
            for mod in m_cpu.modules():
                if isinstance(mod, torch.nn.BatchNorm2d):
                    mod.running_mean.normal_(0.0, 0.05)
                    mod.running_var.uniform_(0.8, 1.2)
        m_gpu = copy.deepcopy(m_cpu).cuda()
        batch = _eval_batch(np.random.RandomState(SEED + 3), 8, (96, 128), K)
        batch["mask"][-1] = 0.0
        mc, pc = make_eval_step(m_cpu, cfg.aug, MPII_MEAN, device="cpu")(batch)
        mg, pg = make_eval_step(m_gpu, cfg.aug, MPII_MEAN, device="cuda")(batch)

        scores = {}
        for dev, model in (("cpu", m_cpu), ("cuda", m_gpu)):
            with torch.no_grad():
                aug = augment_batch(
                    batch["image"], batch["valid_wh"], batch["center"],
                    batch["scale"], batch["pts"], batch["vis"],
                    neutral_params(8, dev), inp_res=cfg.aug.inp_res,
                    out_res=cfg.aug.out_res, mean=MPII_MEAN, device=dev,
                )
                scores[dev] = (model.eval()(aug["input"])[-1].cpu(),
                                aug["target"].cpu())
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev

    loss_c, loss_g = mc["loss"].item(), mg["loss"].item()
    check(abs(loss_c - loss_g) <= PARITY_ATOL + PARITY_RTOL * abs(loss_c),
          f"loss cpu {loss_c} vs cuda {loss_g}")
    s_c, s_g = scores["cpu"][0], scores["cuda"][0]
    score_err = (s_c - s_g).abs().max().item()
    check(torch.allclose(s_g, s_c, atol=PARITY_ATOL, rtol=PARITY_RTOL),
          f"scores differ by {score_err}")
    target_err = (scores["cpu"][1] - scores["cuda"][1]).abs().max().item()
    check(target_err <= RASTER_TOL, f"targets differ by {target_err}")
    for k in ("pck_hit", "pck_cnt"):
        check(torch.equal(mc[k], mg[k].cpu()), f"{k} cpu {mc[k]} vs cuda {mg[k]}")
    check(torch.equal(pc, pg.cpu()), "decoded predictions differ between cpu and cuda")
    emit("parity", loss_cpu=loss_c, loss_cuda=loss_g, score_max_abs_err=score_err,
         target_max_abs_err=target_err, pck_cnt=int(mc["pck_cnt"].sum()))


def _train_batch(rng, B, canvas, K, first_index):
    """An in-memory training batch: the eval batch's fields (no mask or
    offset) and the samples' global dataset indices, which key the draws."""
    b = _eval_batch(rng, B, canvas, K)
    del b["mask"], b["offset"]
    b["index"] = np.arange(first_index, first_index + B, dtype=np.int32)
    return b


def phase_train(cfg):
    """make_train_step at the full hg8_mpii width, bf16, batch 32, color
    jitter on, seeded weights: one warm-up step, then NUM_BATCHES timed
    steps ending in a synchronize.  The launch counts are reset just before
    the timed steps and read just after."""
    torch.manual_seed(SEED + 5)
    model = hg(num_stacks=cfg.model.stacks, num_classes=cfg.model.classes,
               num_feats=cfg.model.feats, depth=cfg.model.depth).cuda()
    check(cfg.aug.color_jitter, "the train phase runs with color jitter")
    opt = make_optimizer(model.parameters(), cfg.optim,
                         steps_per_epoch=MPII_TRAIN_SAMPLES // BATCH)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, cfg.aug, MPII_MEAN, seed=SEED, device="cuda")
    rng = np.random.RandomState(SEED + 6)
    batches = [_train_batch(rng, BATCH, CANVAS, cfg.model.classes, i * BATCH)
               for i in range(1 + NUM_BATCHES)]
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if k.endswith(("running_mean", "running_var"))}
    torch.cuda.reset_peak_memory_stats()
    step(state, batches[0])  # warm-up: cuDNN and cuBLAS set-up, not timed
    torch.cuda.synchronize()

    reset_counters(RASTER, *HAND_OP_COUNTERS)
    t0 = time.perf_counter()
    metrics = [step(state, b) for b in batches[1:]]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"rasterize_gaussians": counter(RASTER), **_hand_op_launches()}
    peak = torch.cuda.max_memory_allocated()

    check(launches["rasterize_gaussians"] == NUM_BATCHES,
          f"rasterizer launches in training: {launches}")
    _check_hand_ops("training", launches, NUM_BATCHES, NUM_BATCHES)
    losses = [m["loss"].item() for m in metrics]
    accs = [m["acc"].item() for m in metrics]
    for loss, acc in zip(losses, accs):
        check(math.isfinite(loss), f"train loss {loss}")
        check(-1.0 <= acc <= 1.0, f"train acc {acc}")
    check(state.step == 1 + NUM_BATCHES, f"state.step {state.step}")
    check(opt.count == 1 + NUM_BATCHES, f"optimizer count {opt.count}")
    moved = {n: not torch.equal(p.detach(), params0[n])
             for n, p in model.named_parameters()}
    still = [n for n, m in moved.items() if not m and n.endswith("weight")]
    check(not still, f"weights that did not move: {still[:5]}")
    stats = model.state_dict()
    still = [k for k, v in stats0.items() if torch.equal(stats[k], v)]
    check(not still, f"BatchNorm statistics that did not move: {still[:5]}")
    emit("train", config=cfg.name, stacks=cfg.model.stacks, feats=cfg.model.feats,
         batch=BATCH, steps=NUM_BATCHES, canvas=list(CANVAS), dtype="bfloat16",
         seconds=seconds, img_per_s=BATCH * NUM_BATCHES / seconds,
         loss=losses, acc=accs, step=state.step,
         params_moved=sum(moved.values()), params=len(moved),
         bn_stats_moved=len(stats0), max_memory_allocated=peak,
         launches=launches)
    return launches, state, step, batches[-1]


def phase_train_profile(state, step, batch):
    """Where one full-width train step spends the card's time."""
    emit("train_profile", step="train", **profile_run(lambda: step(state, batch)))


def _carry_to(state, dev, step_no):
    """A copy of ``state`` (model, optimizer moments and count) on ``dev``."""
    model = copy.deepcopy(state.model).to(dev)
    opt = make_optimizer(model.parameters(), OPT_CFG)
    named = dict(state.model.named_parameters())
    opt.load_carried(model, {
        "count": state.optimizer.count,
        "nu": {n: state.optimizer.state[p].get("nu", torch.zeros_like(p))
               for n, p in named.items()},
    })
    return TrainState(model, opt, step_no)


def _check_card_update(label, cpu_model, card_model, ref, before, nu_before, worst,
                       grad_want=None, grad_atol=TRAIN_GRAD_ATOL):
    """One step's gradients and update on the card against the CPU's, from
    one state (tolerances derived at TRAIN_GRAD_ATOL): the gradients within
    ``grad_atol`` of ``grad_want`` (default: the CPU's own); the update
    within the bound of one RMSprop step of that gap; the update against
    ``ref`` (a copy of the CPU state from before the step) stepped by the
    CPU optimizer on the card's own gradients.  ``before`` and
    ``nu_before`` are the CPU parameters and moments before the step."""
    lr, d, eps = OPT_CFG.lr, OPT_CFG.rms_decay, OPT_CFG.rms_eps
    ulp = 2.0**-23
    g_card = {n: p.grad.cpu() for n, p in card_model.named_parameters()}
    after = {n: p.detach().cpu() for n, p in card_model.named_parameters()}
    ref_params = dict(ref.model.named_parameters())
    for n, p in ref_params.items():
        p.grad = g_card[n]
    ref.optimizer.step()
    if grad_want is None:
        grad_want = {n: p.grad for n, p in cpu_model.named_parameters()}
    for n, p in cpu_model.named_parameters():
        gap = (g_card[n] - grad_want[n]).abs().max().item()
        check(gap <= grad_atol, f"{label}: grad {n} by {gap}")
        worst["grad"] = max(worst["grad"], gap)
        tol = torch.clamp(lr * grad_atol / torch.sqrt(d * nu_before[n] + eps),
                          max=2 * lr / math.sqrt(1 - d)) + 2 * ulp * p.detach().abs()
        ratio = ((after[n] - p.detach()).abs() / tol).max().item()
        check(ratio <= 1.0, f"{label}: update of {n} at {ratio} of its bound")
        worst["update_vs_bound"] = max(worst["update_vs_bound"], ratio)
        want = ref_params[n].detach()
        u = (want - before[n]).abs()
        tol = 6 * ulp * u + 2 * ulp * want.abs()
        ratio = ((after[n] - want).abs() / tol.clamp_min(1e-30)).max().item()
        check(ratio <= 1.0, f"{label}: card update of {n} vs the CPU "
                            f"optimizer at {ratio} of its bound")
        worst["update_vs_cpu_optimizer"] = max(worst["update_vs_cpu_optimizer"], ratio)


def phase_train_parity():
    """hg2_mpii_mini at feats 8, 64² input, f32, TF32 off: three train
    steps on the CPU; before each, the CPU's state is carried to the card
    and the card takes the same step from it.  The draws must agree (flips
    equal, scale and rotation to one float32 ulp), then the loss, the
    gradients, the update (against the bound of one RMSprop step, and
    against the CPU optimizer applied to the card's own gradients) and the
    BatchNorm statistics, each within the tolerances derived above; after
    the last step, the card's parameters and statistics against the CPU's."""
    cfg = named_config("hg2_mpii_mini")
    cfg.model.feats = 8
    cfg.model.bf16 = False
    cfg.aug.inp_res = (64, 64)
    cfg.aug.out_res = (16, 16)
    K, B = cfg.model.classes, 8
    rng = np.random.RandomState(SEED + 8)
    batches = [_train_batch(rng, B, (96, 128), K, 1000 + t * B)
               for t in range(TRAIN_PARITY_STEPS)]

    draws_err = 0.0
    for t, b in enumerate(batches):
        idx = torch.from_numpy(b["index"])
        kw = dict(scale_factor=cfg.aug.scale_factor, rot_factor=cfg.aug.rot_factor,
                  rot_prob=cfg.aug.rot_prob, flip_prob=cfg.aug.flip_prob,
                  scale_mode=cfg.aug.scale_mode)
        pc = sample_aug_params_ps(SEED, t, idx, **kw)
        pg = sample_aug_params_ps(SEED, t, idx.cuda(), **kw)
        check(torch.equal(pg.flip.cpu(), pc.flip), f"step {t}: flips differ")
        for name in ("scale_factor", "rot"):
            a, w = getattr(pg, name).cpu().numpy(), getattr(pc, name).numpy()
            err = np.abs(a - w)
            check((err <= np.spacing(np.abs(w))).all(), f"step {t}: {name} by {err.max()}")
            draws_err = max(draws_err, float(err.max()))

    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        torch.manual_seed(SEED + 7)
        model = hg(num_stacks=cfg.model.stacks, num_classes=K,
                   num_feats=cfg.model.feats, dtype=torch.float32)
        cpu = TrainState(model, make_optimizer(model.parameters(), OPT_CFG))
        cpu_step = make_train_step(model, cpu.optimizer, cfg.aug, MPII_MEAN,
                                   seed=SEED, device="cpu")
        worst = {"loss": 0.0, "grad": 0.0, "update_vs_bound": 0.0,
                 "update_vs_cpu_optimizer": 0.0, "stats": 0.0}
        losses = {"cpu": [], "cuda": []}
        for t, b in enumerate(batches):
            card = _carry_to(cpu, "cuda", t)
            ref = _carry_to(cpu, "cpu", t)  # the CPU optimizer, for the card's gradients
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            nu_before = {n: cpu.optimizer.state[p].get("nu", torch.zeros_like(p)).clone()
                         for n, p in model.named_parameters()}
            card_step = make_train_step(card.model, card.optimizer, cfg.aug, MPII_MEAN,
                                        seed=SEED, device="cuda")
            mg = card_step(card, b)
            mc = cpu_step(cpu, b)
            torch.cuda.synchronize()
            lc, lg = mc["loss"].item(), mg["loss"].item()
            losses["cpu"].append(lc)
            losses["cuda"].append(lg)
            check(abs(lc - lg) <= PARITY_ATOL + PARITY_RTOL * abs(lc),
                  f"step {t}: loss cpu {lc} vs cuda {lg}")
            worst["loss"] = max(worst["loss"], abs(lc - lg))
            _check_card_update(f"step {t}", model, card.model, ref, before, nu_before,
                               worst)
            sd_c, sd_g = model.state_dict(), card.model.state_dict()
            for k in sd_c:
                if k.endswith(("running_mean", "running_var")):
                    w, g = sd_c[k], sd_g[k].cpu()
                    check(torch.allclose(g, w, atol=TRAIN_STATS_ATOL, rtol=TRAIN_STATS_RTOL),
                          f"step {t}: {k} by {(g - w).abs().max().item()}")
                    worst["stats"] = max(worst["stats"], (g - w).abs().max().item())
        check(cpu.step == card.step == TRAIN_PARITY_STEPS, "step counts")
        check(cpu.optimizer.count == card.optimizer.count == TRAIN_PARITY_STEPS,
              "optimizer counts")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    emit("train_parity", steps=TRAIN_PARITY_STEPS, batch=B, loss_cpu=losses["cpu"],
         loss_cuda=losses["cuda"], draws_max_abs_err=draws_err,
         **{f"max_{k}": v for k, v in worst.items()})


def _joint_state(cfg, dev, seed, widths=(32, 64, 128, 256),
                 steps_per_epoch=MPII_TRAIN_SAMPLES // BATCH, **step_kw):
    """Seeded pose network and agent of ``cfg`` on ``dev``, their
    optimizers, and the options of ``make_joint_step`` for them."""
    torch.manual_seed(seed)
    pose = hg(num_stacks=cfg.model.stacks, num_classes=cfg.model.classes,
              num_feats=cfg.model.feats, depth=cfg.model.depth,
              dtype=torch.bfloat16 if cfg.model.bf16 else torch.float32).to(dev)
    pose_opt = make_optimizer(pose.parameters(), cfg.optim,
                              steps_per_epoch=steps_per_epoch)
    agent, agent_opt, kw = agent_from_config(cfg, steps_per_epoch=steps_per_epoch,
                                             widths=widths, device=dev)
    kw.update(step_kw)
    return JointState(TrainState(pose, pose_opt), TrainState(agent, agent_opt)), kw


def _pose_forwards(kw):
    """The pose network's forwards a joint step of options ``kw`` runs: the
    reward's reference forward where it has one and does not mix the
    reference crops into the train batch, and the train forward."""
    ref = kw.get("ref_baseline", True) and not kw.get("pose_ref_weight", 0.0)
    return 2 if ref else 1


def _joint_step_for(state, cfg, dev, kw):
    return make_joint_step(state.pose.model, state.agent.model, state.pose.optimizer,
                           state.agent.optimizer, cfg.aug, MPII_MEAN, seed=SEED,
                           device=dev, **kw)


def phase_joint(cfg):
    """make_joint_step at full width (8 stacks, 128 features, 256² input;
    the agent's widths (32, 64, 128, 256) at input_downscale 2), bf16,
    batch 32, color jitter on, seeded weights: one warm-up step, then
    JOINT_STEPS timed steps ending in a synchronize.  The launch counts are
    reset just before the timed steps and read just after."""
    steps = JOINT_STEPS[cfg.name]
    check(cfg.aug.color_jitter and cfg.model.bf16, "the joint phase runs bf16 with jitter")
    state, kw = _joint_state(cfg, "cuda", SEED + 10)
    step = _joint_step_for(state, cfg, "cuda", kw)
    agent = state.agent.model
    rng = np.random.RandomState(SEED + 11)
    batches = [_train_batch(rng, BATCH, CANVAS, cfg.model.classes, i * BATCH)
               for i in range(1 + steps)]
    agent0 = {n: p.detach().clone() for n, p in agent.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    step(state, batches[0])  # warm-up: cuDNN and cuBLAS set-up, not timed
    torch.cuda.synchronize()

    reset_counters(RASTER, *HAND_OP_COUNTERS)
    t0 = time.perf_counter()
    metrics = [step(state, b) for b in batches[1:]]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"rasterize_gaussians": counter(RASTER), **_hand_op_launches()}
    peak = torch.cuda.max_memory_allocated()

    check(launches["rasterize_gaussians"] == JOINT_RASTER_LAUNCHES * steps,
          f"rasterizer launches in the joint steps: {launches}")
    _check_hand_ops(f"{cfg.name} joint steps", launches, _pose_forwards(kw) * steps, steps)
    values = {k: [m[k].item() for m in metrics] for k in metrics[0]}
    for k, vs in values.items():
        check(all(math.isfinite(v) for v in vs), f"joint {k} {vs}")
    check(all(-1.0 <= a <= 1.0 for a in values["acc"]), f"joint acc {values['acc']}")
    check(state.step == state.pose.step == 1 + steps, f"joint step {state.step}")
    check(state.agent.step == state.agent.optimizer.count == 1 + steps,
          f"agent step {state.agent.step}, count {state.agent.optimizer.count}")
    # a one-cell head (the tree's 1x1 level) has log-prob 0 whatever its
    # logit, so its gradient is exactly 0 and it never moves
    fixed = {f"{n}.{w}" for n, mod in agent.named_modules()
             if isinstance(mod, torch.nn.Linear) and mod.out_features == 1
             for w in ("weight", "bias")}
    moved = {n: not torch.equal(p.detach(), agent0[n]) for n, p in agent.named_parameters()
             if n not in fixed}
    check(all(moved.values()), f"agent parameters that did not move: "
                               f"{[n for n, m in moved.items() if not m][:5]}")
    emit("joint", config=cfg.name, stacks=cfg.model.stacks, feats=cfg.model.feats,
         joints=cfg.model.classes, agent_widths=list(agent.widths),
         agent_input_downscale=agent.input_downscale,
         occ_mode=agent.occ_mode if agent.num_occ_nodes else None,
         occ_nodes=agent.num_occ_nodes, batch=BATCH, steps=steps, canvas=list(CANVAS),
         dtype="bfloat16", seconds=seconds, img_per_s=BATCH * steps / seconds,
         max_memory_allocated=peak, launches=launches,
         raster_launches_per_step=launches["rasterize_gaussians"] / steps,
         agent_params_moved=sum(moved.values()), agent_params=len(moved),
         agent_params_fixed=sorted(fixed), **values)
    return launches, state, step, batches[-1]


def phase_joint_profile(state, step, batch):
    """Where one full-width hg8_mpii_asr joint step spends the card's time."""
    emit("joint_profile", step="joint", **profile_run(lambda: step(state, batch)))


@contextlib.contextmanager
def _recording():
    """What the joint steps draw and compute, by device: the draws, the
    per-sample losses, the advantage before and after normalization, the
    policy's log-probs and the agent's input.  The joint step reads these
    functions by their module-level names."""
    rec = {"cpu": {"losses": []}, "cuda": {"losses": []}}
    names = ("sample_policy", "per_sample_stacked_mse", "normalize_advantage",
             "policy_logp")
    orig = {n: getattr(adversarial, n) for n in names}

    def sample_policy(seed, step, index, logits, *args):
        out = orig["sample_policy"](seed, step, index, logits, *args)
        rec[index.device.type].update(draws=out, logits=logits)
        return out

    def mse(outs, target):
        out = orig["per_sample_stacked_mse"](outs, target)
        rec[out.device.type]["losses"].append(out.detach())
        return out

    def normalize(gap, baseline, group=None):
        out = orig["normalize_advantage"](gap, baseline, group)
        rec[gap.device.type].update(gap=gap, adv=out)
        return out

    def logp(logits, extras):
        out = orig["policy_logp"](logits, extras)
        rec[out.device.type].update(logp=out.detach(), extras=extras)
        return out

    for n, f in zip(names, (sample_policy, mse, normalize, logp)):
        setattr(adversarial, n, f)
    try:
        yield rec
    finally:
        for n, f in orig.items():
            setattr(adversarial, n, f)


def _flat_logits(logits):
    out = {k: v for k, v in logits.items() if k != "occ_cells"}
    out.update({f"occ_cells{i}": c for i, c in enumerate(logits.get("occ_cells", ()))})
    return out


def _agent_snapshot(ts):
    return ({n: p.detach().clone() for n, p in ts.model.named_parameters()},
            {n: b.clone() for n, b in ts.model.named_buffers()},
            {n: ts.optimizer.state[p].get("nu", torch.zeros_like(p)).clone()
             for n, p in ts.model.named_parameters()},
            ts.optimizer.count, ts.step)


def _same_snapshot(a, b):
    return all(all(torch.equal(x[n], y[n].to(x[n].device)) for n in x)
               for x, y in zip(a[:3], b[:3])) and a[3:] == b[3:]


def _check_joint_metrics(label, mc, mg, rc, rg, worst):
    """The card's joint step against the CPU's from one state.  Each f32
    forward value v (a per-sample loss, a logit) is held to PARITY_ATOL +
    PARITY_RTOL*|v|; from those: the advantage by the mean over samples of
    its two losses' bounds d_i; the normalized advantage by (d_i + d +
    |adv_i|*d)/s, s its denominator and d the largest d_i (the moments move
    by at most d); log_softmax by twice the logits' gap per head on the
    path; agent_loss = -mean(adv*logp) and the entropy by what those move
    (|dH| <= 2*max|dx|*max|log p|, plus 1e-6 for its own float32 sums:
    8 ulps at 1.9 nats)."""
    lc, lg = mc["loss"].item(), mg["loss"].item()
    check(abs(lc - lg) <= PARITY_ATOL + PARITY_RTOL * abs(lc),
          f"{label}: loss cpu {lc} vs cuda {lg}")
    worst["loss"] = max(worst["loss"], abs(lc - lg))
    check(abs(mc["acc"].item() - mg["acc"].item()) <= 0.1, f"{label}: acc")
    for a, b in zip(rc["losses"], rg["losses"]):
        check(((a - b.cpu()).abs() <= PARITY_ATOL + PARITY_RTOL * a.abs()).all(),
              f"{label}: per-sample losses")
    xc, xg = _flat_logits(rc["logits"]), _flat_logits(rg["logits"])
    dx = max((xc[k] - xg[k].cpu()).abs().max().item() for k in xc)
    check(all(((xc[k] - xg[k].cpu()).abs() <= PARITY_ATOL + PARITY_RTOL * xc[k].abs()).all()
              for k in xc), f"{label}: agent logits by {dx}")
    worst["logits"] = max(worst["logits"], dx)
    max_logp = max(torch.log_softmax(v, -1).abs().max().item() for v in xc.values())
    gap_h = abs(mc["entropy"].item() - mg["entropy"].item())
    check(gap_h <= 2 * dx * max_logp + 1e-6, f"{label}: entropy by {gap_h}")

    B = rc["gap"].shape[0]
    l_adv = rc["losses"][-1][:B]
    l_ref = l_adv - rc["gap"]
    d_i = 2 * PARITY_ATOL + PARITY_RTOL * (l_adv.abs() + l_ref.abs())
    gap_a = abs(mc["advantage"].item() - mg["advantage"].item())
    check(gap_a <= d_i.mean().item(), f"{label}: advantage by {gap_a}")
    adv, gap = rc["adv"], rc["gap"]
    s = torch.sqrt(torch.clamp((gap * gap).mean() - gap.mean() ** 2, min=0.0)) + 1e-6
    d = d_i.max()
    dadv = (d_i + d + adv.abs() * d) / s + 8 * 2.0**-23 * (1 + adv.abs())
    err = (rg["adv"].cpu() - adv).abs()
    check((err <= dadv).all(), f"{label}: normalized advantage by {err.max().item()}")
    ex = rc["extras"]
    terms = 2 + (2 if "occ_lvl" in ex else 1 if "oi" in ex else 0)
    dlogp = 2 * dx * terms
    bound = ((rc["logp"].abs() * dadv).mean() + adv.abs().mean() * dlogp).item()
    gap_l = abs(mc["agent_loss"].item() - mg["agent_loss"].item())
    check(gap_l <= bound, f"{label}: agent_loss by {gap_l} (bound {bound})")
    worst["agent_loss_vs_bound"] = max(worst["agent_loss_vs_bound"], gap_l / bound)


def _check_stats_close(label, cpu_model, card_model, worst):
    sd_c, sd_g = cpu_model.state_dict(), card_model.state_dict()
    for k in sd_c:
        if k.endswith(("running_mean", "running_var")):
            w, g = sd_c[k], sd_g[k].cpu()
            check(torch.allclose(g, w, atol=TRAIN_STATS_ATOL, rtol=TRAIN_STATS_RTOL),
                  f"{label}: {k} by {(g - w).abs().max().item()}")
            worst["stats"] = max(worst["stats"], (g - w).abs().max().item())


def phase_joint_parity():
    """hg8_mpii_asr cut to 2 stacks at feats 8 and hourglass depth 2 (as
    tests/torch_joint_harness.py), agent widths (8, 16), 5 scale and 5
    rotation bins, 64² crops, f32, TF32 off, for each of
    JOINT_PARITY_CASES: two joint steps on the CPU; before each, the CPU's
    state is carried to the card and the card takes the same step from it.
    The draws must be equal (bins, occlusion node/level/cell, flips, the
    reference crop's parameters, jitter), the metrics within the bounds of
    _check_joint_metrics, the pose update within the bounds of train_parity
    at JOINT_GRAD_ATOL, the agent's at TRAIN_GRAD_ATOL (its gradient held
    to the CPU's gradient of the same objective with the card's
    advantages), the BatchNorm statistics
    within TRAIN_STATS_*, and on a non-update step the agent (parameters,
    statistics, moments, count, step) unchanged on both."""
    K, B = 16, 8
    worst = {"loss": 0.0, "grad": 0.0, "update_vs_bound": 0.0,
             "update_vs_cpu_optimizer": 0.0, "stats": 0.0, "logits": 0.0,
             "agent_loss_vs_bound": 0.0}
    cases = []
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for c, (name, agent_fields, step_kw) in enumerate(JOINT_PARITY_CASES):
            cfg = named_config("hg8_mpii_asr")
            cfg.model.stacks, cfg.model.feats, cfg.model.bf16 = 2, 8, False
            cfg.model.depth = 2  # the deepest BatchNorms see 4x4, not 1x1
            cfg.aug.inp_res, cfg.aug.out_res = (64, 64), (16, 16)
            cfg.optim = copy.deepcopy(OPT_CFG)
            cfg.agent.scale_bins = cfg.agent.rot_bins = 5
            cfg.agent.occ_levels = (1, 2)
            for k, v in agent_fields.items():
                setattr(cfg.agent, k, v)
            cpu, kw = _joint_state(cfg, "cpu", SEED + 12 + c, widths=(8, 16),
                                   steps_per_epoch=1, **step_kw)
            cpu_step = _joint_step_for(cpu, cfg, "cpu", kw)
            seen = {}
            cpu.agent.model.register_forward_pre_hook(
                lambda mod, args: seen.__setitem__("x", args[0].detach().clone()))
            rng = np.random.RandomState(SEED + 13 + c)
            draws_equal, agent_updates = 0, 0
            for t in range(JOINT_PARITY_STEPS):
                b = _train_batch(rng, B, (96, 128), K, 3000 + t * B)
                label = f"joint_parity {name} step {t}"
                card = JointState(_carry_to(cpu.pose, "cuda", t),
                                  _carry_to(cpu.agent, "cuda", cpu.agent.step), t)
                ref_pose = _carry_to(cpu.pose, "cpu", t)
                ref_agent = _carry_to(cpu.agent, "cpu", cpu.agent.step)
                agent_before = copy.deepcopy(cpu.agent.model)
                nets = {}
                for net in ("pose", "agent"):
                    ts = getattr(cpu, net)
                    nets[net] = (
                        {n: p.detach().clone() for n, p in ts.model.named_parameters()},
                        {n: ts.optimizer.state[p].get("nu", torch.zeros_like(p)).clone()
                         for n, p in ts.model.named_parameters()})
                start = _agent_snapshot(card.agent), _agent_snapshot(cpu.agent)
                card_step = _joint_step_for(card, cfg, "cuda", kw)
                with _recording() as rec:
                    mg = card_step(card, b)
                    mc = cpu_step(cpu, b)
                    torch.cuda.synchronize()
                rc, rg = rec["cpu"], rec["cuda"]
                (ec, ac, pc, jc), (eg, ag, pg, jg) = rc["draws"], rg["draws"]
                check(set(ec) == set(eg) and all(torch.equal(ec[k], eg[k].cpu()) for k in ec),
                      f"{label}: agent draws differ")
                check(all(torch.equal(x, y.cpu()) for x, y in zip((*ac, *pc), (*ag, *pg))),
                      f"{label}: augmentation draws differ")
                check(torch.equal(jc, jg.cpu()), f"{label}: jitter differs")
                draws_equal += 1
                _check_joint_metrics(label, mc, mg, rc, rg, worst)
                _check_card_update(f"{label} pose", cpu.pose.model, card.pose.model,
                                   ref_pose, *nets["pose"], worst,
                                   grad_atol=JOINT_GRAD_ATOL)
                _check_stats_close(f"{label} pose", cpu.pose.model, card.pose.model, worst)
                if t % kw["update_every"] == 0:
                    agent_before.train()
                    objective = -(rg["adv"].cpu() * adversarial.policy_logp(
                        agent_before(seen["x"]), rc["extras"])).mean()
                    objective.backward()
                    want = {n: p.grad for n, p in agent_before.named_parameters()}
                    _check_card_update(f"{label} agent", cpu.agent.model, card.agent.model,
                                       ref_agent, *nets["agent"], worst, grad_want=want)
                    agent_updates += 1
                else:
                    check(_same_snapshot(start[0], _agent_snapshot(card.agent)),
                          f"{label}: the card's agent moved on a non-update step")
                    check(_same_snapshot(start[1], _agent_snapshot(cpu.agent)),
                          f"{label}: the CPU's agent moved on a non-update step")
                _check_stats_close(f"{label} agent", cpu.agent.model, card.agent.model, worst)
                check(card.step == cpu.step == t + 1, f"{label}: step counts")
            cases.append({"case": name, "occ_mode": cpu.agent.model.occ_mode,
                          "occ_nodes": cpu.agent.model.num_occ_nodes, **step_kw,
                          "steps": JOINT_PARITY_STEPS, "draws_equal": draws_equal,
                          "agent_updates": agent_updates})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    emit("joint_parity", batch=B, cases=cases, **{f"max_{k}": v for k, v in worst.items()})

def _route_probe():
    """What the machine decodes with, and the decode routes this run
    takes: "pil" where Pillow imports, "native" where the C++ pool builds,
    "gpu" where the card's route builds and starts on the card."""
    try:
        import PIL

        pillow = PIL.__version__
    except ImportError:
        pillow = None
    gxx = shutil.which("g++")
    header = bool(gxx) and subprocess.run(
        [gxx, "-x", "c++", "-fsyntax-only", "-"],
        input="#include <cstddef>\n#include <cstdio>\n#include <jpeglib.h>\n",
        capture_output=True, text=True, timeout=60).returncode == 0
    ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                              timeout=60).stdout
    libjpeg = sorted({ln.split()[0] for ln in ldconfig.splitlines()
                      if "libjpeg" in ln})
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    try:
        import matplotlib  # noqa: F401

        mpl = True
    except ImportError:
        mpl = False
    routes, native_error, gpu_error = [], None, None
    if pillow:
        routes.append("pil")
    try:
        from posetpu_torch.native import NativeDecoder

        NativeDecoder(num_threads=1).close()
        routes.append("native")
    except Exception as e:  # no g++ or no libjpeg: the route is absent
        lines = str(e).strip().splitlines()
        native_error = next((ln for ln in lines if "error" in ln), lines[-1])[:200]
    try:
        GpuJpegDecoder("cuda").close()
        routes.append("gpu")
    except Exception as e:
        lines = str(e).strip().splitlines() or [repr(e)]
        gpu_error = next((ln for ln in lines if "error" in ln), lines[-1])[:200]
    try:
        import tensorboard

        tb = tensorboard.__version__
    except ImportError:
        tb = None
    shm = shutil.disk_usage("/dev/shm").total if os.path.isdir("/dev/shm") else None
    return dict(pillow=pillow, gxx=gxx, jpeglib_header=header, libjpeg=libjpeg,
                cpu_count=os.cpu_count(), matplotlib=mpl, routes=routes,
                native_error=native_error, gpu_error=gpu_error, tensorboard=tb,
                dev_shm_bytes=shm,
                worker_start_method=WORKER_START_METHOD)


def phase_host():
    info = _route_probe()
    check(info["routes"], "no decode route: neither Pillow nor the native pool")
    emit("host", **info)
    check("gpu" in info["routes"], f"the card's decode route does not start: {info['gpu_error']}")
    return info["routes"], info["tensorboard"] is not None


class _Cycled:
    """``n`` samples that cycle through ``ds``'s, the same JPEGs: an epoch
    long enough to time the workers' steady rate.  At module level, so the
    workers can unpickle it."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def image_path(self, i):
        return self.ds.image_path(i % len(self.ds))

    def meta(self, i):
        return self.ds.meta(i % len(self.ds))


def _host_batches(loader):
    """One epoch of ``loader``'s batches on the host only, and the ms the
    consumer waited for each (the workers' start falls in the first)."""
    gen, got, host_ms = loader._batches(loader._order()), [], []
    while True:
        t0 = time.perf_counter()
        b = next(gen, None)
        if b is None:
            return got, host_ms
        host_ms.append(1e3 * (time.perf_counter() - t0))
        got.append(b)


def phase_loader(routes, workdir):
    """One epoch per decode route at MPII's image size, batch 32: host-only
    (decode ms a batch), then through the CUDA batch placer (img/s over the
    epoch, copy ms a batch, bytes a batch).  The placed batches equal the
    host ones exactly; the routes agree."""
    check("pil" in routes, "the loader phase writes its JPEGs with Pillow")
    root = os.path.join(workdir, "loader")
    t0 = time.perf_counter()
    # the validation images come after the train ones: the train JPEGs are
    # those of a split without them (fit_jpeg_gpu validates on them)
    make_synthetic_dataset(root, num_train=LOADER_IMAGES, num_val=LOADER_VAL, res=LOADER_RES,
                           seed=SEED)
    make_s = time.perf_counter() - t0
    ds = MpiiDataset(os.path.join(root, "annotations.json"),
                     os.path.join(root, "images"), split="train")
    results, host = [], {}
    for route in routes:
        host[route], decode_ms = _host_batches(
            HostLoader(ds, BATCH, pad_hw=LOADER_PAD, seed=SEED, backend=route))
        placer = make_batch_placer("cuda")
        loader = HostLoader(ds, BATCH, pad_hw=LOADER_PAD, seed=SEED, backend=route,
                            place=placer)
        check(loader.backend == route, f"loader route {loader.backend} != {route}")
        torch.cuda.synchronize()
        since = REGISTRY.watermark()
        t0 = time.perf_counter()
        placed = []
        with REGISTRY.forced_on():  # the placer's copies as device spans
            for b in loader:
                b["image"].sum(dtype=torch.int64)  # a consumer on the compute stream
                placed.append(b)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(len(placed) == len(host[route]) == LOADER_IMAGES // BATCH,
              f"{route}: {len(placed)} placed batches")
        for d, h in zip(placed, host[route]):
            check(set(d) == set(h), f"{route}: keys {sorted(d)}")
            for k, v in h.items():
                got = d[k].cpu().numpy()
                check(d[k].is_cuda and got.dtype == v.dtype and np.array_equal(got, v),
                      f"{route}: placed {k} differs from the host batch")
        nbytes = sum(v.nbytes for v in host[route][0].values())
        copy_ms = _place_ms(since)
        results.append({"route": route, "img_per_s": LOADER_IMAGES / seconds,
                        "decode_ms_per_batch": decode_ms,
                        "copy_ms_per_batch": copy_ms, "bytes_per_batch": nbytes,
                        "copy_gb_per_s": [nbytes / (ms * 1e6) for ms in copy_ms]})
    workers = [_worker_epochs(ds, n, host["pil"]) for n in LOADER_WORKERS]
    agree = {}
    for route in routes[1:]:
        lsb = 0
        for a, b in zip(host[routes[0]], host[route]):
            lsb = max(lsb, int(np.abs(a["image"].astype(np.int16)
                                      - b["image"].astype(np.int16)).max()))
            for k in a:
                if k != "image":
                    check(np.array_equal(a[k], b[k]), f"{route} vs {routes[0]}: {k}")
        bound = JPEG_LSB if route == "gpu" else LOADER_LSB
        check(lsb <= bound, f"{route} vs {routes[0]}: images {lsb} LSB apart")
        agree[route] = lsb
    emit("loader", images=LOADER_IMAGES, res=list(LOADER_RES), pad_hw=list(LOADER_PAD),
         batch=BATCH, synth_seconds=make_s, routes=results, max_lsb_vs_first=agree,
         workers=workers)
    return root, results, workers


def _place_ms(since):
    """The card's ms of each placer copy traced since ``REGISTRY.watermark()``
    gave ``since``: the device spans ``loader.place``."""
    return [r.ms for r in REGISTRY.records("loader.place", since) if r.device]


def _worker_epochs(ds, n, want):
    """WorkerLoader with ``n`` processes: one epoch on the host only (ms a
    batch as the consumer waits for it), one through the CUDA placer (img/s
    over the epoch), both equal to the Pillow route's host batches ``want``
    exactly; then one epoch of LOADER_STEADY_IMAGES on the host only, its
    img/s over the batches after the first."""
    got, host_ms = _host_batches(
        WorkerLoader(ds, BATCH, pad_hw=LOADER_PAD, seed=SEED, num_workers=n))
    placer = make_batch_placer("cuda")
    loader = WorkerLoader(ds, BATCH, pad_hw=LOADER_PAD, seed=SEED, num_workers=n,
                          place=placer)
    torch.cuda.synchronize()
    since = REGISTRY.watermark()
    t0 = time.perf_counter()
    placed = []
    with REGISTRY.forced_on():  # the placer's copies as device spans
        for b in loader:
            b["image"].sum(dtype=torch.int64)  # a consumer on the compute stream
            placed.append(b)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(len(got) == len(placed) == len(want), f"{n} workers: {len(got)}, {len(placed)} batches")
    for h, d, w in zip(got, placed, want):
        for k, v in w.items():
            check(np.array_equal(np.asarray(h[k]), v), f"{n} workers: host {k} differs from Pillow")
            check(d[k].is_cuda and np.array_equal(d[k].cpu().numpy(), v),
                  f"{n} workers: placed {k} differs from Pillow")
    steady, steady_ms = _host_batches(WorkerLoader(
        _Cycled(ds, LOADER_STEADY_IMAGES), BATCH, pad_hw=LOADER_PAD, seed=SEED,
        num_workers=n))
    check(len(steady) == LOADER_STEADY_IMAGES // BATCH, f"{n} workers: {len(steady)} batches")
    del steady
    return {"workers": n, "img_per_s": LOADER_IMAGES / seconds,
            "host_ms_per_batch": host_ms, "copy_ms_per_batch": _place_ms(since),
            "steady_images": LOADER_STEADY_IMAGES, "steady_host_ms_per_batch": steady_ms,
            "steady_img_per_s": BATCH * (len(steady_ms) - 1) * 1e3 / sum(steady_ms[1:])}


@contextlib.contextmanager
def _loader_routes():
    """Records the decode route of every Experiment built inside: a list
    of (train loader's backend, validation loader's)."""
    from posetpu_torch.train import loop

    seen, init = [], loop.Experiment.__init__

    def recording(self, *args, **kw):
        init(self, *args, **kw)
        seen.append((self.loader.backend, self.val_loader.backend))

    loop.Experiment.__init__ = recording
    try:
        yield seen
    finally:
        loop.Experiment.__init__ = init


def _cli(main, argv):
    """Call a CLI's main in this process with the kernels' counts reset
    just before; returns (result, rasterizer launches, stdout, decode),
    decode: the idct_islow and ycc_canvas kernels' launches and each
    Experiment's (train, validation) decode routes."""
    buf = io.StringIO()
    reset_counters(RASTER)
    reset_counters(islow.IDCT_LAUNCHES, ycc.YCC_LAUNCHES)
    with contextlib.redirect_stdout(buf), _loader_routes() as routes:
        result = main(argv)
    torch.cuda.synchronize()
    launches = counter(RASTER)
    print(buf.getvalue(), end="", file=sys.stderr, flush=True)
    decode = {"ycc_canvas": counter(ycc.YCC_LAUNCHES),
              "idct_islow": counter(islow.IDCT_LAUNCHES), "routes": routes}
    return result, launches, buf.getvalue(), decode


def _check_decode(label, decode, route="gpu"):
    """Every Experiment of a run decoded through ``route`` ("gpu" for the
    host loader on the card; the worker loader's processes keep Pillow),
    and the idct_islow and ycc_canvas kernels launched where the card's
    route decoded, once each a batch."""
    check(decode["routes"] and all(r == (route, route) for r in decode["routes"]),
          f"{label}: decode routes {decode['routes']}, want {route}")
    check((decode["ycc_canvas"] > 0) == (route == "gpu")
          and decode["idct_islow"] == decode["ycc_canvas"],
          f"{label}: ycc_canvas launched {decode['ycc_canvas']} times, "
          f"idct_islow {decode['idct_islow']}")


def _img_per_s(out):
    return [float(x) for x in re.findall(r"\| ([0-9.]+) img/s", out)]


def _check_run(label, run_dir, rows, steps_total):
    """log.txt rows with finite losses, the ckpt/ layout (the newest 3
    epochs), best/ where a validation improved, and the last checkpoint's
    update count and step."""
    with open(os.path.join(run_dir, "log.txt")) as f:
        lines = f.read().splitlines()
    check(lines[0].split("\t") == ["Epoch", "LR", "Train Loss", "Val Loss",
                                   "Train Acc", "Val Acc"], f"{label}: log header")
    vals = [[float(x) for x in ln.split("\t")] for ln in lines[1:]]
    check(len(vals) == rows and [v[0] for v in vals] == list(range(rows)),
          f"{label}: log rows {lines[1:]}")
    check(all(math.isfinite(v[2]) and math.isfinite(v[3]) for v in vals),
          f"{label}: non-finite losses")
    kept = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
    check(kept == [f"{e:05d}" for e in range(max(0, rows - 3), rows)],
          f"{label}: ckpt/ holds {kept}")
    best = os.path.isdir(os.path.join(run_dir, "best"))
    check(best == (max(v[5] for v in vals) > 0), f"{label}: best/ {best}")
    last = CheckpointManager(run_dir).load()
    st = last["state"]
    pose = st.get("pose", st)
    check(last["epoch"] == rows - 1, f"{label}: last epoch {last['epoch']}")
    check(pose["count"] == pose["step"] == steps_total and st["step"] == steps_total,
          f"{label}: count {pose['count']}, step {pose['step']}, want {steps_total}")
    return vals, best


def phase_fit(workdir):
    """train.cli.main at full hg8_mpii width, bf16, batch 32 on the
    synthetic split: 2 epochs, then --resume auto to 3, then eval.cli.main.
    The rasterizer launches once per train step (a CUDA graph of one step,
    K = 1) and per validation batch, and once per warm-up step before each
    run's capture."""
    ckpt = os.path.join(workdir, "fit")
    common = ["--config", "hg8_mpii", "--synthetic", "--train-batch", str(BATCH),
              "--checkpoint", ckpt]
    run_dir = os.path.join(ckpt, "hg8_mpii")
    per_epoch = FIT_STEPS + FIT_VAL_BATCHES
    t0 = time.perf_counter()
    rc, l1, out1, d1 = _cli(train_cli.main, common + ["--epochs", str(FIT_EPOCHS)])
    s1 = time.perf_counter() - t0
    check(rc == 0, f"train cli returned {rc}")
    _check_decode("fit", d1)
    check(d1["ycc_canvas"] == FIT_EPOCHS * per_epoch,
          f"fit: ycc_canvas launches {d1['ycc_canvas']}, want one a decoded batch")
    want1 = FIT_EPOCHS * per_epoch + WARMUP_STEPS + EVAL_WARMUP
    check(l1 == want1, f"fit launches {l1}, want {want1}")
    _check_run("fit", run_dir, FIT_EPOCHS, FIT_EPOCHS * FIT_STEPS)
    t0 = time.perf_counter()
    rc, l2, out2, d2 = _cli(train_cli.main, common + ["--epochs", str(FIT_RESUME_EPOCHS),
                                                      "--resume", "auto"])
    s2 = time.perf_counter() - t0
    check(rc == 0, f"resumed train cli returned {rc}")
    _check_decode("fit resumed", d2)
    extra = FIT_RESUME_EPOCHS - FIT_EPOCHS
    check(l2 == extra * per_epoch + WARMUP_STEPS + EVAL_WARMUP, f"resumed fit launches {l2}")
    # the resumed run restored count and step (4) and added its 2 steps
    vals, best = _check_run("fit resumed", run_dir, FIT_RESUME_EPOCHS,
                            FIT_RESUME_EPOCHS * FIT_STEPS)
    t0 = time.perf_counter()
    pckh, l3, out3, d3 = _cli(eval_cli.main, common + (["--best"] if best else []))
    s3 = time.perf_counter() - t0
    _check_decode("fit eval", d3)
    check(math.isfinite(pckh) and 0.0 <= pckh <= 100.0, f"PCKh {pckh}")
    check("PCKh@0.5" in out3, "eval printed no PCKh@0.5")
    check(l3 == FIT_VAL_BATCHES + EVAL_WARMUP, f"eval launches {l3}")
    preds = load_preds(os.path.join(run_dir, "preds.mat"))
    check(preds.shape == (16, 16, 2) and np.isfinite(preds).all(), f"preds {preds.shape}")
    emit("fit", config="hg8_mpii", batch=BATCH, epochs=FIT_EPOCHS,
         resumed_to=FIT_RESUME_EPOCHS, steps_per_epoch=FIT_STEPS,
         val_batches=FIT_VAL_BATCHES, seconds=[s1, s2, s3],
         images_per_sec=_img_per_s(out1) + _img_per_s(out2), log=vals,
         best_written=best, eval_from="best" if best else "latest", pckh=pckh,
         launches={"train": l1, "resumed": l2, "eval": l3},
         launches_per_epoch=per_epoch, warmup_steps=WARMUP_STEPS,
         decode_routes=d1["routes"] + d2["routes"] + d3["routes"],
         ycc_canvas_launches=[d1["ycc_canvas"], d2["ycc_canvas"], d3["ycc_canvas"]],
         idct_islow_launches=[d1["idct_islow"], d2["idct_islow"], d3["idct_islow"]])
    return l1 + l2 + l3, {k: d1[k] + d2[k] + d3[k] for k in DECODE_KERNELS}


@contextlib.contextmanager
def _canvas_routes():
    """Records, for every GpuJpegDecoder.decode_batch call inside, whether
    its canvas stayed on the card (a CUDA tensor ``out``) or came back to
    the host, and every superbatch whose images the loader stacked on the
    host (its ``_stack`` without the group's tensor)."""
    from posetpu_torch.data import loader as loader_mod

    seen = {"card": [], "host": [], "host_stacks": []}  # list.append: thread-safe
    decode, stack = GpuJpegDecoder.decode_batch, loader_mod._stack

    def decode_batch(self, paths, centers, pad_hw, out=None):
        seen["card" if torch.is_tensor(out) and out.is_cuda else "host"].append(len(paths))
        return decode(self, paths, centers, pad_hw, out=out)

    def recording_stack(items, host_image=None, image=None):
        if image is None and "image" in items[0]:
            seen["host_stacks"].append(len(items))
        return stack(items, host_image, image)

    GpuJpegDecoder.decode_batch, loader_mod._stack = decode_batch, recording_stack
    try:
        yield seen
    finally:
        GpuJpegDecoder.decode_batch, loader_mod._stack = decode, stack


def phase_fit_jpeg_gpu(loader_root, loader_results, workers):
    """train.cli.main at full hg8_mpii width, bf16, batch 32, FIT_EPOCHS
    epochs over the loader phase's 64 frames at 1280x720 (its 16 validation
    frames validate), decoded by the card's route into the (768, 1280) canvas the
    driver's auto-sizing picks: img/s of each epoch (the first captures the
    graph) beside the loader phase's Pillow and WorkerLoader rates from
    this run.  Every train batch is decoded into a canvas on the card (none
    copied back, no image stacked on the host; the validation loader's
    stay on the host); the idct_islow and ycc_canvas kernels launch once
    each a decoded batch; the counts are reset just before."""
    ckpt = os.path.join(loader_root, "fit_jpeg_gpu")
    steps, val_batches = LOADER_IMAGES // BATCH, -(-LOADER_VAL // BATCH)
    t0 = time.perf_counter()
    with _canvas_routes() as canvases:
        rc, launches, out, decode = _cli(train_cli.main, [
            "--config", "hg8_mpii", "--json", os.path.join(loader_root, "annotations.json"),
            "--image-path", os.path.join(loader_root, "images"), "--train-batch", str(BATCH),
            "--checkpoint", ckpt, "--epochs", str(FIT_EPOCHS)])
    seconds = time.perf_counter() - t0
    check(rc == 0, f"train cli returned {rc}")
    _check_decode("fit_jpeg_gpu", decode)
    check(len(canvases["card"]) == FIT_EPOCHS * steps and not canvases["host_stacks"]
          and len(canvases["host"]) == FIT_EPOCHS * val_batches,
          f"fit_jpeg_gpu: {len(canvases['card'])} train batches decoded on the card, "
          f"{len(canvases['host'])} to the host, {len(canvases['host_stacks'])} stacked "
          f"there; want {FIT_EPOCHS * steps}, {FIT_EPOCHS * val_batches} (validation), 0")
    check(f"pad_hw={LOADER_PAD}" in out, "fit_jpeg_gpu: the driver picked another pad_hw")
    batches = FIT_EPOCHS * (steps + val_batches)
    check(decode["ycc_canvas"] == batches,
          f"fit_jpeg_gpu: ycc_canvas launches {decode['ycc_canvas']}, want {batches}")
    want = batches + WARMUP_STEPS + EVAL_WARMUP
    check(launches == want, f"fit_jpeg_gpu launches {launches}, want {want}")
    vals, _ = _check_run("fit_jpeg_gpu", os.path.join(ckpt, "hg8_mpii"), FIT_EPOCHS,
                         FIT_EPOCHS * steps)
    emit("fit_jpeg_gpu", config="hg8_mpii", batch=BATCH, epochs=FIT_EPOCHS, images=LOADER_IMAGES,
         res=list(LOADER_RES), pad_hw=list(LOADER_PAD), seconds=seconds,
         images_per_sec=_img_per_s(out), log=vals, launches=launches,
         ycc_canvas_launches=decode["ycc_canvas"], idct_islow_launches=decode["idct_islow"],
         decode_routes=decode["routes"],
         canvases_on_card=len(canvases["card"]), canvases_to_host=len(canvases["host"]),
         host_stacks=len(canvases["host_stacks"]),
         loader_img_per_s={r["route"]: r["img_per_s"] for r in loader_results},
         worker_loader_img_per_s={w["workers"]: w["img_per_s"] for w in workers},
         worker_loader_steady_img_per_s={w["workers"]: w["steady_img_per_s"] for w in workers})
    return launches, {k: decode[k] for k in DECODE_KERNELS}


def phase_fit_joint(workdir):
    """One epoch each of hg8_mpii_asr and hg8_lsp_aho through the train
    CLI at full width, batch 32, each joint step a CUDA graph of one step
    (K = 1): 2 rasterizer launches per joint step and per warm-up step
    before the capture, and 1 per validation batch."""
    total, decode_total, runs = 0, dict.fromkeys(DECODE_KERNELS, 0), []
    for name in ("hg8_mpii_asr", "hg8_lsp_aho"):
        ckpt = os.path.join(workdir, name)
        t0 = time.perf_counter()
        rc, launches, out, decode = _cli(train_cli.main, [
            "--config", name, "--synthetic", "--train-batch", str(BATCH),
            "--checkpoint", ckpt, "--epochs", "1"])
        seconds = time.perf_counter() - t0
        check(rc == 0, f"{name}: train cli returned {rc}")
        _check_decode(name, decode)
        want = (JOINT_RASTER_LAUNCHES * (FIT_STEPS + WARMUP_STEPS) + FIT_VAL_BATCHES
                + EVAL_WARMUP)
        check(launches == want, f"{name}: launches {launches}, want {want}")
        run_dir = os.path.join(ckpt, name)
        vals, best = _check_run(name, run_dir, 1, FIT_STEPS)
        agent = CheckpointManager(run_dir).load()["state"]["agent"]
        check(agent["count"] == agent["step"] == FIT_STEPS,
              f"{name}: agent count {agent['count']}")
        check("agent" in out, f"{name}: no agent loss in the progress line")
        runs.append({"config": name, "seconds": seconds, "images_per_sec": _img_per_s(out),
                     "log": vals, "best_written": best, "launches": launches,
                     "launches_want": want, "decode_routes": decode["routes"],
                     "ycc_canvas_launches": decode["ycc_canvas"],
                     "idct_islow_launches": decode["idct_islow"]})
        total += launches
        for k in DECODE_KERNELS:
            decode_total[k] += decode[k]
    emit("fit_joint", batch=BATCH, epochs=1, steps_per_epoch=FIT_STEPS, runs=runs)
    return total, decode_total


# dispatch: K train steps a CUDA graph at full width, and the dispatches
# timed after the one that captures
DISPATCH_K, DISPATCH_TIMED = 4, 3
# dispatch: the graph against eager steps in bf16 at full width.  Two eager
# runs from one state differ only where a kernel's reduction order changes
# from run to run (cuDNN's weight-gradient algorithms may add partial sums
# with atomics); that gap is the spread of the eager result itself.  The
# graph replays the same kernels on the same arguments, so it is one more
# draw from that spread: by the triangle inequality its distance to one
# eager run is at most its distance to the other plus theirs, two spreads.
# When the eager runs agree bit for bit, the graph must too.
GRAPH_GAP_FACTOR = 2.0
# dispatch_parity: hg2 at feats 8, f32; graphed dispatches of K = 2 over 7
# steps (2, 2, a state load, 2, then a short group of 1)
PARITY_K, PARITY_STEPS = 2, 7
# fit_dispatch: the train CLI with every dispatch option
FIT_DISPATCH = ["--steps-per-dispatch", "2", "--loader-backend", "grain",
                "--loader-workers", "4", "--tensorboard", "--profile"]


@contextlib.contextmanager
def _exact_f32():
    """TF32 off and deterministic algorithms (main() sets
    CUBLAS_WORKSPACE_CONFIG before any cuBLAS call)."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev[:2]
        torch.use_deterministic_algorithms(prev[2])


def _graph_replay(dispatch):
    """The replay of a dispatch step's one captured graph."""
    (g,) = dispatch.graphs.values()
    return g.graph.replay


def _stack(batches, dev="cuda"):
    return {k: torch.from_numpy(np.stack([b[k] for b in batches])).to(dev)
            for k in batches[0]}


def _snap_tensors(snap):
    """The tensors of a ``TrainState.snapshot()`` or a
    ``JointState.snapshot()`` (the pose state's, then the agent's)."""
    return snap[0] if isinstance(snap[0], list) else snap[0][0] + snap[1][0]


def _gap(a, b):
    """Largest difference between two ``TrainState.snapshot()``s or two
    ``JointState.snapshot()``s, over the floating tensors."""
    out = 0.0
    for x, y in zip(_snap_tensors(a), _snap_tensors(b), strict=True):
        if x.is_floating_point():
            out = max(out, (x.float() - y.float()).abs().max().item())
    return out


def phase_dispatch(cfg):
    """K = DISPATCH_K train steps a CUDA graph at the full hg8_mpii width,
    bf16, batch 32, from one state: two eager runs of K steps
    (make_train_step) and one graphed dispatch; the graph's gap to the first
    eager run within GRAPH_GAP_FACTOR of the eager runs' own gap (parameters,
    statistics and moments; losses).  Then DISPATCH_TIMED timed dispatches
    with the launch counts reset just before (the rasterizer launches once
    a replayed step), and one dispatch under torch.profiler."""
    torch.manual_seed(SEED + 9)
    model = hg(num_stacks=cfg.model.stacks, num_classes=cfg.model.classes,
               num_feats=cfg.model.feats, depth=cfg.model.depth).cuda()
    opt = make_optimizer(model.parameters(), cfg.optim,
                         steps_per_epoch=MPII_TRAIN_SAMPLES // BATCH)
    state = TrainState(model, opt)
    K = DISPATCH_K
    rng = np.random.RandomState(SEED + 10)
    supers = [_stack([_train_batch(rng, BATCH, CANVAS, cfg.model.classes, (d * K + i) * BATCH)
                      for i in range(K)]) for d in range(1 + DISPATCH_TIMED)]
    eager = make_train_step(model, opt, cfg.aug, MPII_MEAN, seed=SEED, device="cuda")
    eager(state, {k: v[0] for k, v in supers[-1].items()})  # cuDNN set-up, not compared
    s0 = state.snapshot()
    runs, eager_s = {}, []
    for name in ("eager_a", "eager_b"):
        state.restore_(s0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = [eager(state, {k: v[i] for k, v in supers[0].items()}) for i in range(K)]
        loss = torch.stack([m["loss"] for m in ms]).cpu()
        eager_s.append(time.perf_counter() - t0)
        runs[name] = (state.snapshot(), loss)
    state.restore_(s0)
    dispatch = make_dispatch_step(model, opt, cfg.aug, MPII_MEAN, seed=SEED, steps=K,
                                  device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_counters(RASTER)
    loss = dispatch(state, supers[0])["loss"].cpu()  # warms up, captures, replays
    first = counter(RASTER)
    runs["graph"] = (state.snapshot(), loss)
    emit("dispatch_capture", config=cfg.name, steps=K, seconds=dispatch.capture_seconds[0],
         warmup_steps=WARMUP_STEPS, launches=first)
    check(first == WARMUP_STEPS + K, f"first dispatch: {first} launches, want "
          f"{WARMUP_STEPS} warm-up + {K} replayed")

    reset_counters(RASTER, *HAND_OP_COUNTERS)
    t0 = time.perf_counter()
    metrics = [dispatch(state, sb) for sb in supers[1:]]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"rasterize_gaussians": counter(RASTER), **_hand_op_launches()}
    peak = torch.cuda.max_memory_allocated()
    prof = profile_run(lambda: dispatch(state, supers[1]))
    replay_ms = cuda_ms(_graph_replay(dispatch), reps=1, samples=5)

    eager_gap = _gap(runs["eager_a"][0], runs["eager_b"][0])
    graph_gap = _gap(runs["eager_a"][0], runs["graph"][0])
    eager_loss_gap = (runs["eager_a"][1] - runs["eager_b"][1]).abs().max().item()
    graph_loss_gap = (runs["eager_a"][1] - runs["graph"][1]).abs().max().item()
    losses = [m["loss"].tolist() for m in metrics]
    emit("dispatch", config=cfg.name, stacks=cfg.model.stacks, feats=cfg.model.feats,
         batch=BATCH, steps_per_dispatch=K, dispatches=DISPATCH_TIMED, canvas=list(CANVAS),
         dtype="bfloat16", seconds=seconds,
         img_per_s=BATCH * K * DISPATCH_TIMED / seconds,
         eager_img_per_s=[BATCH * K / t for t in eager_s],
         device_busy_ms_per_step=prof["device_busy_ms"] / K,
         replay_ms_per_step=replay_ms / K, idle_share=prof["idle_share"],
         profile=prof, max_memory_allocated=peak, loss=losses,
         acc=[m["acc"].tolist() for m in metrics], launches=launches,
         captures=dispatch.captures, param_gap_eager=eager_gap, param_gap_graph=graph_gap,
         loss_gap_eager=eager_loss_gap, loss_gap_graph=graph_loss_gap,
         gap_factor=GRAPH_GAP_FACTOR)
    check(dispatch.captures == 1, f"captures {dispatch.captures}")
    check(launches["rasterize_gaussians"] == K * DISPATCH_TIMED,
          f"rasterizer launches over {DISPATCH_TIMED} dispatches: {launches}")
    _check_hand_ops("train dispatches", launches, K * DISPATCH_TIMED, K * DISPATCH_TIMED)
    steps = K * (2 + DISPATCH_TIMED) + 1
    check(state.step == opt.count == steps, f"step {state.step}, count {opt.count}")
    check(all(math.isfinite(x) for ls in losses for x in ls), f"dispatch losses {losses}")
    check(graph_gap <= GRAPH_GAP_FACTOR * eager_gap,
          f"graph vs eager {graph_gap}, eager vs eager {eager_gap}")
    check(graph_loss_gap <= GRAPH_GAP_FACTOR * eager_loss_gap,
          f"losses: graph vs eager {graph_loss_gap}, eager vs eager {eager_loss_gap}")
    return launches


def phase_dispatch_parity():
    """hg2_mpii_mini at feats 8, 64² input, f32, TF32 off, deterministic
    algorithms: PARITY_STEPS train steps eagerly, and as graphed
    dispatches of PARITY_K (2, 2, then a state load, which captures again,
    2, then a short group of 1, eager), from one state across both
    schedule drops.  Parameters, statistics, moments, metrics and counts
    must be equal exactly; the rasterizer launches once a step, and on the
    graph's side also once for each warm-up step before each capture."""
    cfg = named_config("hg2_mpii_mini")
    cfg.model.feats = 8
    cfg.model.bf16 = False
    cfg.aug.inp_res = (64, 64)
    cfg.aug.out_res = (16, 16)
    cfg.optim.schedule = (1, 2)  # at 2 updates an epoch: drops at 2 and 4
    K, B, J = PARITY_K, 8, cfg.model.classes
    rng = np.random.RandomState(SEED + 12)
    batches = [_train_batch(rng, B, (96, 128), J, 3000 + t * B) for t in range(PARITY_STEPS)]
    with _exact_f32():
        torch.manual_seed(SEED + 11)
        base = hg(num_stacks=cfg.model.stacks, num_classes=J, num_feats=cfg.model.feats,
                  dtype=torch.float32)
        runs = {}
        for how in ("eager", "graph"):
            model = copy.deepcopy(base).cuda()
            opt = make_optimizer(model.parameters(), cfg.optim, steps_per_epoch=2)
            state = TrainState(model, opt)
            kw = dict(seed=SEED, device="cuda")
            reset_counters(RASTER)
            if how == "eager":
                step = make_train_step(model, opt, cfg.aug, MPII_MEAN, **kw)
                ms = [step(state, b) for b in batches]
                metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
            else:
                dispatch = make_dispatch_step(model, opt, cfg.aug, MPII_MEAN, steps=K, **kw)
                parts = [dispatch(state, _stack(batches[0:2])),
                         dispatch(state, _stack(batches[2:4]))]
                opt.load_state_dict(copy.deepcopy(opt.state_dict()))  # new moment tensors
                parts += [dispatch(state, _stack(batches[4:6])),
                          dispatch(state, _stack(batches[6:7]))]
                metrics = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
                captures = dispatch.captures
            torch.cuda.synchronize()
            runs[how] = (state.snapshot(), {k: v.cpu() for k, v in metrics.items()},
                         counter(RASTER))
    (se, me, le), (sg, mg, lg) = runs["eager"], runs["graph"]
    gap = _gap(se, sg)
    metric_gap = max((me[k] - mg[k]).abs().max().item() for k in me)
    emit("dispatch_parity", batch=B, steps=PARITY_STEPS, steps_per_dispatch=K,
         captures=captures, warmup_steps=WARMUP_STEPS, param_gap=gap,
         metric_gap=metric_gap, loss=me["loss"].tolist(),
         launches={"eager": le, "graph": lg})
    check(captures == 2, f"captures {captures}: a state load must capture again")
    check(se[1:] == sg[1:] == (PARITY_STEPS, PARITY_STEPS), f"counts {se[1:]} {sg[1:]}")
    for a, b in zip(se[0], sg[0], strict=True):
        check(torch.equal(a, b), f"graphed state differs from eager by {gap}")
    for k in me:
        check(torch.equal(me[k], mg[k]), f"graphed {k} differs from eager")
    want = PARITY_STEPS + WARMUP_STEPS * captures
    check(le == PARITY_STEPS and lg == want,
          f"launches eager {le}, graph {lg} (want {PARITY_STEPS}, {want})")
    return lg


def phase_fit_dispatch(workdir, have_tensorboard):
    """train.cli.main at full hg8_mpii width, bf16, batch 32 on the synthetic
    split with every dispatch option (FIT_DISPATCH): the first epoch traced,
    then FIT_EPOCHS epochs from the state before it.  Launches: each
    epoch's train steps and validation batch, the traced epoch's train
    steps once more, and the warm-up steps of the one capture (the traced
    epoch's; the state is put back in place, so it is replayed after); the
    trace file and, where tensorboard is installed, the event file."""
    ckpt = os.path.join(workdir, "fit_dispatch")
    run_dir = os.path.join(ckpt, "hg8_mpii")
    t0 = time.perf_counter()
    rc, launches, out, decode = _cli(train_cli.main, [
        "--config", "hg8_mpii", "--synthetic", "--train-batch", str(BATCH),
        "--checkpoint", ckpt, "--epochs", str(FIT_EPOCHS), *FIT_DISPATCH])
    seconds = time.perf_counter() - t0
    check(rc == 0, f"train cli returned {rc}")
    _check_decode("fit_dispatch", decode, route="pil")
    want = (FIT_EPOCHS * (FIT_STEPS + FIT_VAL_BATCHES) + FIT_STEPS + WARMUP_STEPS
            + EVAL_WARMUP)
    vals, best = _check_run("fit_dispatch", run_dir, FIT_EPOCHS, FIT_EPOCHS * FIT_STEPS)
    trace_dir = os.path.join(run_dir, "trace")
    traces = {n: os.path.getsize(os.path.join(trace_dir, n))
              for n in (os.listdir(trace_dir) if os.path.isdir(trace_dir) else [])}
    tb_dir = os.path.join(run_dir, "tb")
    events = [n for n in (os.listdir(tb_dir) if os.path.isdir(tb_dir) else [])
              if n.startswith("events.out.tfevents")]
    emit("fit_dispatch", config="hg8_mpii", batch=BATCH, epochs=FIT_EPOCHS,
         flags=FIT_DISPATCH, seconds=seconds, images_per_sec=_img_per_s(out), log=vals,
         launches=launches, launches_want=want, traces=traces, tensorboard_events=events,
         decode_routes=decode["routes"])
    check(launches == want, f"fit_dispatch launches {launches}, want {want}")
    check(traces and all(n > 0 for n in traces.values()), f"trace files {traces}")
    check(bool(events) == have_tensorboard, f"tensorboard events {events}")
    return launches


# ---- K joint steps per dispatch (make_joint_dispatch_step)

# joint_dispatch_parity: hg2 at feats 8, f32: JOINT_DISPATCHES graphed
# dispatches of JOINT_DISPATCH_K joint steps against as many eager steps,
# for each (case, named config, agent fields); "every3" updates the agent
# at steps 0 and 3, so its dispatches from steps 0, 2 and 4 take three
# patterns, (T, F), (F, T) and (F, F), each its own graph
JOINT_DISPATCH_K, JOINT_DISPATCHES = 2, 3
JOINT_DISPATCH_CASES = (
    ("asr", "hg8_mpii_asr", {}),
    ("tree_lsp", "hg8_lsp_aho", {}),
    ("parts", "hg8_mpii_asr", dict(occ_mode="parts", occ_nodes=9)),
    ("every3", "hg8_mpii_asr", dict(update_every=3)),
    ("mixed", "hg8_mpii_asr", dict(pose_ref_weight=0.3)),
)
# the case whose pose optimizer is loaded before its last dispatch (new
# moment tensors), which must capture again
JOINT_DISPATCH_RELOAD = "asr"
# fit_joint_dispatch: hg8_mpii_asr through the train CLI, K = 2, batch 16
# (4 batches of the synthetic split an epoch) capped at 3 steps an epoch:
# a graphed dispatch of 2 and one the cap trims to 1, run eagerly
FIT_JOINT_BATCH, FIT_JOINT_STEPS = 16, 3
FIT_JOINT_DISPATCH = ["--steps-per-dispatch", "2", "--steps-per-epoch", str(FIT_JOINT_STEPS),
                      "--loader-backend", "grain", "--loader-workers", "4",
                      "--tensorboard", "--profile"]


def _joint_dispatch_for(state, cfg, dev, kw, steps, group=None):
    return make_joint_dispatch_step(state.pose.model, state.agent.model,
                                    state.pose.optimizer, state.agent.optimizer, cfg.aug,
                                    MPII_MEAN, seed=SEED, steps=steps, group=group,
                                    device=dev, **kw)


def _small_joint_cfg(name, agent_fields):
    """``name`` cut as joint_parity cuts it: hg2 at feats 8, depth 2, 64²
    crops, f32, 5 scale and 5 rotation bins; its learning rates drop at
    updates 2 and 4 (2 updates an epoch)."""
    cfg = named_config(name)
    cfg.model.stacks, cfg.model.feats, cfg.model.depth, cfg.model.bf16 = 2, 8, 2, False
    cfg.aug.inp_res, cfg.aug.out_res = (64, 64), (16, 16)
    cfg.optim = copy.deepcopy(OPT_CFG)
    cfg.optim.schedule = (1, 2)
    cfg.agent.scale_bins = cfg.agent.rot_bins = 5
    for k, v in agent_fields.items():
        setattr(cfg.agent, k, v)
    return cfg


def _same_state(label, a, b):
    """Two JointState snapshots equal bit for bit, ints included."""
    ta, tb = _snap_tensors(a), _snap_tensors(b)
    if not (len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))):
        check(False, f"{label}: graphed state differs from eager by {_gap(a, b)}")
    check((a[0][1:], a[1][1:], a[2]) == (b[0][1:], b[1][1:], b[2]),
          f"{label}: ints {a[0][1:], a[1][1:], a[2]} vs {b[0][1:], b[1][1:], b[2]}")


def phase_joint_dispatch_parity():
    """For each of JOINT_DISPATCH_CASES (hg2 feats 8, agent widths (8, 16),
    f32, TF32 off, deterministic algorithms, batch 8): JOINT_DISPATCHES
    graphed dispatches of JOINT_DISPATCH_K joint steps against the same
    steps of make_joint_step from the same seeded state.  Both networks'
    parameters, statistics and moments, every step and count, and the
    metrics must be equal bit for bit; a dispatch whose pattern updates the
    agent nowhere leaves the agent as it was; the rasterizer launches twice
    a step, and twice a warm-up step before each capture.  In the
    JOINT_DISPATCH_RELOAD case the pose optimizer's state is loaded before
    the last dispatch, which must capture again."""
    K, B = JOINT_DISPATCH_K, 8
    steps = K * JOINT_DISPATCHES
    cases = []
    with _exact_f32():
        for c, (label, name, fields) in enumerate(JOINT_DISPATCH_CASES):
            cfg = _small_joint_cfg(name, fields)
            rng = np.random.RandomState(SEED + 60 + c)
            batches = [_train_batch(rng, B, (96, 128), cfg.model.classes, 5000 + t * B)
                       for t in range(steps)]
            runs, kept = {}, 0
            for how in ("eager", "graph"):
                state, kw = _joint_state(cfg, "cuda", SEED + 61 + c, widths=(8, 16),
                                         steps_per_epoch=2)
                reset_counters(RASTER)
                if how == "eager":
                    step = _joint_step_for(state, cfg, "cuda", kw)
                    ms = [step(state, b) for b in batches]
                    metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
                else:
                    dispatch = _joint_dispatch_for(state, cfg, "cuda", kw, K)
                    parts = []
                    for d in range(JOINT_DISPATCHES):
                        if label == JOINT_DISPATCH_RELOAD and d == JOINT_DISPATCHES - 1:
                            opt = state.pose.optimizer
                            opt.load_state_dict(copy.deepcopy(opt.state_dict()))
                        idle = not any(dispatch.pattern(state.step, K))
                        agent0 = [t.clone() for t in state.agent.tensors()] if idle else None
                        parts.append(dispatch(state, _stack(batches[d * K:(d + 1) * K])))
                        if idle:
                            check(all(torch.equal(t, u) for t, u in
                                      zip(state.agent.tensors(), agent0, strict=True)),
                                  f"joint_dispatch_parity {label}: the agent moved in a "
                                  "dispatch without an update step")
                            kept += 1
                    metrics = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
                    captures, patterns = dispatch.captures, sorted(dispatch.graphs)
                    seconds, nbytes = dispatch.capture_seconds, dispatch.pool_bytes
                torch.cuda.synchronize()
                runs[how] = (state.snapshot(), {k: v.cpu() for k, v in metrics.items()},
                             counter(RASTER))
            (se, me, le), (sg, mg, lg) = runs["eager"], runs["graph"]
            want_captures = {"every3": 3, JOINT_DISPATCH_RELOAD: 2}.get(label, 1)
            cases.append({"case": label, "config": name, **fields, "steps": steps,
                          "captures": captures, "patterns": [list(p) for p in patterns],
                          "capture_seconds": seconds, "pool_bytes": nbytes,
                          "agent_kept_dispatches": kept, "param_gap": _gap(se, sg),
                          "launches": {"eager": le, "graph": lg},
                          "ints": [se[0][1:], se[1][1:], se[2]]})
            label = f"joint_dispatch_parity {label}"
            _same_state(label, se, sg)
            for k in me:
                check(torch.equal(me[k], mg[k]), f"{label}: graphed {k} differs from eager")
            check(captures == want_captures, f"{label}: captures {captures}")
            check(kept == (1 if cases[-1]["case"] == "every3" else 0), f"{label}: kept {kept}")
            want = JOINT_RASTER_LAUNCHES * (steps + WARMUP_STEPS * captures)
            check(le == JOINT_RASTER_LAUNCHES * steps and lg == want,
                  f"{label}: launches eager {le}, graph {lg} (want {want})")
    emit("joint_dispatch_parity", batch=B, steps_per_dispatch=K, dispatches=JOINT_DISPATCHES,
         warmup_steps=WARMUP_STEPS, cases=cases)
    return sum(c["launches"]["graph"] for c in cases)


def phase_joint_dispatch():
    """hg8_mpii_asr at full width (8 stacks, 128 features, 256², bf16,
    batch 32), K = DISPATCH_K joint steps a CUDA graph, from one state: two
    eager runs of K steps (make_joint_step) and one graphed dispatch, the
    graph's gap to the first eager run within GRAPH_GAP_FACTOR of the eager
    runs' own gap (both networks' parameters, statistics and moments;
    losses).  The capture's seconds, the graph's memory and the first
    dispatch's launches on a ``joint_dispatch_capture`` line; then
    DISPATCH_TIMED timed dispatches with the launch counts reset just
    before (2 a replayed step), and one under torch.profiler.  Then
    hg8_lsp_aho at K = 1: three dispatches, the first capturing."""
    cfg = named_config("hg8_mpii_asr")
    K = DISPATCH_K
    state, kw = _joint_state(cfg, "cuda", SEED + 20)
    rng = np.random.RandomState(SEED + 21)
    supers = [_stack([_train_batch(rng, BATCH, CANVAS, cfg.model.classes, (d * K + i) * BATCH)
                      for i in range(K)]) for d in range(1 + DISPATCH_TIMED)]
    eager = _joint_step_for(state, cfg, "cuda", kw)
    eager(state, {k: v[0] for k, v in supers[-1].items()})  # cuDNN set-up, not compared
    s0 = state.snapshot()
    runs, eager_s = {}, []
    for name in ("eager_a", "eager_b"):
        state.restore_(s0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = [eager(state, {k: v[i] for k, v in supers[0].items()}) for i in range(K)]
        loss = torch.stack([m["loss"] for m in ms]).cpu()
        eager_s.append(time.perf_counter() - t0)
        runs[name] = (state.snapshot(), loss)
    state.restore_(s0)
    dispatch = _joint_dispatch_for(state, cfg, "cuda", kw, K)
    torch.cuda.reset_peak_memory_stats()
    reset_counters(RASTER)
    loss = dispatch(state, supers[0])["loss"].cpu()  # warms up, captures, replays
    first = counter(RASTER)
    runs["graph"] = (state.snapshot(), loss)
    emit("joint_dispatch_capture", config=cfg.name, steps=K,
         seconds=dispatch.capture_seconds[0], pool_bytes=dispatch.pool_bytes[0],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         warmup_steps=WARMUP_STEPS, launches=first)
    check(first == JOINT_RASTER_LAUNCHES * (WARMUP_STEPS + K),
          f"first joint dispatch: {first} launches, want {JOINT_RASTER_LAUNCHES} x "
          f"({WARMUP_STEPS} warm-up + {K} replayed)")

    reset_counters(RASTER, *HAND_OP_COUNTERS)
    t0 = time.perf_counter()
    metrics = [dispatch(state, sb) for sb in supers[1:]]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"rasterize_gaussians": counter(RASTER), **_hand_op_launches()}
    peak = torch.cuda.max_memory_allocated()
    prof = profile_run(lambda: dispatch(state, supers[1]))
    replay_ms = cuda_ms(_graph_replay(dispatch), reps=1, samples=5)

    eager_gap = _gap(runs["eager_a"][0], runs["eager_b"][0])
    graph_gap = _gap(runs["eager_a"][0], runs["graph"][0])
    eager_loss_gap = (runs["eager_a"][1] - runs["eager_b"][1]).abs().max().item()
    graph_loss_gap = (runs["eager_a"][1] - runs["graph"][1]).abs().max().item()
    values = {k: [m[k].tolist() for m in metrics] for k in metrics[0]}
    emit("joint_dispatch", config=cfg.name, stacks=cfg.model.stacks, feats=cfg.model.feats,
         batch=BATCH, steps_per_dispatch=K, dispatches=DISPATCH_TIMED, canvas=list(CANVAS),
         dtype="bfloat16", seconds=seconds, img_per_s=BATCH * K * DISPATCH_TIMED / seconds,
         eager_img_per_s=[BATCH * K / t for t in eager_s],
         device_busy_ms_per_step=prof["device_busy_ms"] / K,
         replay_ms_per_step=replay_ms / K, idle_share=prof["idle_share"], profile=prof,
         max_memory_allocated=peak, capture_seconds=dispatch.capture_seconds,
         pool_bytes=dispatch.pool_bytes, launches=launches,
         captures=dispatch.captures, param_gap_eager=eager_gap, param_gap_graph=graph_gap,
         loss_gap_eager=eager_loss_gap, loss_gap_graph=graph_loss_gap,
         gap_factor=GRAPH_GAP_FACTOR, **values)
    check(dispatch.captures == 1, f"captures {dispatch.captures}")
    check(launches["rasterize_gaussians"] == JOINT_RASTER_LAUNCHES * K * DISPATCH_TIMED,
          f"rasterizer launches over {DISPATCH_TIMED} joint dispatches: {launches}")
    _check_hand_ops("joint dispatches", launches, _pose_forwards(kw) * K * DISPATCH_TIMED,
                     K * DISPATCH_TIMED)
    steps = K * (2 + DISPATCH_TIMED) + 1
    check((state.step, state.pose.step, state.pose.optimizer.count, state.agent.step,
           state.agent.optimizer.count) == (steps,) * 5, f"joint step {state.step}")
    for k, vs in values.items():
        check(all(math.isfinite(x) for v in vs for x in v), f"joint_dispatch {k} {vs}")
    check(graph_gap <= GRAPH_GAP_FACTOR * eager_gap,
          f"graph vs eager {graph_gap}, eager vs eager {eager_gap}")
    check(graph_loss_gap <= GRAPH_GAP_FACTOR * eager_loss_gap,
          f"losses: graph vs eager {graph_loss_gap}, eager vs eager {eager_loss_gap}")
    total = launches
    del dispatch, eager, state, s0, runs
    torch.cuda.empty_cache()

    cfg = named_config("hg8_lsp_aho")
    state, kw = _joint_state(cfg, "cuda", SEED + 22)
    rng = np.random.RandomState(SEED + 23)
    dispatch = _joint_dispatch_for(state, cfg, "cuda", kw, 1)
    reset_counters(RASTER)
    t0 = time.perf_counter()
    ms = [dispatch(state, _stack([_train_batch(rng, BATCH, CANVAS, cfg.model.classes,
                                               t * BATCH)]))
          for t in range(3)]
    torch.cuda.synchronize()
    lsp_s = time.perf_counter() - t0
    lsp = counter(RASTER)
    values = {k: [m[k].item() for m in ms] for k in ms[0]}
    emit("joint_dispatch_lsp", config=cfg.name, joints=cfg.model.classes,
         occ_nodes=state.agent.model.num_occ_nodes, steps_per_dispatch=1, dispatches=3,
         seconds=lsp_s, capture_seconds=dispatch.capture_seconds,
         pool_bytes=dispatch.pool_bytes, launches=lsp, **values)
    check(dispatch.captures == 1, f"lsp captures {dispatch.captures}")
    check(lsp == JOINT_RASTER_LAUNCHES * (3 + WARMUP_STEPS), f"lsp launches {lsp}")
    check(state.step == state.agent.optimizer.count == 3, f"lsp step {state.step}")
    for k, vs in values.items():
        check(all(math.isfinite(v) for v in vs), f"joint_dispatch_lsp {k} {vs}")
    del dispatch, state
    torch.cuda.empty_cache()
    return total, lsp


def phase_fit_joint_dispatch(workdir, have_tensorboard):
    """train.cli.main with hg8_mpii_asr at full width, bf16, batch 16, with
    FIT_JOINT_DISPATCH (K = 2, 3 steps an epoch: a graphed dispatch and
    one the cap trims, run eagerly; the worker loader, TensorBoard, the
    traced first epoch): FIT_EPOCHS epochs, then --resume auto to
    FIT_RESUME_EPOCHS.  Launches as fit_dispatch counts them, 2 a joint
    step: each epoch's steps and validation batch, the traced epoch's
    steps once more, each run's capture's warm-up steps; the log rows,
    the checkpoints' steps and counts (the agent's too), the trace file
    and the event file."""
    name = "hg8_mpii_asr"
    ckpt = os.path.join(workdir, "fit_joint_dispatch")
    run_dir = os.path.join(ckpt, name)
    common = ["--config", name, "--synthetic", "--train-batch", str(FIT_JOINT_BATCH),
              "--checkpoint", ckpt, *FIT_JOINT_DISPATCH]
    val_batches = -(-16 // FIT_JOINT_BATCH)  # the synthetic split's 16 validation images
    per_epoch = JOINT_RASTER_LAUNCHES * FIT_JOINT_STEPS + val_batches
    warmup = JOINT_RASTER_LAUNCHES * WARMUP_STEPS
    t0 = time.perf_counter()
    rc, l1, out1, d1 = _cli(train_cli.main, common + ["--epochs", str(FIT_EPOCHS)])
    s1 = time.perf_counter() - t0
    check(rc == 0, f"train cli returned {rc}")
    _check_decode("fit_joint_dispatch", d1, route="pil")
    want1 = (FIT_EPOCHS * per_epoch + JOINT_RASTER_LAUNCHES * FIT_JOINT_STEPS + warmup
             + EVAL_WARMUP)
    _check_run("fit_joint_dispatch", run_dir, FIT_EPOCHS, FIT_EPOCHS * FIT_JOINT_STEPS)
    t0 = time.perf_counter()
    rc, l2, out2, d2 = _cli(train_cli.main, common + ["--epochs", str(FIT_RESUME_EPOCHS),
                                                      "--resume", "auto"])
    s2 = time.perf_counter() - t0
    check(rc == 0, f"resumed train cli returned {rc}")
    _check_decode("fit_joint_dispatch resumed", d2, route="pil")
    extra = FIT_RESUME_EPOCHS - FIT_EPOCHS
    want2 = (extra * per_epoch + JOINT_RASTER_LAUNCHES * FIT_JOINT_STEPS + warmup
             + EVAL_WARMUP)
    steps_total = FIT_RESUME_EPOCHS * FIT_JOINT_STEPS
    vals, best = _check_run("fit_joint_dispatch resumed", run_dir, FIT_RESUME_EPOCHS,
                            steps_total)
    agent = CheckpointManager(run_dir).load()["state"]["agent"]
    trace_dir = os.path.join(run_dir, "trace")
    traces = {n: os.path.getsize(os.path.join(trace_dir, n))
              for n in (os.listdir(trace_dir) if os.path.isdir(trace_dir) else [])}
    tb_dir = os.path.join(run_dir, "tb")
    events = [n for n in (os.listdir(tb_dir) if os.path.isdir(tb_dir) else [])
              if n.startswith("events.out.tfevents")]
    emit("fit_joint_dispatch", config=name, batch=FIT_JOINT_BATCH, epochs=FIT_EPOCHS,
         resumed_to=FIT_RESUME_EPOCHS, steps_per_epoch=FIT_JOINT_STEPS,
         flags=FIT_JOINT_DISPATCH, seconds=[s1, s2],
         images_per_sec=_img_per_s(out1) + _img_per_s(out2), log=vals,
         launches={"train": l1, "resumed": l2}, launches_want={"train": want1, "resumed": want2},
         agent_count=agent["count"], agent_step=agent["step"], traces=traces,
         tensorboard_events=events, decode_routes=d1["routes"] + d2["routes"])
    check(l1 == want1 and l2 == want2, f"fit_joint_dispatch launches {l1}, {l2}, "
          f"want {want1}, {want2}")
    check(agent["count"] == agent["step"] == steps_total,
          f"agent count {agent['count']}, step {agent['step']}, want {steps_total}")
    check("agent" in out1, "no agent loss in the progress line")
    check(traces and all(n > 0 for n in traces.values()), f"trace files {traces}")
    check(bool(events) == have_tensorboard, f"tensorboard events {events}")
    return l1 + l2


# ---- data parallelism (posetpu_torch.parallel)

# dp_config: hg8_mpii_384_dp8 at full width on this one card (num_devices 1)
# with --steps-per-dispatch DP_CONFIG_K: one warm-up epoch, then
# DP_CONFIG_EPOCHS epochs and one validation pass (the synthetic split's 64
# train images make one batch of 48 an epoch, a short group run eagerly),
# then DP_CONFIG_TIMED dispatches of DP_CONFIG_K joint steps on one placed
# batch, the graph's, timed by CUDA events
DP_CONFIG_EPOCHS, DP_CONFIG_TIMED, DP_CONFIG_K = 2, 3, 2
# dp_gloo2: two gloo ranks sharing the card, each with half of a global
# batch of DP_GLOO_BATCH, against one process on the same batch and weights
DP_GLOO_WORLD, DP_GLOO_BATCH = 2, 8
# the ranks' f32 pose gradients against float64: the cross-replica norm
# takes flax's one-pass variance E[x²] - E[x]², whose float32 cancellation
# moves the reference's own gradients by up to 3.9e-3 from its float64
# ones (tests/torch_joint_harness.py); on the card (H100 80GB HBM3, 700 W)
# the ranks' train-step gradients read 5.94e-3 from float64 and the one
# process's 5.98e-3 (hg2 feats 8, TF32 off: cuDNN's float32 algorithms).
# The first bound, train_parity's TRAIN_GRAD_ATOL (4e-3), failed on that
# reading.  No ratio to the one process's own gap bounds it: in the joint
# step the ranks read 4.2e-4 from float64 where cuDNN's two-pass norm read
# 2.9e-5, the one-pass cancellation that the reference's statistics share.
# JOINT_GRAD_ATOL's allowance for such region-wide roundings:
DP_GRAD_ATOL = JOINT_GRAD_ATOL
# rasterizer launches of one step of each kind
DP_RASTER_LAUNCHES = {"train": 1, "joint": JOINT_RASTER_LAUNCHES, "eval": 1}
# dp_gloo2 in bf16 at full width: the two-rank step against the one-process
# step, as ROADMAP's precision rule holds bf16 (tests/test_torch_hourglass.py):
# the mean gap within DP_RATIO times the one process's own bf16-vs-f32 gap
DP_RATIO = 2.0
# dp_nccl1: graphed dispatches of K = 2 at world size 1, hg2 feats 8, f32
NCCL_K, NCCL_DISPATCHES = 2, 3
# all-reduce calls of one joint step under a group whose norms are local
# (train/adversarial.py): the pose gradient bucket, the agent's (an update
# step: every step at update_every 1), the advantage's two moments in one
# call (the batch-mean baseline) and the metric bucket
JOINT_ALL_REDUCES = 4


def phase_dp_config(workdir):
    """hg8_mpii_384_dp8 (8 stacks, 128 features, 384² crops, 96² heatmaps,
    the agent, bf16, global batch 48) through Experiment with num_devices
    1 and steps_per_dispatch DP_CONFIG_K (the reference's DP joint route)
    on the synthetic split: a warm-up epoch, DP_CONFIG_EPOCHS epochs and
    one validation pass with the launch counts reset just before (2 a joint
    step, 1 a validation batch), then one placed batch stacked into a
    superbatch of DP_CONFIG_K: a dispatch that captures the graph, then
    DP_CONFIG_TIMED dispatches timed with CUDA events and one under
    torch.profiler."""
    from posetpu_torch.train.loop import Experiment

    cfg = named_config("hg8_mpii_384_dp8")
    check((cfg.model.stacks, cfg.model.feats, cfg.batch_size, tuple(cfg.aug.inp_res),
           tuple(cfg.aug.out_res), cfg.agent.enabled, cfg.num_devices, cfg.model.bf16)
          == (8, 128, 48, (384, 384), (96, 96), True, 8, True), f"config {cfg}")
    cfg.num_devices = 1
    cfg.steps_per_dispatch = DP_CONFIG_K
    cfg.synthetic = True
    cfg.checkpoint_dir = os.path.join(workdir, "dp_config")
    torch.cuda.empty_cache()
    exp = Experiment(cfg, device="cuda")
    routes = (exp.loader.backend, exp.val_loader.backend)
    reset_counters(islow.IDCT_LAUNCHES, ycc.YCC_LAUNCHES)
    try:
        check(routes == ("gpu", "gpu"), f"dp_config decode routes {routes}")
        check(exp.world == 1 and exp.group is None, "one rank")
        check(exp.state.agent.model.input_downscale == 2, "the agent's input downscale")
        exp.train_epoch(0)  # warm-up: cuDNN and cuBLAS set-up at 384²
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters(RASTER)
        t0 = time.perf_counter()
        epochs = [exp.train_epoch(1 + e) for e in range(DP_CONFIG_EPOCHS)]
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        val, preds = exp.validate(DP_CONFIG_EPOCHS)
        val_s = time.perf_counter() - t0
        launches = counter(RASTER)
        peak = torch.cuda.max_memory_allocated()
        steps = sum(e["steps"] for e in epochs)
        val_batches = -(-len(exp.val_ds) // cfg.batch_size)
        check(launches == DP_RASTER_LAUNCHES["joint"] * steps + val_batches + EVAL_WARMUP,
              f"dp_config launches {launches} ({steps} steps, {val_batches} val batches)")
        for e in epochs:
            for k in ("loss", "acc", "agent_loss", "advantage", "entropy"):
                check(math.isfinite(e[k]), f"dp_config {k} {e[k]}")
        check(math.isfinite(val["loss"]) and -1.0 <= val["acc"] <= 1.0, f"val {val}")
        check(preds.shape == (len(exp.val_ds), cfg.model.classes, 2)
              and np.isfinite(preds).all(), f"preds {preds.shape}")

        it = iter(exp.loader)
        batch = next(it)  # a group of 1: the split holds one batch of 48
        it.close()
        sb = {k: v.expand(DP_CONFIG_K, *v.shape[1:]).contiguous() for k, v in batch.items()}
        B = batch["index"].shape[1]
        dispatch = exp.train_step
        dispatch(exp.state, sb)  # warms up and captures
        torch.cuda.synchronize()
        check(dispatch.captures == 1, f"dp_config captures {dispatch.captures}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(DP_CONFIG_TIMED):
            dispatch(exp.state, sb)
        end.record()
        end.synchronize()
        step_s = (time.perf_counter() - t0) / (DP_CONFIG_TIMED * DP_CONFIG_K)
        event_ms = start.elapsed_time(end) / (DP_CONFIG_TIMED * DP_CONFIG_K)
        prof = profile_run(lambda: dispatch(exp.state, sb))
        peak = max(peak, torch.cuda.max_memory_allocated())
    finally:
        exp.close()
    decode = {"ycc_canvas": counter(ycc.YCC_LAUNCHES),
              "idct_islow": counter(islow.IDCT_LAUNCHES)}
    check(decode["ycc_canvas"] > 0 and decode["idct_islow"] == decode["ycc_canvas"],
          f"dp_config: decode launches {decode}")
    emit("dp_config", config=cfg.name, stacks=cfg.model.stacks, feats=cfg.model.feats,
         batch=B, inp_res=list(cfg.aug.inp_res), out_res=list(cfg.aug.out_res),
         num_devices=cfg.num_devices, dtype="bfloat16", pad_hw=list(cfg.pad_hw),
         epochs=DP_CONFIG_EPOCHS, steps=steps, train_seconds=train_s,
         epoch_img_per_s=[e["images_per_sec"] for e in epochs], val_seconds=val_s,
         val_loss=val["loss"], val_acc=val["acc"],
         loss=[e["loss"] for e in epochs], agent_loss=[e["agent_loss"] for e in epochs],
         steps_per_dispatch=DP_CONFIG_K, timed_dispatches=DP_CONFIG_TIMED,
         img_per_s=B / step_s, step_ms_events=event_ms,
         device_busy_ms_per_step=prof["device_busy_ms"] / DP_CONFIG_K,
         idle_share=prof["idle_share"], profile=prof, max_memory_allocated=peak,
         capture_seconds=dispatch.capture_seconds, pool_bytes=dispatch.pool_bytes,
         launches=launches, decode_routes=[routes], ycc_canvas_launches=decode["ycc_canvas"],
         idct_islow_launches=decode["idct_islow"])
    return launches, decode


def _dp_model(cfg, state_np, dev, group):
    model = hg(num_stacks=cfg.model.stacks, num_classes=cfg.model.classes,
               num_feats=cfg.model.feats, depth=cfg.model.depth,
               dtype=torch.bfloat16 if cfg.model.bf16 else torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_np.items()})
    return convert_cross_replica_(model.to(dev), group)


@contextlib.contextmanager
def _policy(record=None, draws=None):
    """Record the joint step's draws (``record``, a dict), or make it take
    ``draws`` (by global sample index) in place of its own."""
    real = adversarial.sample_policy

    def recording(seed, step, index, logits, *args):
        out = real(seed, step, index, logits, *args)
        extras, adv, ref, jitter = out
        record.update(index=index.cpu(), extras={k: v.cpu() for k, v in extras.items()},
                      adv=[t.cpu() for t in adv], ref=[t.cpu() for t in ref],
                      jitter=None if jitter is None else jitter.cpu())
        return out

    def replaying(seed, step, index, logits, *args):
        row = {int(i): j for j, i in enumerate(draws["index"])}
        r = torch.as_tensor([row[int(i)] for i in index.tolist()])
        t = lambda a: torch.as_tensor(a)[r].to(index.device)  # noqa: E731
        jitter = None if draws["jitter"] is None else t(draws["jitter"])
        params = adversarial.AugParams
        return ({k: t(v) for k, v in draws["extras"].items()},
                params(*map(t, draws["adv"])), params(*map(t, draws["ref"])), jitter)

    adversarial.sample_policy = recording if record is not None else replaying
    try:
        yield
    finally:
        adversarial.sample_policy = real


def _dp_step(job, group, rank, world, dev):
    """One step of ``job["kind"]`` ("train", "joint" or "eval") from the
    job's weights on this rank's rows of its global batch (all of it with
    no group); what it computed, where it left the networks, and the
    rasterizer's launches."""
    cfg, kind = job["cfg"], job["kind"]
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = job["tf32"]
    try:
        model = _dp_model(cfg, job["pose"], dev, group)
        local = shard_slice(job["batch"], rank, world)
        reset_counters(RASTER)
        nets = {"pose": model}
        out = {}
        if kind == "eval":
            step = make_eval_step(model, cfg.aug, MPII_MEAN, group=group, device=dev)
            seen = {}
            hook = model.score[-1].register_forward_hook(
                lambda mod, args, y: seen.__setitem__("heatmaps", y.detach().float()))
            m, preds = step(local)
            hook.remove()
            out["preds"] = gather_rows(preds, group)
            out["heatmaps"] = gather_rows(seen["heatmaps"], group)
        elif kind == "train":
            opt = make_optimizer(model.parameters(), cfg.optim, steps_per_epoch=1)
            step = make_train_step(model, opt, cfg.aug, MPII_MEAN, seed=SEED, group=group,
                                   device=dev)
            with _crops(model, out if job["crops"] else None):
                m = step(TrainState(model, opt), local)
        else:
            state, kw = _joint_state(cfg, dev, SEED, widths=job["widths"], steps_per_epoch=1)
            state.pose = TrainState(model, make_optimizer(model.parameters(), cfg.optim,
                                                          steps_per_epoch=1))
            agent = state.agent.model
            agent.load_state_dict({k: torch.from_numpy(v) for k, v in job["agent"].items()})
            convert_cross_replica_(agent, group)
            nets["agent"] = agent
            step = make_joint_step(model, agent, state.pose.optimizer, state.agent.optimizer,
                                   cfg.aug, MPII_MEAN, seed=SEED, group=group, device=dev,
                                   **kw)
            record = {} if job["draws"] is None else None
            with _policy(record, job["draws"]), _crops(model, out if job["crops"] else None):
                m = step(state, local)
            out["draws"] = record
        out.update(metrics={k: v.float() for k, v in m.items()},
                   launches=counter(RASTER))
        for name, net in nets.items():
            out[name] = {"grads": {n: p.grad.float() for n, p in net.named_parameters()
                                   if p.grad is not None},
                         "stats": {k: v for k, v in net.state_dict().items()
                                   if "running" in k}}
        return to_numpy(out)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@contextlib.contextmanager
def _crops(model, out):
    """With ``out`` (a dict), record in it the crops and targets of the
    pose network's train-mode pass (``crops``): the last train-mode input
    and the target of the last loss call after it."""
    if out is None:
        yield
        return
    import posetpu_torch.train.step as step_module

    losses = {"train": (step_module, "stacked_mse"),
              "joint": (adversarial, "per_sample_stacked_mse")}
    real = {k: getattr(mod, name) for k, (mod, name) in losses.items()}
    seen = {}

    def pre(mod, args):
        if mod.training:
            seen["input"] = args[0].detach()

    def wrap(fn):
        def loss(outs, target, *a):
            seen["target"] = target.detach()
            return fn(outs, target, *a)
        return loss

    hook = model.register_forward_pre_hook(pre)
    for k, (mod, name) in losses.items():
        setattr(mod, name, wrap(real[k]))
    try:
        yield
    finally:
        hook.remove()
        for k, (mod, name) in losses.items():
            setattr(mod, name, real[k])
    out["crops"] = (seen["input"], seen["target"])


def _grads64(job, dev):
    """The pose loss's gradients in float64 on the card, on the crops and
    targets the one-process step trained on (``crops``): the reference
    that the small f32 comparison holds the ranks' averaged gradients to."""
    cfg = job["cfg"]
    model = hg(num_stacks=cfg.model.stacks, num_classes=cfg.model.classes,
               num_feats=cfg.model.feats, depth=cfg.model.depth, dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in job["pose"].items()})
    model = model.double().to(dev).train()
    inp, tgt = (torch.as_tensor(a, device=dev, dtype=torch.float64) for a in job["crops"])
    stacked_mse(model(inp), tgt).backward()
    return to_numpy({n: p.grad for n, p in model.named_parameters()})


def _bucket_numel(cfg):
    """Parameters of ``cfg``'s pose network: its gradient bucket's length."""
    return sum(p.numel() for p in hg(num_stacks=cfg.model.stacks, num_classes=cfg.model.classes,
                                     num_feats=cfg.model.feats,
                                     depth=cfg.model.depth).parameters())


def _all_reduce_ms(group, numel, dev, reps=5):
    """Milliseconds of one ``all_reduce_mean_`` of a float32 gradient
    bucket of ``numel`` on ``dev`` (host clock to a synchronize, after a
    warm-up; the median of ``reps``)."""
    from posetpu_torch.parallel import all_reduce_mean_

    grads = [torch.ones(numel, device=dev)]
    all_reduce_mean_(grads, group)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        all_reduce_mean_(grads, group)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _dp_rank_all_reduce(ctx, numel):
    return _all_reduce_ms(ctx.group, numel, ctx.device)


def _dp_rank(ctx, job):
    """:func:`_dp_step` on a rank of the dp_gloo2 pool."""
    return _dp_step(job, ctx.group, ctx.rank, ctx.world, ctx.device)


def _dp_job(kind, cfg, tf32, seed, widths=(8, 16)):
    """Seeded weights (pose network, and the agent for a joint step) and a
    global batch of DP_GLOO_BATCH for one dp_gloo2 comparison."""
    torch.manual_seed(seed)
    pose = hg(num_stacks=cfg.model.stacks, num_classes=cfg.model.classes,
              num_feats=cfg.model.feats, depth=cfg.model.depth, dtype=torch.float32)
    job = {"kind": kind, "cfg": cfg, "tf32": tf32, "widths": widths, "draws": None,
           "crops": False, "pose": to_numpy(pose.state_dict())}
    if kind == "joint":
        state, _ = _joint_state(cfg, "cpu", seed + 1, widths=widths, steps_per_epoch=1)
        job["agent"] = to_numpy(state.agent.model.state_dict())
    rng = np.random.RandomState(seed + 2)
    res = tuple(2 * r for r in cfg.aug.inp_res)
    if kind == "eval":
        b = _eval_batch(rng, DP_GLOO_BATCH, res, cfg.model.classes)
        b["mask"][-3:] = 0.0  # a ragged last batch, padded
    else:
        b = _train_batch(rng, DP_GLOO_BATCH, res, cfg.model.classes, 5000 + seed)
    job["batch"] = b
    return job


def _mean_gap(a, b):
    keys = sorted(b)
    return float(np.mean(np.concatenate([np.abs(a[k] - b[k]).ravel() for k in keys])))


def _max_gap_np(a, b):
    return max(float(np.abs(a[k] - b[k]).max()) for k in b)


def _dp_f32_checks(label, kind, got, want, g64):
    """A small f32 step on two ranks against one process (train_parity's
    and joint_parity's derived bounds), and its pose gradients against the
    float64 gradients of the same loss on the same crops (``g64``).
    Returns (gaps, failures).

    The one process's float32 gradients are no reference for the ranks':
    its BatchNorm takes a two-pass variance where the cross-replica norm
    takes flax's one-pass E[x²] - E[x]², and on the CPU the one process's
    lie 1.1e-2 to 6.7e-2 from float64 on such steps where the ranks' lie
    4.1e-4.  The ranks' pose gradients are held to float64 within
    DP_GRAD_ATOL (below).  The agent's gradients are held to the one
    process's within JOINT_GRAD_ATOL."""
    bad = []
    for k, w in want["metrics"].items():
        g = got["metrics"][k]
        if k == "pck_cnt":  # from the targets alone
            if not np.array_equal(g, w):
                bad.append(f"{label}: {k}")
            continue
        # a joint more or less near an argmax tie
        tol = {"acc": 0.1, "pck_hit": 1.0}.get(k, PARITY_ATOL + PARITY_RTOL * np.abs(w))
        if not np.all(np.abs(g - w) <= tol):
            bad.append(f"{label}: {k} {g} vs {w}")
    if kind == "eval":
        gap = _max_gap_np({"h": got["heatmaps"]}, {"h": want["heatmaps"]})
        if not np.allclose(got["heatmaps"], want["heatmaps"], atol=PARITY_ATOL,
                           rtol=PARITY_RTOL):
            bad.append(f"{label}: heatmaps {gap}")
        if got["preds"].shape != want["preds"].shape or not np.isfinite(got["preds"]).all():
            bad.append(f"{label}: preds {got['preds'].shape}")
        return {"heatmaps": gap}, bad
    gaps = {"pose_grad_one_vs_f64": _max_gap_np(want["pose"]["grads"], g64)}
    for net in ("pose", "agent") if kind == "joint" else ("pose",):
        ref, tol = (g64, DP_GRAD_ATOL) if net == "pose" else (want[net]["grads"], JOINT_GRAD_ATOL)
        gaps[f"{net}_grad"] = _max_gap_np(got[net]["grads"], ref)
        if gaps[f"{net}_grad"] > tol:
            bad.append(f"{label}: {net} gradients {gaps[f'{net}_grad']} (bound {tol})")
        for k, w in want[net]["stats"].items():
            g = got[net]["stats"][k]
            if not np.all(np.abs(g - w) <= TRAIN_STATS_ATOL + TRAIN_STATS_RTOL * np.abs(w)):
                bad.append(f"{label}: {net} {k}")
        gaps[f"{net}_stats"] = _max_gap_np(got[net]["stats"], want[net]["stats"])
    return gaps, bad


def _dp_bf16_checks(label, kind, got, want16, want32):
    """A full-width bf16 step on two ranks against one process, by the
    ratio of their mean gap to the one process's bf16-vs-f32 gap.
    Returns (gaps, failures)."""
    pairs = [("heatmaps", {"h": got["heatmaps"]}, {"h": want16["heatmaps"]},
              {"h": want32["heatmaps"]})] if kind == "eval" else [
        (f"{net}_grad", got[net]["grads"], want16[net]["grads"], want32[net]["grads"])
        for net in (("pose", "agent") if kind == "joint" else ("pose",))]
    gaps, bad = {}, []
    for name, g, w16, w32 in pairs:
        dp, prec = _mean_gap(g, w16), _mean_gap(w16, w32)
        gaps[name] = {"dp_vs_one": dp, "bf16_vs_f32": prec}
        if not (prec > 0 and dp <= DP_RATIO * prec):
            bad.append(f"{label}: {name} {gaps[name]}")
    return gaps, bad


def phase_dp_gloo2(dev="cuda"):
    """Two gloo ranks on this one card (CUDA tensors), each with half of a
    global batch: the eager train step, the joint step (its draws taken
    from the one-process step, by sample index) and the eval step (a
    padded ragged batch; predictions gathered), each against one process
    on the same batch and weights.  hg2 at feats 8 in f32 with TF32 off,
    within train_parity's and joint_parity's bounds; then hg8 at full width
    in bf16, by the ratio to the one process's bf16-vs-f32 gap.  Every rank
    ends with the same metrics and statistics, and launches the rasterizer
    once a train or eval step and twice a joint step."""
    small = named_config("hg2_mpii_mini")
    small.model.feats, small.model.bf16 = 8, False
    small.aug.inp_res, small.aug.out_res = (64, 64), (16, 16)
    small.agent.enabled, small.agent.occ_nodes = True, 6
    small.agent.occ_levels = (1, 2)
    full = named_config("hg8_mpii_asr")
    launches = [0] * DP_GLOO_WORLD
    out, bad = {}, []
    t0 = time.perf_counter()
    # the ranks share the card (``dev="cpu"`` rehearses the phase on the CPU)
    devices = "cuda:0" if dev == "cuda" else dev
    with RankPool(DP_GLOO_WORLD, devices=devices, backend="gloo") as pool:
        start_s = time.perf_counter() - t0
        for kind in ("train", "joint", "eval"):
            job = _dp_job(kind, small, tf32=False, seed=SEED + 30)
            job["crops"] = kind != "eval"
            one = _dp_step(job, None, 0, 1, dev)
            job.update(draws=one.get("draws"), crops=False)
            g64 = _grads64(dict(job, crops=one["crops"]), dev) if kind != "eval" else None
            ranks = pool.run(_dp_rank, job)
            if not ranks_equal([{k: r[k] for k in r if k != "draws"} for r in ranks]):
                bad.append(f"dp_gloo2 f32 {kind}: the ranks differ")
            want = DP_RASTER_LAUNCHES[kind] if dev == "cuda" else 0  # the CPU's plain version
            if not (all(r["launches"] == want for r in ranks) and one["launches"] == want):
                bad.append(f"dp_gloo2 f32 {kind} launches {[r['launches'] for r in ranks]}")
            launches = [n + r["launches"] for n, r in zip(launches, ranks)]
            gaps, failed = _dp_f32_checks(f"dp_gloo2 f32 {kind}", kind, ranks[0], one, g64)
            bad += failed
            out[f"f32_{kind}"] = {
                "gaps": gaps,
                "loss": [float(one["metrics"]["loss"]), float(ranks[0]["metrics"]["loss"])]}

            job = _dp_job(kind, full, tf32=True, seed=SEED + 40,
                          widths=(32, 64, 128, 256))
            one16 = _dp_step(job, None, 0, 1, dev)
            job["draws"] = one16.get("draws")
            job32 = dict(job, cfg=copy.deepcopy(full), tf32=False)
            job32["cfg"].model.bf16 = False
            one32 = _dp_step(job32, None, 0, 1, dev)
            ranks = pool.run(_dp_rank, job)
            if not ranks_equal([{k: r[k] for k in r if k != "draws"} for r in ranks]):
                bad.append(f"dp_gloo2 bf16 {kind}: the ranks differ")
            launches = [n + r["launches"] for n, r in zip(launches, ranks)]
            gaps, failed = _dp_bf16_checks(f"dp_gloo2 bf16 {kind}", kind, ranks[0], one16,
                                           one32)
            bad += failed
            out[f"bf16_{kind}"] = {
                "gaps": gaps,
                "loss": [float(one16["metrics"]["loss"]), float(ranks[0]["metrics"]["loss"]),
                         float(one32["metrics"]["loss"])]}
        seconds = time.perf_counter() - t0
        numel = _bucket_numel(full)
        all_reduce = pool.run(_dp_rank_all_reduce, numel) if dev == "cuda" else None
    want = 2 * sum(DP_RASTER_LAUNCHES.values()) if dev == "cuda" else 0
    emit("dp_gloo2", world=DP_GLOO_WORLD, backend="gloo", device="cuda:0 (shared)",
         global_batch=DP_GLOO_BATCH, small="hg2 feats 8 f32 TF32 off",
         full=f"hg8 feats 128 bf16 {tuple(full.aug.inp_res)}", ratio=DP_RATIO,
         pool_start_seconds=start_s, seconds=seconds, launches_per_rank=launches,
         collectives={"bucket_numel": numel, "bucket_bytes": 4 * numel,
                      "all_reduce_ms_per_rank": all_reduce}, failures=bad, **out)
    check(not bad, "; ".join(bad))
    check(launches == [want] * DP_GLOO_WORLD, f"dp_gloo2 launches {launches}, want {want}")
    return sum(launches)


def _kernel_names(run, part):
    """Device kernels of one ``run()`` under torch.profiler whose names
    hold ``part`` (any case), with their calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and part in e.name.lower():
            names[e.name[:90]] = names.get(e.name[:90], 0) + 1
    return names


def _cross_replica_norms_(model, group):
    """Give every norm of ``model`` ``group``, also a group of one rank
    (which :func:`convert_cross_replica_` leaves local): the norms then take
    their statistics by the cross-replica route, all-reduces included.
    Returns how many norms there are."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.group = group
    return len(norms)


def _dp_norm_cost(group):
    """hg8_mpii (bf16, batch BATCH) graphed at K = 1 under ``group``: one
    step with the norms local, one with every norm on the cross-replica
    route (plain float32 ops and two all-reduces a norm), each captured
    once and its replay timed with CUDA events."""
    cfg = named_config("hg8_mpii")
    rng = np.random.RandomState(SEED + 53)
    sb = _stack([_train_batch(rng, BATCH, CANVAS, cfg.model.classes, 9000)])
    torch.manual_seed(SEED + 52)
    base = hg(num_stacks=cfg.model.stacks, num_classes=cfg.model.classes,
              num_feats=cfg.model.feats, depth=cfg.model.depth)
    out = {}
    for how in ("local", "cross"):
        model = copy.deepcopy(base).cuda()
        norms = _cross_replica_norms_(model, group) if how == "cross" else 0
        opt = make_optimizer(model.parameters(), cfg.optim,
                             steps_per_epoch=MPII_TRAIN_SAMPLES // BATCH)
        state = TrainState(model, opt)
        dispatch = make_dispatch_step(model, opt, cfg.aug, MPII_MEAN, seed=SEED, steps=1,
                                      group=group, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = dispatch(state, sb)["loss"].item()  # warms up, captures, replays
        out[how] = {"norms": norms, "step_ms": cuda_ms(_graph_replay(dispatch), reps=1, samples=5),
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "first_loss": loss, "captures": dispatch.captures}
        del dispatch, state, opt, model
        torch.cuda.empty_cache()
    out["cost_ms_per_step"] = out["cross"]["step_ms"] - out["local"]["step_ms"]
    return out


def phase_dp_nccl1():
    """NCCL at world size 1 in this process: make_dispatch_step(group=...)
    with K = NCCL_K, hg2 at feats 8, f32, TF32 off, deterministic
    algorithms, NCCL_DISPATCHES dispatches from one state, four ways: the
    group-less graph ("plain"); the group's graph ("nccl", its norms local
    as at one rank, so equal to "plain" bit for bit); the group's graph
    with every norm forced onto the cross-replica route ("norms": each
    norm's differentiable all-reduce captured, the backward ones issued
    from autograd's thread); and the same eagerly ("norms_eager", equal to
    "norms" bit for bit).  Every all-reduce of a captured step must be
    issued while the stream captures (so it replays inside the graph); a
    replay under torch.profiler lists its NCCL kernels.  Then the joint
    step's graph (make_joint_dispatch_step, hg8_mpii_asr's agent cut as
    joint_dispatch_parity cuts it) without and with the group: the
    group's captures JOINT_ALL_REDUCES calls a step and equals the
    group-less graph bit for bit.  Then the forced norms' cost at hg8_mpii
    width (:func:`_dp_norm_cost`)."""
    import torch.distributed as dist

    cfg = named_config("hg2_mpii_mini")
    cfg.model.feats, cfg.model.bf16 = 8, False
    cfg.aug.inp_res, cfg.aug.out_res = (64, 64), (16, 16)
    B, J = 8, cfg.model.classes
    rng = np.random.RandomState(SEED + 50)
    supers = [_stack([_train_batch(rng, B, (96, 128), J, 7000 + (d * NCCL_K + i) * B)
                      for i in range(NCCL_K)]) for d in range(NCCL_DISPATCHES)]
    group = init_process_group(0, 1, "cuda:0", backend="nccl", port=free_port())
    calls = {}
    real = dist.all_reduce

    def counted(tensor, *args, **kw):
        key = "capturing" if torch.cuda.is_current_stream_capturing() else "eager"
        calls[how][key] += 1
        return real(tensor, *args, **kw)

    with _exact_f32():
        torch.manual_seed(SEED + 51)
        base = hg(num_stacks=cfg.model.stacks, num_classes=J, num_feats=cfg.model.feats,
                  dtype=torch.float32)
        runs, dispatches = {}, {}
        for how in ("plain", "nccl", "norms", "norms_eager"):
            model = copy.deepcopy(base).cuda()
            norms = _cross_replica_norms_(model, group) if how.startswith("norms") else 0
            opt = make_optimizer(model.parameters(), cfg.optim, steps_per_epoch=2)
            state = TrainState(model, opt)
            kw = dict(seed=SEED, group=None if how == "plain" else group, device="cuda")
            reset_counters(RASTER)
            calls[how] = {"capturing": 0, "eager": 0, "norms": norms}
            dist.all_reduce = counted
            try:
                if how == "norms_eager":
                    step = make_train_step(model, opt, cfg.aug, MPII_MEAN, **kw)
                    ms = [step(state, {k: v[i] for k, v in sb.items()})
                          for sb in supers for i in range(NCCL_K)]
                    metrics = {k: torch.stack([m[k] for m in ms]).cpu() for k in ms[0]}
                else:
                    dispatch = make_dispatch_step(model, opt, cfg.aug, MPII_MEAN,
                                                  steps=NCCL_K, **kw)
                    ms = [dispatch(state, sb) for sb in supers]
                    metrics = {k: torch.cat([m[k] for m in ms]).cpu() for k in ms[0]}
                    dispatches[how] = dispatch
            finally:
                dist.all_reduce = real
            torch.cuda.synchronize()
            runs[how] = (state.snapshot(), metrics,
                         counter(RASTER))
        replay = profile_run(_graph_replay(dispatches["nccl"]))
        nccl_kernels = _kernel_names(_graph_replay(dispatches["norms"]), "nccl")

        jcfg = _small_joint_cfg("hg8_mpii_asr", {})
        jrng = np.random.RandomState(SEED + 55)
        jsupers = [_stack([_train_batch(jrng, B, (96, 128), J, 8000 + (d * NCCL_K + i) * B)
                           for i in range(NCCL_K)]) for d in range(NCCL_DISPATCHES)]
        for how in ("joint_plain", "joint_nccl"):
            state, kw = _joint_state(jcfg, "cuda", SEED + 56, widths=(8, 16),
                                     steps_per_epoch=2)
            reset_counters(RASTER)
            calls[how] = {"capturing": 0, "eager": 0, "norms": 0}
            dist.all_reduce = counted
            try:
                dispatch = _joint_dispatch_for(state, jcfg, "cuda", kw, NCCL_K,
                                               group=None if how == "joint_plain" else group)
                ms = [dispatch(state, sb) for sb in jsupers]
                metrics = {k: torch.cat([m[k] for m in ms]).cpu() for k in ms[0]}
            finally:
                dist.all_reduce = real
            torch.cuda.synchronize()
            runs[how] = (state.snapshot(), metrics,
                         counter(RASTER))
            dispatches[how] = dispatch
        numel = _bucket_numel(named_config("hg8_mpii"))
        all_reduce_ms = _all_reduce_ms(group, numel, torch.device("cuda:0"))
    try:
        norm_cost = _dp_norm_cost(group)
    finally:
        dist.destroy_process_group()
    steps = NCCL_K * NCCL_DISPATCHES
    norms = calls["norms"]["norms"]
    emit("dp_nccl1", world=1, backend="nccl", steps_per_dispatch=NCCL_K,
         dispatches=NCCL_DISPATCHES, batch=B,
         captures={k: d.captures for k, d in dispatches.items()},
         all_reduce_calls=calls, param_gap_nccl=_gap(runs["plain"][0], runs["nccl"][0]),
         param_gap_norms_eager=_gap(runs["norms"][0], runs["norms_eager"][0]),
         param_gap_norms_vs_local=_gap(runs["plain"][0], runs["norms"][0]),
         param_gap_joint=_gap(runs["joint_plain"][0], runs["joint_nccl"][0]),
         loss=runs["nccl"][1]["loss"].tolist(),
         launches={k: r[2] for k, r in runs.items()},
         joint_all_reduces_per_step=JOINT_ALL_REDUCES,
         collectives={"bucket_numel": numel, "bucket_bytes": 4 * numel,
                      "all_reduce_ms": all_reduce_ms, "hg8_norms": norm_cost},
         replay_nccl_kernels=nccl_kernels, replay_profile=replay)
    check(all(d.captures == 1 for d in dispatches.values()), f"captures {dispatches}")
    # each captured step: one gradient bucket and one metric bucket, and a
    # forced norm's one all-reduce forward and one backward
    check(calls["nccl"]["capturing"] == 2 * NCCL_K, f"all-reduce calls {calls}")
    check(norms > 0 and calls["norms"]["capturing"] == (2 + 2 * norms) * NCCL_K,
          f"all-reduce calls {calls}")
    check(calls["norms_eager"] == {"capturing": 0, "eager": (2 + 2 * norms) * steps,
                                   "norms": norms}, f"all-reduce calls {calls}")
    for a, b in (("plain", "nccl"), ("norms_eager", "norms")):
        (sa, ma, _), (sb_, mb, _) = runs[a], runs[b]
        check(sa[1:] == sb_[1:] == (steps, steps), f"counts {a} {sa[1:]}, {b} {sb_[1:]}")
        # one message: an f-string is built even when the check holds, and
        # _gap reads every tensor (one per tensor cost minutes a run)
        check(all(torch.equal(x, y) for x, y in zip(sa[0], sb_[0], strict=True)),
              f"{b} differs from {a} by {_gap(sa, sb_)}")
        for k in ma:
            check(torch.equal(ma[k], mb[k]), f"{b}'s {k} differs from {a}'s")
    check(calls["joint_nccl"]["capturing"] == JOINT_ALL_REDUCES * NCCL_K
          and calls["joint_plain"]["capturing"] == calls["joint_plain"]["eager"] == 0,
          f"joint all-reduce calls {calls}")
    (sa, ma, _), (sb_, mb, _) = runs["joint_plain"], runs["joint_nccl"]
    _same_state("dp_nccl1 joint", sa, sb_)
    check(sa[2] == steps, f"joint step {sa[2]}")
    for k in ma:
        check(torch.equal(ma[k], mb[k]), f"dp_nccl1 joint: the group's {k} differs")
    want = steps + WARMUP_STEPS
    got = {k: r[2] for k, r in runs.items()}
    jwant = JOINT_RASTER_LAUNCHES * want
    check(got == {"plain": want, "nccl": want, "norms": want, "norms_eager": steps,
                  "joint_plain": jwant, "joint_nccl": jwant},
          f"launches {got}, want {want} a graph, {steps} eagerly and {jwant} a joint graph")
    for how in ("local", "cross"):
        c = norm_cost[how]
        check(c["captures"] == 1 and math.isfinite(c["first_loss"]),
              f"hg8 {how} norms: {c}")
    return runs["nccl"][2] + runs["joint_nccl"][2]


# variants: residual blocks a site of the hourglass at hg8_mpii width (the
# reference's default, then --blocks 2), graphed dispatches timed after
# the one that captures
VARIANT_BLOCKS, VARIANT_TIMED = (1, 2), 3
# remat: (config, batch) at full width: hg8_mpii, and hg8_mpii_384_dp8's
# global batch on one card (384² crops, 96² heatmaps), where remat is meant
# to make room
REMAT_CASES = (("hg8_mpii", BATCH), ("hg8_mpii_384_dp8", 48))


def _hg_for(cfg, **kw):
    """The network of ``cfg.model`` as Experiment builds it (layout and
    dtype; remat as ``kw`` says)."""
    m = cfg.model
    return hg(num_stacks=m.stacks, num_blocks=m.blocks, num_classes=m.classes,
              num_feats=m.feats, depth=m.depth,
              dtype=torch.bfloat16 if m.bf16 else torch.float32,
              scan_stacks=m.scan_stacks, **kw)


def _fresh_state(cfg):
    model = _hg_for(cfg)
    return TrainState(model, make_optimizer(model.parameters(), cfg.optim))


def _same_predictions(label, a, b):
    for k in a:
        check(np.array_equal(a[k], b[k]), f"{label}: {k} differs")


def _variant_run(cfg, workdir):
    """One --blocks value (module docstring, ``variants``): eager steps,
    the K = 1 graph, then serving from a run directory.  Returns (fields,
    rasterizer launches)."""
    torch.cuda.empty_cache()
    torch.manual_seed(SEED + 20)
    model = _hg_for(cfg).cuda()
    opt = make_optimizer(model.parameters(), cfg.optim,
                         steps_per_epoch=MPII_TRAIN_SAMPLES // BATCH)
    state = TrainState(model, opt)
    rng = np.random.RandomState(SEED + 21)
    batches = [_train_batch(rng, BATCH, CANVAS, cfg.model.classes, i * BATCH)
               for i in range(1 + NUM_BATCHES)]
    step = make_train_step(model, opt, cfg.aug, MPII_MEAN, seed=SEED, device="cuda")
    step(state, batches[0])  # warm-up: cuDNN and cuBLAS set-up, not timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(RASTER)
    t0 = time.perf_counter()
    metrics = [step(state, b) for b in batches[1:]]
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager = counter(RASTER)
    eager_peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in metrics]
    check(eager == NUM_BATCHES, f"blocks {cfg.model.blocks}: eager launches {eager}")
    check(all(math.isfinite(x) for x in losses), f"blocks {cfg.model.blocks}: losses {losses}")

    dispatch = make_dispatch_step(model, opt, cfg.aug, MPII_MEAN, seed=SEED, steps=1,
                                  device="cuda")
    supers = [_stack([b]) for b in batches[1:]]
    torch.cuda.reset_peak_memory_stats()
    reset_counters(RASTER)
    dispatch(state, supers[0])  # warms up, captures, replays
    first = counter(RASTER)
    check(first == WARMUP_STEPS + 1, f"blocks {cfg.model.blocks}: first dispatch {first}")
    reset_counters(RASTER)
    t0 = time.perf_counter()
    graphed = [dispatch(state, sb) for sb in supers[1:1 + VARIANT_TIMED]]
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    timed = counter(RASTER)
    graph_peak = torch.cuda.max_memory_allocated()
    check(timed == VARIANT_TIMED, f"blocks {cfg.model.blocks}: graphed launches {timed}")
    check(dispatch.captures == 1, f"blocks {cfg.model.blocks}: captures {dispatch.captures}")
    graph_losses = [m["loss"].item() for m in graphed]
    check(all(math.isfinite(x) for x in graph_losses), f"graphed losses {graph_losses}")
    prof = profile_run(lambda: dispatch(state, supers[1]))
    replay_ms = cuda_ms(_graph_replay(dispatch), reps=1, samples=5)
    steps = 1 + NUM_BATCHES + 1 + VARIANT_TIMED + 1
    check(state.step == opt.count == steps, f"step {state.step}, count {opt.count}")

    run_dir = os.path.join(workdir, f"variants_blocks{cfg.model.blocks}")
    CheckpointManager(run_dir).save(state, 0, 0.0)
    served = PosePredictor.from_config(cfg, run_dir, mean=MPII_MEAN)
    request = _serve_batches(np.random.RandomState(SEED + 22))[0]
    _same_predictions(f"blocks {cfg.model.blocks} served from {run_dir}", served(*request),
                      PosePredictor(model, mean=MPII_MEAN)(*request))
    fields = dict(blocks=cfg.model.blocks, params=sum(p.numel() for p in model.parameters()),
                  eager_img_per_s=BATCH * NUM_BATCHES / eager_s, eager_loss=losses,
                  eager_max_memory_allocated=eager_peak,
                  capture_seconds=dispatch.capture_seconds[0],
                  pool_bytes=dispatch.pool_bytes[0],
                  graph_img_per_s=BATCH * VARIANT_TIMED / graph_s, graph_loss=graph_losses,
                  graph_max_memory_allocated=graph_peak,
                  device_busy_ms_per_step=prof["device_busy_ms"], replay_ms_per_step=replay_ms,
                  idle_share=prof["idle_share"], profile=prof,
                  launches={"eager": eager, "first_dispatch": first, "graphed": timed})
    del dispatch, state, model, opt, served
    return fields, eager + first + timed


def phase_variants(cfg, workdir):
    """hg8_mpii at full width (bf16, batch 32, seeded weights, color
    jitter) with 1, then 2 residual blocks a site (--blocks 2): one warm-up
    and NUM_BATCHES timed make_train_step calls, then make_dispatch_step at
    K = 1 (the graph Experiment trains through): the capture (its warm-up
    steps and the replay launch the rasterizer once each), VARIANT_TIMED
    timed dispatches and one under torch.profiler; then the state saved as
    a run directory and served through PosePredictor.from_config(cfg,
    run_dir), whose predictions equal those of a predictor holding the
    trained network.  Launch counts are reset just before each counted
    part."""
    runs, total = [], 0
    for blocks in VARIANT_BLOCKS:
        c = copy.deepcopy(cfg)
        c.model.blocks = blocks
        fields, launches = _variant_run(c, workdir)
        runs.append(fields)
        total += launches
    emit("variants", config=cfg.name, stacks=cfg.model.stacks, feats=cfg.model.feats,
         batch=BATCH, canvas=list(CANVAS), dtype="bfloat16", runs=runs, launches=total)
    return total


def _remat_runs(cfg, B, timed):
    """From one state: remat off twice and remat on once, one train step
    each; with ``timed``, each step's peak memory and (one more step each)
    its device busy ms under torch.profiler.  Then remat on through the
    K = 1 graph from the same state.  Returns ({run: (snapshot, loss)},
    measurements, rasterizer launches)."""
    torch.cuda.empty_cache()
    torch.manual_seed(SEED + 30)
    model = _hg_for(cfg).cuda()
    opt = make_optimizer(model.parameters(), cfg.optim,
                         steps_per_epoch=MPII_TRAIN_SAMPLES // B)
    state = TrainState(model, opt)
    rng = np.random.RandomState(SEED + 31)
    b0, b1 = (_train_batch(rng, B, CANVAS, cfg.model.classes, i * B) for i in range(2))
    step = make_train_step(model, opt, cfg.aug, MPII_MEAN, seed=SEED, device="cuda")
    step(state, b0)  # cuDNN set-up, not compared
    s0 = state.snapshot()
    runs, meas, launches = {}, {}, 0
    for name, remat in (("off_a", False), ("off_b", False), ("on", True)):
        model.remat = remat
        state.restore_(s0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counters(RASTER)
        t0 = time.perf_counter()
        loss = step(state, b1)["loss"].item()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n = counter(RASTER)
        check(n == 1, f"remat {name}: {n} launches")
        launches += n
        runs[name] = (state.snapshot(), loss)
        if timed and name != "off_b":
            m = {"step_seconds": seconds, "max_memory_allocated": torch.cuda.max_memory_allocated()}
            reset_counters(RASTER)
            prof = profile_run(lambda: step(state, b1))
            n = counter(RASTER)
            check(n == 1, f"remat {name} profiled step: {n} launches")
            launches += n
            m.update(device_busy_ms=prof["device_busy_ms"], idle_share=prof["idle_share"],
                     by_kind_ms=prof["by_kind_ms"])
            meas[name] = m
    if timed:
        model.remat = True
        state.restore_(s0)
        dispatch = make_dispatch_step(model, opt, cfg.aug, MPII_MEAN, seed=SEED, steps=1,
                                      device="cuda")
        reset_counters(RASTER)
        loss = dispatch(state, _stack([b1]))["loss"].item()  # warms up, captures, replays
        n = counter(RASTER)
        check(n == WARMUP_STEPS + 1, f"remat graph: {n} launches")
        launches += n
        runs["graph_on"] = (state.snapshot(), loss)
        meas["graph_on"] = {"capture_seconds": dispatch.capture_seconds[0],
                            "pool_bytes": dispatch.pool_bytes[0]}
        del dispatch
    del state, model, opt, s0
    return runs, meas, launches


def _remat_checks(label, runs, exact):
    """Remat on (and its graph) against remat off from one state: the loss
    and the BatchNorm statistics (forward values), ``num_batches_tracked``
    and the state after the update.  ``exact``: equal bit for bit;
    otherwise within GRAPH_GAP_FACTOR of the two remat-off runs' own gap
    (bit for bit when those agree)."""
    (sa, la), (sb, lb) = runs["off_a"], runs["off_b"]
    gaps = {"eager_param_gap": _gap(sa, sb), "eager_loss_gap": abs(la - lb)}
    for name in [n for n in runs if n.startswith(("on", "graph_on"))]:
        s, loss = runs[name]
        ints = [(x, y) for x, y in zip(_snap_tensors(sa), _snap_tensors(s), strict=True)
                if not x.is_floating_point()]
        check(all(torch.equal(x, y) for x, y in ints),
              f"{label} {name}: num_batches_tracked differs")
        gap, loss_gap = _gap(sa, s), abs(la - loss)
        gaps[f"{name}_param_gap"], gaps[f"{name}_loss_gap"] = gap, loss_gap
        if exact:
            same = all(torch.equal(x, y) for x, y in zip(_snap_tensors(sa), _snap_tensors(s)))
            check(same and loss_gap == 0.0, f"{label} {name}: not equal to remat off")
        else:
            check(gap <= GRAPH_GAP_FACTOR * gaps["eager_param_gap"],
                  f"{label} {name}: gap {gap}, eager runs {gaps['eager_param_gap']}")
            check(loss_gap <= GRAPH_GAP_FACTOR * gaps["eager_loss_gap"],
                  f"{label} {name}: loss gap {loss_gap}, eager {gaps['eager_loss_gap']}")
    return gaps


def phase_remat():
    """Remat on against off from one state, one train step each
    (make_train_step, full width, seeded weights): hg8_mpii at batch 32
    and hg8_mpii_384_dp8's shapes (384² crops, 96² heatmaps, batch 48) in
    bf16 (two remat-off runs measure the eager spread; remat on, eagerly
    and through the K = 1 CUDA graph, within GRAPH_GAP_FACTOR of it: the
    loss, the statistics and the state after the update; the
    num_batches_tracked equal), each step's peak memory and device busy
    ms; then hg8_mpii in float32 with TF32 off and deterministic
    algorithms, where remat on equals remat off bit for bit."""
    out, total = [], 0
    for name, B in REMAT_CASES:
        cfg = named_config(name)
        check((cfg.model.stacks, cfg.model.feats, cfg.model.bf16) == (8, 128, True), name)
        runs, meas, launches = _remat_runs(cfg, B, timed=True)
        gaps = _remat_checks(name, runs, exact=False)
        check(meas["on"]["max_memory_allocated"] < meas["off_a"]["max_memory_allocated"],
              f"{name}: remat did not lower the peak: {meas}")
        out.append({"config": name, "batch": B, "inp_res": list(cfg.aug.inp_res),
                    "out_res": list(cfg.aug.out_res), "dtype": "bfloat16",
                    "remat_off": meas["off_a"], "remat_on": meas["on"],
                    "graph_on": meas["graph_on"], **gaps, "launches": launches})
        total += launches
    cfg = named_config("hg8_mpii")
    cfg.model.bf16 = False
    with _exact_f32():
        runs, _, launches = _remat_runs(cfg, BATCH, timed=False)
    out.append({"config": "hg8_mpii", "batch": BATCH, "dtype": "float32",
                **_remat_checks("hg8_mpii float32", runs, exact=True), "launches": launches})
    total += launches
    emit("remat", runs=out, launches=total)
    return total


def phase_ckpt_interop(workdir):
    """A fit through the train CLI at full hg8_mpii width with --blocks 2
    --scan-stacks (remat through the K = 1 CUDA graph; one epoch of
    FIT_STEPS steps and FIT_VAL_BATCHES validation batches, bf16, batch
    32), then PosePredictor.from_config(cfg, run_dir), whose predictions
    equal a predictor's of the checkpoint's state dict; the JAX package's
    torch container written from the run's state and read back equal bit
    for bit (parameters, buffers, moments, update count and step); and
    from_config on phase_fit_joint's hg8_mpii_asr run directory serving its
    pose network."""
    from posetpu_torch.ckpt.torch_export import (
        restore_reference_checkpoint,
        save_reference_checkpoint,
    )

    torch.cuda.empty_cache()
    ckpt = os.path.join(workdir, "interop")
    t0 = time.perf_counter()
    rc, launches, out, decode = _cli(train_cli.main, [
        "--config", "hg8_mpii", "--synthetic", "--train-batch", str(BATCH),
        "--checkpoint", ckpt, "--epochs", "1", "--blocks", "2", "--scan-stacks"])
    fit_s = time.perf_counter() - t0
    check(rc == 0, f"train cli returned {rc}")
    _check_decode("ckpt_interop", decode)
    want = FIT_STEPS + FIT_VAL_BATCHES + WARMUP_STEPS + EVAL_WARMUP
    check(launches == want, f"ckpt_interop launches {launches}, want {want}")
    run_dir = os.path.join(ckpt, "hg8_mpii")
    vals, best = _check_run("ckpt_interop", run_dir, 1, FIT_STEPS)
    cfg = named_config("hg8_mpii")
    cfg.model.blocks, cfg.model.scan_stacks = 2, True
    mgr = CheckpointManager(run_dir)
    payload = mgr.load(mgr.best_path if best else None)
    model = _hg_for(cfg)
    model.load_state_dict(payload["state"]["model"])
    request = _serve_batches(np.random.RandomState(SEED + 40))[0]
    _same_predictions("from_config(run_dir)",
                      PosePredictor.from_config(cfg, run_dir, mean=MPII_MEAN)(*request),
                      PosePredictor(model, mean=MPII_MEAN)(*request))

    state = _fresh_state(cfg)
    _, epoch, best_acc = mgr.restore(state)
    path = os.path.join(workdir, "interop.pth.tar")
    t0 = time.perf_counter()
    save_reference_checkpoint(path, state, epoch, best_acc, cfg=cfg)
    write_s = time.perf_counter() - t0
    back = _fresh_state(cfg)
    t0 = time.perf_counter()
    check(restore_reference_checkpoint(back, path, cfg=cfg) == (epoch, best_acc),
          "the container's epoch and best accuracy")
    read_s = time.perf_counter() - t0
    sd, sd_back = state.model.state_dict(), back.model.state_dict()
    check(sd.keys() == sd_back.keys(), "container round trip: state dict keys")
    check(all(torch.equal(sd[k], sd_back[k]) for k in sd),
          "container round trip: parameters and buffers")
    moments = [(state.optimizer.state[p], back.optimizer.state[q])
               for p, q in zip(state.model.parameters(), back.model.parameters())]
    check(all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
              for a, b in moments), "container round trip: moments")
    check(back.optimizer.count == state.optimizer.count == back.step == state.step
          == FIT_STEPS, f"count {back.optimizer.count}, step {back.step}")

    jdir = os.path.join(workdir, "hg8_mpii_asr", "hg8_mpii_asr")
    jcfg = named_config("hg8_mpii_asr")
    jmgr = CheckpointManager(jdir)
    jstate = jmgr.load(jmgr.best_path if os.path.isdir(jmgr.best_path) else None)["state"]
    check("agent" in jstate, "fit_joint's run directory holds a joint checkpoint")
    jmodel = _hg_for(jcfg)
    jmodel.load_state_dict(jstate["pose"]["model"])
    _same_predictions("from_config(joint run_dir)",
                      PosePredictor.from_config(jcfg, jdir, mean=MPII_MEAN)(*request),
                      PosePredictor(jmodel, mean=MPII_MEAN)(*request))
    emit("ckpt_interop", config="hg8_mpii", blocks=2, scan_stacks=True, batch=BATCH,
         fit_seconds=fit_s, images_per_sec=_img_per_s(out), log=vals, best_written=best,
         container_bytes=os.path.getsize(path), container_write_seconds=write_s,
         container_read_seconds=read_s, tensors=len(sd), launches=launches,
         launches_want=want)
    return launches


# ---- the profiling tools, the adversarial-gain protocol, the pictures

# profiling: hg8_mpii at full width, batch 16; measure_duty_cycle (K = 1)
# over at most DUTY_STEPS steps, measure_duty_cycle_fused over
# DUTY_STEPS // DUTY_K dispatches of DUTY_K
DUTY_BATCH, DUTY_K, DUTY_STEPS = 16, 4, 30
PROFILE_STEPS = 3  # profile_step's traced steps, after its 3 warm ones
# adv_gain: the protocol at its full width (2 stacks, 128 features, 256²,
# batch 16) on 32 train and 16 hard validation images, 2 + 2 epochs; arm B
# on the scale/rotation agent with body-part occlusion
ADV_GAIN = dict(epochs1=2, epochs2=2, stacks=2, feats=128, res=256, batch=16,
                num_train=32, num_val=16)
ADV_GAIN_KEYS = {"phase1_best_acc", "armA_baseline", "armB_adversarial", "pckh_gain",
                 "epochs", "hard_val", "pose_ref_weight", "occlusion", "seed",
                 "reused_phase1", "reused_arm_a"}
VIZ_IMAGES = 4


def phase_profiling(workdir):
    """posetpu_torch.utils.profiling at full hg8_mpii width, bf16, batch
    DUTY_BATCH, through posetpu_torch.tools.duty_cycle: measure_duty_cycle
    (K = 1, the driver's route) and measure_duty_cycle_fused (K = DUTY_K),
    each timing the device with time_device_step (a CUDA graph of
    DEVICE_STEPS steps, one warm and one timed dispatch) over a synthetic
    512x384 split that HostLoader decodes and make_batch_placer places.
    Then posetpu_torch.tools.profile_step over PROFILE_STEPS steps of the
    train graph (by kernel) and of the joint graph (by kind).  Launches: the
    rasterizer's, once a train step and twice a joint step run, each
    capture's WARMUP_STEPS included."""
    from posetpu_torch.tools import duty_cycle, profile_step
    from posetpu_torch.utils.profiling import DEVICE_STEPS

    split = os.path.join(workdir, "duty_split")
    prev_root = duty_cycle.split_root
    duty_cycle.split_root = lambda: split
    runs, total = {}, 0
    try:
        for K in (1, DUTY_K):
            torch.cuda.empty_cache()
            reset_counters(RASTER)
            t0 = time.perf_counter()
            res = duty_cycle.main(["--batch", str(DUTY_BATCH), "--k-per-dispatch", str(K),
                                   "--steps", str(DUTY_STEPS)])
            seconds = time.perf_counter() - t0
            got = counter(RASTER)
            per_epoch = duty_cycle.NUM_IMAGES // DUTY_BATCH  # whole K x B groups
            timed = (min(DUTY_STEPS, per_epoch) if K == 1
                     else max(1, DUTY_STEPS // K) * K)
            want = (WARMUP_STEPS + 2 * DEVICE_STEPS) + (WARMUP_STEPS + K) + timed
            runs[f"K={K}"] = {**res, "seconds": seconds, "timed_steps": timed,
                              "launches": got, "launches_want": want}
            check(got == want, f"duty K={K}: launches {got}, want {want}")
            check(0.0 < res["duty_cycle"] <= 1.0 and res["device_step"] > 0
                  and res["wall_step"] > 0, f"duty K={K}: {res}")
            check(res["device_captures"] == res["captures"] == 1, f"duty K={K}: {res}")
            total += got
    finally:
        duty_cycle.split_root = prev_root
    for joint in (False, True):
        torch.cuda.empty_cache()
        name = "joint" if joint else "train"
        reset_counters(RASTER)
        t0 = time.perf_counter()
        out = profile_step.main(["--steps", str(PROFILE_STEPS), "--top", "12",
                                 "--trace-dir", os.path.join(workdir, f"trace_{name}"),
                                 "--out", os.path.join(workdir, f"profile_{name}.txt")]
                                + (["--joint", "--by-category"] if joint else []))
        seconds = time.perf_counter() - t0
        got = counter(RASTER)
        per_step = JOINT_RASTER_LAUNCHES if joint else 1
        # 3 warm calls (the first captures after its warm-up steps), then traced
        want = per_step * (WARMUP_STEPS + 3 + PROFILE_STEPS)
        check(got == want, f"profile_step {name}: launches {got}, want {want}")
        check(len(out["summary"]) == 1 and out["summary"][0][0].startswith("device"),
              f"profile_step {name}: no device track in {out['trace']}")
        rows = out["summary"][0][1]
        # every row of the trace, not only the top ones the tool printed
        ((_, every),) = profile_step.summarize_trace(out["trace"], top=None,
                                                     by_category=joint)
        raster = [c for n, _, c in every if "rasterize" in n]
        check(raster == [per_step * PROFILE_STEPS],
              f"profile_step {name}: the rasterizer's rows in the trace {raster}")
        runs[f"profile_{name}"] = {"seconds": seconds, "launches": got,
                                   "top": [[n[:60], ms, c] for n, ms, c in rows[:8]]}
        total += got
    emit("profiling", config="hg8_mpii", batch=DUTY_BATCH, device_steps=DEVICE_STEPS,
         runs=runs, launches=total)
    return total


def phase_adv_gain(workdir):
    """posetpu_torch.tools.adversarial_gain at ADV_GAIN: phase 1, arm A and
    arm B (parts occlusion) through Experiment, each arm's validation
    through its graph; result.json with the JAX tool's fields, each run's
    log and checkpoints, both arms started from phase 1's best checkpoint
    (else its latest, as the driver loads it: the pose network right after
    the load), and the rasterizer's launches: a train step once, a joint
    step twice, each capture's warm-up steps, each validation batch once,
    each arm's first validation once more (its capture's warm-up call),
    and the final evaluation of each arm."""
    from posetpu_torch.tools import adversarial_gain
    from posetpu_torch.train import loop

    out = os.path.join(workdir, "adv_gain")
    inits = {}
    load = loop.Experiment._init_pose_from

    def recording(self, path):
        load(self, path)
        inits[self.cfg.name] = (path, {k: v.detach().cpu().clone()
                                       for k, v in self.model.state_dict().items()})

    argv = ["--out", out, "--seed", str(SEED)]
    for k, v in ADV_GAIN.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    loop.Experiment._init_pose_from = recording
    reset_counters(RASTER)
    try:
        t0 = time.perf_counter()
        result = adversarial_gain.main(argv)
        seconds = time.perf_counter() - t0
    finally:
        loop.Experiment._init_pose_from = load
    launches = counter(RASTER)

    with open(os.path.join(out, "result.json")) as f:
        written = json.load(f)
    check(set(written) == ADV_GAIN_KEYS, f"result.json keys {sorted(written)}")
    check(written == json.loads(json.dumps(result)), "result.json differs from the result")
    check(written["epochs"] == [ADV_GAIN["epochs1"], ADV_GAIN["epochs2"]]
          and written["occlusion"] and written["hard_val"], f"result {written}")
    for arm in ("armA_baseline", "armB_adversarial"):
        r = written[arm]
        check(0.0 <= r["pckh"] <= 100.0 and -1.0 <= r["acc"] <= 1.0
              and math.isfinite(r["best_acc"]), f"{arm}: {r}")
    steps = ADV_GAIN["num_train"] // ADV_GAIN["batch"]
    val = -(-ADV_GAIN["num_val"] // ADV_GAIN["batch"])
    runs = {}
    for name, epochs in (("phase1", ADV_GAIN["epochs1"]), ("armA_baseline", ADV_GAIN["epochs2"]),
                         ("armB_adversarial", ADV_GAIN["epochs2"])):
        vals, best = _check_run(f"adv_gain {name}", os.path.join(out, name), epochs,
                                epochs * steps)
        runs[name] = {"log": vals, "best_written": best}
    p1 = CheckpointManager(os.path.join(out, "phase1"))
    p1_sd = p1.load(p1.best_path if os.path.isdir(p1.best_path) else None)["state"]["model"]
    for arm in ("armA_baseline", "armB_adversarial"):
        check(arm in inits, f"{arm} did not load phase 1")
        path, sd = inits[arm]
        check(os.path.abspath(path) == os.path.abspath(os.path.join(out, "phase1")),
              f"{arm} started from {path}")
        check(sd.keys() == p1_sd.keys() and all(torch.equal(sd[k], p1_sd[k]) for k in sd),
              f"{arm} did not start from phase 1's checkpoint")
    E1, E2 = ADV_GAIN["epochs1"], ADV_GAIN["epochs2"]
    want = ((E1 * steps + WARMUP_STEPS) + E1 * val + EVAL_WARMUP
            + (E2 * steps + WARMUP_STEPS) + E2 * val + EVAL_WARMUP + val
            + JOINT_RASTER_LAUNCHES * (E2 * steps + WARMUP_STEPS) + E2 * val + EVAL_WARMUP
            + val)
    emit("adv_gain", **ADV_GAIN, seed=SEED, seconds=seconds, result=written, runs=runs,
         launches=launches, launches_want=want)
    check(launches == want, f"adv_gain launches {launches}, want {want}")
    return launches


def phase_visualize(workdir):
    """posetpu_torch.tools.visualize on phase_adv_gain's arm A run (its
    latest checkpoint, served as the config's run directory; the tool
    builds a pose-only state, as the JAX tool does): VIZ_IMAGES
    PNG files of the hard validation images at their size, and the
    rasterizer's launches (the validation batch, and its capture's warm-up
    call)."""
    from PIL import Image

    from posetpu_torch.tools import visualize

    out = os.path.join(workdir, "adv_gain")
    ckpt = os.path.join(workdir, "viz")
    os.makedirs(ckpt)
    os.symlink(os.path.join(out, "armA_baseline"), os.path.join(ckpt, "hg2_mpii_mini"))
    reset_counters(RASTER)
    paths = visualize.main([
        "--checkpoint", ckpt, "--json", os.path.join(out, "data", "annotations.json"),
        "--image-path", os.path.join(out, "data", "images"),
        "--stacks", str(ADV_GAIN["stacks"]), "--features", str(ADV_GAIN["feats"]),
        "--train-batch", str(ADV_GAIN["batch"]), "--n", str(VIZ_IMAGES),
        "--out", os.path.join(ckpt, "png")])
    launches = counter(RASTER)
    sizes = []
    for p in paths:
        with Image.open(p) as im:
            sizes.append((im.format, im.mode, im.size))
    check(len(paths) == VIZ_IMAGES and all(s == ("PNG", "RGB", (320, 240)) for s in sizes),
          f"visualize wrote {sizes}")
    want = -(-ADV_GAIN["num_val"] // ADV_GAIN["batch"]) + EVAL_WARMUP
    check(launches == want, f"visualize launches {launches}, want {want}")
    emit("visualize", files=[os.path.basename(p) for p in paths], sizes=sizes,
         bytes=[os.path.getsize(p) for p in paths], launches=launches)
    return launches


def _processes():
    """{pid: (state, ppid, process group, command line)} of every process
    /proc lists."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:  # it ended meanwhile
            continue
        state, ppid, pgrp = stat[stat.rindex(")") + 2:].split()[:3]
        out[int(name)] = (state, int(ppid), int(pgrp), cmd)
    return out


def _started(at_start):
    """Processes this run started that still run: its descendants, and
    multiprocessing's processes in its process group whose parent ended
    (adopted by init), which were not there at its start."""
    procs = _processes()
    children = {}
    for pid, (_, ppid, _, _) in procs.items():
        children.setdefault(ppid, []).append(pid)
    found, todo = set(), [os.getpid()]
    while todo:
        for c in children.get(todo.pop(), []):
            if c not in found:
                found.add(c)
                todo.append(c)
    found |= {pid for pid, (_, _, pgrp, cmd) in procs.items()
              if pgrp == os.getpgrp() and "multiprocessing" in cmd and pid not in at_start}
    return {pid: procs[pid][3] for pid in sorted(found) if procs[pid][0] != "Z"}


def phase_processes(at_start):
    """Stop the worker loaders' server and resource tracker (waiting for
    both), then end whatever else this run started and still runs (SIGTERM,
    then SIGKILL after 10 s); returns what had to be ended."""
    stop_worker_server()
    left = _started(at_start)
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in _started(at_start):
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + 10
        while _started(at_start) and time.monotonic() < deadline:
            time.sleep(0.1)
    return left


def main():
    # before any cuBLAS call: dispatch_parity turns deterministic algorithms on
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = phase_device()
    at_start = set(_processes())
    try:
        kernels = _run_phases(smi)
    finally:
        left = phase_processes(at_start)
    emit("processes", left_running=left)
    check(not left, f"processes still running after the phases: {left}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def _run_phases(smi):
    """Every phase after ``device``; returns the kernel summaries."""
    phase_build()
    raster = phase_kernels()
    conv_bias_summaries = phase_conv_bias()
    bn_relu_summaries = phase_bn_relu()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        bench_launches = phase_bench(smi, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ycc_summary, idct_summary = phase_jpeg_gpu(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    cfg = named_config("hg8_mpii")
    predictor, serve_launches = phase_serve(cfg)
    launches, eager_launches, graphed, eager = phase_validate(cfg, predictor)
    phase_profile(cfg, graphed, eager)
    del predictor, graphed, eager
    phase_parity()
    train_launches, state, step, batch = phase_train(cfg)
    phase_train_profile(state, step, batch)
    del state, step
    phase_train_parity()

    joint_launches, state, step, batch = phase_joint(named_config("hg8_mpii_asr"))
    phase_joint_profile(state, step, batch)
    del state, step
    lsp_launches, state, step, _ = phase_joint(named_config("hg8_lsp_aho"))
    del state, step
    phase_joint_parity()

    dispatch_parity_launches = phase_dispatch_parity()
    dispatch_launches = phase_dispatch(cfg)
    joint_dispatch_parity_launches = phase_joint_dispatch_parity()
    joint_dispatch_launches, joint_dispatch_lsp_launches = phase_joint_dispatch()
    dp_nccl1_launches = phase_dp_nccl1()
    dp_gloo2_launches = phase_dp_gloo2()

    routes, have_tensorboard = phase_host()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        loader_root, loader_results, workers = phase_loader(routes, workdir)
        fit_jpeg_gpu_launches, decode_fit_jpeg_gpu = phase_fit_jpeg_gpu(
            loader_root, loader_results, workers)
        fit_launches, decode_fit = phase_fit(workdir)
        fit_joint_launches, decode_fit_joint = phase_fit_joint(workdir)
        fit_dispatch_launches = phase_fit_dispatch(workdir, have_tensorboard)
        fit_joint_dispatch_launches = phase_fit_joint_dispatch(workdir, have_tensorboard)
        dp_config_launches, decode_dp_config = phase_dp_config(workdir)
        variants_launches = phase_variants(cfg, workdir)
        remat_launches = phase_remat()
        ckpt_interop_launches = phase_ckpt_interop(workdir)
        profiling_launches = phase_profiling(workdir)
        adv_gain_launches = phase_adv_gain(workdir)
        phase_visualize(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    raster["launches"] = launches["rasterize_gaussians"]
    raster["launches_by_path"] = {"validate": eager_launches["rasterize_gaussians"],
                                  "validate_graph": launches["rasterize_gaussians"],
                                  "serve_graph": serve_launches["rasterize_gaussians"],
                                  "train": train_launches["rasterize_gaussians"],
                                  "joint": joint_launches["rasterize_gaussians"],
                                  "joint_lsp": lsp_launches["rasterize_gaussians"],
                                  "fit": fit_launches,
                                  "fit_jpeg_gpu": fit_jpeg_gpu_launches,
                                  "fit_joint": fit_joint_launches,
                                  "dispatch": dispatch_launches["rasterize_gaussians"],
                                  "dispatch_parity": dispatch_parity_launches,
                                  "fit_dispatch": fit_dispatch_launches,
                                  "joint_dispatch":
                                      joint_dispatch_launches["rasterize_gaussians"],
                                  "joint_dispatch_lsp": joint_dispatch_lsp_launches,
                                  "joint_dispatch_parity": joint_dispatch_parity_launches,
                                  "fit_joint_dispatch": fit_joint_dispatch_launches,
                                  "dp_nccl1": dp_nccl1_launches,
                                  "dp_gloo2": dp_gloo2_launches,
                                  "dp_config": dp_config_launches,
                                  "variants": variants_launches,
                                  "remat": remat_launches,
                                  "ckpt_interop": ckpt_interop_launches,
                                  "profiling": profiling_launches,
                                  "adv_gain": adv_gain_launches,
                                  **{f"bench_{name}": n["rasterize_gaussians"]
                                     for name, n in bench_launches.items()}}
    conv_paths = {"dispatch": dispatch_launches, "train": train_launches,
                  "joint": joint_launches, "joint_lsp": lsp_launches,
                  "joint_dispatch": joint_dispatch_launches, "serve_graph": serve_launches,
                  "validate_graph": launches, "validate": eager_launches}
    for summary in (*conv_bias_summaries, *bn_relu_summaries):
        name = summary.pop("counter")
        summary["launches"] = dispatch_launches[name]
        summary["launches_by_path"] = {path: n[name] for path, n in conv_paths.items()}
    for summary in (ycc_summary, idct_summary):
        name = summary["name"]
        summary["launches"] = decode_fit_jpeg_gpu[name]
        summary["launches_by_path"] = {"fit_jpeg_gpu": decode_fit_jpeg_gpu[name],
                                       "fit": decode_fit[name],
                                       "fit_joint": decode_fit_joint[name],
                                       "dp_config": decode_dp_config[name],
                                       **{f"bench_{mode}": n[name]
                                          for mode, n in bench_launches.items()
                                          if mode.startswith("loader_host")}}
    return [raster, ycc_summary, idct_summary, *conv_bias_summaries, *bn_relu_summaries]


if __name__ == "__main__":
    sys.exit(main())
