"""The keyed draws of the augmentation, frozen for the benchmark's plain
reference.  Copied from ``posetpu_torch/aug/keyed.py`` (``pcg_hash``,
``keyed_bits``, ``bits_to_uniform``, ``bits_to_normal64``,
``sample_categorical``), ``posetpu_torch/train/adversarial.py``
(``sample_policy``'s draws) and
``posetpu_torch/aug/pipeline.py`` / ``aug/color.py``
(``sample_aug_params_ps``, ``sample_jitter_scales``), so that a later change
to the program cannot move the yardstick.

A sample's draws are a hash of (seed, step, global sample index, stream,
draw): PCG's RXS-M-XS permutation over an LCG step, nested over the key's
parts, in int64 tensors masked to 32 bits.  Uniforms take the top 24 bits;
normals come from Box-Muller in float64.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_U24 = 2.0**-24

STREAM_AUG = 0
STREAM_JITTER = 1
STREAM_SCALE_BIN = 2
STREAM_ROT_BIN = 3
STREAM_ADV_FLIP = 5


def pcg_hash(x):
    state = (x * 747796405 + 2891336453) & _M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _M32
    return (word >> 22) ^ word


def keyed_bits(seed, step, index, stream, count):
    """(B, count) int64 32-bit words: draw ``j`` of sample ``index[i]``."""
    head = pcg_hash((int(step) + pcg_hash(int(seed) & _M32)) & _M32)
    index = torch.as_tensor(index).to(torch.int64)
    per_sample = pcg_hash((index + head) & _M32)
    per_stream = pcg_hash((per_sample + int(stream)) & _M32)
    draws = torch.arange(count, dtype=torch.int64, device=index.device)
    return pcg_hash((per_stream[:, None] + draws[None, :]) & _M32)


def bits_to_uniform(bits):
    return (bits >> 8).to(torch.float32) * _U24


def bits_to_normal64(bits_a, bits_b):
    u1 = 1.0 - (bits_a >> 8).to(torch.float64) * _U24
    u2 = (bits_b >> 8).to(torch.float64) * _U24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def aug_params(seed, step, index, aug):
    """(scale factor, rotation in degrees, flip) per sample, float32/bool,
    from the training distribution of the hourglass lineage: scale
    2^clip(N*sf, -2sf, 2sf) ("exp") or clip(N*sf + 1, 1-sf, 1+sf)
    ("linear"), rotation clip(N*rf, -2rf, 2rf) kept with probability
    ``rot_prob``, a flip with probability ``flip_prob``."""
    bits = keyed_bits(seed, step, index, STREAM_AUG, 6)
    ns = bits_to_normal64(bits[:, 0], bits[:, 1])
    nr = bits_to_normal64(bits[:, 2], bits[:, 3])
    sf, rf = float(aug["scale_factor"]), float(aug["rot_factor"])
    if aug["scale_mode"] == "exp":
        scale = torch.exp2(torch.clamp(ns * sf, -2 * sf, 2 * sf))
    else:
        scale = torch.clamp(ns * sf + 1.0, 1.0 - sf, 1.0 + sf)
    rot = torch.clamp(nr * rf, -2 * rf, 2 * rf)
    rot = torch.where(bits_to_uniform(bits[:, 4]) <= aug["rot_prob"], rot, 0.0)
    flip = bits_to_uniform(bits[:, 5]) < aug["flip_prob"]
    return scale.to(torch.float32), rot.to(torch.float32), flip


def jitter_scales(seed, step, index):
    """(B, 3) float32 colour scales from U(0.8, 1.2)."""
    u = bits_to_uniform(keyed_bits(seed, step, index, STREAM_JITTER, 3))
    return (0.8 + 0.4 * u.to(torch.float64)).to(torch.float32)


def sample_categorical(seed, step, index, stream, logits):
    """One draw a sample from categorical ``logits`` (B, N) by Gumbel-max,
    the noise from 24-bit uniforms on (0, 1) added in float64: the index
    (B,) int64."""
    bits = keyed_bits(seed, step, index, stream, logits.shape[-1])
    u = ((bits >> 8).to(torch.float64) + 0.5) * _U24
    return torch.argmax(logits.to(torch.float64) - torch.log(-torch.log(u)), dim=-1)


def adversarial_flip(seed, step, index, flip_prob):
    """The adversarial crop's flip: a uniform under ``flip_prob``."""
    u = bits_to_uniform(keyed_bits(seed, step, index, STREAM_ADV_FLIP, 1)[:, 0])
    return u < flip_prob
