"""Counter-based random draws keyed on (seed, step, global sample index,
stream) — the port's counterpart of the JAX package's key chain
``fold_in(key, step)`` -> ``split`` -> ``per_sample_keys(key, index)``
(``posetpu/aug/pipeline.py:32-41``).

A sample's draws depend only on its own key, never on its position in the
batch or on its batch-mates, so a batch split over several devices draws
what one device would.  The draws cannot be JAX's threefry bits; they
follow the same distributions.

The hash is PCG's RXS-M-XS output permutation over an LCG step (Jarzynski
and Olano, "Hash Functions for GPU Rendering", JCGT 2020), nested over the
key's parts: ``pcg(draw + pcg(stream + pcg(index + pcg(step + pcg(seed)))))``.
Its 32-bit words are held in int64 tensors: every multiplier is below
2**31 and every product is masked back to 32 bits, so nothing overflows
and the CPU and the card compute the same integers.  Uniforms take the top
24 bits (exact in float32); normals come from Box-Muller in float64.

:func:`sample_categorical` draws from categorical logits by Gumbel-max,
``argmax(logits + g)`` with ``g = -log(-log u)`` made from the 24-bit
uniforms and added in float64: the CPU and the card draw the same index
from the same logits unless two of them tie to float64 rounding.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_U24 = 2.0**-24

# streams: each consumer of randomness draws on its own
STREAM_AUG = 0
STREAM_JITTER = 1
# the adversarial agent's draws (posetpu_torch.train.adversarial)
STREAM_SCALE_BIN = 2
STREAM_ROT_BIN = 3
STREAM_OCC = 4  # the tree's level and each level's cell: disjoint draws
STREAM_ADV_FLIP = 5


def pcg_hash(x):
    """PCG-RXS-M-XS of 32-bit values: int64 tensors or Python ints.
    A bijection of [0, 2**32)."""
    state = (x * 747796405 + 2891336453) & _M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _M32
    return (word >> 22) ^ word


def keyed_bits(seed, step, index, stream, count, first=0):
    """(B, count) int64 tensor of 32-bit words on ``index``'s device.

    ``seed`` and ``stream`` are Python ints; ``step`` is a Python int or a
    0-d int64 tensor on ``index``'s device (a train step inside a CUDA
    graph reads it there: a Python int would be baked into the capture),
    and both give the same words.  ``index`` (B,) holds the samples'
    global dataset indices.  Column ``j`` holds draw ``first + j`` of
    sample ``i``, a hash of (seed, step, index[i], stream, first + j)
    alone.
    """
    if not isinstance(step, torch.Tensor):
        step = int(step)
    head = pcg_hash((step + pcg_hash(int(seed) & _M32)) & _M32)
    index = torch.as_tensor(index).to(torch.int64)
    per_sample = pcg_hash((index + head) & _M32)
    per_stream = pcg_hash((per_sample + int(stream)) & _M32)
    draws = torch.arange(first, first + count, dtype=torch.int64,
                         device=index.device)
    return pcg_hash((per_stream[:, None] + draws[None, :]) & _M32)


def bits_to_uniform(bits):
    """32-bit words -> float32 uniforms on [0, 1) from their top 24 bits."""
    return (bits >> 8).to(torch.float32) * _U24


def bits_to_normal64(bits_a, bits_b):
    """Two tensors of 32-bit words -> float64 standard normals by
    Box-Muller.  Callers finish their arithmetic in float64 and round once
    to float32, so the CPU and the card agree to that rounding.  The 24-bit
    uniforms cut the tail at 5.77 standard deviations."""
    u1 = 1.0 - (bits_a >> 8).to(torch.float64) * _U24  # (0, 1]: log is finite
    u2 = (bits_b >> 8).to(torch.float64) * _U24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def sample_categorical(seed, step, index, stream, logits, first=0):
    """One draw per sample from categorical ``logits`` (B, N), keyed like
    :func:`keyed_bits` on draws ``first`` .. ``first + N - 1`` of
    ``stream``: the counterpart of the JAX package's ``sample_bins_ps``.

    Returns (idx (B,) int64, logp (B,) float32), ``logp`` the float32
    ``log_softmax(logits)`` at ``idx``.  The Gumbel noise is made from
    uniforms on (0, 1) (the 24-bit grid shifted by half a step, so the
    noise is finite) and added to the logits in float64.
    """
    logits = torch.as_tensor(logits)
    bits = keyed_bits(seed, step, index, stream, logits.shape[-1], first)
    u = ((bits >> 8).to(torch.float64) + 0.5) * _U24
    g = -torch.log(-torch.log(u))
    idx = torch.argmax(logits.to(torch.float64) + g, dim=-1)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return idx, logp.gather(-1, idx[:, None])[:, 0]
