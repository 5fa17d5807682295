"""The benchmark's inputs, drawn from the run's seed on the device.

Frozen copies of the port's generators, so that a later change to the
program cannot move the yardstick:

- :func:`train_pool` fills a pool of (K, B) training rows with canvases of
  ``posetpu_torch/bench.py:synthetic_batch``'s side (``res + res // 4``,
  all valid), each holding a person drawn by the port's renderer
  (``frames.py:persons``, the loader cell's frames) and her annotation with
  the MPII adjustment (centre 15 scale lower, scale x 1.25), ``frames``
  distinct canvases cycled over the rows.  (``synthetic_batch`` itself
  fills the canvas with uniform noise and scatters the joints, on which
  the bf16 step's gradients lie so far from float32's that no comparison
  tells them from fp8's: PERF.md.)  Every row has its own global sample
  index, so the keyed augmentation draws differ on every row.
- :func:`serve_pool` draws what ``posetpu_torch/bench.py:serve_requests``
  draws (uint8 canvases of side ``pad`` with values in [0, 255), the
  whole canvas valid, centre at the canvas centre, scale ``pad / 250``),
  for a pool of batches.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.frozen.frames import persons

# the reference's per-sample adjustment of an MPII annotation
CENTER_Y_SHIFT, SCALE_INFLATE = 15.0, 1.25


def generator(seed, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (any
    integer below 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**64)
    return g


def train_pool(seed, pool, steps, batch, res, frames, device):
    """(pool, K, B, ...) training rows: ``image`` uint8, ``valid_wh``,
    ``center``, ``scale``, ``pts``, ``vis`` and ``index`` (distinct
    global sample indices), every field on ``device``."""
    pad = res + res // 4
    drawn = list(persons(frames, (pad, pad), seed))
    lead = (pool, steps, batch)
    n = pool * steps * batch
    take = [i % frames for i in range(n)]

    def field(values, dtype):
        return torch.as_tensor(np.stack([values[i] for i in take]), dtype=dtype,
                               device=device).reshape(*lead, *np.shape(values[0]))

    images = [np.asarray(img, np.uint8) for img, _, _, _ in drawn]
    center = [c + [0.0, CENTER_Y_SHIFT * s] for _, c, s, _ in drawn]
    return {
        "image": field(images, torch.uint8),
        "valid_wh": torch.full((*lead, 2), pad, dtype=torch.int32, device=device),
        "center": field(center, torch.float32),
        "scale": field([s * SCALE_INFLATE for _, _, s, _ in drawn], torch.float32),
        "pts": field([p for _, _, _, p in drawn], torch.float32),
        "vis": torch.ones((*lead, len(drawn[0][3])), dtype=torch.float32, device=device),
        "index": torch.arange(n, dtype=torch.int32, device=device).reshape(lead),
    }


def serve_pool(seed, pool, batch, pad, device):
    """(pool, B, ...) serving requests on ``device``: ``images`` uint8,
    ``valid_wh`` int32, ``center`` and ``scale`` float32."""
    g = generator(seed, device)
    lead = (pool, batch)
    kw = dict(device=device)
    return {
        "images": torch.randint(0, 255, (*lead, pad, pad, 3), generator=g,
                                dtype=torch.uint8, **kw),
        "valid_wh": torch.full((*lead, 2), pad, dtype=torch.int32, **kw),
        "center": torch.full((*lead, 2), pad / 2, dtype=torch.float32, **kw),
        "scale": torch.full(lead, pad / 250.0, dtype=torch.float32, **kw),
    }
