"""What the drivers share: the program's network and configuration objects
built from a configuration file, the card's clock, and freeing the
program's state before the reference runs."""

from __future__ import annotations

import gc
import time

import torch


def port_configs(cfg):
    """The program's ``AugConfig`` and ``OptimConfig`` of configuration
    file ``cfg``."""
    from posetpu_torch.configs.config import AugConfig, OptimConfig

    def fields(group):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in group.items()}

    return AugConfig(**fields(cfg["aug"])), OptimConfig(**fields(cfg["optim"]))


def port_network(cfg, device):
    """The program's stacked hourglass of ``cfg["model"]`` on ``device``."""
    from posetpu_torch.models import hg

    m = cfg["model"]
    dtype = torch.bfloat16 if m["bf16"] else torch.float32
    return hg(num_stacks=m["stacks"], num_blocks=m["blocks"], num_classes=m["classes"],
              num_feats=m["feats"], depth=m["depth"], dtype=dtype).to(device)


class Clock:
    """The card's clock: pairs of CUDA events around units of work on the
    current stream (a copy of ``posetpu_torch/utils/profiling.py``'s
    ``DeviceTimer``); ``start`` and ``stop`` do nothing off the card."""

    def __init__(self, device):
        self.on = device.type == "cuda"
        self._spans, self._start = [], None

    def start(self):
        if self.on:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()

    def stop(self):
        if self.on:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._spans.append((self._start, end))

    def ms(self):
        """Every span's ms (waits for the last); empty off the card."""
        out = []
        for start, end in self._spans:
            end.synchronize()
            out.append(start.elapsed_time(end))
        return out


class Phases(dict):
    """Seconds from the start of a driver's set-up to each of its marks."""

    def __init__(self, device):
        super().__init__()
        self.device, self.t0 = device, time.perf_counter()

    def mark(self, name):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self[name] = time.perf_counter() - self.t0


def free(device):
    """Return the program's freed memory to the card before the reference
    runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reference_precision():
    """float32 for the reference: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
