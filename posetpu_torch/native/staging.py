"""Descriptor staging of the decode route's kernels: page-locked host
buffers and card buffers, used in turn, that carry a launch's descriptors
to the card inside the same C call as the launch.

A kernel's C function ``<name>_stage_launch`` waits on its slot's event
(recorded after the last launch that read the slot: its copy and its
kernel), copies the descriptors into the slot's pinned buffer, then to the
card on the launch's stream, launches, and records the event again.  So one
call's host work runs while the previous call's kernel does, and no slot is
rewritten before its copy has run.
"""

from __future__ import annotations

import threading

import torch

STAGING_SLOTS = 2  # descriptor buffers of a device, used in turn


class Staging:
    """One device's descriptor buffers for one kernel: STAGING_SLOTS slots
    used in turn, each page-locked host memory and card memory of the same
    size, grown as needed, with the event recorded after the last launch
    that read them.  ``lock`` makes each launch one step, as the decode runs
    in loaders' producer threads."""

    def __init__(self, device):
        self.lock = threading.Lock()
        self.device = device
        self.turn = 0
        self.words = [0] * STAGING_SLOTS
        self.buffers = [()] * STAGING_SLOTS  # (host, device) tensors of a slot
        self.pointers = [None] * STAGING_SLOTS  # (host, device, event) for the C call
        self.done = [torch.cuda.Event() for _ in range(STAGING_SLOTS)]
        with torch.cuda.device(device):
            for event in self.done:
                event.record()  # creates the event on its device

    def reserve(self, words):
        """The next slot's pointers for a launch of ``words`` int64 words."""
        s = self.turn
        self.turn = (s + 1) % STAGING_SLOTS
        if words > self.words[s]:
            self.done[s].synchronize()  # the old buffers are no longer read
            self.words[s] = max(words, 2 * self.words[s])
            self.buffers[s] = ()
            host = torch.empty(self.words[s], dtype=torch.int64, pin_memory=True)
            dev = torch.empty(self.words[s], dtype=torch.int64, device=self.device)
            self.buffers[s] = (host, dev)
            self.pointers[s] = (host.data_ptr(), dev.data_ptr(), self.done[s].cuda_event)
        return self.pointers[s]


class StagingSet:
    """A kernel's :class:`Staging` of each device, made at first use."""

    def __init__(self):
        self._by_device = {}
        self._lock = threading.Lock()

    def get(self, device):
        with self._lock:
            if device.index not in self._by_device:
                self._by_device[device.index] = Staging(device)
            return self._by_device[device.index]
