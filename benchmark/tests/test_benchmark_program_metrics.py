"""The per-layer metrics read from the program's own spans and counters
(``posetpu_torch/utils/profiling.py``): each reads nothing, and raises
nothing, with the registry empty, with the registry missing and with a
profiling module that has none (a program that predates it), and the
right number from a registry filled by hand."""

import sys
import types

import pytest

from benchmark import run

READERS = ("loader_epoch_wait_ms", "loader_steady_wait_ms", "producer_busy_ms",
           "dispatch_host_ms", "replay_device_ms", "capture_s")
MS = 1_000_000  # ns


@pytest.fixture
def registry(monkeypatch):
    """A registry of the test's own in the module's place."""
    from posetpu_torch.utils import profiling

    reg = profiling.Registry()
    monkeypatch.setattr(profiling, "window", reg.window)
    monkeypatch.setattr(profiling, "counter", reg.counter)
    return reg


def _add(reg, name, ms, id, parent=None, marks=None, device_ms=None):
    from posetpu_torch.utils.profiling import Record

    rec = Record(name, 0, int(ms * MS), id, parent, ("u", id), marks or {},
                 None if device_ms is None else (None, None))
    if device_ms is not None:
        rec._ms = device_ms
    reg._add(rec)


@pytest.mark.parametrize("name", READERS)
def test_an_empty_registry_reads_nothing(registry, name):
    assert run.reader(name)({}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_registry_reads_nothing(monkeypatch, name):
    import posetpu_torch.utils

    monkeypatch.delattr(posetpu_torch.utils, "profiling")
    monkeypatch.setitem(sys.modules, "posetpu_torch.utils.profiling", None)
    assert run.reader(name)({}) is None
    # a profiling module of its own, with no registry in it
    monkeypatch.setitem(sys.modules, "posetpu_torch.utils.profiling",
                        types.ModuleType("posetpu_torch.utils.profiling"))
    assert run.reader(name)({}) is None


def test_the_loader_metrics_from_a_filled_registry(registry):
    _add(registry, "loader.wait", 90.0, 1, marks={"first_of_epoch": True})
    _add(registry, "loader.wait", 0.5, 2)
    _add(registry, "loader.wait", 1.5, 3)
    _add(registry, "loader.wait", 110.0, 4, marks={"first_of_epoch": True})
    _add(registry, "loader.put_wait", 30.0, 11, parent=10)
    _add(registry, "loader.produce", 80.0, 10)
    _add(registry, "loader.produce", 60.0, 12)  # handed over at once
    assert run.reader("loader_epoch_wait_ms")({}) == 100.0
    assert run.reader("loader_steady_wait_ms")({}) == 1.0
    assert run.reader("producer_busy_ms")({}) == 55.0  # (80 - 30 + 60) / 2


def test_the_dispatch_metrics_from_a_filled_registry(registry):
    for i, (host, replay, device) in enumerate(((5.0, 1.0, 110.0), (7.0, 1.0, 118.0))):
        top = 10 * (i + 1)
        _add(registry, "dispatch.replay", replay, top + 1, parent=top)
        _add(registry, "dispatch.replay", 0.0, top + 2, parent=top + 1,
             marks={"steps": 1}, device_ms=device)
        _add(registry, "dispatch", host, top, marks={"steps": 1})
    _add(registry, "dispatch", 40.0, 99, marks={"steps": 1})  # eager: not counted
    assert run.reader("dispatch_host_ms")({}) == 5.0  # (5 - 1 + 7 - 1) / 2
    assert run.reader("replay_device_ms")({}) == 114.0


def test_capture_seconds_from_the_counter(registry):
    registry.count("graph.capture_s", 2.5)
    registry.count("graph.capture_s", 1.0)
    assert run.reader("capture_s")({}) == 3.5
