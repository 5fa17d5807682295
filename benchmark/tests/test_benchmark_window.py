"""The window's statistics: every rate is all the work of the window over
all its time, and a tail is the tail of every unit, so a stall inside the
window lowers the rate and raises the tail."""

import time

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import tiny_cells

SEED = 2**31 + 99


def rec(latencies, window_s, units=None):
    return {"kind": "serve", "latencies_ms": latencies, "window_s": window_s,
            "units": units or len(latencies), "images": 64 * (units or len(latencies)),
            "spans_ms": [10.0] * (units or len(latencies))}


def test_p95_is_the_nearest_rank_of_every_batch():
    read = run.reader("serve_p95_ms")
    lat = [float(i) for i in range(1, 201)]
    assert read(rec(lat, 10.0)) == 190.0
    stalled = lat[:-1] + [5000.0]
    assert read(rec(stalled, 10.0)) == 190.0
    assert read(rec(lat[:-20] + [900.0] * 20, 10.0)) == 900.0


def test_rates_and_idle_take_the_whole_window():
    rate, idle = run.reader("serve_img_s"), run.reader("idle.serve")
    assert rate(rec([1.0] * 100, 10.0)) == 640.0
    assert rate(rec([1.0] * 100, 12.0)) < 640.0
    assert idle(rec([1.0] * 100, 2.0)) == pytest.approx(50.0)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return tiny_cells(tmp_path_factory.mktemp("window"))


def test_a_stall_in_the_serving_window_shows(cells, monkeypatch):
    from posetpu_torch.infer import PosePredictor

    spec, here = cells
    dev = torch.device("cpu")
    plain = run.run_cell(spec, "tiny.serve", SEED, 1.0, False, dev, here=here)
    real, calls = PosePredictor._fetch, []

    def stall(pending):
        calls.append(1)
        if len(calls) % 4 == 0:
            time.sleep(0.1)
        return real(pending)

    monkeypatch.setattr(PosePredictor, "_fetch", staticmethod(stall))
    stalled = run.run_cell(spec, "tiny.serve", SEED, 1.0, False, dev, here=here)
    m0, m1 = plain["metrics"], stalled["metrics"]
    assert m1["serve_img_s"]["value"] < m0["serve_img_s"]["value"]
    assert m1["serve_p95_ms"]["value"] > m0["serve_p95_ms"]["value"] + 50.0


def test_a_stall_in_the_training_window_shows(cells, monkeypatch):
    from posetpu_torch.train.step import GraphedSteps

    spec, here = cells
    dev = torch.device("cpu")
    plain = run.run_cell(spec, "tiny.train", SEED, 1.0, False, dev, here=here)
    real = GraphedSteps.__call__

    def stall(self, state, superbatch):
        time.sleep(0.2)
        return real(self, state, superbatch)

    monkeypatch.setattr(GraphedSteps, "__call__", stall)
    stalled = run.run_cell(spec, "tiny.train", SEED, 1.0, False, dev, here=here)
    assert (stalled["metrics"]["train_img_s"]["value"]
            < 0.9 * plain["metrics"]["train_img_s"]["value"])
