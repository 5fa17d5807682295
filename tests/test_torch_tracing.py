"""The port's spans and counters (posetpu_torch/utils/profiling.py) and the
layers that open them: spans nest under their parent and record nothing
while tracing is off; a ``torch.profiler`` on the driving thread turns
tracing on for every thread, the profiler's events hold that thread's
spans on the same clock, and the window ends with that thread's last
span; ``trace()`` writes every thread's spans into its Chrome trace;
counters stay exact under threads; the loader's producer, its consumer
and the step that takes a batch share the batch's unit; the dispatch's
spans nest as its docstring says; ``trace()`` lays device spans on rows
of their own and writes the block's counts.  The ``cuda`` cases check the
replay's device span, the decoder's device stages and its timed call that
does not wait for its canvas, and the placer's copy as a device span.  The
file imports nothing of the JAX package:

    python -m pytest --noconftest tests/test_torch_tracing.py -m cuda
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from posetpu_torch.aug import cuda_kernels
from posetpu_torch.data import HostLoader, MpiiDataset, make_synthetic_dataset
from posetpu_torch.train.step import GraphedSteps
from posetpu_torch.utils import profiling
from posetpu_torch.utils.profiling import REGISTRY, count, counter, records, span


@pytest.fixture(autouse=True)
def clean():
    REGISTRY.reset()
    yield
    REGISTRY.reset()


def _by_name():
    return {r.name: r for r in records()}


def _kineto(prof):
    return {e.name(): e for e in prof.profiler.kineto_results.events()}


def test_off_is_the_default_and_records_nothing():
    assert not REGISTRY.tracing
    with span("a") as s:
        s.mark("k")
        with span("b"):
            pass
    with profiling.device_span("c") as d:
        pass
    assert records() == [] and s is profiling.OFF and d is profiling.OFF


def test_spans_nest_under_their_parent_and_share_its_unit():
    with REGISTRY.forced_on():
        with span("outer", unit=("batch", 7)) as o:
            o.mark("first_of_epoch")
            with span("middle"):
                with span("inner"):
                    pass
            with span("dropped") as d:
                d.cancel()
        with span("alone"):
            pass
    got = _by_name()
    assert set(got) == {"outer", "middle", "inner", "alone"}
    assert got["outer"].parent is None and got["middle"].parent == got["outer"].id
    assert got["inner"].parent == got["middle"].id
    assert got["outer"].unit == got["middle"].unit == got["inner"].unit == ("batch", 7)
    assert got["alone"].unit == ("span", got["alone"].id)  # a unit of its own
    assert got["outer"].marks == {"first_of_epoch": True}
    o, i = got["outer"], got["inner"]
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns and o.ms >= i.ms >= 0
    assert not REGISTRY.tracing


def test_the_threads_unit_reaches_its_top_spans_only():
    with REGISTRY.forced_on():
        REGISTRY.set_unit((3, 1))
        with span("step"):
            with span("part", unit=("own", 0)):
                pass
    got = _by_name()
    assert got["step"].unit == (3, 1) and got["part"].unit == ("own", 0)


def test_a_profiler_turns_tracing_on_for_every_thread():
    def producer():
        with span("producer.work", unit=("u", 1)):
            with span("producer.child"):
                pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("main.work"):
            t = threading.Thread(target=producer)
            t.start()
            t.join(10)
    assert not t.is_alive()
    names = _kineto(prof)
    # the main thread's spans are the profiler's ranges; the producer's
    # thread has no profiler of its own, so its spans are only recorded
    assert "main.work" in names and "producer.work" not in names
    got = _by_name()
    assert got["producer.child"].parent == got["producer.work"].id
    assert got["producer.work"].unit == ("u", 1)
    assert got["producer.work"].tid != got["main.work"].tid == threading.get_ident()
    # the driving thread takes tracing back at its first span after
    with span("after"):
        pass
    assert not REGISTRY.tracing and "after" not in _by_name()


def test_the_window_ends_with_the_driving_threads_last_span():
    """A producer's span still open when the profiler stops (its teardown
    holds the interpreter's lock for seconds) is no record of the window."""
    started, release = threading.Event(), threading.Event()

    def producer():
        with span("producer.inside"):
            pass
        with span("producer.straddles"):
            started.set()
            release.wait(10)

    with profile(activities=[ProfilerActivity.CPU]):
        with span("main.work"):
            t = threading.Thread(target=producer)
            t.start()
            assert started.wait(10)
    release.set()
    t.join(10)
    assert not t.is_alive()
    assert {r.name for r in profiling.window()} == {"main.work", "producer.inside"}
    assert "producer.straddles" in {r.name for r in records()}


def test_a_spans_stamps_lie_on_the_profilers_clock():
    """Within 100 us of the profiler's range around it, at each end (the
    best of five tries: a preempted thread says nothing of the clocks)."""
    worst = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(8):  # the profiler's first ranges are slow
            with record_function(f"bracket{i}"):
                with span(f"inside{i}"):
                    pass
    ev, got = _kineto(prof), _by_name()
    for i in range(3, 8):
        b, r = ev[f"bracket{i}"], got[f"inside{i}"]
        worst.append(max(abs(r.start_ns - b.start_ns()), abs(b.end_ns() - r.end_ns)))
    assert min(worst) < 100_000, worst


def test_trace_writes_every_threads_spans_in_order(tmp_path):
    def producer():
        with span("producer.stage"):
            time.sleep(0.003)

    with profiling.trace(str(tmp_path)):
        with record_function("main.before"):
            time.sleep(0.003)
        t = threading.Thread(target=producer, name="producer")
        t.start()
        t.join(10)
        with record_function("main.after"):
            time.sleep(0.003)
    with open(tmp_path / f"trace_{os.getpid()}.json") as f:
        doc = json.load(f)
    ev = {e["name"]: e for e in doc["traceEvents"] if e.get("ph") == "X"}
    before, stage, after = ev["main.before"], ev["producer.stage"], ev["main.after"]
    assert before["ts"] + before["dur"] <= stage["ts"]
    assert stage["ts"] + stage["dur"] <= after["ts"]
    assert 2.5e3 <= stage["dur"] < 1e5 and stage["tid"] != before["tid"]
    rows = [e["args"]["name"] for e in doc["traceEvents"]
            if e.get("ph") == "M" and e.get("tid") == stage["tid"]]
    assert rows == ["spans: producer"]
    assert not REGISTRY.tracing


def _device_record(name, start_us, ms, tid=7):
    rec = profiling.Record(name, start_us * 1000, start_us * 1000, 0, None, None, {},
                           events=(None, None))
    rec.tid, rec.thread, rec._ms = tid, "producer", ms  # the card's ms, read already
    return rec


def test_merge_spans_lays_device_spans_in_order_on_their_row(tmp_path):
    """Each from its enqueue, or from the end of its thread's device span
    before it, as one stream runs them."""
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": 1_000_000, "traceEvents": []}))
    recs = [_device_record("copy_in", 2000, 1.0), _device_record("idct", 2010, 0.5),
            _device_record("canvas", 9000, 0.25)]
    profiling.merge_spans(str(path), recs)
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], e["ts"], e["dur"]) for e in events if e["ph"] == "X"]
    assert spans == [("copy_in", 1000.0, 1000.0), ("idct", 2000.0, 500.0),
                     ("canvas", 8000.0, 250.0)]
    assert {e["tid"] for e in events} == {profiling.DEVICE_ROWS + 7}
    assert [e["args"]["name"] for e in events if e["ph"] == "M"] == ["device spans: producer"]


def test_trace_writes_the_blocks_counts(tmp_path):
    count("test.before", 4)
    with profiling.trace(str(tmp_path)):
        count("test.before")
        count("test.inside", 3)
    with open(tmp_path / f"trace_{os.getpid()}.json") as f:
        doc = json.load(f)
    got = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "C" and e["name"].startswith("test."):
            got.setdefault(e["name"], []).append((e["ts"], e["args"]["value"]))
    assert {n: [v for _, v in vs] for n, vs in got.items()} == {
        "test.before": [0, 1], "test.inside": [0, 3]}
    assert got["test.inside"][0][0] <= got["test.inside"][1][0]


def test_counters_stay_exact_under_threads():
    n, per = 8, 5000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                count("test.hits")
                count("test.seconds", 0.5)

        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert counter("test.hits") == n * per and counter("test.seconds") == n * per * 0.5
    profiling.reset_counters("test.hits")
    assert profiling.counters("test.") == {"test.hits": 0, "test.seconds": n * per * 0.5}


def test_counted_as_replays_and_add_replay_behave_as_before():
    raster = cuda_kernels.RASTERIZE_LAUNCHES
    count(raster, 5)  # launches that ran
    with profiling.counted_as_replays((raster,)) as captured:
        count(raster, 3)  # recorded into a graph: nothing ran
    assert counter(raster) == 5 and captured == {raster: 3}
    for _ in range(2):
        profiling.add_replay(captured)
    assert counter(raster) == 11


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing_split")
    make_synthetic_dataset(str(root), num_train=6, num_val=0, res=(64, 48), seed=4)
    return MpiiDataset(str(root / "annotations.json"), str(root / "images"), split="train")


def test_a_batchs_spans_share_its_unit_across_threads(split):
    """Three epochs of a CPU loader: one first-of-epoch wait each, and the
    producer's spans, the consumer's wait and the step that takes the
    batch in the batch's unit (epoch, batch)."""
    loader = HostLoader(split, 2, pad_hw=(64, 80), seed=1, backend="pil")
    with REGISTRY.forced_on():
        for _ in range(3):
            for _ in loader:
                with span("step"):
                    pass
    recs = records()
    waits = [r for r in recs if r.name == "loader.wait"]
    assert len(waits) == 9
    first = [r.unit for r in waits if r.marks.get("first_of_epoch")]
    assert first == [(0, 0), (1, 0), (2, 0)]
    for unit in ((e, k) for e in range(3) for k in range(3)):
        names = sorted(r.name for r in recs if r.unit == unit)
        assert names == ["loader.place", "loader.produce", "loader.put_wait", "loader.wait",
                         "step"], (unit, names)
    produce = {r.id: r for r in recs if r.name == "loader.produce"}
    for r in recs:
        if r.name in ("loader.place", "loader.put_wait"):
            assert r.parent in produce and produce[r.parent].unit == r.unit
            assert r.tid == produce[r.parent].tid != threading.get_ident()
    assert counter("loader.epochs") == 3 and counter("loader.batches") == 9
    assert 0 <= counter("loader.starved") <= 9


class _State:
    """A state of one tensor, a module's buffer, for :class:`GraphedSteps`."""

    def __init__(self, dev):
        self.step, self.model = 0, torch.nn.Module()
        self.model.register_buffer("w", torch.zeros(4, device=dev))

    def holders(self):
        return (self.model,), ()

    def snapshot(self):
        return self.model.w.clone()

    def restore_(self, saved):
        self.model.w.copy_(saved)


class _Counters:
    def load(self, state):
        pass

    def advance(self, state, pattern):
        state.step += len(pattern)


def _body(counters, batch, update):
    return {"loss": (batch["index"].float() * 2).sum()}


def _dispatch(dev):
    steps = GraphedSteps(_body, _Counters(), lambda s: None, 1, dev)
    return steps, _State(dev), {"index": torch.arange(6).view(1, 6)}


def test_the_dispatchs_spans_nest_in_one_unit():
    steps, state, sb = _dispatch(torch.device("cpu"))
    with REGISTRY.forced_on():
        out = steps(state, sb)
    assert out["loss"].tolist() == [30.0] and state.step == 1
    got = _by_name()
    assert set(got) == {"dispatch", "dispatch.stage", "dispatch.eager", "dispatch.finish"}
    top = got["dispatch"]
    assert top.parent is None and top.marks == {"steps": 1}
    assert all(got[n].parent == top.id and got[n].unit == top.unit
               for n in ("dispatch.stage", "dispatch.eager", "dispatch.finish"))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_cuda_the_replay_is_a_device_span_and_the_graph_is_counted():
    _cuda()
    steps, state, sb = _dispatch(torch.device("cuda"))
    sb = {k: v.cuda() for k, v in sb.items()}
    steps(state, sb)  # the capture, untraced
    assert steps.captures == 1 and counter("graph.capture_s") == steps.capture_seconds[0] > 0
    with REGISTRY.forced_on():
        for _ in range(3):
            out = steps(state, sb)
    torch.cuda.synchronize()
    assert out["loss"].item() == 30.0 and counter("graph.replays") == 4
    host = {r.id: r for r in records("dispatch.replay") if not r.device}
    dev = [r for r in records("dispatch.replay") if r.device]
    assert len(host) == len(dev) == 3
    assert all(r.parent in host and r.unit == host[r.parent].unit and r.ms > 0 for r in dev)
    assert not [r for r in records() if r.name == "graph.capture"]


def _jpegs(tmp_path, n=6):
    from PIL import Image

    paths = []
    for k in range(n):
        paths.append(str(tmp_path / f"f{k}.jpg"))
        rng = np.random.RandomState(k)
        Image.fromarray(rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)).save(
            paths[-1], quality=92)
    return paths


@pytest.mark.cuda
def test_cuda_the_decoders_device_stages_and_a_timed_call_that_does_not_wait(tmp_path):
    _cuda()
    from posetpu_torch.native.jpeg_gpu import GpuJpegDecoder

    paths = _jpegs(tmp_path)
    centers = np.array([[80.0, 60.0]] * len(paths), np.float32)
    dec = GpuJpegDecoder("cuda", timing=True)
    out = dec.canvas((len(paths), 96, 112, 3))
    dec.decode_batch(paths, centers, (96, 112), out=out)  # builds and warms
    with torch.cuda.stream(dec.stream):
        torch.cuda._sleep(200_000_000)  # the decoder's stream held
    with REGISTRY.forced_on():
        with span("produce"):
            images = dec.decode_batch(paths, centers, (96, 112), out=out)[0]
    # the timed call returned with its canvas still behind the sleep
    assert not images.ready.query() and len(dec.times) == 2
    assert set(dec.times[-1]) == {"threads", "refused", "read_ms", "info_ms", "host_ms",
                                  "desc_ms", "total_ms"}
    got = _by_name()
    parent = got["loader.device_decode"]
    assert got["produce"].id == parent.parent
    assert all(got[n].parent == got["produce"].id
               for n in ("loader.read", "loader.header", "loader.entropy"))
    stages = [r for r in records() if r.device]
    assert [r.name for r in stages] == ["loader.copy_in", "loader.idct", "loader.canvas"]
    assert all(r.parent == parent.id and r.ms >= 0 for r in stages)
    assert images.ready.query() and stages[1].ms > 0 and stages[2].ms > 0
    # into a host buffer: the canvas's copy back is a fourth stage
    since = REGISTRY.watermark()
    host = torch.empty((len(paths), 96, 112, 3), dtype=torch.uint8, pin_memory=True)
    with REGISTRY.forced_on():
        dec.decode_batch(paths, centers, (96, 112), out=host.numpy())
    assert [r.name for r in records(since=since) if r.device] == [
        "loader.copy_in", "loader.idct", "loader.canvas", "loader.copy_out"]
    assert torch.equal(host, out.cpu())


@pytest.mark.cuda
def test_cuda_the_placers_copy_is_a_device_span_of_loader_place(split):
    _cuda()
    from posetpu_torch.data import make_batch_placer

    placer = make_batch_placer("cuda")
    with REGISTRY.forced_on():
        batches = list(HostLoader(split, 2, pad_hw=(64, 80), seed=1, backend="pil",
                                  place=placer))
    host = {r.id: r for r in records("loader.place") if not r.device}
    dev = [r for r in records("loader.place") if r.device]
    assert len(batches) == len(host) == len(dev) == 3
    assert all(r.parent in host and r.unit == host[r.parent].unit and r.ms >= 0 for r in dev)


def test_span_cost_measures_each_case():
    from posetpu_torch.tools import span_cost

    out = span_cost.measure(2000)
    assert out["spans"] == 2000 and 0 < out["off_us"] < out["on_us"]
    assert out["on_profiled_us"] > 0 and ("card" in out) == torch.cuda.is_available()
    assert records() == [] and not REGISTRY.tracing
