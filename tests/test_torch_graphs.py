"""Serving and validation as one CUDA graph per input signature
(posetpu_torch.utils.graphs): PosePredictor and make_graphed_eval_step,
the counterparts of the JAX package's ``jax.jit`` of its serving forward
and of its eval step.

On the CPU both run their eager bodies, and Experiment validates through
the graphed step.  On the card (``cuda`` marker; skips here; run there with
``python -m pytest --noconftest tests/test_torch_graphs.py -m cuda``), at
feats 8, 2 stacks, 64² crops: each graph equals its eager body bit for bit;
two batches in flight keep their own outputs; weights loaded in place are
read by the graphs without a capture, and weights whose storage moved are
captured again; each input shape, and each set of optional validation
fields, takes a graph of its own; three validation batches keep three
different predictions; the rasterizer counts one launch a replay; a
``DeviceTimer`` set on the graphs spans each call.

The recapture check that every graph cache runs before a call
(``GraphCache._drop_if_moved``) is driven directly on the CPU, on a small
hourglass's ``TrainState`` and on a ``JointState`` whose agent is moved:
each way a state tensor can move drops a sentinel graph and counts a
recapture; calls where nothing moved keep it and walk nothing.
"""

import contextlib
import copy
import gc

import numpy as np
import pytest
import torch

from posetpu_torch.configs import named_config
from posetpu_torch.infer import MPII_MEAN, PosePredictor
from posetpu_torch.models import hg
from posetpu_torch.train import GraphedEvalStep, make_eval_step, make_graphed_eval_step
from posetpu_torch.train.adversarial import JointState, agent_from_config
from posetpu_torch.train.state import TrainState, make_optimizer
from posetpu_torch.utils import graphs
from posetpu_torch.utils.graphs import GraphCache
from posetpu_torch.utils.profiling import counter, reset_counters


def _cfg():
    cfg = named_config("hg2_mpii_mini")
    cfg.model.feats = 8
    cfg.aug.inp_res, cfg.aug.out_res = (64, 64), (16, 16)
    return cfg


def _model(seed=0):
    torch.manual_seed(seed)
    return hg(num_stacks=2, num_feats=8, num_classes=16, dtype=torch.float32)


def _serve_batch(rng, B=4, canvas=(96, 128)):
    H, W = canvas
    vw = rng.randint(W * 2 // 3, W + 1, B)
    vh = rng.randint(H * 2 // 3, H + 1, B)
    valid_wh = np.stack([vw, vh], axis=1).astype(np.int32)
    center = (valid_wh / 2 + rng.uniform(-5, 5, (B, 2))).astype(np.float32)
    scale = (vh / 200.0 * rng.uniform(0.7, 1.0, B)).astype(np.float32)
    images = rng.randint(0, 256, (B, H, W, 3), dtype=np.uint8)
    return images, valid_wh, center, scale


def _eval_batch(rng, B=4, canvas=(96, 128), optional=True):
    images, valid_wh, center, scale = _serve_batch(rng, B, canvas)
    box = 200.0 * scale
    pts = center[:, None, :] + rng.uniform(-0.4, 0.4, (B, 16, 2)) * box[:, None, None]
    b = {"image": images, "valid_wh": valid_wh, "center": center, "scale": scale,
         "pts": pts.astype(np.float32), "vis": (rng.rand(B, 16) < 0.8).astype(np.float32)}
    if optional:
        b["mask"] = np.array([1, 1, 1, 0][:B], np.float32)
        b["offset"] = rng.uniform(-3, 3, (B, 2)).astype(np.float32)
    return b


def _eager(predictor, batch):
    dev = predictor.device
    with torch.no_grad():
        out = predictor._forward(*(torch.from_numpy(a).to(dev) for a in batch))
    return {k: v.cpu().numpy() for k, v in out.items()}


def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def test_cpu_serving_and_validation_run_their_eager_bodies():
    cfg = _cfg()
    predictor = PosePredictor(_model(), device="cpu", inp_res=(64, 64), out_res=(16, 16))
    assert predictor.graphs is None
    batch = _serve_batch(np.random.RandomState(0))
    _equal(predictor(*batch), _eager(predictor, batch))
    graphed = make_graphed_eval_step(predictor.model, cfg.aug, MPII_MEAN, device="cpu")
    assert isinstance(graphed, GraphedEvalStep) and graphed.graphs is None
    eager = make_eval_step(predictor.model, cfg.aug, MPII_MEAN, device="cpu")
    b = _eval_batch(np.random.RandomState(1))
    (mg, pg), (me, pe) = graphed(b), eager(b)
    assert torch.equal(pg, pe) and all(torch.equal(mg[k], me[k]) for k in me)


def _train_state(which):
    """A small hourglass's ``TrainState`` ("pose"), or a ``JointState``
    ("agent"); and the ``TrainState`` a move is made on."""
    cfg = named_config("hg8_mpii_asr")
    cfg.optim.momentum = 0.9  # a second moment key a parameter
    model = _model()
    state = TrainState(model, make_optimizer(model.parameters(), cfg.optim))
    if which == "pose":
        return state, state
    agent, agent_opt, _ = agent_from_config(cfg, widths=(8, 16), device="cpu")
    agent_state = TrainState(agent, agent_opt)
    return JointState(state, agent_state), agent_state


def _first(module, kind):
    return next((m, n) for m in module.modules() for n in getattr(m, kind))


def _set_param(st):
    m, n = _first(st.model, "_parameters")
    setattr(m, n, torch.nn.Parameter(getattr(m, n).detach().clone()))


def _set_buffer(st):
    m, n = _first(st.model, "_buffers")
    setattr(m, n, getattr(m, n).clone())


def _set_moment(st):
    moments = st.optimizer.state[st.optimizer.param_groups[0]["params"][0]]
    moments["nu"] = moments["nu"].clone()


def _set_(st):
    p = next(st.model.parameters())
    with torch.no_grad():
        p.set_(p.detach().clone())


def _swap(st):
    p = next(st.model.parameters())
    torch.utils.swap_tensors(p, torch.nn.Parameter(p.detach().clone()))


def _data(st):
    p = next(st.model.parameters())
    p.data = p.data.clone()


def _set_child(st):
    name, child = next(st.model.named_children())
    setattr(st.model, name, copy.deepcopy(child))


def _delete(st):
    m, n = _first(st.model, "_parameters")
    delattr(m, n)


def _register(st):
    m, _ = _first(st.model, "_parameters")
    m.register_parameter("extra", torch.nn.Parameter(torch.zeros(3)))


MOVES = {
    "optimizer_load_state_dict": lambda st: st.optimizer.load_state_dict(
        copy.deepcopy(st.optimizer.state_dict())),
    "param_data": _data,
    "model_to": lambda st: st.model.to(torch.float64),
    "param_setattr": _set_param,
    "buffer_setattr": _set_buffer,
    "moment_replaced": _set_moment,
    "param_set_": _set_,
    "param_swapped": _swap,
    "submodule_setattr": _set_child,
    "param_registered": _register,
    "param_deleted": _delete,
}


def _ptrs(state):
    return [t.data_ptr() for t in state.tensors()]


@pytest.mark.parametrize("which", ["pose", "agent"])
@pytest.mark.parametrize("move", list(MOVES))
def test_graph_cache_recaptures_when_a_state_tensor_moves(which, move):
    """A move the full walk's pointers see drops every graph, counts them
    as recaptures and walks once; the next call is quiet again."""
    state, target = _train_state(which)
    cache = GraphCache()
    cache._drop_if_moved(*state.holders())
    cache.graphs["sentinel"] = object()
    before = _ptrs(state)
    recaptures, walks = counter("graph.recaptures"), counter("graph.state_walks")
    MOVES[move](target)
    assert _ptrs(state) != before  # the move is one the full walk sees
    cache._drop_if_moved(*state.holders())
    assert cache.graphs == {}
    assert counter("graph.recaptures") == recaptures + 1
    assert counter("graph.state_walks") == walks + 1
    cache.graphs["sentinel"] = object()
    cache._drop_if_moved(*state.holders())
    assert "sentinel" in cache.graphs and counter("graph.state_walks") == walks + 1


def _in_place(state):
    """Every tensor changed in place: an update, a module's and an
    optimizer moment's load that copy."""
    with torch.no_grad():
        for t in state.tensors():
            t.add_(1)
    for st in (state.pose, state.agent) if isinstance(state, JointState) else (state,):
        st.model.load_state_dict(copy.deepcopy(st.model.state_dict()))


@pytest.mark.parametrize("which", ["pose", "agent"])
@pytest.mark.parametrize("between", ["nothing", "in_place"])
def test_graph_cache_keeps_its_graphs_while_nothing_moves(which, between):
    """Calls over a state whose tensors stay where they are keep the
    graphs and walk nothing after the first."""
    state, _ = _train_state(which)
    cache = GraphCache()
    cache._drop_if_moved(*state.holders())
    cache.graphs["sentinel"] = object()
    recaptures, walks = counter("graph.recaptures"), counter("graph.state_walks")
    for _ in range(5):
        if between == "in_place":
            _in_place(state)
        cache._drop_if_moved(*state.holders())
    assert "sentinel" in cache.graphs
    assert counter("graph.recaptures") == recaptures
    assert counter("graph.state_walks") == walks


def test_graph_cache_walks_again_after_a_registration_elsewhere():
    """A module built anywhere in the process registers parameters: the
    next call walks once, finds every pointer where it was, and keeps the
    graphs."""
    state, _ = _train_state("pose")
    cache = GraphCache()
    cache._drop_if_moved(*state.holders())
    cache.graphs["sentinel"] = object()
    walks = counter("graph.state_walks")
    torch.nn.Linear(2, 2)
    cache._drop_if_moved(*state.holders())
    cache._drop_if_moved(*state.holders())
    assert "sentinel" in cache.graphs and counter("graph.state_walks") == walks + 1


def test_experiment_validates_through_the_graphed_step(tmp_path):
    from posetpu_torch.train.loop import Experiment

    cfg = _cfg()
    cfg.model.stacks = 1
    cfg.batch_size = 4
    cfg.checkpoint_dir = str(tmp_path)
    cfg.seed = 11
    exp = Experiment(cfg, device="cpu")
    try:
        assert isinstance(exp.eval_step, GraphedEvalStep)
        metrics, preds = exp.validate(0)
        assert np.isfinite(metrics["loss"]) and preds.shape == (16, 16, 2)
    finally:
        exp.close()


@pytest.mark.cuda
def test_serving_graph_equals_eager_and_keeps_two_in_flight():
    _card()
    predictor = PosePredictor(_model(), inp_res=(64, 64), out_res=(16, 16))
    rng = np.random.RandomState(2)
    batches = [_serve_batch(rng) for _ in range(4)]
    outs = list(predictor.predict_iter(iter(batches), depth=2))
    assert predictor.graphs.captures == 1
    for out, b in zip(outs, batches):
        _equal(out, _eager(predictor, b))
    for a, b in zip(outs, outs[1:]):
        assert not np.array_equal(a["conf"], b["conf"])


@pytest.mark.cuda
def test_serving_timer_spans_each_call_on_the_card():
    _card()
    from posetpu_torch.utils.profiling import DeviceTimer

    predictor = PosePredictor(_model(), inp_res=(64, 64), out_res=(16, 16))
    rng = np.random.RandomState(5)
    batches = [_serve_batch(rng) for _ in range(3)]
    predictor(*batches[0])  # captures, untimed
    predictor.graphs.timer = DeviceTimer()
    outs = list(predictor.predict_iter(iter(batches), depth=2))
    ms = predictor.graphs.timer.ms()
    assert len(ms) == 3 and all(t > 0 for t in ms)
    for out, b in zip(outs, batches):
        _equal(out, _eager(predictor, b))


@pytest.mark.cuda
def test_serving_graph_reads_loaded_weights_and_recaptures_moved_ones():
    _card()
    predictor = PosePredictor(_model(), inp_res=(64, 64), out_res=(16, 16))
    batch = _serve_batch(np.random.RandomState(3))
    first = predictor(*batch)
    predictor.model.load_state_dict(_model(seed=1).state_dict())  # in place
    second = predictor(*batch)
    assert predictor.graphs.captures == 1
    _equal(second, _eager(predictor, batch))
    assert not np.array_equal(first["conf"], second["conf"])
    with torch.no_grad():
        for p in predictor.model.parameters():
            p.data = p.data.clone() * 0.5  # new storage
    third = predictor(*batch)
    assert predictor.graphs.captures == 2
    _equal(third, _eager(predictor, batch))


@pytest.mark.cuda
def test_one_serving_graph_per_shape():
    _card()
    predictor = PosePredictor(_model(), inp_res=(64, 64), out_res=(16, 16))
    rng = np.random.RandomState(4)
    for canvas, captures in (((96, 128), 1), ((64, 64), 2), ((96, 128), 2), ((64, 64), 2)):
        b = _serve_batch(rng, canvas=canvas)
        _equal(predictor(*b), _eager(predictor, b))
        assert predictor.graphs.captures == captures
    image = rng.randint(0, 256, (70, 90, 3), dtype=np.uint8)
    predictor.predict_single(image, (45.0, 35.0), 0.4)
    predictor.predict_single(image, (40.0, 30.0), 0.3)
    assert predictor.graphs.captures == 3  # (1, 128, 128)
    assert len(predictor.graphs.pool_bytes) == 3


@pytest.mark.cuda
def test_validation_graph_keeps_each_batch_and_counts_replays():
    _card()
    from posetpu_torch.aug import cuda_kernels
    from posetpu_torch.utils.graphs import WARMUP_CALLS

    cfg = _cfg()
    model = _model().cuda()
    graphed = make_graphed_eval_step(model, cfg.aug, MPII_MEAN)
    eager = make_eval_step(model, cfg.aug, MPII_MEAN)
    rng = np.random.RandomState(5)
    batches = [_eval_batch(rng) for _ in range(3)]
    reset_counters(cuda_kernels.RASTERIZE_LAUNCHES)
    results = [graphed(b) for b in batches]
    torch.cuda.synchronize()
    assert counter(cuda_kernels.RASTERIZE_LAUNCHES) == 3 + WARMUP_CALLS
    assert graphed.graphs.captures == 1
    for (mg, pg), b in zip(results, batches):
        me, pe = eager(b)
        assert torch.equal(pg, pe)
        for k in me:
            assert torch.equal(mg[k], me[k]), k
    for (_, a), (_, b) in zip(results, results[1:]):
        assert not torch.equal(a, b)
    graphed(_eval_batch(rng, optional=False))  # no mask or offset: its own graph
    assert graphed.graphs.captures == 2


def test_capture_pauses_the_cyclic_collector(monkeypatch):
    """graphs.record captures with the cyclic collector paused, and
    restores it after, also when the capture raises: a collection inside a
    capture that freed an old predictor's graph (PosePredictor is a
    reference cycle) invalidated that capture on the card."""
    seen = []

    @contextlib.contextmanager
    def fake_graph(graph, pool=None, capture_error_mode=None):
        seen.append(("enter", gc.isenabled()))
        yield
        seen.append(("exit", gc.isenabled()))

    for name, fn in (("synchronize", lambda dev=None: None), ("empty_cache", lambda: None),
                     ("memory_reserved", lambda dev=None: 0), ("CUDAGraph", object),
                     ("graph", fake_graph)):
        monkeypatch.setattr(torch.cuda, name, fn)
    assert gc.isenabled()
    _, out, launches, _ = graphs.record(lambda: gc.isenabled(), "cuda")
    assert out is False and not any(launches.values()) and gc.isenabled()
    assert seen == [("enter", False), ("exit", False)]

    def boom():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.record(boom, "cuda")
    assert gc.isenabled()
    gc.disable()
    try:
        graphs.record(lambda: None, "cuda")
        assert not gc.isenabled()  # left as it was found
    finally:
        gc.enable()
