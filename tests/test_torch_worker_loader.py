"""posetpu_torch's worker-process loader and superbatch stacking: two
shuffled epochs of ``WorkerLoader`` (2 workers, and 12) equal
``HostLoader(backend="pil")`` bit for bit (and an unshuffled validation
split with a ragged last batch); ``group_stack`` equals the JAX package's
on the same batches, short last group included; ``group=`` stacks before
``place`` (a group of 1 too); a ``break`` after one batch leaves no worker
process alive and does not hang; ``stop_worker_server`` ends the server
and the resource tracker; and an early exit from a source that hangs
raises instead of waiting on it."""

import threading

import numpy as np
import pytest
import torch

from posetpu.data import make_synthetic_dataset as ref_make
from posetpu.data.loader import group_stack as ref_group_stack
from posetpu_torch.data import HostLoader, MpiiDataset, WorkerLoader, group_stack
from posetpu_torch.data import loader as loader_mod
from posetpu_torch.data.worker_loader import stop_worker_server


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("worker_split")
    ref_make(str(root), num_train=11, num_val=7, res=(96, 72), seed=3)
    ann, imgs = str(root / "annotations.json"), str(root / "images")
    return MpiiDataset(ann, imgs), MpiiDataset(ann, imgs, split="valid")


def _same(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _epochs(loader, n):
    return [[{k: np.array(v) for k, v in b.items()} for b in loader] for _ in range(n)]


# 12: more workers than this machine's cores, and a ring of 9 batch slots
# that every epoch wraps around while the workers run ahead of the collate
@pytest.mark.parametrize("workers", [2, 12])
def test_two_shuffled_epochs_equal_host_loader_pil(dataset, workers):
    train, _ = dataset
    kw = dict(pad_hw=(64, 80), seed=5)
    want = _epochs(HostLoader(train, 3, backend="pil", **kw), 2)
    loader = WorkerLoader(train, 3, num_workers=workers, **kw)
    got = _epochs(loader, 2)
    assert loader.epoch == 2 and len(loader) == 3 and loader.backend == "pil"
    assert [len(e) for e in got] == [3, 3]
    assert not np.array_equal(got[0][0]["index"], got[1][0]["index"])  # reshuffled
    for ge, we in zip(got, want):
        for g, w in zip(ge, we):
            _same(g, w)


def test_validation_split_with_a_ragged_last_batch(dataset):
    _, val = dataset
    kw = dict(pad_hw=(72, 96), shuffle=False, drop_last=False)
    want = _epochs(HostLoader(val, 3, backend="pil", **kw), 1)[0]
    got = _epochs(WorkerLoader(val, 3, num_workers=2, **kw), 1)[0]
    assert [len(b["index"]) for b in got] == [3, 3, 1]
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("group,n_batches", [(2, 5), (3, 5), (3, 3), (4, 1)])
def test_group_stack_equals_reference(group, n_batches):
    rng = np.random.RandomState(group * 10 + n_batches)
    batches = [{"image": rng.randint(0, 256, (2, 4, 5, 3), dtype=np.uint8),
                "pts": rng.randn(2, 16, 2).astype(np.float32),
                "index": rng.randint(0, 100, 2).astype(np.int32)} for _ in range(n_batches)]
    want = list(ref_group_stack(iter(batches), group))
    got = list(group_stack(iter(batches), group))
    pinned = list(group_stack(iter(batches), group,
                              host_image=lambda s: torch.empty(s, dtype=torch.uint8)))
    assert [g["image"].shape[0] for g in got] == [w["image"].shape[0] for w in want]
    assert got[-1]["image"].shape[0] == (n_batches % group or group)
    for g, p, w in zip(got, pinned, want):
        _same(g, w)
        assert isinstance(p["image"], torch.Tensor)
        _same({k: np.asarray(v) for k, v in p.items()}, w)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("workers", [0, 2])
def test_group_stacks_before_place(dataset, workers, group):
    """3 batches: at group=2 one (2, B, ...) superbatch and a short one, at
    group=1 three (1, B, ...) ones, each the host batches stacked, handed to
    place whole."""
    train, _ = dataset
    kw = dict(pad_hw=(64, 80), seed=1)
    want = _epochs(HostLoader(train, 3, backend="pil", **kw), 1)[0]
    shapes = []

    def place(b):
        shapes.append(b["image"].shape)
        return b

    got = _epochs(WorkerLoader(train, 3, num_workers=workers, group=group, place=place,
                               **kw), 1)[0]
    sizes = [2, 1] if group == 2 else [1, 1, 1]
    assert shapes == [(n, 3, 64, 80, 3) for n in sizes]
    first = 0
    for g, n in zip(got, sizes):
        for k in want[0]:
            np.testing.assert_array_equal(g[k], np.stack([w[k] for w in want[first:first + n]]))
        first += n


def _live_workers():
    """The processes the forkserver forked (the loader's workers) that are
    still running."""
    import psutil

    out = []
    for server in psutil.Process().children():
        if "forkserver" in " ".join(server.cmdline()):
            out += [p for p in server.children()
                    if p.is_running() and p.status() != psutil.STATUS_ZOMBIE]
    return out


def test_break_leaves_no_worker_alive(dataset):
    train, _ = dataset
    loader = WorkerLoader(train, 2, pad_hw=(64, 80), num_workers=2)
    seen = []

    def one_batch():
        for _ in loader:
            seen.append(len(_live_workers()))
            break

    # in a thread of its own, so a hang fails the test instead of the run
    t = threading.Thread(target=one_batch, daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive(), "the break hung"
    # the break returned after the producer closed the epoch's source
    assert seen == [2]
    assert not _live_workers()
    assert [len(b["index"]) for b in loader] == [2] * 5  # a fresh epoch runs whole
    assert not _live_workers()


def _multiprocessing_children():
    import psutil

    return [p for p in psutil.Process().children(recursive=True)
            if "multiprocessing" in " ".join(p.cmdline())]


def test_stop_worker_server_leaves_nothing_running(dataset):
    """After an epoch the server and the resource tracker still run; the
    stop ends both (it waits for them), and the next epoch starts anew."""
    train, _ = dataset
    loader = WorkerLoader(train, 2, pad_hw=(64, 80), num_workers=2)
    assert [len(b["index"]) for b in loader] == [2] * 5
    assert _multiprocessing_children()
    stop_worker_server()
    assert not _multiprocessing_children()
    assert [len(b["index"]) for b in loader] == [2] * 5
    stop_worker_server()
    assert not _multiprocessing_children()
    stop_worker_server()  # without a server: nothing to do


def test_bad_worker_count_raises(dataset):
    with pytest.raises(ValueError):
        WorkerLoader(dataset[0], 2, num_workers=-1)
    with pytest.raises(ValueError):
        HostLoader(dataset[0], 2, group=0)


def test_early_exit_from_a_hung_source_raises(monkeypatch):
    """The consumer stops after one item while the source hangs making the
    next: the early exit waits JOIN_TIMEOUT for the producer, then raises."""
    monkeypatch.setattr(loader_mod, "JOIN_TIMEOUT", 0.2)
    release = threading.Event()

    def hung():
        yield {"x": 1}
        release.wait(30)
        yield {"x": 2}

    it = loader_mod.threaded_place_iter(hung(), lambda b: b)
    assert next(it) == {"x": 1}
    try:
        with pytest.raises(RuntimeError, match="did not stop"):
            it.close()
    finally:
        release.set()
