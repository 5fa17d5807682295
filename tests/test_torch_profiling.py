"""posetpu_torch.utils.profiling against posetpu/utils/profiling.py.

The reference's guards (tests/test_profiling.py), held on the port's
functions: a ragged superbatch is skipped, never dispatched; a loader that
only yields ragged groups raises; an empty loader raises (and, for
``measure_duty_cycle``, one with no batch after the warm-up).  The same
toy superbatch pattern through the JAX package's
``measure_duty_cycle_fused`` and the port's runs the same steps on the same
groups, in the same order.  ``time_device_step`` advances a real train
state by (warmup + 1) x K steps, as K-step dispatches of the port's train
step, equal to as many eager steps.  All on the CPU, timed by the host's
clock.
"""

import copy

import numpy as np
import pytest
import torch

from posetpu_torch.configs import named_config
from posetpu_torch.models import hg
from posetpu_torch.train import TrainState, make_dispatch_step, make_optimizer, make_train_step
from posetpu_torch.utils.profiling import (
    DEVICE_STEPS,
    measure_duty_cycle,
    measure_duty_cycle_fused,
    time_device_step,
)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread for this module's CPU training (the suite runs
    several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ToyDispatch:
    """A dispatch of ``steps`` steps over (k, B, 4) superbatches whose
    ``x`` holds its group's id: it records the id of every step it runs and
    the k of every call."""

    def __init__(self, steps, log):
        self.steps, self.log = steps, log
        self.calls = []

    def __call__(self, state, superbatch):
        x = torch.as_tensor(superbatch["x"])
        k = x.shape[0]
        assert 1 <= k <= self.steps
        self.calls.append(k)
        for i in range(k):
            self.log.append(int(x[i, 0, 0]))
            state["s"] = state["s"] + float(x[i].sum()) * 1e-9
        return {"loss": torch.full((k,), state["s"])}


def _superbatch(k, gid, b=2):
    return {"x": np.full((k, b, 4), gid, np.float32)}


class Loader:
    """Restartable loader of a fixed per-epoch pattern of group sizes; each
    group's id is its place in the pattern."""

    def __init__(self, pattern):
        self.pattern = pattern

    def __iter__(self):
        for gid, k in enumerate(self.pattern):
            yield _superbatch(k, gid)


def _toys(K):
    log = []
    return ToyDispatch(K, log), ToyDispatch(DEVICE_STEPS, log), log


def test_ragged_groups_skipped_not_dispatched():
    step, device, _ = _toys(3)
    # an epoch of 2 whole groups of K = 3 and a ragged group of 2
    duty, t_dev, t_wall = measure_duty_cycle_fused(
        step, device, {"s": 0.0}, Loader([3, 3, 2]), max_dispatches=4)
    assert np.isfinite(duty) and 0.0 <= duty <= 1.0
    assert t_wall > 0 and t_dev > 0
    # the warm dispatch, then 4 whole ones: never the ragged group
    assert step.calls == [3] * 5
    assert device.calls == [DEVICE_STEPS] * 2


def test_all_ragged_raises_instead_of_spinning():
    step, device, _ = _toys(3)

    class FirstWholeThenRagged(Loader):
        def __init__(self):
            super().__init__(None)
            self.first = True

        def __iter__(self):
            if self.first:
                self.first = False
                yield _superbatch(3, 0)
            yield _superbatch(2, 1)
            yield _superbatch(1, 2)

    with pytest.raises(ValueError, match="ragged"):
        measure_duty_cycle_fused(step, device, {"s": 0.0}, FirstWholeThenRagged(),
                                 max_dispatches=2)


def test_empty_loader_raises():
    step, device, _ = _toys(1)
    with pytest.raises(ValueError, match="no superbatches"):
        measure_duty_cycle_fused(step, device, {"s": 0.0}, Loader([]), max_dispatches=1)


def test_duty_cycle_without_batches_after_the_warmup_raises():
    step, device, _ = _toys(1)

    class OneShot(Loader):
        def __init__(self):
            super().__init__([1])
            self.used = False

        def __iter__(self):
            if not self.used:
                self.used = True
                yield from super().__iter__()

    with pytest.raises(ValueError, match="no batches"):
        measure_duty_cycle(step, device, {"s": 0.0}, OneShot())


def test_duty_cycle_counts_its_steps():
    step, device, log = _toys(1)
    duty, t_dev, t_wall = measure_duty_cycle(step, device, {"s": 0.0},
                                             Loader([1] * 5), max_steps=3)
    assert 0.0 < duty <= 1.0 and t_dev > 0 and t_wall > 0
    # device: 2 dispatches of DEVICE_STEPS on group 0; warm step on group 0;
    # then a fresh epoch, cut at 3 steps
    assert log == [0] * (2 * DEVICE_STEPS) + [0] + [0, 1, 2]


@pytest.mark.parametrize("pattern,K,dispatches", [
    ([3, 3, 2], 3, 4),
    ([2, 1, 2, 2], 2, 5),
])
def test_fused_runs_the_reference_steps(pattern, K, dispatches):
    """The JAX package's measure_duty_cycle_fused and the port's run the
    same steps on the same groups in the same order (a host callback in the
    JAX step records each step's group as it runs)."""
    import jax
    import jax.numpy as jnp

    from posetpu.utils.profiling import measure_duty_cycle_fused as ref_fused

    ref_log = []

    def ref_step(state, batch, key):
        jax.debug.callback(lambda g: ref_log.append(int(g)), batch["x"][0, 0],
                           ordered=True)
        s = state + jnp.sum(batch["x"]) * 1e-9
        return s, {"loss": s}

    class RefLoader(Loader):
        def __iter__(self):
            for b in super().__iter__():
                yield {"x": jnp.asarray(b["x"])}

    ref_fused(ref_step, jnp.zeros(()), RefLoader(pattern), jax.random.PRNGKey(0),
              max_dispatches=dispatches)
    jax.effects_barrier()

    step, device, log = _toys(K)
    measure_duty_cycle_fused(step, device, {"s": 0.0}, Loader(pattern),
                             max_dispatches=dispatches)
    assert log == ref_log
    assert len(log) == 2 * DEVICE_STEPS + K * (1 + dispatches)


def _small_train(seed=0):
    cfg = named_config("hg2_mpii_mini")
    cfg.aug.inp_res, cfg.aug.out_res = (64, 64), (16, 16)
    torch.manual_seed(seed)
    model = hg(num_stacks=1, num_feats=8, num_classes=16, dtype=torch.float32)
    return cfg, model


def _batch(B=2, pad=80):
    rng = np.random.RandomState(3)
    return {
        "image": rng.randint(0, 256, (B, pad, pad, 3), dtype=np.uint8),
        "valid_wh": np.full((B, 2), pad, np.int32),
        "center": np.full((B, 2), pad / 2, np.float32),
        "scale": np.full((B,), pad / 200.0, np.float32),
        "pts": (rng.rand(B, 16, 2) * 40 + 20).astype(np.float32),
        "vis": np.ones((B, 16), np.float32),
        "index": np.arange(B, dtype=np.int32),
    }


def test_time_device_step_advances_the_state_by_its_steps():
    """(warmup + 1) dispatches of K = 3 train steps on one batch: the
    state's step and update count advance by 6, and its weights equal those
    of 6 eager train steps on that batch."""
    cfg, model = _small_train()
    twin = copy.deepcopy(model)
    opt = make_optimizer(model.parameters(), cfg.optim, 10)
    state = TrainState(model, opt)
    dispatch = make_dispatch_step(model, opt, cfg.aug, (0.4, 0.4, 0.4), seed=2, steps=3,
                                  device="cpu")
    batch = _batch()
    seconds, out = time_device_step(dispatch, state, batch, warmup=1)
    assert out is state and seconds > 0
    assert state.step == opt.count == 6

    twin_opt = make_optimizer(twin.parameters(), cfg.optim, 10)
    twin_state = TrainState(twin, twin_opt)
    eager = make_train_step(twin, twin_opt, cfg.aug, (0.4, 0.4, 0.4), seed=2, device="cpu")
    for _ in range(6):
        eager(twin_state, batch)
    for (n, a), b in zip(model.state_dict().items(), twin.state_dict().values()):
        assert torch.equal(a, b), n
