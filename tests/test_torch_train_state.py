"""posetpu_torch's optimizer and schedule against the JAX package's
(``posetpu.train.state.make_optimizer``: optax ``rmsprop`` over a
``piecewise_constant_schedule``, behind ``add_decayed_weights``), and the
carry of optax's state (``from_optax_state``).

Tolerances of :func:`test_optimizer_matches_optax`, per element, from the
float32 operations of one update (u = one ulp, at most 2**-23 relative):

- ``nu``.  Both compute ``(1-d)*g*g + d*nu`` from equal inputs; a fused
  multiply-add on one side skips a rounding, so a step may differ by one
  ulp.  The average shrinks old differences by d per step, so the gap stays
  below ``NU_RTOL = 2**-23 / (1 - d)`` relative (1.6e-7 read, 8.4e-7
  allowed at d = 0.99).
- The update ``-lr * g * rsqrt(nu + eps)``: half of nu's relative gap
  through the root, at most 2 ulps between the two rsqrt implementations
  and one each for the two products: ``U_RTOL = NU_RTOL/2 + 4 * 2**-23``.
- The trace ``m = u + mu*m`` carries each update gap into later updates
  with weight ``sum mu**k = 1/(1-mu)`` and adds one rounding of |m| per step,
  itself at most ``sum|u|/(1-mu)``; the parameter adds one rounding of |p|
  per step.  With S = sum over steps of |u| (optax's own updates):
  ``|dp| <= U_RTOL*S/(1-mu) + 2**-23*S/(1-mu)**2 + T*2**-23*(|p| + S)``.
- Weight decay reads p, whose gap is below 1e-5: ``1e-4 * 1e-5`` more in
  a gradient is far below one ulp of the gradients used here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posetpu.configs.config import OptimConfig as RefOptimConfig
from posetpu.train.state import lr_schedule as ref_lr_schedule
from posetpu.train.state import make_optimizer as ref_make_optimizer
from posetpu_torch.configs import OptimConfig
from posetpu_torch.train.state import OptaxRMSprop, lr_schedule, make_optimizer

ULP = 2.0**-23  # one ulp, relative, at most
STEPS, STEPS_PER_EPOCH, SCHEDULE = 60, 10, (2, 4)  # drops at updates 20, 40
SHAPES = {"a": (3, 4), "b": (7,), "c": (2, 3, 5)}


def _gradients(rng):
    """Gradients over six decades: the eps in the root matters below 1e-4."""
    g = {k: (rng.randn(*s) * 10.0 ** rng.uniform(-6, 0, s)).astype(np.float32)
         for k, s in SHAPES.items()}
    g["b"][:2] = 0.0  # a zero gradient: nu decays, the update is zero
    return g


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_optimizer_matches_optax(momentum, weight_decay):
    kw = dict(schedule=SCHEDULE, momentum=momentum, weight_decay=weight_decay)
    tx = ref_make_optimizer(RefOptimConfig(**kw), steps_per_epoch=STEPS_PER_EPOCH)
    rng = np.random.RandomState(0)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(params)

    @jax.jit
    def update(grads, opt_state, params):
        u, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, u), opt_state, u

    port = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in SHAPES]
    opt = make_optimizer(port, OptimConfig(**kw), steps_per_epoch=STEPS_PER_EPOCH)
    total = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    for _ in range(STEPS):
        g = _gradients(rng)
        params, opt_state, u = update({k: jnp.asarray(v) for k, v in g.items()},
                                      opt_state, params)
        for k in SHAPES:
            total[k] += np.abs(np.asarray(u[k]))
        for p, k in zip(port, SHAPES):
            p.grad = torch.from_numpy(g[k])
        opt.step()

    assert opt.count == STEPS
    decay = 0.99
    nu_rtol = ULP / (1 - decay)
    u_rtol = nu_rtol / 2 + 4 * ULP
    nu = optax.tree_utils.tree_get(opt_state, "nu")
    for p, k in zip(port, SHAPES):
        want_nu = np.asarray(nu[k])
        np.testing.assert_allclose(opt.state[p]["nu"].numpy(), want_nu,
                                   rtol=nu_rtol, atol=0, err_msg=f"nu {k}")
        s = total[k]
        want = np.asarray(params[k])
        tol = (u_rtol * s / (1 - momentum) + ULP * s / (1 - momentum) ** 2
               + STEPS * ULP * (np.abs(want) + s))
        got = p.detach().numpy()
        assert (np.abs(got - want) <= tol).all(), (k, np.abs(got - want).max())
        assert not np.array_equal(got, p0[k])  # it trained


def test_lr_exact_at_every_boundary():
    """The schedule counts optimizer updates, reads the count before the
    update, and drops once count >= boundary: equal float32 values."""
    ref = ref_lr_schedule(RefOptimConfig(schedule=SCHEDULE), STEPS_PER_EPOCH)
    port = lr_schedule(OptimConfig(schedule=SCHEDULE), STEPS_PER_EPOCH)
    for count in (0, 19, 20, 21, 39, 40, 41, 59):
        want = np.float32(ref(jnp.asarray(count, jnp.int32)))
        assert np.float32(port(count)) == want, count
        assert port(count) == float(want), count  # no rounding left to do
    assert port(19) == float(np.float32(2.5e-4))
    assert port(20) < port(19) and port(40) < port(20)


def test_first_update_is_not_torch_rmsprop():
    """The gap the port exists to close: optax puts eps inside the root.
    For |g| = 1e-5 the first update is lr*g/sqrt(0.01 g^2 + 1e-8) =
    lr*0.1, and torch's lr*g/(0.1|g| + 1e-8) = lr*9.9: 0.0101 of it."""
    g = torch.full((4,), 1e-5)
    mine = torch.nn.Parameter(torch.zeros(4))
    theirs = torch.nn.Parameter(torch.zeros(4))
    opt = make_optimizer([mine], OptimConfig())
    ref = torch.optim.RMSprop([theirs], lr=2.5e-4, alpha=0.99, eps=1e-8)
    mine.grad, theirs.grad = g.clone(), g.clone()
    opt.step()
    ref.step()
    want = -np.float32(2.5e-4) * 1e-5 / np.sqrt(0.01 * 1e-10 + 1e-8)
    np.testing.assert_allclose(mine.detach().numpy(), want, rtol=1e-6)
    ratio = (mine / theirs).detach().numpy()
    np.testing.assert_allclose(ratio, 0.1 / (1e-5 / (0.1 * 1e-5 + 1e-8)), rtol=1e-3)


def test_optimizer_takes_no_closure():
    p = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError):
        OptaxRMSprop([p], lambda count: 1.0).step(lambda: 0.0)
