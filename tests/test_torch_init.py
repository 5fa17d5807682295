"""posetpu_torch's fresh weights (``seeded_init_``) against flax's defaults,
which the JAX package's networks take: for every conv and linear layer of
the hourglass (1 stack, feats 8, 64² input) and of the agent (tree
occlusion over 22 nodes), a two-sample KS test of the port's draws against
the JAX package's ``model.init`` draws (p > 0.01; layers of under 200
weights pooled after scaling by sqrt(fan_in)), the standard deviation
within 10 % of sqrt(1/fan_in) (pooled likewise), nothing beyond two
standard deviations of the untruncated normal, and every bias exactly 0.
BatchNorm keeps scale 1 and shift 0."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from scipy.stats import ks_2samp

from posetpu.models import hg as ref_hg
from posetpu.models.agent import AugAgent as RefAgent
from posetpu_torch.ckpt import from_flax_agent_variables, from_flax_variables
from posetpu_torch.models import hg
from posetpu_torch.models.agent import AugAgent
from posetpu_torch.train.loop import seeded_init_

SMALL = 200  # layers with fewer weights are pooled
P_MIN, STD_RTOL = 0.01, 0.10
AGENT = dict(num_scale_bins=7, num_rot_bins=7, num_occ_nodes=22, occ_mode="tree",
             occ_levels=(1, 2, 4))


def _hourglass():
    port = seeded_init_(hg(num_stacks=1, num_classes=16, num_feats=8,
                           dtype=torch.float32), seed=0)
    ref = ref_hg(num_stacks=1, num_classes=16, num_feats=8, dtype=jnp.float32)
    v = ref.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    v = jax.tree.map(np.asarray, v)
    return port, from_flax_variables(v["params"], v["batch_stats"], num_stacks=1)


def _agent():
    port = seeded_init_(AugAgent(**AGENT, dtype=torch.float32, device="cpu"), seed=1)
    ref = RefAgent(**AGENT, dtype=jnp.float32)
    v = ref.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)), train=False)
    v = jax.tree.map(np.asarray, v)
    return port, from_flax_agent_variables(v["params"], v["batch_stats"])


@pytest.fixture(scope="module", params=["hourglass", "agent"])
def nets(request):
    return request.param, (_hourglass if request.param == "hourglass" else _agent)()


def _layers(port):
    return [(name, m) for name, m in port.named_modules()
            if isinstance(m, (nn.Conv2d, nn.Linear))]


def _groups(port, ref_sd):
    """(label, port draws, flax draws, fan_in) per layer of SMALL weights
    or more, then one pooled group of the smaller layers (each scaled by
    sqrt(fan_in), so its target std is 1)."""
    out, pool = [], ([], [])
    for name, m in _layers(port):
        fan_in = m.weight[0].numel()
        mine = m.weight.detach().numpy().ravel().astype(np.float64)
        theirs = ref_sd[f"{name}.weight"].numpy().ravel().astype(np.float64)
        assert mine.shape == theirs.shape, name
        if mine.size >= SMALL:
            out.append((name, mine, theirs, fan_in))
        else:
            pool[0].append(mine * math.sqrt(fan_in))
            pool[1].append(theirs * math.sqrt(fan_in))
    if pool[0]:
        out.append(("pooled small layers", np.concatenate(pool[0]),
                    np.concatenate(pool[1]), 1))
    return out


def test_draws_follow_flax_lecun_normal(nets):
    what, (port, ref_sd) = nets
    groups = _groups(port, ref_sd)
    assert len(groups) >= (10 if what == "hourglass" else 6)
    for label, mine, theirs, fan_in in groups:
        p = ks_2samp(mine, theirs).pvalue
        assert p > P_MIN, f"{what} {label}: KS p = {p:.2e}"
        want = math.sqrt(1.0 / fan_in)
        assert abs(mine.std() / want - 1.0) <= STD_RTOL, (label, mine.std(), want)
        # truncated at two standard deviations of the normal before the cut
        assert np.abs(mine).max() <= 2.0 * want / 0.87962566103423978 * (1 + 1e-6)


def test_biases_zero_and_batchnorm_identity(nets):
    _, (port, _) = nets
    biases = [m.bias for _, m in _layers(port) if m.bias is not None]
    assert biases and all(torch.count_nonzero(b) == 0 for b in biases)
    for m in port.modules():
        if isinstance(m, nn.BatchNorm2d):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert torch.equal(m.bias, torch.zeros_like(m.bias))
            assert torch.equal(m.running_mean, torch.zeros_like(m.running_mean))
            assert torch.equal(m.running_var, torch.ones_like(m.running_var))


def test_flax_biases_are_zero_too(nets):
    """What the port copies: flax's default bias is zero."""
    _, (port, ref_sd) = nets
    for name, m in _layers(port):
        if m.bias is not None:
            assert not ref_sd[f"{name}.bias"].any(), name
