"""Port parity of ``models/regnet.py`` on the CPU against the JAX package.

``REGNET_TINY`` and a RegNetY with squeeze-excite and odd group counts
(widths 24, 40, 56, 72 at group width 8: 3, 5, 7 and 9 groups, which JAX's
``MergedGroupConv`` packs into wider groups and the port runs as a plain
``groups=`` conv) at 64^2, float32, JAX's parameters (FrozenBN statistics
and the SE convs' biases among them) carried by
``convert.flax_to_state_dict``: every stage's features within 1e-5 of
their scale. The JAX side is jitted once for the module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models import regnet as jreg
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models import regnet as treg

from torch_port_util import few_threads, n, random_variables, t, to_jax  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

ODD_Y = dict(depths=(1, 2, 1, 1), widths=(24, 40, 56, 72), group_width=8, stem_width=8, se_ratio=0.25)
CONFIGS = {"tiny": (jreg.REGNET_TINY, treg.REGNET_TINY),
           "y_odd_groups": (jreg.RegNetConfig(**ODD_Y), treg.RegNetConfig(**ODD_Y))}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    jcfg, tcfg = CONFIGS[request.param]
    x = np.random.default_rng(0).normal(0, 50, (2, 64, 64, 3)).astype(np.float32)
    jm = jreg.RegNet(config=jcfg)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=1)
    want = jax.jit(jm.apply)(to_jax(variables), jnp.asarray(x))
    return tcfg, variables, x, {k: np.asarray(v) for k, v in want.items()}


def test_regnet_features_match_jax(case):
    tcfg, variables, x, want = case
    model = treg.RegNet(tcfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = model(t(x))
    assert got.keys() == want.keys() == {"s1", "s2", "s3", "s4"}
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(n(got[k]), want[k], atol=1e-5 * max(1.0, np.abs(want[k]).max()))


def test_regnet_tree_and_group_widths(case):
    """The port's parameters are JAX's tree leaf for leaf, the grouped convs
    compact (in // groups) and the SE middle width from the block input."""
    tcfg, variables, _, _ = case
    sd = flax_to_state_dict(variables)
    model = treg.RegNet(tcfg, device="cpu")
    assert set(model.state_dict()) == set(sd)
    for si, w in enumerate(tcfg.widths):
        assert model.state_dict()[f"s{si + 1}_b0.b.conv.weight"].shape == (w, tcfg.group_width, 3, 3)
    if tcfg.se_ratio:
        w_in = tcfg.stem_width
        assert model.s1_b0.se.fc1.weight.shape == (round(w_in * tcfg.se_ratio), tcfg.widths[0], 1, 1)
        assert model.s1_b0.se.fc1.bias is not None and model.s1_b0.se.fc2.bias is not None
