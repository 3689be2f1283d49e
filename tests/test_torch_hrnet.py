"""Port parity: models/layers + models/hrnet (classic head) and the weight bridge.

``HRNET_TINY`` with 11 joints: one numpy-seeded Flax variable tree goes
through the JAX model and, via ``convert.flax_to_state_dict``, the port
on the CPU in float32. Tolerance 1e-4 of the heatmaps' peak magnitude:
the same convolutions summed in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet

from torch_port_util import n, random_variables, t, to_jax


@pytest.fixture(scope="module")
def tiny():
    jmodel = JHRNet(config=J_TINY.with_joints(11))
    variables = random_variables(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False), seed=0,
        overrides={"final_layer": 0.1},
    )
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(to_jax(variables), x))
    return variables, x, want


def test_heatmaps_match_jax(tiny):
    variables, x, want = tiny
    model = HRNet(HRNET_TINY.with_joints(11), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = n(model(t(x)))
    assert got.shape == want.shape == (2, 16, 16, 11)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_bfloat16_compute_stays_close(tiny):
    """Serving runs bf16 activations over float32 parameters."""
    variables, x, want = tiny
    model = HRNet(HRNET_TINY.with_joints(11), dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        got = n(model(t(x)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.1 * np.abs(want).max())


def test_bridge_covers_every_name(tiny):
    variables, _, _ = tiny
    sd = flax_to_state_dict(variables)
    model = HRNet(HRNET_TINY.with_joints(11), device="cpu")
    assert set(sd) == set(model.state_dict())
    assert sd["stem1.conv.weight"].shape == (8, 3, 3, 3)  # HWIO -> OIHW
    del sd["final_layer.bias"]
    with pytest.raises(RuntimeError, match="final_layer.bias"):
        model.load_state_dict(sd)


def test_seeded_init_is_reproducible():
    a = HRNet(HRNET_TINY, device="cpu", generator=torch.Generator().manual_seed(3))
    b = HRNet(HRNET_TINY, device="cpu", generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
