"""The port's SuperSloMo (``events/slomo.py``) against the JAX package's
Flax model on the same weights and frames.

Bars: ``backwarp`` exact (the same gather in the same arithmetic order);
the 2x bilinear upsampling (``F.interpolate``, align_corners=False)
within 1e-6 of ``jax.image.resize`` (which contracts with weight
matrices); the UNets and the whole model, float32 with TF32 off, within
SLOMO_TOL absolute on outputs of order 1 (the two libraries' convolutions
sum in different orders; read here: at most 5.7e-7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.events import slomo as js
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.events import slomo as ts
from torch_port_util import few_threads, n, random_variables, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

H, W = 32, 64
SLOMO_TOL = 1e-4


def frames(seed: int, b: int = 2, c: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Two smooth frames in [0, 1], the second the first shifted by ~2 px."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for shift in (0.0, 2.3):
        imgs = []
        for k in range(b):
            ph = rng.uniform(0, 6, c)
            imgs.append(np.stack([0.5 + 0.4 * np.sin((xs - shift) / 5 + ph[i]) * np.cos(ys / 7 + k)
                                  for i in range(c)], -1))
        out.append(np.stack(imgs).astype(np.float32))
    return out[0], out[1]


@pytest.fixture(scope="module")
def jax_model():
    model = js.SuperSloMo()
    f0, _ = frames(0)
    variables = random_variables(lambda: model.init(jax.random.key(0), jnp.asarray(f0), jnp.asarray(f0),
                                                    jnp.full((2,), 0.5)), seed=1)
    return model, variables


@pytest.fixture(scope="module")
def port_model(jax_model):
    model = ts.SuperSloMo(channels=1, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax_model[1]), strict=True)
    return model


def test_unet_and_upsampling_equal_flax(jax_model, port_model):
    x = np.random.default_rng(2).uniform(0, 1, (2, H, W, 2)).astype(np.float32)
    jout = js.UNet(4).apply({"params": jax_model[1]["params"]["flow_comp"]}, jnp.asarray(x))
    with torch.inference_mode():
        tout = port_model.flow_comp(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    err = float(np.abs(n(tout) - n(jout)).max())
    print(f"flow UNet: max |port - JAX| {err:.3g}, output scale {float(np.abs(n(jout)).max()):.3g}")
    assert err <= SLOMO_TOL
    y = np.random.default_rng(3).normal(0, 1, (2, 5, 7, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(y), (2, 10, 14, 3), "bilinear")
    got = torch.nn.functional.interpolate(t(y).permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                                          align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["exact", "torch"])
def test_backwarp_equals_jax(mode):
    """Flows up to 6 px, reaching off the image on every side: exact."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (2, 12, 16, 3)).astype(np.float32)
    flow = rng.uniform(-6, 6, (2, 12, 16, 2)).astype(np.float32)
    np.testing.assert_array_equal(n(ts.backwarp(t(img), t(flow), mode)),
                                  n(js.backwarp(jnp.asarray(img), jnp.asarray(flow), mode)))
    zero = np.zeros_like(flow)
    np.testing.assert_array_equal(n(ts.backwarp(t(img), t(zero), "exact")), img)


@pytest.mark.parametrize("tval", [0.125, 0.7])
def test_superslomo_at_t_and_flow_equal_flax(jax_model, port_model, tval):
    model, variables = jax_model
    f0, f1 = frames(5)
    tt = np.full((2,), tval, np.float32)
    want = model.apply(variables, jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(tt))
    with torch.inference_mode():
        got = port_model(t(f0), t(f1), t(tt))
        flow = port_model(t(f0), t(f1), t(tt), return_flow=True)
    err = float(np.abs(n(got) - n(want)).max())
    print(f"SuperSloMo t={tval}: max |port - JAX| {err:.3g}")
    assert got.shape == (2, H, W, 1) and err <= SLOMO_TOL
    jflow = model.apply(variables, jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(tt), return_flow=True)
    np.testing.assert_allclose(n(flow), n(jflow), rtol=0, atol=SLOMO_TOL)


def test_interpolate_pair_equals_flax(jax_model, port_model):
    """n = 3 at the midpoint schedule: the port's one flow pass and one
    batched interpolation pass against JAX's vmap over t."""
    model, variables = jax_model
    f0, f1 = frames(6)
    want = js.interpolate_pair(model, variables, jnp.asarray(f0), jnp.asarray(f1), 3)
    got = ts.interpolate_pair(port_model, t(f0), t(f1), 3)
    assert got.shape == want.shape == (3, 2, H, W, 1)
    assert float(np.abs(n(got) - n(want)).max()) <= SLOMO_TOL
    np.testing.assert_array_equal(n(ts.midpoint_times(4)), n((jnp.arange(4) + 0.5) / 4))
    for mf in (0.0, 1.0, 1.5, 7.2):
        assert ts.auto_upsampling_factor(mf) == int(js.auto_upsampling_factor(jnp.asarray(mf, jnp.float32)))


def test_official_checkpoint_layout_loads_directly(jax_model):
    """A synthetic checkpoint with the official key layout
    (``state_dictFC`` / ``state_dictAT``, OIHW tensors): JAX imports it
    through ``slomo_torch_to_flax``, the port with ``load_state_dict``;
    both give the same frame at t = 0.3."""
    model, _ = jax_model
    rng = np.random.default_rng(7)
    ref = ts.SuperSloMo(channels=1, device="cpu")
    ckpt = {}
    for key, sub in (("state_dictFC", ref.flow_comp), ("state_dictAT", ref.arb_interp)):
        ckpt[key] = {name: torch.from_numpy(rng.normal(0, 1 / np.sqrt(max(v[0].numel(), 1)) if v.dim() == 4 else 0.05,
                                                       tuple(v.shape)).astype(np.float32))
                     for name, v in sub.state_dict().items()}
    assert "down3.conv2.weight" in ckpt["state_dictFC"] and "up5.conv1.bias" in ckpt["state_dictAT"]
    assert ts.checkpoint_channels(ckpt) == 1
    port = ts.load_checkpoint(ts.SuperSloMo(channels=1, device="cpu"), ckpt)
    variables = {"params": js.slomo_torch_to_flax(ckpt)}
    f0, f1 = frames(8)
    tt = np.full((2,), 0.3, np.float32)
    want = model.apply(variables, jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(tt))
    with torch.inference_mode():
        got = port(t(f0), t(f1), t(tt))
    assert float(np.abs(n(got) - n(want)).max()) <= SLOMO_TOL
    bad = dict(ckpt, state_dictFC={k.replace("down1", "downA"): v for k, v in ckpt["state_dictFC"].items()})
    with pytest.raises(RuntimeError):
        ts.load_checkpoint(ts.SuperSloMo(channels=1, device="cpu"), bad)
