"""Port parity of the CMS heads and the other landmark nets: ``layers.upsample_bilinear``,
``layers.ConvTranspose``, ``hrnet.HRNet`` with ``head="cms"`` / ``"cms_half"``,
``pose_resnet.PoseResNet``, ``discriminator.MultiScaleDiscriminator``,
``HRNET_GOLDEN``, ``build_landmark_model`` and the weight bridge of
transposed-conv kernels.

One numpy-seeded Flax variable tree per model goes through the JAX model
and, via ``convert.flax_to_state_dict``, the port on the CPU in float32.
Tolerances, each of the output's peak magnitude (the same convolutions
summed in another order): the bilinear upsample 1e-6 (both are two-tap
weighted sums); a transposed conv 1e-5; the CMS nets 1e-5 in eval mode
and in train mode (the four scales and the updated ``batch_stats``, 1e-5
absolute) on batches of 4 (at 32x32 the coarsest branch is 1x1, and
with a batch of 2 its train-mode BN normalizes over 2 values: JAX's own
float32 outputs are then 1e-4 from its float64 ones, the port's 4e-6);
PoseResNet, the discriminator and ``HRNET_GOLDEN`` 1e-4 (deeper
stacks of convolutions).
"""

import dataclasses

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models import build_landmark_model as j_build
from spacecraft_pose_estimation_tpu.models.discriminator import MultiScaleDiscriminator as JDisc
from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.models.layers import upsample_bilinear as j_upsample
from spacecraft_pose_estimation_tpu_torch import evaluate
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, module_to_flax
from spacecraft_pose_estimation_tpu_torch.models import build_landmark_model
from spacecraft_pose_estimation_tpu_torch.models.discriminator import MultiScaleDiscriminator
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet
from spacecraft_pose_estimation_tpu_torch.models.layers import ConvTranspose, upsample_bilinear
from spacecraft_pose_estimation_tpu_torch.train.checkpoint import save_npz

from torch_port_util import few_threads, n, random_variables, t, to_jax

pytestmark = pytest.mark.usefixtures("few_threads")
J = 11
NAMES = ("pose_hrnet", "hrnet_cms", "hrnet_cms_384", "hrnet_tiny", "hrnet_golden", "hrnet_tiny_cms", "pose_resnet")


def leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def close(got, want, rel):
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_upsample_bilinear_matches_jax_resize(factor):
    """4x4 maps, so most output pixels sit in the edge cells where
    ``jax.image.resize`` renormalizes its taps and ``F.interpolate`` clamps."""
    x = np.random.default_rng(factor).normal(size=(2, 4, 4, 3)).astype(np.float32)
    want = np.asarray(j_upsample(jnp.asarray(x), factor))
    got = n(upsample_bilinear(t(x).permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1))
    assert got.shape == want.shape == (2, 4 * factor, 4 * factor, 3)
    close(got, want, 1e-6)


class _Holder(torch.nn.Module):
    def __init__(self, deconv):
        super().__init__()
        self.deconv = deconv


DECONVS = {  # name: (kernel, stride, Flax padding, the port's (lo, hi), bias)
    "cms_k5s4": (5, 4, ((3, 4), (3, 4)), (3, 4), True),
    "cms_half_k3s2": (3, 2, ((1, 2), (1, 2)), (1, 2), True),
    "pose_resnet_k4s2_same": (4, 2, "SAME", (2, 2), False),
}


@pytest.mark.parametrize("case", list(DECONVS))
def test_conv_transpose_matches_flax(case):
    """Non-symmetric random kernels through the bridge, 5 -> 6 channels; a
    bridge that dropped the spatial flip or the (in, out) order (here with
    6 -> 6 channels, where the wrong layout loads without error) is off by
    far more than the bound."""
    k, s, fpad, pad, bias = DECONVS[case]
    rng = np.random.default_rng(k * 10 + s)
    for cin, cout in ((5, 6), (6, 6)):
        x = rng.normal(size=(2, 7, 6, cin)).astype(np.float32)
        kernel = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
        params = {"kernel": kernel} | ({"bias": rng.normal(size=cout).astype(np.float32)} if bias else {})
        flax_m = fnn.ConvTranspose(cout, (k, k), strides=(s, s), padding=fpad, use_bias=bias)
        want = np.asarray(flax_m.apply({"params": params}, jnp.asarray(x)))
        m = _Holder(ConvTranspose(cin, cout, k, s, pad, bias=bias))
        m.load_state_dict(flax_to_state_dict({"params": {"deconv": params}}))
        with torch.no_grad():
            got = n(m.deconv(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        assert got.shape == want.shape == (2, 7 * s, 6 * s, cout)
        close(got, want, 1e-5)
        back = module_to_flax(m)["params"]["deconv"]
        np.testing.assert_array_equal(back["kernel"], kernel)
        if cin == cout:
            w = torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)))
            for wrong in (w, w.transpose(0, 1).flip(2, 3)):  # no flip; flipped but (out, in)
                with torch.no_grad():
                    m.deconv.weight.copy_(wrong)
                    bad = n(m.deconv(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
                assert np.abs(bad - want).max() > 0.1 * np.abs(want).max()


def cms_config(head):
    return dataclasses.replace(J_TINY.with_joints(J), head=head)


def cms_pair(head, size, seed):
    jm = JHRNet(config=cms_config(head))
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.zeros((1, size, size, 3)), train=False),
                                 seed=seed, overrides={"head": 0.1})
    model = HRNet(dataclasses.replace(HRNET_TINY.with_joints(J), head=head), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    return jm, variables, model


@pytest.mark.parametrize("head,size", [("cms", 32), ("cms", 64), ("cms_half", 32), ("cms_half", 64)])
def test_cms_hrnet_matches_jax(head, size):
    """Eval mode: the fused finest map; ``return_all_scales`` under the
    running statistics; train mode: the four maps and the updated
    ``batch_stats``."""
    jm, variables, model = cms_pair(head, size, seed=size)
    x = np.random.default_rng(size + 1).normal(size=(4, size, size, 3)).astype(np.float32)
    v = to_jax(variables)
    res = size // (1 if head == "cms" else 2)
    want_eval = np.asarray(jm.apply(v, x, train=False))
    want_all = jm.apply(v, x, train=False, return_all_scales=True)
    want_train, upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got_eval = n(model(t(x)))
        got_all = model(t(x), return_all_scales=True)
        model.train()
        got_train = model(t(x))
    assert got_eval.shape == want_eval.shape == (4, res, res, J)
    close(got_eval, want_eval, 1e-5)
    for outs, wants in ((got_all, want_all), (got_train, want_train)):
        assert len(outs) == 4
        for i, (g, w) in enumerate(zip(outs, wants)):
            assert g.shape == w.shape == (4, res >> i, res >> i, J)
            close(n(g), np.asarray(w), 1e-5)
    stats = module_to_flax(model)["batch_stats"]
    assert jax.tree_util.tree_structure(stats) == jax.tree_util.tree_structure(upd["batch_stats"])
    for a, b in zip(leaves(upd["batch_stats"]), leaves(stats)):
        np.testing.assert_allclose(b, a, atol=1e-5)


def test_cms_npz_round_trip_loads_into_jax(tmp_path):
    """port -> ``module_to_flax`` -> JAX ``HRNet(head="cms")`` gives the
    port's heatmaps, and the ``.npz`` loads through ``evaluate.load_landmark_model``
    bit for bit."""
    model = build_landmark_model("hrnet_tiny_cms", J, device="cpu", generator=torch.Generator().manual_seed(3))
    with torch.no_grad():  # heads off their N(0, 0.001) start, so that a layout slip would show
        for name, p in model.named_parameters():
            if name.startswith("head"):
                p.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(len(name)))
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = n(model(t(x)))
    tree = module_to_flax(model)
    want = np.asarray(JHRNet(config=cms_config("cms")).apply(to_jax(tree), x, train=False))
    close(got, want, 1e-5)
    path = str(tmp_path / "cms.npz")
    save_npz(model, path)
    loaded = evaluate.load_landmark_model(path, "hrnet_tiny_cms", J, torch.float32, "cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(n(loaded(t(x))), got)


@pytest.mark.parametrize("depth", [18, 50])
def test_pose_resnet_matches_jax(depth):
    from spacecraft_pose_estimation_tpu.models.pose_resnet import PoseResNet as JPR, PoseResNetConfig as JCfg
    from spacecraft_pose_estimation_tpu_torch.models.pose_resnet import PoseResNet, PoseResNetConfig

    jm = JPR(config=JCfg(num_joints=J, depth=depth))
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False),
                                 seed=depth, overrides={"deconv": 0.1, "final_layer": 0.1})
    x = np.random.default_rng(depth + 1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(to_jax(variables), x))
    model = PoseResNet(PoseResNetConfig(num_joints=J, depth=depth), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = n(model(t(x)))
    assert got.shape == want.shape == (2, 16, 16, J)
    close(got, want, 1e-4)


def test_discriminator_matches_jax():
    """``stage_blocks=(1, 1, 1, 1)`` on the four scales of a 32x32 map: the
    logits in eval mode, and in train mode with the updated ``batch_stats``."""
    jd = JDisc(stage_blocks=(1, 1, 1, 1))
    rng = np.random.default_rng(7)
    hs = [rng.normal(size=(3, 32 >> i, 32 >> i, J)).astype(np.float32) for i in range(4)]
    variables = random_variables(lambda: jd.init(jax.random.key(0), *hs, train=False), seed=8)
    v = to_jax(variables)
    want = np.asarray(jd.apply(v, *hs, train=False))
    want_train, upd = jd.apply(v, *hs, train=True, mutable=["batch_stats"])
    model = MultiScaleDiscriminator(J, stage_blocks=(1, 1, 1, 1), device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = n(model(*map(t, hs)))
        model.train()
        got_train = n(model(*map(t, hs)))
    assert got.shape == want.shape == (3, 2)
    close(got, want, 1e-4)
    close(got_train, np.asarray(want_train), 1e-4)
    for a, b in zip(leaves(upd["batch_stats"]), leaves(module_to_flax(model)["batch_stats"])):
        np.testing.assert_allclose(b, a, atol=1e-5)


def test_hrnet_golden_matches_jax():
    jm = j_build("hrnet_golden", J)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False),
                                 seed=9, overrides={"final_layer": 0.1})
    x = np.random.default_rng(10).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(to_jax(variables), x))
    model = build_landmark_model("hrnet_golden", J, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = n(model(t(x)))
    assert got.shape == want.shape == (2, 16, 16, J)
    close(got, want, 1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_build_landmark_model_has_the_jax_tree(name):
    """Every name of the JAX registry builds, with the JAX model's variable
    tree: the same names and shapes (HWIO kernels back from the port's
    layouts) and heads at N(0, 0.001)."""
    size = 64
    jshapes = jax.eval_shape(lambda: j_build(name, J).init(jax.random.key(0), jnp.zeros((1, size, size, 3)),
                                                           train=False))
    model = build_landmark_model(name, J, device="cpu", generator=torch.Generator().manual_seed(0))
    tree = module_to_flax(model)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(jshapes)
    for a, b in zip(jax.tree_util.tree_leaves(jshapes), leaves(tree)):
        assert a.shape == b.shape
    heads = [p for k, p in model.named_parameters() if k.startswith(("head", "final_layer", "deconv"))
             and k.endswith("weight")]
    assert heads and all(float(p.detach().std()) < 2e-3 for p in heads)
    if name in ("hrnet_tiny_cms",):
        model.train()
        with torch.no_grad():
            assert len(model(torch.zeros(1, size, size, 3))) == 4
