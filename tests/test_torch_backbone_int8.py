"""Port parity of the int8 detection backbone (``models/backbone_int8.py``).

``RESNET_TINY`` with numpy-seeded weights and frozen-BN statistics.

* ``quantize_backbone``: identical keys, bit-equal int8 weights and bf16
  stem weights. The scales come from two bf16 calibration forwards that
  round at different places (the JAX FrozenBN casts its affine to bf16
  before applying it, the port after folding), so m, b, coeffs and the
  feature scales agree to rtol 2e-2.
* ``backbone_int8_apply`` on the JAX tree (bridged with
  ``convert.quantized_to_torch``): every int8 conv equals its JAX site and
  only the bf16 stem conv sums in another order, so features agree to
  1e-2 of their peak (one int8 step of a feature is 1/127 of it) on all
  but 1e-3 of entries.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models import backbone_int8 as jbi
from spacecraft_pose_estimation_tpu.models.resnet_backbone import RESNET_TINY as J_TINY, ResNetBackbone as JBackbone
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, quantized_to_torch
from spacecraft_pose_estimation_tpu_torch.models import backbone_int8 as tbi
from spacecraft_pose_estimation_tpu_torch.models.resnet_backbone import RESNET_TINY, ResNetBackbone

from torch_port_util import n, random_variables, t, to_jax


@pytest.fixture(scope="module")
def tiny():
    jmodel = JBackbone(J_TINY, dtype=jnp.bfloat16)
    variables = random_variables(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3))), seed=9)
    rng = np.random.default_rng(10)
    calib = rng.normal(0, 1.0, (2, 64, 64, 3)).astype(np.float32)
    jq = jbi.quantize_backbone(J_TINY, to_jax(variables), jnp.asarray(calib))
    tmodel = ResNetBackbone(RESNET_TINY)
    tmodel.load_state_dict(flax_to_state_dict(variables))
    return dict(variables=variables, calib=calib, jq=jq, jq_np=jax.tree_util.tree_map(np.asarray, jq),
                tmodel=tmodel, rng=rng)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_quantize_matches_jax(tiny):
    got = dict(_leaves(tbi.quantize_backbone(RESNET_TINY, tiny["tmodel"], t(tiny["calib"]))))
    want = dict(_leaves(tiny["jq_np"]))
    assert set(got) == set(want)
    for path, w in want.items():
        name = "/".join(path)
        if path[-1] in ("w8", "w_bf16"):
            np.testing.assert_array_equal(n(got[path].float()), np.asarray(w, np.float32), err_msg=name)
        else:
            g = got[path] if isinstance(got[path], float) else n(got[path])
            np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=2e-2, atol=1e-6, err_msg=name)


def test_apply_matches_jax(tiny):
    x = tiny["rng"].normal(0, 1.0, (2, 64, 64, 3)).astype(np.float32)
    want = jbi.backbone_int8_apply(J_TINY, tiny["jq"], jnp.asarray(x))  # eager: jit rounds the bf16 stem elsewhere
    got = tbi.backbone_int8_apply(RESNET_TINY, quantized_to_torch(tiny["jq_np"]), t(x))
    assert set(got) == set(want) == {"res2", "res3", "res4", "res5"}
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = n(got[k].float())
        assert got[k].dtype == torch.bfloat16 and g.shape == w.shape
        off = np.abs(g - w) > 1e-2 * np.abs(w).max()
        assert off.mean() < 1e-3, (k, off.mean())


def test_max_pool_pads_with_minus_infinity():
    x = torch.full((1, 4, 4, 4), -100, dtype=torch.int8)
    want = jax.lax.reduce_window(jnp.asarray(n(x)), jnp.int8(-128), jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                                 ((0, 0), (1, 1), (1, 1), (0, 0)))
    np.testing.assert_array_equal(n(tbi.max_pool_i8(x)), np.asarray(want))


def test_detector_takes_precomputed_features():
    """GeneralizedRCNN.forward(precomputed_feats=...) runs the FPN and heads
    on the given NHWC features in place of its backbone's (JAX rcnn.py:148-163):
    handed its own backbone's features, it gives its own detections."""
    from spacecraft_pose_estimation_tpu_torch.models import rcnn as trcnn

    det = trcnn.GeneralizedRCNN(trcnn.RCNN_TINY, device="cpu", generator=torch.Generator().manual_seed(0))
    img = torch.from_numpy(np.random.default_rng(11).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        det.backbone.stem.conv.weight.mul_(1e-2)
        feats = det.backbone(det.normalize(img).permute(0, 3, 1, 2))
        want = det(img)
        got = det(img, precomputed_feats={k: v.permute(0, 2, 3, 1) for k, v in feats.items()})
    for key in ("boxes", "scores", "valid"):
        np.testing.assert_array_equal(n(got[key]), n(want[key]), err_msg=key)
