"""Port parity: the ResNeXt trunk (X101-32x8d's grouped 3x3 with the stride on it) and its detector.

The JAX package merges groups block-diagonally into wider groups
(``MergedGroupConv``, ``merged_group_width``); the port runs a plain
``groups=`` conv on the compact weight. A tiny ResNeXt (depth 50, 4 groups
of 4 in res2, ``stride_in_1x1=False``) goes through JAX at merge width 128
(every group merged into one) and 8 (pairs merged in res2, none in res3
and after) and through the port in float32, from one numpy-seeded tree:
features within 1e-4 of their scale, as ``tests/test_torch_detector.py``
holds the dense trunk. The tiny X R-CNN end to end: boxes within 1e-2 px.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models import rcnn as jrcnn
from spacecraft_pose_estimation_tpu.models.resnet_backbone import (
    MergedGroupConv as JMergedGroupConv,
    ResNetBackbone as JBackbone,
    ResNetConfig as JResNetConfig,
)
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models import rcnn as trcnn
from spacecraft_pose_estimation_tpu_torch.models.resnet_backbone import (
    RESNEXT101_32x8d,
    MergedGroupConv,
    ResNetBackbone,
    ResNetConfig,
)

from torch_port_util import n, random_variables, t, to_jax

TINY_X = dict(depth=50, stem_channels=8, res2_out_channels=16, groups=4, width_per_group=4, stride_in_1x1=False)


def _jax_cfg(width):
    return JResNetConfig(merged_group_width=width, **TINY_X)


@pytest.mark.parametrize("width", [128, 8], ids=["all_merged", "partly_merged"])
def test_resnext_backbone_matches_jax(width):
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jmodel = JBackbone(_jax_cfg(width))
    variables = random_variables(lambda: jmodel.init(jax.random.key(0), jnp.asarray(x)), seed=1)
    want = jax.jit(jmodel.apply)(to_jax(variables), jnp.asarray(x))
    model = ResNetBackbone(ResNetConfig(**TINY_X))
    model.load_state_dict(flax_to_state_dict(variables))
    assert model.res2_b0.conv2.conv.groups == 4 and model.res2_b0.conv2.conv.stride == 1
    assert model.res3_b0.conv1.conv.stride == 1 and model.res3_b0.conv2.conv.stride == 2  # the stride on the 3x3
    with torch.no_grad():
        got = model(t(x).permute(0, 3, 1, 2))
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(n(got[name].permute(0, 2, 3, 1)), w, atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("width", [128, 8], ids=["all_merged", "partly_merged"])
def test_grouped_kernel_bridge_layout(width):
    """A Flax grouped kernel (k, k, cin / g, cout), compact whatever the merge
    width, crosses the bridge as (cout, cin / g, k, k): the port's conv equals
    each group's dense conv on its own channels, and the JAX module."""
    g, cin, cout = 4, 16, 24
    x = np.random.default_rng(2).normal(size=(1, 9, 9, cin)).astype(np.float32)
    jconv = JMergedGroupConv(cout, 3, 2, g, target_group_width=width)
    variables = random_variables(lambda: jconv.init(jax.random.key(0), jnp.asarray(x)), seed=3)
    kernel = variables["params"]["kernel"]
    assert kernel.shape == (3, 3, cin // g, cout)
    conv = MergedGroupConv(cin, cout, 3, 2, g)
    bridged = flax_to_state_dict({"params": {"c": variables["params"]}})  # {"c.weight": ...}
    conv.load_state_dict({k.split(".", 1)[-1]: v for k, v in bridged.items()})
    assert tuple(conv.weight.shape) == (cout, cin // g, 3, 3)
    with torch.no_grad():
        got = n(conv(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        per_group = []
        for i in range(g):
            xi = t(x[..., i * cin // g:(i + 1) * cin // g]).permute(0, 3, 1, 2)
            wi = t(kernel[..., i * cout // g:(i + 1) * cout // g]).permute(3, 2, 0, 1)
            per_group.append(F.conv2d(xi, wi, stride=2, padding=1))
        dense = n(torch.cat(per_group, 1).permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, dense, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jconv.apply(to_jax(variables), jnp.asarray(x))), atol=1e-5)


def test_x101_presets_mirror_jax():
    assert RESNEXT101_32x8d == ResNetConfig(depth=101, groups=32, width_per_group=8, stride_in_1x1=False)
    for name in ("FASTER_RCNN_X101_SPACECRAFT", "FASTER_RCNN_X101_SERVING"):
        j, p = getattr(jrcnn, name), getattr(trcnn, name)
        assert p.pixel_std == j.pixel_std == jrcnn.X101_PIXEL_STD == trcnn.X101_PIXEL_STD
        topk = lambda c: (c.rpn.pre_nms_topk_test, c.rpn.post_nms_topk_test)
        assert topk(p) == topk(j)
        assert (p.roi.num_classes, p.roi.cls_agnostic_bbox_reg, p.roi.detections_per_image) == (1, True, 2)
        assert j.roi.pooler_impl == "pallas" and p.roi.pooler_window == j.roi.pooler_window
        jb = j.backbone
        assert (jb.depth, jb.groups, jb.width_per_group, jb.stride_in_1x1) == (
            p.backbone.depth, p.backbone.groups, p.backbone.width_per_group, p.backbone.stride_in_1x1)


@pytest.mark.parametrize("width", [128, 8], ids=["all_merged", "partly_merged"])
def test_tiny_x_rcnn_end_to_end(width):
    j_cfg = dataclasses.replace(
        jrcnn.RCNN_TINY, backbone=_jax_cfg(width), pixel_std=jrcnn.X101_PIXEL_STD,
        roi=dataclasses.replace(jrcnn.RCNN_TINY.roi, pooler_impl="pallas", pooler_window=32))
    t_cfg = dataclasses.replace(
        trcnn.RCNN_TINY, backbone=ResNetConfig(**TINY_X), pixel_std=trcnn.X101_PIXEL_STD,
        roi=dataclasses.replace(trcnn.RCNN_TINY.roi, pooler_window=32))
    images = np.random.default_rng(1).uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    jmodel = jrcnn.GeneralizedRCNN(config=j_cfg)
    variables = random_variables(
        lambda: jmodel.init({"params": jax.random.key(0)}, jnp.asarray(images), train=False), seed=2,
        overrides={"rpn_head/deltas": 0.05, "bbox_pred": 0.05, "cls_score": 0.05})
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(to_jax(variables), jnp.asarray(images))
    model = trcnn.GeneralizedRCNN(t_cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = model(t(images))
    np.testing.assert_array_equal(n(got["valid"]), np.asarray(want["valid"]))
    np.testing.assert_allclose(n(got["scores"]), np.asarray(want["scores"]), atol=1e-5)
    np.testing.assert_allclose(n(got["boxes"]), np.asarray(want["boxes"]), atol=1e-2)
    assert n(got["valid"]).any()
