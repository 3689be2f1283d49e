"""Port parity of FCOS: ``models/fcos.py`` against the JAX ``FCOS``.

``FCOS_TINY`` in float32 at 64x96 (not square, so a transposed layout
shows), batch 2, one numpy-seeded Flax variable tree carried across by
``convert.flax_to_state_dict`` (a small stem keeps the mean-subtracted
pixels, which FCOS does not divide by a std, from saturating the
features). Checked:

* inference (per level the top 64 of sqrt(sigmoid(cls) * sigmoid(ctr)), one
  class-aware NMS over 64 + 24 + 6 + 2 + 1 candidates an image, the top 4):
  the valid flags and classes equal, boxes within 1e-3 px, scores within
  1e-5;
* the three losses and ``loss_total``, with GT in both images (boxes that
  fall to p3 and to p4 by their scale range, and one across the image's
  edge), in one, and in none (the batch-wide normalizers clamp), within
  1e-5 relative;
* the gradient of ``loss_total`` in every parameter against ``jax.grad``:
  the global norm within 1e-4 relative, each parameter within 1e-4 of its
  scale (the per-level ``scale_p3`` ... included);
* a bridge round trip of the model, bit-equal, and ``FCOSConfig``'s
  defaults and ``SCALE_RANGES`` against the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from spacecraft_pose_estimation_tpu.models import fcos as jfcos
from spacecraft_pose_estimation_tpu_torch import convert
from spacecraft_pose_estimation_tpu_torch.models import fcos as tfcos
from spacecraft_pose_estimation_tpu_torch.train.optim import global_norm

from torch_port_util import few_threads, n, random_variables, t, to_jax  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

HW, B, G = (64, 96), 2, 3
OVERRIDES = {"backbone/stem/conv": 0.001, "bbox_pred": 0.3, "cls_score": 0.3, "centerness": 0.3}


def images():
    return np.random.default_rng(0).uniform(0, 255, (B, *HW, 3)).astype(np.float32)


def gt(which: str):
    """GT in both images, in image 0 only, or in none; padded to G."""
    boxes = np.zeros((B, G, 4), np.float32)
    boxes[0, :2] = [[6, 8, 40, 44], [-20, -10, 100, 70]]  # p3 by its scale; p4 (max distance 64-128)
    boxes[1, :3] = [[0, 12, 30, 50], [50, 2, 80, 22], [40, 30, 94, 62]]
    valid = np.zeros((B, G), bool)
    valid[0, :2] = which in ("both", "first")
    valid[1, :3] = which == "both"
    return {"gt_boxes": boxes, "gt_classes": np.zeros((B, G), np.int32), "gt_valid": valid}


@pytest.fixture(scope="module")
def models():
    jmodel = jfcos.FCOS(config=jfcos.FCOS_TINY)
    x = jnp.asarray(images())
    variables = random_variables(lambda: jmodel.init(jax.random.key(0), x, train=False), 0, OVERRIDES)
    model = tfcos.FCOS(tfcos.FCOS_TINY, device="cpu")
    model.load_state_dict(convert.flax_to_state_dict(variables))
    return jmodel, variables, model


def test_config_and_bridge_match_jax(models):
    _, variables, model = models
    assert tfcos.SCALE_RANGES == jfcos.SCALE_RANGES
    for cfg_t, cfg_j in ((tfcos.FCOSConfig(), jfcos.FCOSConfig()), (tfcos.FCOS_TINY, jfcos.FCOS_TINY)):
        got, want = dataclasses.asdict(cfg_t), dataclasses.asdict(cfg_j)
        for k in ("depth", "stem_channels", "res2_out_channels", "freeze_at", "groups", "width_per_group"):
            assert got["backbone"][k] == want["backbone"][k], k
        assert {k: v for k, v in got.items() if k != "backbone"} == {k: v for k, v in want.items() if k != "backbone"}
    back = {"/".join(k): v for k, v in traverse_util.flatten_dict(convert.module_to_flax(model)["params"]).items()}
    want = {"/".join(k): v for k, v in traverse_util.flatten_dict(variables["params"]).items()}
    assert set(back) == set(want) and "scale_p7" in want
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_inference_matches_jax(models):
    jmodel, variables, model = models
    x = images()
    want = jax.jit(lambda v, im: jmodel.apply(v, im, train=False))(to_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        got = model(t(x))
    assert got["boxes"].shape == (B, 4, 4)
    for k in ("valid", "classes"):
        np.testing.assert_array_equal(n(got[k]), np.asarray(want[k]), err_msg=k)
    assert n(got["valid"]).any()
    np.testing.assert_allclose(n(got["boxes"]), np.asarray(want["boxes"]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(n(got["scores"]), np.asarray(want["scores"]), atol=1e-5, rtol=0)


def jax_losses(jmodel, params, x, g):
    return jmodel.apply({"params": params}, x, gt_boxes=g["gt_boxes"], gt_classes=g["gt_classes"],
                        gt_valid=g["gt_valid"], train=True)


@pytest.mark.parametrize("which", ["both", "first", "none"])
def test_training_losses_match_jax(models, which):
    jmodel, variables, model = models
    x, g = images(), gt(which)
    want = jax.jit(lambda p, im, gg: jax_losses(jmodel, p, im, gg))(
        to_jax(variables["params"]), jnp.asarray(x), {k: jnp.asarray(v) for k, v in g.items()})
    with torch.no_grad():
        got = model.losses(t(x), t(g["gt_boxes"]), t(g["gt_classes"]), t(g["gt_valid"]))
    assert set(got) == set(want)
    for k in ("loss_cls", "loss_box_reg", "loss_centerness", "loss_total"):
        w = float(want[k])
        assert abs(float(got[k]) - w) <= 1e-5 * max(abs(w), 1e-6), (k, float(got[k]), w)
    if which == "none":
        assert float(got["loss_box_reg"]) == 0.0 and float(got["loss_centerness"]) == 0.0
    else:
        assert float(got["loss_box_reg"]) > 0 and float(got["loss_centerness"]) > 0


def test_gradient_matches_jax_grad(models):
    jmodel, variables, model = models
    x, g = images(), gt("both")
    grads = jax.jit(jax.grad(lambda p, im, gg: jax_losses(jmodel, p, im, gg)["loss_total"]))(
        to_jax(variables["params"]), jnp.asarray(x), {k: jnp.asarray(v) for k, v in g.items()})
    want = convert.flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})
    want_norm = float(optax.global_norm(grads))
    model.zero_grad()
    model.losses(t(x), t(g["gt_boxes"]), t(g["gt_classes"]), t(g["gt_valid"]))["loss_total"].backward()
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    norm = float(global_norm([torch.zeros_like(want[k]) if v is None else v for k, v in got.items()]))
    assert abs(norm - want_norm) <= 1e-4 * want_norm, (norm, want_norm)
    for k, w in want.items():
        if got[k] is None:  # FrozenBN's tensors: JAX's gradient there is zero too
            assert float(w.abs().max()) == 0.0, k
            continue
        atol = 1e-4 * max(float(w.abs().max()), 1e-5 * want_norm)
        np.testing.assert_allclose(n(got[k]), n(w), atol=atol, rtol=0, err_msg=k)
