"""Port parity of ``models/tta.py`` on the CPU against the JAX package.

* ``flip_boxes`` exactly; ``resize_bilinear`` against ``jax.image.resize(...,
  "bilinear")`` on a seeded uint8 batch, shrinking and growing, within
  1e-5 of the 0-255 scale (float32, unrounded: 3e-5 shrinking, 4.1e-4
  growing, where the two weight the taps with other roundings).
* the JAX tests' fake detector (one fixed box a view) through both
  wrappers with the flip: the same boxes, scores, classes and ``valid``.
* ``RCNN_TINY`` in both packages (float32, JAX's seeded variables carried
  by ``convert.flax_to_state_dict``) at 64^2 on seeded uint8 images with
  ``scales=(1.0, 0.5)`` and the flip, so four views, the second at 32^2 in
  float32, and room for every candidate in the merge (8): boxes within
  1e-4 px, scores within 1e-5, classes and ``valid`` equal. The JAX side is jitted once for the module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models import rcnn as jrcnn
from spacecraft_pose_estimation_tpu.models import tta as jtta
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models import rcnn as trcnn
from spacecraft_pose_estimation_tpu_torch.models import tta as ttta

from torch_port_util import few_threads, n, random_variables, t, to_jax  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

HW = (64, 64)


def test_flip_boxes_matches_jax():
    b = np.random.default_rng(0).uniform(-5, 70, (3, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(n(ttta.flip_boxes(t(b), 64)), np.asarray(jtta.flip_boxes(jnp.asarray(b), 64)))


@pytest.mark.parametrize("size", [(32, 32), (24, 40), (96, 80)], ids=["half", "uneven_shrink", "grow"])
def test_resize_matches_jax_image_resize(size):
    x = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size, 3), "bilinear"))
    got = ttta.resize_bilinear(t(x), size)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(n(got), want, atol=1e-5 * 255)


def _fake_infer(xp):
    """The JAX tests' fake detector: one box a view whatever the input."""

    def infer(images):
        b = images.shape[0]
        box = xp.asarray([10.0, 10.0, 30.0, 30.0]) if xp is jnp else torch.tensor([10.0, 10.0, 30.0, 30.0])
        if xp is jnp:
            return {"boxes": jnp.tile(box, (b, 2, 1)), "scores": jnp.tile(jnp.asarray([0.9, 0.0]), (b, 1)),
                    "classes": jnp.zeros((b, 2), jnp.int32), "valid": jnp.tile(jnp.asarray([True, False]), (b, 1))}
        return {"boxes": box.repeat(b, 2, 1), "scores": torch.tensor([0.9, 0.0]).repeat(b, 1),
                "classes": torch.zeros(b, 2, dtype=torch.int32), "valid": torch.tensor([True, False]).repeat(b, 1)}

    return infer


@pytest.mark.parametrize("scales", [(1.0,), (1.0, 0.5)])
def test_fake_detector_merge_matches_jax(scales):
    want = jtta.make_tta_inference(_fake_infer(jnp), scales=scales, flip=True, max_dets=4)(jnp.zeros((1, *HW, 3)))
    got = ttta.make_tta_inference(_fake_infer(torch), scales=scales, flip=True, max_dets=4)(torch.zeros(1, *HW, 3))
    for k in ("boxes", "scores", "classes", "valid"):
        np.testing.assert_array_equal(n(got[k]), np.asarray(want[k]), err_msg=k)
    # the box and its flip survive the merge, at each scale (mapped back, the half-scale box is another)
    assert int(n(got["valid"]).sum()) == 2 * len(scales)


@pytest.fixture(scope="module")
def tiny_rcnn():
    images = np.random.default_rng(1).integers(0, 256, (2, *HW, 3)).astype(np.uint8)
    jmodel = jrcnn.GeneralizedRCNN(config=jrcnn.RCNN_TINY)
    variables = random_variables(
        lambda: jmodel.init({"params": jax.random.key(0)}, jnp.asarray(images, jnp.float32), train=False), seed=2,
        overrides={"backbone/stem/conv": 0.001, "rpn_head/deltas": 0.05, "bbox_pred": 0.05, "cls_score": 0.05})
    jv = to_jax(variables)
    infer = jax.jit(lambda x: jmodel.apply(jv, x, train=False))
    want = jtta.make_tta_inference(infer, scales=(1.0, 0.5), flip=True, max_dets=8)(jnp.asarray(images))
    model = trcnn.GeneralizedRCNN(trcnn.RCNN_TINY, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    return images, model, {k: np.asarray(v) for k, v in want.items()}


def test_tiny_rcnn_tta_matches_jax(tiny_rcnn):
    images, model, want = tiny_rcnn
    with torch.no_grad():
        got = ttta.make_tta_inference(model, scales=(1.0, 0.5), flip=True, max_dets=8)(t(images))
    np.testing.assert_array_equal(n(got["valid"]), want["valid"])
    np.testing.assert_array_equal(n(got["classes"]), want["classes"])
    np.testing.assert_allclose(n(got["scores"]), want["scores"], atol=1e-5)
    np.testing.assert_allclose(n(got["boxes"]), want["boxes"], atol=1e-4)
    assert 0 < want["valid"].sum() < want["valid"].size  # the merge kept some candidates and dropped some
