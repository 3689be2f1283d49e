"""Port parity of RetinaNet: ``models/retinanet.py`` and its EMA train step
against the JAX ``RetinaNet`` and ``make_detection_train_step(False,
ema_loss_normalizer=True)``.

``RETINANET_TINY`` in float32 at 64x96 (not square, so a transposed layout
shows), batch 2, one numpy-seeded Flax variable tree carried across by
``convert.flax_to_state_dict`` (a small stem keeps raw 0-255 pixels from
saturating the features, as in ``tests/test_torch_detection_train.py``).
Checked:

* the anchors of p3-p7 (``octave_sizes(4 * stride)`` x 3 ratios, the JAX
  order within a cell): equal;
* the head's logits and deltas per level in the JAX NHWC layout: within
  1e-5 of their scale (the same convolutions, summed in another order);
* inference (per-level top-k, one class-aware NMS over 4 x 64 + 36 + 9 +
  9 candidates, the top 4): the same kept detections, classes and valid
  flags equal, boxes within 1e-3 px, scores within 1e-5;
* the training branch's sums, ``num_fg`` and the losses, with GT in both
  images, in one, and in none (``num_fg`` clamps to 1): ``num_fg`` equal,
  the rest within 1e-5 relative;
* three SGD updates of the EMA step (lr 1e-3, momentum 0.9, weight decay
  1e-4, a milestone at step 2): ``loss_normalizer`` within 1e-6 relative,
  the losses and ``grad_norm`` within 1e-4 relative, the parameters after 1
  and 3 updates within 1 lr of JAX's with at most 1% beyond 1e-3 lr (the
  bars of ``test_torch_detection_train.py``);
* the focal loss elementwise (also without the alpha weight) and
  ``config_20``'s configuration against the JAX registry's;
* ``config_20``'s seeded start: R101's depth at 1/8 of its width, seeded as
  each package seeds a model (JAX ``model.init``, the port's
  ``init_params``), gives a first loss_cls in the hundreds in both, within
  3x of each other, and the port on JAX's seeded weights gives JAX's to
  1e-4 relative. So a trainer that starts ``config_20`` from a seed, with
  no pretrained trunk, starts blown up in the reference as in the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from spacecraft_pose_estimation_tpu.models import anchors as janchors
from spacecraft_pose_estimation_tpu.models import resnet_backbone as jrb
from spacecraft_pose_estimation_tpu.models import retinanet as jret
from spacecraft_pose_estimation_tpu.models import zoo as jzoo
from spacecraft_pose_estimation_tpu.train import detection_state as jds
from spacecraft_pose_estimation_tpu.train import optim as joptim
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from spacecraft_pose_estimation_tpu_torch.models import resnet_backbone as trb
from spacecraft_pose_estimation_tpu_torch.models import retinanet as tret
from spacecraft_pose_estimation_tpu_torch.models import zoo as tzoo
from spacecraft_pose_estimation_tpu_torch.train import detection_state as tds
from spacecraft_pose_estimation_tpu_torch.train import optim as toptim

from torch_port_util import few_threads, n, random_variables, t, to_jax  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

HW, B, G = (64, 96), 2, 4
LR, MILESTONES, STEPS = 1e-3, [2], 3
OVERRIDES = {"backbone/stem/conv": 0.001, "bbox_pred": 0.05, "cls_score": 0.05}


def images():
    return np.random.default_rng(0).uniform(0, 255, (B, *HW, 3)).astype(np.float32)


def gt(which: str):
    """GT in both images, in image 0 only, or in none; padded to G."""
    boxes = np.zeros((B, G, 4), np.float32)
    boxes[0, :2] = [[6, 8, 40, 44], [50, 10, 90, 60]]
    boxes[1, :3] = [[0, 12, 30, 50], [20, 2, 36, 22], [40, 30, 94, 62]]
    valid = np.zeros((B, G), bool)
    valid[0, :2] = which in ("both", "first")
    valid[1, :3] = which == "both"
    return {"gt_boxes": boxes, "gt_classes": np.zeros((B, G), np.int32), "gt_valid": valid}


@pytest.fixture(scope="module")
def models():
    jmodel = jret.RetinaNet(config=jret.RETINANET_TINY)
    x = jnp.asarray(images())
    variables = random_variables(lambda: jmodel.init(jax.random.key(0), x, train=False), 0, OVERRIDES)
    model = tret.RetinaNet(tret.RETINANET_TINY, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    return jmodel, variables, model


def test_anchors_match_jax(models):
    _, _, model = models
    shapes = {"p3": (8, 12), "p4": (4, 6), "p5": (2, 3), "p6": (1, 2), "p7": (1, 1)}
    sizes = {lvl: jret.octave_sizes(4 * jret.RETINA_STRIDES[lvl]) for lvl in shapes}
    want = janchors.fpn_anchors(shapes, jret.RETINA_STRIDES, sizes, jret.RETINANET_TINY.aspect_ratios)
    got = model.anchors(shapes, "cpu")
    assert tret.RETINA_STRIDES == jret.RETINA_STRIDES
    for lvl in shapes:
        assert got[lvl].shape == (shapes[lvl][0] * shapes[lvl][1] * 9, 4)
        np.testing.assert_array_equal(n(got[lvl]), np.asarray(want[lvl]), err_msg=lvl)


def test_head_outputs_match_jax(models):
    jmodel, variables, model = models
    x = images()
    _, state = jax.jit(lambda v, im: jmodel.apply(v, im, train=False, capture_intermediates=True,
                                                  mutable=["intermediates"]))(to_jax(variables), jnp.asarray(x))
    want = state["intermediates"]["head"]["__call__"][0]
    with torch.no_grad():
        levels, head, _ = model._outputs(t(x))
    assert levels == ["p3", "p4", "p5", "p6", "p7"] and set(want) == set(levels)
    for lvl in levels:
        for i, what in enumerate(("logits", "deltas")):
            w = np.asarray(want[lvl][i])
            g = n(head[lvl][i])
            assert g.shape == w.shape, (lvl, what, g.shape, w.shape)
            np.testing.assert_allclose(g, w, atol=1e-5 * max(1.0, np.abs(w).max()), rtol=0, err_msg=f"{lvl} {what}")


def test_inference_matches_jax(models):
    jmodel, variables, model = models
    x = images()
    want = jax.jit(lambda v, im: jmodel.apply(v, im, train=False))(to_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        got = model(t(x))
    for k in ("valid", "classes"):
        np.testing.assert_array_equal(n(got[k]), np.asarray(want[k]), err_msg=k)
    assert n(got["valid"]).all()  # random heads score far above score_thresh: 4 detections an image
    np.testing.assert_allclose(n(got["boxes"]), np.asarray(want["boxes"]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(n(got["scores"]), np.asarray(want["scores"]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("which", ["both", "first", "none"])
def test_training_sums_match_jax(models, which):
    jmodel, variables, model = models
    x, g = images(), gt(which)
    want = jax.jit(lambda v, im, gb, gc, gv: jmodel.apply(v, im, gt_boxes=gb, gt_classes=gc, gt_valid=gv,
                                                          train=True))(
        to_jax(variables), jnp.asarray(x), *(jnp.asarray(g[k]) for k in ("gt_boxes", "gt_classes", "gt_valid")))
    with torch.no_grad():
        got = model.losses(t(x), t(g["gt_boxes"]), t(g["gt_classes"]), t(g["gt_valid"]))
    assert set(got) == set(want)
    assert float(got["num_fg"]) == float(want["num_fg"])
    if which == "none":
        assert float(got["num_fg"]) == 1.0 and float(got["loss_box_reg_sum"]) == 0.0
    else:
        assert float(got["num_fg"]) > 1 and float(got["loss_box_reg_sum"]) > 0
    for k in ("loss_cls_sum", "loss_box_reg_sum", "loss_cls", "loss_box_reg", "loss_total"):
        w = float(want[k])
        assert abs(float(got[k]) - w) <= 1e-5 * max(abs(w), 1e-6), (k, float(got[k]), w)


def flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def ema_runs(models):
    jmodel, variables, _ = models
    x, g = images(), gt("both")
    data = {"image": x, **g}
    tx = joptim.build_optimizer("sgd", joptim.multistep_schedule(LR, MILESTONES), weight_decay=1e-4, momentum=0.9)
    jstate = jds.DetTrainState.create(jmodel, to_jax(variables), tx)
    jstep = jax.jit(jds.make_detection_train_step(False, ema_loss_normalizer=True))
    model = tret.RetinaNet(tret.RETINANET_TINY, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    opt = toptim.build_optimizer("sgd", model.parameters(), toptim.multistep_schedule(LR, MILESTONES),
                                 weight_decay=1e-4, momentum=0.9)
    state = tds.DetTrainState(model, opt)
    step = tds.make_detection_train_step(needs_sampling_rng=False, ema_loss_normalizer=True)
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    metrics, params = [], []
    for i in range(STEPS):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in data.items()}, jax.random.key(i))
        tm = step(state, tbatch)
        metrics.append(({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in tm.items()}))
        params.append((flat(jstate.params), flat(state_dict_to_flax(model.state_dict(), stats=set())["params"])))
    return {"metrics": metrics, "params": params, "state": state, "jstate": jstate}


def test_ema_steps_match_jax(ema_runs):
    normalizers = []
    for i, (jm, tm) in enumerate(ema_runs["metrics"]):
        assert set(tm) == set(jm), (set(tm) ^ set(jm))
        assert abs(tm["loss_normalizer"] - jm["loss_normalizer"]) <= 1e-6 * jm["loss_normalizer"], i
        for k in ("loss_cls", "loss_box_reg", "loss_total", "loss_cls_sum", "loss_box_reg_sum", "grad_norm"):
            assert abs(tm[k] - jm[k]) <= 1e-4 * max(abs(jm[k]), 1e-6), (i, k, tm[k], jm[k])
        assert tm["num_fg"] == jm["num_fg"]
        normalizers.append(tm["loss_normalizer"])
    # 100 -> 0.9 * 100 + 0.1 * num_fg, a step at a time
    expect, fg = 100.0, ema_runs["metrics"][0][1]["num_fg"]
    for v in normalizers:
        expect = 0.9 * expect + 0.1 * fg
        assert abs(v - expect) <= 1e-5 * expect
    assert float(ema_runs["state"].loss_normalizer) == normalizers[-1]


@pytest.mark.parametrize("after", [1, 3])
def test_ema_step_parameters_match_jax(ema_runs, after):
    jp, tp = ema_runs["params"][after - 1]
    assert set(jp) == set(tp)
    dp = np.concatenate([(np.abs(tp[k] - jp[k]) / LR).ravel() for k in jp])
    print(f"parameters after {after} EMA SGD updates: {dp.size} entries, max {dp.max():.4g} lr, "
          f"{(dp > 1e-3).mean():.4g} beyond 1e-3 lr")
    assert dp.max() <= 1.0 and (dp > 1e-3).mean() <= 0.01


@pytest.mark.parametrize("alpha", [0.25, -1.0])
def test_focal_loss_matches_jax(alpha):
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 4, (64, 3)).astype(np.float32)
    targets = (rng.uniform(size=(64, 3)) > 0.7).astype(np.float32)
    want = np.asarray(jret.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets), alpha, 2.0))
    got = n(tret.sigmoid_focal_loss(t(logits), t(targets), alpha, 2.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_config_20_is_the_jax_registrys():
    want, got = jzoo.DETECTOR_PRESETS["config_20"], tzoo.DETECTOR_PRESETS["config_20"]
    assert got.arch == want.arch == "retinanet"
    assert (got.input_size, got.flip, dataclasses.asdict(got.solver)) == (
        want.input_size, want.flip, dataclasses.asdict(want.solver))
    jcfg, tcfg = dataclasses.asdict(want.config), dataclasses.asdict(tzoo.build_detector_config(got))
    jb, tb = jcfg.pop("backbone"), tcfg.pop("backbone")
    assert tcfg == jcfg
    assert all(tb[k] == jb[k] for k in tb), (tb, jb)  # the port's ResNetConfig has no out_features
    assert tb["depth"] == 101 and tb["groups"] == 1


def test_seeded_r101_starts_as_blown_up_as_the_references():
    """No FrozenBN statistics (identity, as both packages initialize them)
    and N(0, 1/fan_in) convolutions (Flax's lecun truncated normal, the
    port's normal: the same variance) let each of R101's 33 residual adds
    grow the features, so the random head's logits leave the prior: the
    prior alone gives about 1.1 a foreground anchor."""
    trunk = dict(depth=101, width_per_group=8, stem_channels=8, res2_out_channels=32)
    jcfg = jret.RetinaNetConfig(backbone=jrb.ResNetConfig(**trunk), fpn_channels=32, topk_candidates=64)
    tcfg = tret.RetinaNetConfig(backbone=trb.ResNetConfig(**trunk), fpn_channels=32, topk_candidates=64)
    x, g = images(), gt("both")
    jmodel = jret.RetinaNet(config=jcfg)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.asarray(x), train=False))(jax.random.key(0))
    want = jax.jit(lambda v: jmodel.apply(v, jnp.asarray(x), **{k: jnp.asarray(a) for k, a in g.items()},
                                          train=True))(variables)
    args = (t(x), *(t(g[k]) for k in ("gt_boxes", "gt_classes", "gt_valid")))
    seeded = tret.RetinaNet(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    carried = tret.RetinaNet(tcfg, device="cpu")
    carried.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.array, variables)))
    with torch.no_grad():
        got, same = seeded.losses(*args), carried.losses(*args)
    jl, tl, cl = float(want["loss_cls"]), float(got["loss_cls"]), float(same["loss_cls"])
    print(f"first loss_cls, R101 at 1/8 width, {HW[0]}x{HW[1]}, batch {B}, num_fg {float(want['num_fg'])}: "
          f"JAX model.init {jl:.6g}, the port's init_params {tl:.6g}, the port on JAX's weights {cl:.6g}")
    assert float(got["num_fg"]) == float(want["num_fg"]) > 1
    assert jl > 100 and tl > 100, (jl, tl)
    assert 1 / 3 <= tl / jl <= 3, (tl, jl)
    assert abs(cl - jl) <= 1e-4 * jl, (cl, jl)
