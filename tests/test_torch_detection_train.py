"""Port parity of the detector's train step: ``GeneralizedRCNN.losses`` and
``make_detection_train_step`` against the JAX ``make_detection_train_step``.

``RCNN_TINY`` in float32 at 64x64, batch 2 with two GT boxes an image
(padded to 16), one numpy-seeded Flax variable tree in both packages (a
small stem keeps raw 0-255 pixels from saturating the logits, as in
``tests/test_torch_detector.py``), SGD at 1e-3 with momentum 0.9, weight
decay 1e-4 and a milestone at step 2, 3 updates. The sampling's draws are
JAX's own (``torch_port_util.jax_detection_draws``), handed to the port.
Also with ``freeze_at=2`` (no gradient into the stem and res2).

Bars, those of the landmark train step (``tests/test_torch_train_step.py``):
each update's losses and ``grad_norm`` within 1e-4 relative; the parameters after 1 and 3 updates within 1 lr of JAX's, at
most 1% of them beyond 1e-3 lr. The frozen parameters (FrozenBN's four
tensors everywhere, the stem's and res2's weights with ``freeze_at=2``)
get a zero gradient in both packages and move only by the weight decay
through the momentum, which optax applies to every leaf: they must have
moved, and match JAX's within 1e-6 relative. ``model.train()`` changes no
FrozenBN output.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from spacecraft_pose_estimation_tpu.models import rcnn as jrcnn
from spacecraft_pose_estimation_tpu.train import detection_state as jds
from spacecraft_pose_estimation_tpu.train import optim as joptim
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from spacecraft_pose_estimation_tpu_torch.models import rcnn as trcnn
from spacecraft_pose_estimation_tpu_torch.models.resnet_backbone import FrozenBN
from spacecraft_pose_estimation_tpu_torch.train import detection_state as tds
from spacecraft_pose_estimation_tpu_torch.train import optim as toptim

from torch_port_util import few_threads, jax_detection_draws, random_variables, to_jax  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

LR, MILESTONES, STEPS, HW, B = 1e-3, [2], 3, (64, 64), 2
OVERRIDES = {"backbone/stem/conv": 0.001, "rpn_head/deltas": 0.05, "bbox_pred": 0.05, "cls_score": 0.05}


def batch():
    rng = np.random.default_rng(1)
    images = rng.uniform(0, 255, (B, *HW, 3)).astype(np.float32)
    gt = np.zeros((B, 16, 4), np.float32)
    gt[0, :2] = [[6, 8, 30, 40], [30, 20, 60, 58]]
    gt[1, :2] = [[0, 10, 44, 50], [20, 2, 36, 22]]
    valid = np.zeros((B, 16), bool)
    valid[:, :2] = True
    return {"image": images, "gt_boxes": gt, "gt_classes": np.zeros((B, 16), np.int32), "gt_valid": valid}


def flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(tree).items()}


def run_both(freeze_at):
    jcfg = dataclasses.replace(jrcnn.RCNN_TINY, backbone=dataclasses.replace(jrcnn.RCNN_TINY.backbone,
                                                                             freeze_at=freeze_at))
    tcfg = dataclasses.replace(trcnn.RCNN_TINY, backbone=dataclasses.replace(trcnn.RCNN_TINY.backbone,
                                                                             freeze_at=freeze_at))
    jmodel = jrcnn.GeneralizedRCNN(config=jcfg)
    data = batch()
    variables = random_variables(lambda: jmodel.init({"params": jax.random.key(0)}, jnp.asarray(data["image"]),
                                                     train=False), 2, OVERRIDES)
    tx = joptim.build_optimizer("sgd", joptim.multistep_schedule(LR, MILESTONES), weight_decay=1e-4, momentum=0.9)
    jstate = jds.DetTrainState.create(jmodel, to_jax(variables), tx)
    jstep = jax.jit(jds.make_detection_train_step(True))
    model = trcnn.GeneralizedRCNN(tcfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables))
    opt = toptim.build_optimizer("sgd", model.parameters(), toptim.multistep_schedule(LR, MILESTONES),
                                 weight_decay=1e-4, momentum=0.9)
    state = tds.DetTrainState(model, opt)
    step = tds.make_detection_train_step()
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    n_anchors = sum(h * w * 3 for h, w in ((16, 16), (8, 8), (4, 4), (2, 2), (1, 1)))
    metrics, params = [], []
    for i in range(STEPS):
        key = jax.random.fold_in(jax.random.key(42), i)
        draws = jax_detection_draws(jmodel, {"params": jstate.params}, key, B, n_anchors, 32 + 16)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in data.items()}, key)
        tm = step(state, tbatch, draws={k: torch.from_numpy(v) for k, v in draws.items()})
        metrics.append(({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in tm.items()}))
        params.append((flat(jstate.params), flat(state_dict_to_flax(model.state_dict(), stats=set())["params"])))
    return {"metrics": metrics, "params": params, "init": flat(variables["params"]), "model": model}


@pytest.fixture(scope="module", params=[0, 2], ids=["freeze_at0", "freeze_at2"])
def runs(request):
    return request.param, run_both(request.param)


def test_losses_and_grad_norm_match_jax(runs):
    _, r = runs
    for i, (jm, tm) in enumerate(r["metrics"]):
        for k in ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_total", "grad_norm"):
            assert abs(tm[k] - jm[k]) <= 1e-4 * max(abs(jm[k]), 1e-6), (i, k, tm[k], jm[k])
    assert r["metrics"][0][0]["loss_box_reg"] > 0 and r["metrics"][0][0]["loss_rpn_loc"] > 0


@pytest.mark.parametrize("after", [1, 3])
def test_parameters_match_jax(runs, after):
    _, r = runs
    jp, tp = r["params"][after - 1]
    assert set(jp) == set(tp)
    dp = np.concatenate([(np.abs(tp[k] - jp[k]) / LR).ravel() for k in jp])
    print(f"parameters after {after} SGD updates: {dp.size} entries, max {dp.max():.4g} lr, "
          f"{(dp > 1e-3).mean():.4g} beyond 1e-3 lr")
    assert dp.max() <= 1.0 and (dp > 1e-3).mean() <= 0.01


def test_frozen_parameters_decay_as_in_jax(runs):
    freeze_at, r = runs
    jp, tp = r["params"][-1]
    frozen = [k for k in jp if k.rsplit("/", 1)[-1] in ("scale", "bias", "mean", "var") and "/norm/" in k]
    if freeze_at >= 2:
        frozen += [k for k in jp if k.startswith(("backbone/stem/", "backbone/res2_")) and k.endswith("kernel")]
    assert len(frozen) > 100
    moved = 0
    for k in frozen:
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-6, atol=1e-9, err_msg=k)
        moved += int(np.any(tp[k] != r["init"][k]))
    assert moved == len(frozen)  # the decay moved every frozen tensor
    if freeze_at >= 2:  # and nothing but the decay moved the frozen stages: p (1 - lr wd)-ish, not a gradient step
        k = "backbone/res2_b0/conv1/conv/kernel"
        rel = np.abs(tp[k] / r["init"][k] - 1)
        assert rel.max() < 1e-6


def test_train_mode_changes_no_frozen_bn_output(runs):
    _, r = runs
    model = r["model"]
    x = torch.randn(2, 3, 32, 32)
    norms = [m for m in model.modules() if isinstance(m, FrozenBN)]
    with torch.no_grad():
        model.eval()
        want = [m(x[:, :1].expand(-1, m.scale.shape[0], -1, -1)) for m in norms]
        model.train()
        got = [m(x[:, :1].expand(-1, m.scale.shape[0], -1, -1)) for m in norms]
        feats_train = model.backbone(x)
        model.eval()
        feats_eval = model.backbone(x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(feats_train[k], feats_eval[k]) for k in feats_eval)
    # the last update gave each of FrozenBN's tensors a zero gradient, and the optimizer took them
    assert all(torch.count_nonzero(p.grad) == 0 for m in norms for p in m.parameters())
