"""Port parity of ``projects/deeplab.py`` and ``projects/panoptic_deeplab.py``
(and the dilation of ``models/resnet_backbone``), on the CPU against the
JAX package.

The same numpy-seeded inputs, and the JAX variables carried by
``convert.flax_to_state_dict``, go to both packages. Bars (float32): heads
and trunk features 1e-4 of each output's largest magnitude; losses and the
schedule 1e-5 relative; gradients (autograd against ``jax.grad``) 1e-4 of
each gradient's largest magnitude; centres, validity, instance ids,
panoptic maps and the target generator's outputs exact. The panoptic
post-processing is held to the JAX package's own functions: it stands in
for ``tests/test_projects_deeplab.py``'s three reference-oracle cases,
whose oracle this host lacks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.models import resnet_backbone as jrb
from spacecraft_pose_estimation_tpu.projects import deeplab as JDL
from spacecraft_pose_estimation_tpu.projects import panoptic_deeplab as JPD
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict
from spacecraft_pose_estimation_tpu_torch.models import resnet_backbone as trb
from spacecraft_pose_estimation_tpu_torch.projects import deeplab as DL
from spacecraft_pose_estimation_tpu_torch.projects import panoptic_deeplab as PD

from torch_port_util import few_threads, n, random_variables, t, to_jax  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def _scaled(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-12))


def _grads_close(named_params, jgrads, rel=1e-4):
    """Each port parameter's gradient against JAX's at its Flax path; a
    parameter without a port gradient (FrozenBN's, detached as JAX's
    stop_gradient) counts as zero."""
    flat = flax_to_state_dict({"params": jax.tree_util.tree_map(np.array, jgrads)})
    assert set(flat) == set(dict(named_params))
    for name, p in named_params:
        got = n(p.grad) if p.grad is not None else np.zeros(p.shape, np.float32)
        want = n(flat[name])
        if np.abs(want).max() == 0:
            np.testing.assert_array_equal(got, want)
        else:
            _scaled(got, want, rel)


def _port(module, variables):
    module.load_state_dict(flax_to_state_dict(variables), strict=True)
    return module


# --------------------------------------------------------------------------- trunk


@pytest.mark.parametrize("stride,dilation,groups", [(1, 2, 1), (1, 4, 1), (2, 1, 1), (1, 2, 4)],
                         ids=["d2", "d4", "s2", "grouped_d2"])
def test_dilated_bottleneck_matches_jax(stride, dilation, groups):
    x = np.random.default_rng(0).normal(size=(2, 12, 12, 16)).astype(np.float32)
    jm = jrb.BottleneckX(out_channels=32, bottleneck_channels=16, stride=stride, groups=groups, dilation=dilation)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=1)
    want = np.asarray(jax.jit(jm.apply)(to_jax(variables), jnp.asarray(x)))
    tm = _port(trb.BottleneckX(16, 32, 16, stride, groups, True, dilation), variables)
    assert tm.conv2.conv.dilation == dilation and tm.conv2.conv.padding == dilation
    with torch.no_grad():
        got = n(tm(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    _scaled(got, want)


def test_undilated_blocks_keep_their_convs():
    """Every existing caller keeps ``dilation=1``: the same convs as before."""
    m = trb.BottleneckX(16, 32, 16, 2, 4, False)
    assert (m.conv2.conv.dilation, m.conv2.conv.padding, m.conv2.conv.stride) == (1, 1, 2)
    assert (m.conv1.conv.dilation, m.conv1.conv.padding) == (1, 0)


FROZEN_TINY = dataclasses.replace(
    JDL.DEEPLAB_TINY, resnet=dataclasses.replace(JDL.DEEPLAB_TINY.resnet, freeze_at=2))


def _port_trunk_cfg(cfg):
    rc = cfg.resnet
    return DL.DeepLabResNetConfig(
        resnet=trb.ResNetConfig(depth=rc.depth, stem_channels=rc.stem_channels, res2_out_channels=rc.res2_out_channels,
                                groups=rc.groups, width_per_group=rc.width_per_group,
                                stride_in_1x1=rc.stride_in_1x1, freeze_at=rc.freeze_at),
        stem_channels=cfg.stem_channels, res4_dilation=cfg.res4_dilation, res5_dilation=cfg.res5_dilation,
        res5_multi_grid=cfg.res5_multi_grid)


@pytest.fixture(scope="module")
def tiny_trunk():
    """DEEPLAB_TINY with ``freeze_at=2`` (which JAX ignores), seeded."""
    x = np.random.default_rng(2).normal(size=(1, 64, 64, 3)).astype(np.float32)
    jm = JDL.DeepLabResNet(config=FROZEN_TINY)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=3)
    tm = _port(DL.DeepLabResNet(_port_trunk_cfg(FROZEN_TINY), device="cpu"), variables)
    return jm, variables, tm, x


def test_deeplab_resnet_features_and_gradients_match_jax(tiny_trunk):
    """Output stride 16 with res5 dilated; every conv gets JAX's gradient,
    the stem's too: nothing is frozen."""
    jm, variables, tm, x = tiny_trunk
    rng = np.random.default_rng(4)
    shapes = {"res2": (1, 16, 16, 16), "res3": (1, 8, 8, 32), "res4": (1, 4, 4, 64), "res5": (1, 4, 4, 128)}
    weights = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}

    def jloss(params):
        feats = jm.apply({"params": params}, jnp.asarray(x))
        return sum(jnp.sum(feats[k] * weights[k]) for k in shapes), feats

    (jl, jfeats), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(to_jax(variables["params"]))
    feats = tm(t(x))
    for k, s in shapes.items():
        assert tuple(feats[k].shape) == s
        _scaled(n(feats[k]), np.asarray(jfeats[k]))
    sum((feats[k] * t(weights[k])).sum() for k in shapes).backward()
    assert np.abs(n(tm.stem.conv1.conv.weight.grad)).max() > 0
    _grads_close(tm.named_parameters(), jgrads)
    assert [tm.get_submodule(f"res5_b{i}").conv2.conv.dilation for i in range(3)] == [2, 4, 8]
    assert tm.res5_b0.shortcut is not None and tm.res4_b0.conv2.conv.stride == 1  # stride_in_1x1
    tm.zero_grad()


# --------------------------------------------------------------------------- loss and schedule


@pytest.mark.parametrize("topk,weighted", [(1.0, False), (0.2, False), (0.2, True), (0.001, False)],
                         ids=["mean", "top20", "top20_weighted", "k_at_least_1"])
def test_deeplab_ce_loss_matches_jax(topk, weighted):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(2, 8, 8, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, size=(2, 8, 8)).astype(np.int32)
    labels[0, :2] = -1
    w = rng.uniform(0.5, 3.0, size=(2, 8, 8)).astype(np.float32) if weighted else None
    want = jax.jit(jax.value_and_grad(lambda lg: JDL.deeplab_ce_loss(
        lg, jnp.asarray(labels), -1, topk, None if w is None else jnp.asarray(w))))(jnp.asarray(logits))
    lt = t(logits).requires_grad_()
    got = DL.deeplab_ce_loss(lt, t(labels), -1, topk, None if w is None else t(w))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want[0]), rtol=1e-5)
    _scaled(n(lt.grad), np.asarray(want[1]))


@pytest.mark.parametrize("kwargs", [dict(base_lr=0.01, max_iters=1000, warmup_iters=100, warmup_factor=0.1),
                                    dict(base_lr=0.01, max_iters=90000),
                                    dict(base_lr=1.0, max_iters=100, warmup_iters=0, constant_ending=0.5),
                                    dict(base_lr=0.1, max_iters=200, warmup_iters=50, constant_ending=0.3)],
                         ids=["warmup", "deeplab_r103", "constant_ending", "warmup_and_constant_ending"])
def test_warmup_poly_schedule_matches_jax(kwargs):
    steps = np.array([0, 1, 10, 49, 50, 51, 99, 100, 101, 150, 500, 999, 1000, 1001, 45000, 89999, 90000, 99999],
                     np.float32)
    # eager, as the JAX package's own test calls it: under jit XLA turns the
    # divisions by constants into reciprocal multiplies, which 1 - step / max_iters
    # amplifies near the end of the schedule (3e-5 relative at step 999 of 1000)
    want = np.asarray(JDL.warmup_poly_schedule(**kwargs)(jnp.asarray(steps)))
    sched = DL.warmup_poly_schedule(**kwargs)
    got = np.array([sched(int(s)).item() for s in steps], np.float32)
    assert sched(3).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    if kwargs.get("constant_ending"):
        assert got[-1] == pytest.approx(kwargs["base_lr"] * kwargs["constant_ending"])


# --------------------------------------------------------------------------- heads


def _feats(seed=6, c2=8, c5=32):
    rng = np.random.default_rng(seed)
    return {"res2": rng.normal(size=(2, 16, 16, c2)).astype(np.float32),
            "res5": rng.normal(size=(2, 4, 4, c5)).astype(np.float32)}


def _targets(seed=7, classes=4):
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, classes, size=(2, 64, 64)).astype(np.int32)
    tgt[0, :8] = -1
    return tgt


def _head_case(jm, tm_build, feats, targets, extra_j=(), extra_t=(), seed=8):
    """Train loss and its parameter gradients, then inference, against JAX."""
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = random_variables(lambda: jm.init(jax.random.key(0), jf, jnp.asarray(targets), *extra_j, train=True),
                                 seed=seed)
    tm = _port(tm_build(), variables)

    def jloss(params):
        _, losses = jm.apply({"params": params}, jf, jnp.asarray(targets), *extra_j, train=True)
        return losses["loss_sem_seg"]

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(to_jax(variables["params"]))
    tf = {k: t(v) for k, v in feats.items()}
    _, losses = tm(tf, t(targets), *extra_t, train=True)
    losses["loss_sem_seg"].backward()
    np.testing.assert_allclose(losses["loss_sem_seg"].item(), float(jl), rtol=1e-5)
    _grads_close(tm.named_parameters(), jgrads)
    want, _ = jax.jit(jm.apply)(to_jax(variables), jf)
    with torch.no_grad():
        got, _ = tm(tf)
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
    _scaled(n(got), np.asarray(want))


def test_v3_head_matches_jax():
    jm = JDL.DeepLabV3Head(num_classes=4, aspp_channels=16, aspp_dilations=(1, 2, 3), common_stride=16)
    _head_case(jm, lambda: DL.DeepLabV3Head(4, 32, aspp_channels=16, aspp_dilations=(1, 2, 3), device="cpu"),
               _feats(), _targets())


def test_v3plus_head_matches_jax():
    jm = JDL.DeepLabV3PlusHead(num_classes=3, project_channels=(8,), aspp_channels=16, aspp_dilations=(1, 2, 3),
                               decoder_channels=(16, 16))
    _head_case(jm, lambda: DL.DeepLabV3PlusHead(3, (8, 32), project_channels=(8,), aspp_channels=16,
                                                aspp_dilations=(1, 2, 3), decoder_channels=(16, 16), device="cpu"),
               _feats(), _targets(classes=3))


def test_panoptic_sem_head_with_weights_matches_jax():
    w = np.random.default_rng(9).uniform(0.5, 3.0, size=(2, 64, 64)).astype(np.float32)
    jm = JPD.PanopticDeepLabSemSegHead(num_classes=3, decoder_channels=(16, 16), head_channels=8)
    _head_case(jm, lambda: PD.PanopticDeepLabSemSegHead(3, (8, 32), decoder_channels=(16, 16), head_channels=8,
                                                        device="cpu"),
               _feats(), _targets(classes=3), extra_j=(jnp.asarray(w),), extra_t=(t(w),))


def _ins_targets(seed=10):
    rng = np.random.default_rng(seed)
    ct = rng.uniform(0, 1, (2, 64, 64)).astype(np.float32)
    cw = (rng.uniform(size=(2, 64, 64)) > 0.5).astype(np.float32)
    ot = rng.normal(0, 8, size=(2, 64, 64, 2)).astype(np.float32)
    ow = (rng.uniform(size=(2, 64, 64)) > 0.3).astype(np.float32)
    return ct, cw, ot, ow


@pytest.mark.parametrize("empty_weights", [False, True], ids=["weighted", "no_weight"])
def test_panoptic_ins_head_losses_and_outputs_match_jax(empty_weights):
    feats = _feats()
    jf, tf = {k: jnp.asarray(v) for k, v in feats.items()}, {k: t(v) for k, v in feats.items()}
    ct, cw, ot, ow = _ins_targets()
    if empty_weights:
        cw, ow = np.zeros_like(cw), np.zeros_like(ow)
    tgts = (ct, cw, ot, ow)
    jm = JPD.PanopticDeepLabInsEmbedHead(decoder_channels=(16, 16), head_channels=8)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jf, *map(jnp.asarray, tgts), train=True), seed=11)
    tm = _port(PD.PanopticDeepLabInsEmbedHead((8, 32), decoder_channels=(16, 16), head_channels=8, device="cpu"),
               variables)

    def jloss(params):
        _, _, cl, ol = jm.apply({"params": params}, jf, *map(jnp.asarray, tgts), train=True)
        return cl["loss_center"] + ol["loss_offset"], (cl["loss_center"], ol["loss_offset"])

    (_, (jcl, jol)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(to_jax(variables["params"]))
    _, _, cl, ol = tm(tf, *map(t, tgts), train=True)
    (cl["loss_center"] + ol["loss_offset"]).backward()
    np.testing.assert_allclose(cl["loss_center"].item(), float(jcl), rtol=1e-5)
    np.testing.assert_allclose(ol["loss_offset"].item(), float(jol), rtol=1e-5)
    if empty_weights:
        assert cl["loss_center"].item() == 0.0 and ol["loss_offset"].item() == 0.0
    else:
        _grads_close(tm.named_parameters(), jgrads)
        center_j, offset_j, _, _ = jax.jit(jm.apply)(to_jax(variables), jf)
        with torch.no_grad():
            center, offset, _, _ = tm(tf)
        _scaled(n(center), np.asarray(center_j))
        _scaled(n(offset), np.asarray(offset_j))


# --------------------------------------------------------------------------- post-processing


def test_find_instance_center_on_a_planted_plateau_matches_jax():
    """Equal neighbours (a plateau: every cell of it survives the max-pool)
    and many -1 rows: the top-k, ties to the lowest index, equals JAX's row
    for row, the invalid rows too."""
    rng = np.random.default_rng(12)
    center = rng.uniform(0, 0.05, (24, 20)).astype(np.float32)
    center[5:7, 4:7] = 0.8  # plateau
    center[15, 12] = 0.6
    center[16, 12] = 0.6  # two tied maxima
    center[20, 3] = 0.09  # below the threshold
    for kernel, top_k in ((3, 10), (7, 200), (5, 4)):
        pts, valid = PD.find_instance_center(t(center), 0.1, kernel, top_k)
        jpts, jvalid = jax.jit(lambda c: JPD.find_instance_center(c, 0.1, kernel, top_k))(jnp.asarray(center))
        np.testing.assert_array_equal(n(pts), np.asarray(jpts))
        np.testing.assert_array_equal(n(valid), np.asarray(jvalid))
    assert int(n(valid).sum()) == 4  # top_k 4 of the 8 plateau and tied cells


def _scene(float_offsets: bool):
    """The JAX test's two-instance scene (integer offsets: exact distance
    ties), or the same with seeded float offsets."""
    rng = np.random.default_rng(13)
    h, w = 32, 40
    center = rng.uniform(0, 0.05, (h, w)).astype(np.float32)
    center[8, 8], center[20, 24], center[26, 34] = 0.9, 0.7, 0.5
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    left = xx < 16
    offsets = np.zeros((h, w, 2), np.float32)
    offsets[..., 0] = np.where(left, 8 - yy, 20 - yy)
    offsets[..., 1] = np.where(left, 8 - xx, 24 - xx)
    if float_offsets:
        offsets += rng.normal(0, 3, offsets.shape).astype(np.float32)
    sem = np.where(left, 1, 2).astype(np.int32)
    sem[:4] = 0
    sem[-3:, -6:] = 3
    return center, offsets, sem


@pytest.mark.parametrize("float_offsets", [False, True], ids=["integer_offsets", "float_offsets"])
def test_group_pixels_matches_jax(float_offsets):
    center, offsets, _ = _scene(float_offsets)
    jpts, jvalid = jax.jit(lambda c: JPD.find_instance_center(c, 0.3, 3, 10))(jnp.asarray(center))
    want = np.asarray(jax.jit(JPD.group_pixels)(jpts, jvalid, jnp.asarray(offsets)))
    got = n(PD.group_pixels(t(jpts), t(jvalid), t(offsets)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    none = np.zeros_like(np.asarray(jvalid))
    np.testing.assert_array_equal(n(PD.group_pixels(t(jpts), t(none), t(offsets))),
                                  np.asarray(jax.jit(JPD.group_pixels)(jpts, jnp.asarray(none), jnp.asarray(offsets))))


def test_group_pixels_in_row_chunks_equals_one_chunk(monkeypatch):
    center, offsets, _ = _scene(True)
    pts, valid = PD.find_instance_center(t(center), 0.3, 3, 10)
    whole = PD.group_pixels(pts, valid, t(offsets))
    monkeypatch.setattr(PD, "_GROUP_CHUNK_ELEMS", 3 * 40 * 3)  # 3 rows a chunk
    assert torch.equal(PD.group_pixels(pts, valid, t(offsets)), whole)


def test_merge_semantic_and_instance_matches_jax():
    rng = np.random.default_rng(14)
    h, w, c, k = 30, 36, 6, 8
    sem = rng.integers(0, c, (h, w)).astype(np.int32)
    ins = rng.integers(0, 5, (h, w)).astype(np.int32)
    ins[:6] = 0
    sem[:6, :20] = 4  # a stuff region free of instances
    ins[20:, 30:] = 7  # an instance of mixed classes
    thing_mask = np.array([False, True, True, False, False, True])
    thing_seg = thing_mask[sem]
    for area in (1, 40, 10_000):
        want = jax.jit(lambda s, i, th: JPD.merge_semantic_and_instance(s, i, th, c, k, jnp.asarray(thing_mask), 1000,
                                                                          area, -1))(
            jnp.asarray(sem), jnp.asarray(ins), jnp.asarray(thing_seg))
        got = PD.merge_semantic_and_instance(t(sem), t(ins), t(thing_seg), c, k, t(thing_mask), 1000, area, -1)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("float_offsets", [False, True], ids=["integer_offsets", "float_offsets"])
def test_get_panoptic_segmentation_matches_jax(float_offsets):
    center, offsets, sem = _scene(float_offsets)
    thing_mask = np.array([False, True, True, False])
    for kwargs in (dict(stuff_area=10, threshold=0.3, nms_kernel=3, top_k=10), dict()):
        fn = jax.jit(lambda s, c, o: JPD.get_panoptic_segmentation(s, c, o, jnp.asarray(thing_mask), 4, **kwargs))
        want = fn(jnp.asarray(sem), jnp.asarray(center), jnp.asarray(offsets))
        got = PD.get_panoptic_segmentation(t(sem), t(center), t(offsets), t(thing_mask), 4, **kwargs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(n(g), np.asarray(w))
    assert len(np.unique(n(got[0]))) >= 3


def test_panoptic_target_generator_matches_jax():
    """Things, stuff, a crowd segment, a small instance, an instance cut by
    the border and an empty one: every output equal to JAX's."""
    pan = np.zeros((40, 56), np.int64)
    pan[4:20, 4:30] = 5  # thing
    pan[25:40, 0:20] = 7  # stuff
    pan[22:26, 40:44] = 9  # small thing
    pan[30:40, 46:56] = 11  # thing on the border
    pan[0:6, 40:56] = 13  # crowd thing
    segs = [{"id": 5, "category_id": 12, "iscrowd": 0}, {"id": 7, "category_id": 2, "iscrowd": 0},
            {"id": 9, "category_id": 14}, {"id": 11, "category_id": 18, "iscrowd": 0},
            {"id": 13, "category_id": 11, "iscrowd": 1}, {"id": 99, "category_id": 15, "iscrowd": 0}]
    things = frozenset(range(11, 19))
    for kwargs in (dict(sigma=2.0, small_instance_area=100), dict(ignore_stuff_in_offset=False,
                                                                  ignore_crowd_in_semantic=True)):
        want = JPD.PanopticTargetGenerator(ignore_label=255, thing_ids=things, **kwargs)(pan, segs)
        got = PD.PanopticTargetGenerator(ignore_label=255, thing_ids=things, **kwargs)(pan, segs)
        assert set(got) == set(want)
        for key in want:
            if key == "center_points":
                assert got[key] == want[key]
            else:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])


# --------------------------------------------------------------------------- the slice end to end


def test_tiny_trunk_heads_and_panoptic_fusion_match_jax(tiny_trunk):
    """DEEPLAB_TINY -> both Panoptic heads -> ``get_panoptic_segmentation``:
    the heads' outputs at the heads' bar, then the panoptic map, centres and
    validity equal to the JAX chain's."""
    jm, variables, tm, x = tiny_trunk
    jfeats = jax.jit(jm.apply)(to_jax(variables), jnp.asarray(x))
    jsub = {k: jfeats[k] for k in ("res2", "res5")}
    jsem = JPD.PanopticDeepLabSemSegHead(num_classes=5, decoder_channels=(16, 16), head_channels=8)
    jins = JPD.PanopticDeepLabInsEmbedHead(decoder_channels=(16, 16), head_channels=8)
    vs = random_variables(lambda: jsem.init(jax.random.key(0), jsub), seed=15)
    vi = random_variables(lambda: jins.init(jax.random.key(0), jsub), seed=16, overrides={"center_predictor": 3.0})
    thing_mask = np.array([False, False, True, True, True])

    @jax.jit
    def jchain(feats):
        logits, _ = jsem.apply(vs, feats)
        center, offset, _, _ = jins.apply(vi, feats)
        sem = jnp.argmax(logits[0], axis=-1)
        return (logits, center, offset) + JPD.get_panoptic_segmentation(
            sem, center[0, ..., 0], offset[0], jnp.asarray(thing_mask), 5, stuff_area=64, threshold=0.1)

    want = jchain(jsub)
    sem_h = _port(PD.PanopticDeepLabSemSegHead(5, (16, 128), decoder_channels=(16, 16), head_channels=8,
                                               device="cpu"), vs)
    ins_h = _port(PD.PanopticDeepLabInsEmbedHead((16, 128), decoder_channels=(16, 16), head_channels=8,
                                                 device="cpu"), vi)
    with torch.no_grad():
        feats = tm(t(x))
        logits, _ = sem_h(feats)
        center, offset, _, _ = ins_h(feats)
        got = (logits, center, offset) + PD.get_panoptic_segmentation(
            torch.argmax(logits[0], dim=-1), center[0, ..., 0], offset[0], t(thing_mask), 5, stuff_area=64,
            threshold=0.1)
    for g, w in zip(got[:3], want[:3]):
        _scaled(n(g), np.asarray(w))
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    assert int(n(got[5]).sum()) > 0 and len(np.unique(n(got[3]))) > 1
