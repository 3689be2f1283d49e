"""Port parity of ``projects/point_rend.py`` and ``projects/pointsup.py``, on
the CPU against the JAX package.

The same numpy-seeded inputs, and the JAX variables carried by
``convert.flax_to_state_dict``, go to both packages; the train-time point
selection takes JAX's own draws (the port's ``draws=``), split from the key
as the JAX module splits it. Bars (float32): point ops and resizes 1e-5
absolute; heads 1e-4 of each output's largest magnitude; losses 1e-5
relative; gradients (autograd against ``jax.grad``) 1e-4 of each gradient's
largest magnitude; selected indices, and the points picked by them, exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.projects import point_rend as JPR
from spacecraft_pose_estimation_tpu.projects import pointsup as JPS
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, module_to_flax
from spacecraft_pose_estimation_tpu_torch.models import layers as tlayers
from spacecraft_pose_estimation_tpu_torch.projects import point_rend as PR
from spacecraft_pose_estimation_tpu_torch.projects import pointsup as PS

from torch_port_util import few_threads, n, random_variables, t, to_jax  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def _scaled(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-12))


def _grads_close(named_params, jgrads, rel=1e-4):
    """Each port parameter's gradient against JAX's at its Flax path
    (a parameter with no port gradient counts as zero)."""
    flat = flax_to_state_dict({"params": jax.tree_util.tree_map(np.array, jgrads)})
    assert set(flat) == set(dict(named_params)), sorted(set(flat) ^ set(dict(named_params)))
    for name, p in named_params:
        got = n(p.grad) if p.grad is not None else np.zeros(p.shape, np.float32)
        want = n(flat[name])
        assert np.abs(want).max() > 0, name
        _scaled(got, want, rel)


def _uniform_draws(key, r, num_points, oversample, importance):
    """JAX's draws of ``uncertain_point_coords_with_randomness`` from ``key``."""
    s, k_rand = int(num_points * oversample), num_points - int(importance * num_points)

    @jax.jit
    def draw(k):
        rng1, rng2 = jax.random.split(k)
        return jax.random.uniform(rng1, (r, s, 2)), jax.random.uniform(rng2, (r, k_rand, 2))

    cand, fresh = draw(key)
    return {"candidates": t(cand), "fresh": t(fresh)}


# --------------------------------------------------------------------------- point ops


def test_point_sample_matches_jax_in_and_outside_the_map():
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(2, 9, 7, 3)).astype(np.float32)
    coords = rng.uniform(-0.2, 1.2, size=(2, 41, 2)).astype(np.float32)
    coords[0, :3] = [[0.0, 0.0], [1.0, 1.0], [0.5, 1.0]]
    want = np.asarray(jax.jit(JPR.point_sample)(jnp.asarray(feat), jnp.asarray(coords)))
    np.testing.assert_allclose(n(PR.point_sample(t(feat), t(coords))), want, rtol=0, atol=1e-5)


def test_point_sample_of_bf16_map_matches_jax():
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(1, 12, 10, 4)).astype(np.float32)
    coords = rng.uniform(0, 1, size=(1, 30, 2)).astype(np.float32)
    want = jax.jit(JPR.point_sample)(jnp.asarray(feat, jnp.bfloat16), jnp.asarray(coords))
    got = PR.point_sample(t(feat).to(torch.bfloat16), t(coords))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=1e-5)


def test_point_sample_nearest_matches_jax_exactly():
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(2, 6, 5, 2)).astype(np.float32)
    coords = rng.uniform(-0.1, 1.1, size=(2, 25, 2)).astype(np.float32)
    coords[1, :4] = [[0.1, 0.25], [0.3, 0.75], [0.5, 0.5], [0.9, 0.083333336]]  # half-way positions
    want = np.asarray(jax.jit(JPR.point_sample_nearest)(jnp.asarray(feat), jnp.asarray(coords)))
    np.testing.assert_array_equal(n(PR.point_sample_nearest(t(feat), t(coords))), want)


@pytest.mark.parametrize("side", [1, 5, 14])
def test_regular_grid_matches_jax(side):
    want = np.asarray(jax.jit(lambda: JPR.regular_grid_coords(3, side))())
    np.testing.assert_array_equal(n(PR.regular_grid_coords(3, side, "cpu")), want)


@pytest.mark.parametrize("out_hw", [(4, 6), (16, 16), (24, 5), (7, 7)])
def test_interpolate_bilinear_matches_jax(out_hw):
    """Up and down, never antialiased."""
    x = np.random.default_rng(21).normal(size=(2, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: JPR.interpolate_bilinear(a, out_hw))(jnp.asarray(x)))
    got = n(PR.interpolate_bilinear(t(x), out_hw))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("factor", [2, 4, 16])
def test_layers_upsample_bilinear_is_jax_upsample_bilinear(factor):
    """``models.layers.upsample_bilinear`` (NCHW, ``scale_factor``) samples as
    JAX ``point_rend.upsample_bilinear``, so the port reuses it; the port's
    wrapper only rewrites the clamped bottom / right border, where both taps
    are one pixel, as that pixel's row / column interpolation: a plateau of
    equal values, as the jitted JAX function gives (its fused multiply-adds
    return the pixel exactly)."""
    x = np.random.default_rng(3).normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: JPR.upsample_bilinear(a, factor))(jnp.asarray(x)))
    plain = n(tlayers.upsample_bilinear(t(x).permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1))
    got = n(PR.upsample_bilinear(t(x), factor))
    np.testing.assert_allclose(plain, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    h, w, edge = 5 * factor, 7 * factor, factor // 2  # the last factor / 2 rows and columns sample past the map
    np.testing.assert_array_equal(got[:, :h - edge, :w - edge], plain[:, :h - edge, :w - edge])
    for a in (want, got):
        assert (a[:, h - edge:] == a[:, h - 1:]).all() and (a[:, :, w - edge:] == a[:, :, w - 1:]).all()
    np.testing.assert_array_equal(got[:, h - 1, w - 1], x[:, -1, -1])


def test_uncertainty_functions_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 5, 6, 4)).astype(np.float32)
    classes = np.array([0, 3, 2], np.int32)
    want = jax.jit(lambda a, c: (JPR.calculate_uncertainty(a, c), JPR.calculate_uncertainty(a[..., :1], None),
                                 JPR.sem_seg_uncertainty(a)))(jnp.asarray(logits), jnp.asarray(classes))
    got = (PR.calculate_uncertainty(t(logits), t(classes)), PR.calculate_uncertainty(t(logits[..., :1]), None),
           PR.sem_seg_uncertainty(t(logits)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))


@pytest.mark.parametrize("num_points", [5, 17, 48])
def test_uncertain_point_coords_on_grid_breaks_ties_as_jax(num_points):
    """A map of few distinct values (many exact ties, as after an
    upsample): the chosen cells equal ``jax.lax.top_k``'s, lowest index first."""
    rng = np.random.default_rng(5)
    unc = rng.integers(-3, 1, size=(2, 6, 8, 1)).astype(np.float32)
    unc[1, 2:4, 3:7] = 0.5  # a plateau of the largest value
    j_idx, j_coords = jax.jit(lambda a: JPR.uncertain_point_coords_on_grid(a, num_points))(jnp.asarray(unc))
    idx, coords = PR.uncertain_point_coords_on_grid(t(unc), num_points)
    np.testing.assert_array_equal(n(idx), np.asarray(j_idx))
    # jitted XLA fuses the cell centre's multiply-add (one ulp): the point ops' bar
    np.testing.assert_allclose(n(coords), np.asarray(j_coords), rtol=0, atol=1e-5)


@pytest.mark.parametrize("semseg", [False, True], ids=["instance", "semseg"])
def test_uncertain_point_coords_with_randomness_on_jax_draws(semseg):
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(3, 7, 7, 4 if semseg else 3)).astype(np.float32)
    logits[0, :, :3] = 2.0  # tied uncertainties
    classes = None if semseg else np.array([2, 0, 1], np.int32)
    key = jax.random.key(7)
    fn_j, fn_t = (JPR.sem_seg_uncertainty, PR.sem_seg_uncertainty) if semseg else (None, None)
    want = jax.jit(lambda k, a, c: JPR.uncertain_point_coords_with_randomness(k, a, c, 24, 3.0, 0.75,
                                                                             uncertainty_fn=fn_j))(
        key, jnp.asarray(logits), None if classes is None else jnp.asarray(classes))
    got = PR.uncertain_point_coords_with_randomness(
        t(logits), None if classes is None else t(classes), 24, 3.0, 0.75, uncertainty_fn=fn_t,
        draws=_uniform_draws(key, 3, 24, 3.0, 0.75))
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_fine_grained_features_on_two_levels_match_jax():
    rng = np.random.default_rng(8)
    feats = [rng.normal(size=(16, 20, 4)).astype(np.float32), rng.normal(size=(8, 10, 3)).astype(np.float32)]
    boxes = np.array([[4.0, 6.0, 50.0, 40.0], [0.0, 0.0, 80.0, 64.0], [0.0, 0.0, 0.0, 0.0]], np.float32)
    coords = rng.uniform(0, 1, size=(3, 11, 2)).astype(np.float32)
    np.testing.assert_allclose(n(PR.point_coords_wrt_image(t(boxes), t(coords))),
                               np.asarray(jax.jit(JPR.point_coords_wrt_image)(jnp.asarray(boxes), jnp.asarray(coords))),
                               rtol=0, atol=1e-5)
    want = np.asarray(jax.jit(lambda fs, b, c: JPR.sample_fine_grained_features(fs, (4, 8), b, c))(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), jnp.asarray(coords)))
    got = n(PR.sample_fine_grained_features([t(f) for f in feats], (4, 8), t(boxes), t(coords)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------- losses


@pytest.mark.parametrize("case", ["agnostic", "agnostic_valid", "per_class"])
def test_roi_mask_point_loss_matches_jax(case):
    rng = np.random.default_rng(9)
    c = 3 if case == "per_class" else 1
    logits = rng.normal(size=(4, 9, c)).astype(np.float32)
    labels = rng.integers(0, 2, size=(4, 9)).astype(np.float32)
    labels[0, :3] = -1
    classes = np.array([2, 0, 1, 2], np.int32) if c > 1 else None
    valid = np.array([1.0, 1.0, 0.0, 1.0], np.float32) if case == "agnostic_valid" else None
    jv = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    tv = lambda a: None if a is None else t(a)  # noqa: E731
    want = float(jax.jit(JPR.roi_mask_point_loss)(jnp.asarray(logits), jnp.asarray(labels), jv(classes), jv(valid)))
    got = float(PR.roi_mask_point_loss(t(logits), t(labels), tv(classes), tv(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sem_seg_point_loss_matches_jax():
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(2, 7, 5)).astype(np.float32)
    targets = rng.integers(0, 5, size=(2, 7)).astype(np.int32)
    targets[0, :2] = 255
    want = float(jax.jit(JPR.sem_seg_point_loss)(jnp.asarray(logits), jnp.asarray(targets)))
    np.testing.assert_allclose(float(PR.sem_seg_point_loss(t(logits), t(targets), 255)), want, rtol=1e-5)


# --------------------------------------------------------------------------- heads

MASK_CFG = JPR.PointRendConfig(train_num_points=24, subdivision_steps=2, subdivision_num_points=64, fc_dim=32,
                               num_fc=2)
CLS_CFG = dataclasses.replace(MASK_CFG, cls_agnostic=False, num_classes=3)
C_FEAT = 16


def _port_cfg(cfg):
    return PR.PointRendConfig(**dataclasses.asdict(cfg))


def _scene():
    rng = np.random.default_rng(11)
    feats = [rng.normal(size=(32, 32, C_FEAT)).astype(np.float32)]
    boxes = np.array([[8.0, 8.0, 72.0, 96.0], [0.0, 0.0, 128.0, 128.0], [30.0, 50.0, 60.0, 58.0]], np.float32)
    gt = np.zeros((3, 128, 128), np.float32)
    gt[:, 20:90, 20:60] = 1.0
    gt[2, 52:56, 35:50] = 0.0
    return feats, boxes, gt, np.array([1.0, 1.0, 0.0], np.float32), np.array([1, 0, 2], np.int32)


@pytest.fixture(scope="module")
def mask_heads():
    """Per config: the JAX head, its seeded variables and the port's head with them."""
    feats, boxes, gt, valid, _ = _scene()
    out = {}
    for name, cfg in (("agnostic", MASK_CFG), ("per_class", CLS_CFG)):
        jm = JPR.PointRendMaskHead(cfg=cfg)
        args = ([jnp.asarray(f) for f in feats], jnp.asarray(boxes))
        variables = random_variables(lambda: jm.init(jax.random.key(0), *args, gt_masks=jnp.asarray(gt),
                                                     gt_classes=jnp.zeros(3, jnp.int32), valid=jnp.asarray(valid),
                                                     rng=jax.random.key(1), train=True), seed=12)
        tm = PR.PointRendMaskHead(_port_cfg(cfg), in_channels=C_FEAT, device="cpu")
        tm.load_state_dict(flax_to_state_dict(variables), strict=True)
        out[name] = (jm, variables, tm)
    return out


@pytest.mark.parametrize("which", ["agnostic", "per_class"])
def test_mask_head_training_and_point_loss_gradient_match_jax(mask_heads, which):
    jm, variables, tm = mask_heads[which]
    feats, boxes, gt, valid, classes = _scene()
    key = jax.random.key(13)
    jfeats = [jnp.asarray(f) for f in feats]

    def jloss(params):
        coarse, pl, lab = jm.apply({"params": params}, jfeats, jnp.asarray(boxes), gt_masks=jnp.asarray(gt),
                                   gt_classes=jnp.asarray(classes), valid=jnp.asarray(valid), rng=key, train=True)
        return JPR.roi_mask_point_loss(pl, lab, jnp.asarray(classes), jnp.asarray(valid)), (coarse, pl, lab)

    (jl, (jc, jpl, jlab)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(to_jax(variables["params"]))
    cfg = jm.cfg
    coarse, pl, lab = tm([t(f) for f in feats], t(boxes), gt_masks=t(gt), gt_classes=t(classes), valid=t(valid),
                         train=True, draws=_uniform_draws(key, 3, cfg.train_num_points, cfg.oversample_ratio,
                                                          cfg.importance_sample_ratio))
    loss = PR.roi_mask_point_loss(pl, lab, t(classes), t(valid))
    loss.backward()
    for got, want in ((coarse, jc), (pl, jpl), (lab, jlab)):
        _scaled(n(got), np.asarray(want))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _grads_close(tm.named_parameters(), jgrads)
    tm.zero_grad()


@pytest.mark.parametrize("which", ["agnostic", "per_class"])
def test_mask_head_subdivision_inference_matches_jax(mask_heads, which):
    jm, variables, tm = mask_heads[which]
    feats, boxes, _, _, classes = _scene()
    cls = None if which == "agnostic" else classes
    want = np.asarray(jax.jit(lambda v, fs, b, c: jm.apply(v, fs, b, gt_classes=c))(
        to_jax(variables), [jnp.asarray(f) for f in feats], jnp.asarray(boxes),
        None if cls is None else jnp.asarray(cls)))
    with torch.no_grad():
        got = n(tm([t(f) for f in feats], t(boxes), gt_classes=None if cls is None else t(cls)))
    side = jm.cfg.init_resolution * 2 ** jm.cfg.effective_steps
    assert got.shape == (3, side, side, 1 if which == "agnostic" else 3)
    _scaled(got, want)


def test_subdivision_scatter_places_point_logits():
    mask = torch.zeros(1, 2, 2, 1)
    mask[0, 0, 0, 0] = 5.0
    up = PR.upsample2x_bilinear(mask)
    idx, _ = PR.uncertain_point_coords_on_grid(PR.calculate_uncertainty(up, None), 3)
    out = PR._scatter_points(up, idx, torch.full((1, 3, 1), -9.0)).reshape(16)
    assert (out[idx[0]] == -9.0).all() and int((out != -9.0).sum()) == 13


IMPL_CFG = JPR.PointRendConfig(train_num_points=16, subdivision_steps=2, subdivision_num_points=16, fc_dim=8,
                               num_fc=1)


@pytest.fixture(scope="module")
def implicit_head():
    feats, boxes, gt, _, _ = _scene()
    jm = JPR.ImplicitPointRendMaskHead(cfg=IMPL_CFG, in_channels=C_FEAT)
    init = lambda: jm.init(jax.random.key(0), [jnp.asarray(f) for f in feats], jnp.asarray(boxes),  # noqa: E731
                           gt_masks=jnp.asarray(gt), rng=jax.random.key(1), train=True)
    variables = random_variables(init, seed=14)
    variables["buffers"] = jax.tree_util.tree_map(np.array, jax.jit(init)()["buffers"])  # JAX's PRNGKey(17) draw
    tm = PR.ImplicitPointRendMaskHead(_port_cfg(IMPL_CFG), in_channels=C_FEAT, device="cpu")
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jm, variables, tm


def test_implicit_head_matches_jax_with_the_buffer_carried(implicit_head):
    jm, variables, tm = implicit_head
    feats, boxes, gt, valid, _ = _scene()
    jfeats = [jnp.asarray(f) for f in feats]
    np.testing.assert_array_equal(n(tm.point_head.positional_encoding_gaussian_matrix),
                                  variables["buffers"]["point_head"]["positional_encoding_gaussian_matrix"])
    key = jax.random.key(15)

    def jloss(params):
        logits, labels, l2 = jm.apply({"params": params, "buffers": variables["buffers"]}, jfeats,
                                      jnp.asarray(boxes), gt_masks=jnp.asarray(gt), rng=key, train=True)
        return JPR.roi_mask_point_loss(logits, labels, None, jnp.asarray(valid)) + l2, (logits, labels, l2)

    (jl, (jlog, jlab, jl2)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(to_jax(variables["params"]))
    draws = {"coords": t(jax.jit(lambda k: jax.random.uniform(k, (3, IMPL_CFG.train_num_points, 2)))(key))}
    logits, labels, l2 = tm([t(f) for f in feats], t(boxes), gt_masks=t(gt), train=True, draws=draws)
    loss = PR.roi_mask_point_loss(logits, labels, None, t(valid)) + l2
    loss.backward()
    _scaled(n(logits), np.asarray(jlog))
    _scaled(n(labels), np.asarray(jlab))
    np.testing.assert_allclose(l2.item(), float(jl2), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _grads_close(tm.named_parameters(), jgrads)
    tm.zero_grad()
    want = np.asarray(jax.jit(jm.apply)(to_jax(variables), jfeats, jnp.asarray(boxes)))
    with torch.no_grad():
        got = n(tm([t(f) for f in feats], t(boxes)))
    assert got.shape == (3, 16, 16, 1)
    _scaled(got, want)


def test_implicit_head_needs_classes_when_not_agnostic():
    cfg = PR.PointRendConfig(train_num_points=16, subdivision_steps=1, subdivision_num_points=16, fc_dim=8,
                             num_fc=1, cls_agnostic=False, num_classes=3)
    tm = PR.ImplicitPointRendMaskHead(cfg, in_channels=4, device="cpu")
    feats, boxes = [torch.zeros(32, 32, 4)], torch.tensor([[4.0, 4.0, 20.0, 20.0]])
    with pytest.raises(ValueError, match="classes"):
        tm(feats, boxes)
    with torch.no_grad():
        assert tuple(tm(feats, boxes, classes=torch.tensor([1])).shape) == (1, 8, 8, 3)


def test_module_to_flax_returns_the_buffers_collection(implicit_head):
    """The bridge's round trip: the positional matrix goes back to Flax's
    ``buffers`` (not ``batch_stats``), and JAX applies the returned tree."""
    jm, variables, tm = implicit_head
    back = module_to_flax(tm)
    assert set(back) == {"params", "batch_stats", "buffers"} and not back["batch_stats"]
    np.testing.assert_array_equal(back["buffers"]["point_head"]["positional_encoding_gaussian_matrix"],
                                  variables["buffers"]["point_head"]["positional_encoding_gaussian_matrix"])
    assert "positional_encoding_gaussian_matrix" not in back["params"].get("point_head", {})
    feats, boxes, _, _, _ = _scene()
    apply = jax.jit(jm.apply)
    want = np.asarray(apply(to_jax(variables), [jnp.asarray(f) for f in feats], jnp.asarray(boxes)))
    again = np.asarray(apply(to_jax({"params": back["params"], "buffers": back["buffers"]}),
                             [jnp.asarray(f) for f in feats], jnp.asarray(boxes)))
    np.testing.assert_array_equal(again, want)
    assert set(module_to_flax(PR.PointRendMaskHead(_port_cfg(MASK_CFG), C_FEAT, device="cpu"))) == {
        "params", "batch_stats"}


@pytest.fixture(scope="module")
def sem_seg_head():
    rng = np.random.default_rng(16)
    coarse = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    fine = [rng.normal(size=(2, 32, 32, 8)).astype(np.float32)]
    targets = rng.integers(0, 3, size=(2, 64, 64)).astype(np.int32)
    targets[0, :10] = 255
    jm = JPR.PointRendSemSegHead(num_classes=3, train_num_points=32, subdivision_steps=2,
                                 subdivision_num_points=64, fc_dim=16, num_fc=2)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(coarse), [jnp.asarray(fine[0])],
                                                 targets=jnp.asarray(targets), rng=jax.random.key(1), train=True),
                                 seed=17)
    tm = PR.PointRendSemSegHead(3, 8, train_num_points=32, subdivision_steps=2, subdivision_num_points=64,
                                fc_dim=16, num_fc=2, device="cpu")
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jm, variables, tm, (coarse, fine, targets)


def test_sem_seg_head_training_matches_jax(sem_seg_head):
    jm, variables, tm, (coarse, fine, targets) = sem_seg_head
    key = jax.random.key(18)

    def jloss(params, coarse_j):
        return jm.apply({"params": params}, coarse_j, [jnp.asarray(fine[0])], targets=jnp.asarray(targets), rng=key,
                        train=True)[1]

    jl, (jgrads, jgc) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(to_jax(variables["params"]),
                                                                         jnp.asarray(coarse))
    coarse_t = t(coarse).requires_grad_()
    _, loss = tm(coarse_t, [t(fine[0])], targets=t(targets), train=True,
                 draws=_uniform_draws(key, 2, 32, 3.0, 0.75))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    _grads_close(tm.named_parameters(), jgrads)
    _scaled(n(coarse_t.grad), np.asarray(jgc))  # the point logits train the coarse head through point_sample
    tm.zero_grad()


def test_sem_seg_head_inference_matches_jax(sem_seg_head):
    jm, variables, tm, (coarse, fine, _) = sem_seg_head
    want, _ = jax.jit(jm.apply)(to_jax(variables), jnp.asarray(coarse), [jnp.asarray(fine[0])])
    with torch.no_grad():
        got, _ = tm(t(coarse), [t(fine[0])])
    assert tuple(got.shape) == (2, 64, 64, 3)
    _scaled(n(got), np.asarray(want))


# --------------------------------------------------------------------------- PointSup


def _annotation():
    rng = np.random.default_rng(19)
    boxes = np.array([[10.0, 20.0, 30.0, 60.0], [0.0, 0.0, 14.0, 14.0], [5.0, 5.0, 40.0, 12.0]], np.float32)
    pts = rng.uniform(-5, 45, size=(3, 10, 2)).astype(np.float32)
    pts[0, :3] = [[20.0, 40.0], [5.0, 30.0], [10.0, 20.0]]  # centre, outside, on the corner
    labels = rng.integers(0, 2, size=(3, 10)).astype(np.float32)
    return boxes, pts, labels


def test_point_labels_from_annotation_match_jax():
    boxes, pts, labels = _annotation()
    for fn_t, fn_j in ((PS.point_labels_from_annotation, JPS.point_labels_from_annotation),
                       (PS.implicit_point_sup_train_points, JPS.implicit_point_sup_train_points)):
        got = fn_t(t(boxes), t(pts), t(labels))
        want = jax.jit(fn_j)(jnp.asarray(boxes), jnp.asarray(pts), jnp.asarray(labels))
        np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(n(PS.point_coords_wrt_box(t(boxes), t(pts))),
                               np.asarray(JPS.point_coords_wrt_box(jnp.asarray(boxes), jnp.asarray(pts))),
                               rtol=0, atol=1e-5)
    assert n(PS.point_labels_from_annotation(t(boxes), t(pts), t(labels))[1])[0, :3].tolist() == [
        labels[0, 0], -1.0, labels[0, 2]]


@pytest.mark.parametrize("per_class", [False, True], ids=["agnostic", "per_class"])
def test_point_sup_loss_matches_jax_and_pointrend_bce(per_class):
    boxes, pts, labels = _annotation()
    rng = np.random.default_rng(20)
    logits = rng.normal(size=(3, 7, 7, 2 if per_class else 1)).astype(np.float32)
    classes = np.array([1, 0, 1], np.int32) if per_class else None
    valid = np.array([1.0, 1.0, 0.0], np.float32)
    jloss = jax.jit(jax.value_and_grad(lambda lg, c: JPS.mask_rcnn_point_sup_loss(
        lg, jnp.asarray(boxes), jnp.asarray(pts), jnp.asarray(labels), c, jnp.asarray(valid))))
    want, jgrad = jloss(jnp.asarray(logits), None if classes is None else jnp.asarray(classes))
    want = float(want)
    logits_t = t(logits).requires_grad_()
    got = PS.mask_rcnn_point_sup_loss(logits_t, t(boxes), t(pts), t(labels), None if classes is None else t(classes),
                                      t(valid))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    coords, lab = PS.point_labels_from_annotation(t(boxes), t(pts), t(labels))
    bce = PR.roi_mask_point_loss(PR.point_sample(t(logits), coords), lab, None if classes is None else t(classes),
                                 t(valid))
    np.testing.assert_allclose(got.item(), bce.item(), rtol=1e-6)
    got.backward()
    _scaled(n(logits_t.grad), np.asarray(jgrad))
