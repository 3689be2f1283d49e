"""Port parity of ``projects/densepose.py`` (and the Flax-named GroupNorm of
``models/layers``), on the CPU against the JAX package.

The same numpy-seeded inputs, and the JAX variables carried by
``convert.flax_to_state_dict``, go to both packages; each JAX reference is
jitted once per module. Bars (float32): point ops and resizes 1e-5
absolute; heads 1e-4 of each output's largest magnitude; losses 1e-5
relative; gradients (autograd against ``jax.grad``) 1e-4 of each
gradient's largest magnitude; labels, indices and masks exact.
``densepose_roi_forward`` is held on both routes at P 28: the decoder's
merged map pooled by ``roi_align_maps`` (the plain version of K2's gather
read on one level, which the card runs) and the FPN levels pooled by the
multilevel plain gather (K2's four-level gather read), each with its
gradient in the features (the plain version K2b's gather read is held to).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from spacecraft_pose_estimation_tpu.projects import densepose as JDP
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, module_to_flax
from spacecraft_pose_estimation_tpu_torch.models import layers as tlayers
from spacecraft_pose_estimation_tpu_torch.ops import roi_align as tra
from spacecraft_pose_estimation_tpu_torch.projects import densepose as DP

from torch_port_util import few_threads, n, random_variables, t, to_jax  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

P = 28  # DensePose's pooler resolution
CIN = 8  # the FPN's channels here (256 at full width)
STRIDES = (4, 8, 16, 32)
CFG = dict(num_stacked_convs=2, conv_head_dim=8, num_patches=3, decoder_channels=8)
HEAD_CFGS = {"v1convx": dict(CFG), "deeplab": dict(CFG, conv_head_dim=32, head="deeplab")}


def _scaled(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-12))


def _port(module, variables):
    module.load_state_dict(flax_to_state_dict(variables), strict=True)
    return module


def _outputs_close(got, want, rel=1e-4):
    for g, w in zip(got, want):
        _scaled(n(g), np.asarray(w), rel)


def _pyramid(seed=0, side=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, side >> i, side >> i, CIN)).astype(np.float32) for i in range(4)]


# per image (B, R, 4): boxes on P2, past the map, zero-area; and (multilevel route) on P3 and P4
BOXES = np.array([[[4.0, 4.0, 40.0, 52.0], [50.0, 50.0, 70.0, 80.0], [10.0, 20.0, 10.0, 20.0],
                   [-20.0, 8.0, 100.0, 130.0], [-40.0, -40.0, 240.0, 200.0]],
                  [[0.0, 0.0, 64.0, 64.0], [30.0, 10.0, 34.0, 60.0], [2.0, 3.0, 20.0, 9.0],
                   [0.0, 0.0, 128.0, 128.0], [60.0, 2.0, 63.0, 5.0]]], np.float32)
BATCH_IDX = np.repeat(np.arange(2, dtype=np.int32), BOXES.shape[1])


# --------------------------------------------------------------------------- JAX references, built once


@pytest.fixture(scope="module")
def heads():
    """Per head kind: the JAX DensePoseHead, its seeded variables, a jitted
    apply and the port's head with the same weights."""
    out = {}
    for kind, kw in HEAD_CFGS.items():
        cfg = JDP.DensePoseConfig(**kw)
        jm = JDP.DensePoseHead(cfg)
        variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.zeros((2, 7, 7, CIN))), seed=1)
        tm = _port(DP.DensePoseHead(DP.DensePoseConfig(**kw), CIN, device="cpu"), variables)
        out[kind] = (jm, variables, jax.jit(jm.apply), tm)
    return out


@pytest.fixture(scope="module")
def decoder():
    cfg = JDP.DensePoseConfig(**CFG)
    jm = JDP.DensePoseDecoder(cfg)
    feats = [jnp.asarray(f) for f in _pyramid()]
    variables = random_variables(lambda: jm.init(jax.random.key(0), feats), seed=2)
    tm = _port(DP.DensePoseDecoder(DP.DensePoseConfig(**CFG), CIN, device="cpu"), variables)
    return jm, variables, jax.jit(jm.apply), tm


# --------------------------------------------------------------------------- point ops and resampling


def test_linear_interpolation_utilities_match_jax():
    rng = np.random.default_rng(3)
    m = 200
    args = [rng.uniform(-20, 276, m), rng.uniform(0, 50, m), rng.uniform(10, 120, m), rng.uniform(0, 50, m),
            rng.uniform(10, 120, m)]
    args = [a.astype(np.float32) for a in args]
    args[0][:4] = [0.0, 256.0, 128.0, -1e-3]  # the box edges
    want = jax.jit(lambda *a: JDP._linear_interpolation_utilities(*a, 28))(*map(jnp.asarray, args))
    got = DP._linear_interpolation_utilities(*map(t, args), 28)
    for i in (0, 1, 3):  # lo, hi, valid: exact
        np.testing.assert_array_equal(n(got[i]), np.asarray(want[i]))
    np.testing.assert_allclose(n(got[2]), np.asarray(want[2]), rtol=0, atol=1e-5)


def test_resample_data_nearest_matches_jax():
    rng = np.random.default_rng(4)
    z = rng.integers(0, 5, (3, 16, 16, 1)).astype(np.float32)
    src = np.stack([rng.uniform(0, 10, 3), rng.uniform(0, 10, 3), rng.uniform(20, 40, 3),
                    rng.uniform(20, 40, 3)], 1).astype(np.float32)
    dst = np.stack([rng.uniform(0, 20, 3), rng.uniform(0, 20, 3), rng.uniform(15, 45, 3),
                    rng.uniform(15, 45, 3)], 1).astype(np.float32)
    dst[0] = src[0]  # the same box: positions half way between two cells, where the rounding decides
    # held to the eager JAX function: jitted, XLA fuses the position's multiply-add and rounds 17 of these
    # 432 half-way positions the other way
    want = JDP.resample_data_nearest(jnp.asarray(z), jnp.asarray(src), jnp.asarray(dst), (12, 12))
    np.testing.assert_array_equal(n(DP.resample_data_nearest(t(z), t(src), t(dst), (12, 12))), np.asarray(want))


@pytest.mark.parametrize("groups,c", [(32, 64), (4, 8)])
def test_group_norm_matches_flax(groups, c):
    """``layers.GroupNorm``: Flax's epsilon (1e-6) and fast variance, on NCHW."""
    x = (np.random.default_rng(5).normal(size=(2, 5, 6, c)) * 3 + 1).astype(np.float32)
    jm = fnn.GroupNorm(num_groups=groups)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=6)
    want = np.asarray(jax.jit(jm.apply)(to_jax(variables), jnp.asarray(x)))
    tm = _port(tlayers.GroupNorm(c, groups), variables)
    assert tm.eps == 1e-6
    got = n(tm(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------- heads


def test_chart_predictor_matches_jax():
    x = np.random.default_rng(7).normal(size=(2, 7, 7, CIN)).astype(np.float32)
    cfg = JDP.DensePoseConfig(**CFG)
    jm = JDP.DensePoseChartPredictor(cfg)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=8)
    want = jax.jit(jm.apply)(to_jax(variables), jnp.asarray(x))
    tm = _port(DP.DensePoseChartPredictor(DP.DensePoseConfig(**CFG), CIN), variables)
    with torch.no_grad():
        got = tm(t(x))
    assert got.u.shape == (2, 28, 28, 4) and got.coarse_segm.shape == (2, 28, 28, 2)
    _outputs_close(got, want)


@pytest.mark.parametrize("kind", list(HEAD_CFGS))
def test_head_matches_jax(heads, kind):
    """The v1convx body and the DeepLab body (ASPP at 6, 12, 56, GroupNorm 32)."""
    _, variables, apply, tm = heads[kind]
    x = np.random.default_rng(9).normal(size=(2, 7, 7, CIN)).astype(np.float32)
    want = apply(to_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        _outputs_close(tm(t(x)), want)


def test_decoder_matches_jax(decoder):
    _, variables, apply, tm = decoder
    feats = _pyramid(10)
    want = np.asarray(apply(to_jax(variables), [jnp.asarray(f) for f in feats]))
    with torch.no_grad():
        got = n(tm([t(f) for f in feats]))
    assert got.shape == (2, 64, 64, 8)
    _scaled(got, want)


# --------------------------------------------------------------------------- the ROI forward at P 28


def _cotangent(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=sh).astype(np.float32) for sh in shapes]


@pytest.fixture(scope="module")
def roi_reference(heads, decoder):
    """The JAX forward on both routes, vmapped over the images (the JAX
    function's unit: one image's maps, its boxes), and the gradient of
    <outputs, cotangent> in the pyramid: jitted once."""
    jhead, hvars, _, _ = heads["v1convx"]
    jdec, dvars, _, _ = decoder

    def forward(feats, hv, dv, use_decoder):
        def one(fs, boxes):
            return JDP.densepose_roi_forward(jhead, hv, [f[None] for f in fs], boxes,
                                             decoder=jdec if use_decoder else None, decoder_variables=dv,
                                             pooler_resolution=P, strides=STRIDES)

        out = jax.vmap(one)(feats, jnp.asarray(BOXES))
        return JDP.DensePoseChartPredictorOutput(*(o.reshape(-1, *o.shape[2:]) for o in out))

    def value_and_grad(feats, cot, use_decoder):
        def loss(fs):
            out = forward(fs, to_jax(hvars), to_jax(dvars), use_decoder)
            return sum(jnp.sum(o * c) for o, c in zip(out, cot)), out

        return jax.value_and_grad(loss, has_aux=True)(feats)

    return jax.jit(value_and_grad, static_argnums=2)


@pytest.mark.parametrize("route", ["decoder", "multilevel"])
def test_roi_forward_at_p28_and_its_feature_gradient_match_jax(heads, decoder, roi_reference, route):
    feats = _pyramid(11)
    use_decoder = route == "decoder"
    r = len(BATCH_IDX)
    cot = _cotangent([(r, 4 * P, 4 * P, c) for c in (2, 4, 4, 4)], 12)  # 4 P a side, K and C channels
    (_, want), jgrads = roi_reference([jnp.asarray(f) for f in feats], [jnp.asarray(c) for c in cot], use_decoder)
    tfeats = [t(f).requires_grad_() for f in feats]
    boxes = t(BOXES.reshape(-1, 4))
    assert tra.assign_levels(boxes, 4, 2).unique().tolist() == [0, 1, 2]
    out = DP.densepose_roi_forward(heads["v1convx"][3], tfeats, boxes, decoder=decoder[3] if use_decoder else None,
                                   pooler_resolution=P, strides=STRIDES, batch_idx=t(BATCH_IDX))
    assert out.fine_segm.shape == (r, 4 * P, 4 * P, 4)
    _outputs_close(out, want)
    sum(torch.sum(o * t(c)) for o, c in zip(out, cot)).backward()
    for f, g in zip(tfeats, jgrads):
        if np.abs(np.asarray(g)).max() == 0:  # a level no box pools from
            assert f.grad is None or not f.grad.any()
        else:
            _scaled(n(f.grad), np.asarray(g))


def test_single_level_gather_is_roi_align_maps():
    """The card's route for the decoder's map, K2's gather read on one level
    (its plain version here), pools as ``roi_align_maps``, the CPU's route."""
    rng = np.random.default_rng(13)
    merged = rng.normal(size=(2, 50, 40, 16)).astype(np.float32)
    boxes = (BOXES.reshape(-1, 4) * 2.5).astype(np.float32)
    got = tra.roi_align_multilevel_plain([t(merged)], t(boxes), t(BATCH_IDX), P, (4,), 2, impl="gather")
    want = tra.roi_align_maps(t(merged), t(BATCH_IDX), t(boxes), P, 0.25, sampling_ratio=2)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-5)


# --------------------------------------------------------------------------- loss and converter


def _annotations(rng, m, p, c, s_gt=16):
    ann = dict(
        x_gt=rng.uniform(0, 256, p), y_gt=rng.uniform(0, 256, p), u_gt=rng.uniform(0, 1, p),
        v_gt=rng.uniform(0, 1, p), fine_segm_labels_gt=rng.integers(0, c, p).astype(np.int32),
        point_instance=rng.integers(0, m, p).astype(np.int32), point_valid=rng.uniform(size=p) > 0.2)
    bb_gt = np.stack([rng.uniform(0, 10, m), rng.uniform(0, 10, m), rng.uniform(20, 60, m), rng.uniform(20, 60, m)], 1)
    ann.update(bbox_xywh_gt=bb_gt, bbox_xywh_est=bb_gt + rng.uniform(-4, 4, (m, 4)),
               coarse_segm_gt=rng.integers(0, 2, (m, s_gt, s_gt)).astype(np.int32),
               instance_valid=np.arange(m) < m - 1)
    return {k: (v.astype(np.float32) if v.dtype == np.float64 else v) for k, v in ann.items()}


def _chart(rng, m, s, c, k=2):
    return [rng.normal(size=(m, s, s, ch)).astype(np.float32) for ch in (k, c, c, c)]


@pytest.fixture(scope="module")
def loss_reference():
    def f(out, ann, cfg):
        losses = JDP.densepose_chart_loss(out, ann, cfg)
        return losses, jax.grad(lambda o: sum(JDP.densepose_chart_loss(o, ann, cfg).values()))(out)

    return jax.jit(f, static_argnums=2)


@pytest.mark.parametrize("k", [2, 15], ids=["coarse2", "coarse15"])
def test_chart_loss_and_its_gradient_match_jax(loss_reference, k):
    rng = np.random.default_rng(14)
    m, s, c = 4, 14, 5
    cfg = dict(num_patches=c - 1, num_coarse_segm_channels=k, heatmap_size=s)
    chart = _chart(rng, m, s, c, k)
    ann = _annotations(rng, m, 60, c)
    if k == 15:
        ann["coarse_segm_gt"] = rng.integers(0, 15, ann["coarse_segm_gt"].shape).astype(np.int32)
    want, jgrad = loss_reference(JDP.DensePoseChartPredictorOutput(*map(jnp.asarray, chart)),
                                 JDP.PackedChartAnnotations(**{k_: jnp.asarray(v) for k_, v in ann.items()}),
                                 JDP.DensePoseConfig(**cfg))
    tchart = [t(z).requires_grad_() for z in chart]
    got = DP.densepose_chart_loss(DP.DensePoseChartPredictorOutput(*tchart),
                                  DP.PackedChartAnnotations(**{k_: t(v) for k_, v in ann.items()}),
                                  DP.DensePoseConfig(**cfg))
    assert set(got) == set(want)
    for name in got:
        assert float(want[name]) != 0.0
        np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=1e-5, err_msg=name)
    sum(got.values()).backward()
    for z, g in zip(tchart, jgrad):
        _scaled(n(z.grad), np.asarray(g))


def test_chart_loss_without_valid_points_is_zero(loss_reference):
    rng = np.random.default_rng(15)
    chart = _chart(rng, 2, 6, 4)
    ann = _annotations(rng, 2, 8, 4)
    ann["point_valid"][:] = False
    cfg = dict(num_patches=3, heatmap_size=6)
    want, _ = loss_reference(JDP.DensePoseChartPredictorOutput(*map(jnp.asarray, chart)),
                             JDP.PackedChartAnnotations(**{k: jnp.asarray(v) for k, v in ann.items()}),
                             JDP.DensePoseConfig(**cfg))
    got = DP.densepose_chart_loss(DP.DensePoseChartPredictorOutput(*map(t, chart)),
                                  DP.PackedChartAnnotations(**{k: t(v) for k, v in ann.items()}),
                                  DP.DensePoseConfig(**cfg))
    for name in got:
        assert got[name].item() == float(want[name]) == 0.0


@pytest.mark.parametrize("grid", [(21, 17), (112, 112), (9, 30)])
def test_chart_result_for_grid_matches_jax(grid):
    """Labels exact (the first maximum on ties, as both argmaxes), UV 1e-5."""
    rng = np.random.default_rng(16)
    chart = _chart(rng, 3, 28, 5)
    chart[1][0, :, :8] = 1.0  # tied fine logits: the first part wins
    want = jax.jit(JDP.chart_result_for_grid, static_argnums=1)(
        JDP.DensePoseChartPredictorOutput(*map(jnp.asarray, chart)), grid)
    labels, uv = DP.chart_result_for_grid(DP.DensePoseChartPredictorOutput(*map(t, chart)), grid)
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(n(labels), np.asarray(want[0]))
    np.testing.assert_allclose(n(uv), np.asarray(want[1]), rtol=0, atol=1e-5)


# --------------------------------------------------------------------------- weights


@pytest.mark.parametrize("kind", list(HEAD_CFGS))
def test_convert_round_trip_of_the_head_and_decoder(heads, decoder, kind):
    """``module_to_flax`` gives back the JAX trees leaf for leaf: the
    transposed convs (``*_lowres``) flipped back, the GroupNorms' scale and
    bias, the ASPP's convs."""
    for _, variables, _, tm in (heads[kind], decoder):
        back = module_to_flax(tm)
        flat_back = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
        flat_want = dict(jax.tree_util.tree_flatten_with_path(variables["params"])[0])
        assert flat_back.keys() == flat_want.keys()
        for key, arr in flat_want.items():
            np.testing.assert_array_equal(flat_back[key], arr)
    assert dataclasses.asdict(DP.DensePoseConfig()) == dataclasses.asdict(JDP.DensePoseConfig())
