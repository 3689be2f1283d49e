"""Port parity of ``projects/vitdet.py`` and ``projects/mvitv2.py`` (and the
Flax-named LayerNorm and GELU of ``models/layers``), on the CPU against
the JAX package.

The same numpy-seeded inputs, and the JAX variables carried by
``convert.flax_to_state_dict``, go to both packages; each JAX reference is
jitted once per module. Bars (float32): point ops and resizes 1e-5
absolute; blocks and backbones 1e-4 of each output's largest magnitude;
gradients (autograd against ``jax.grad``) 1e-4 of each gradient's largest
magnitude; window partitions exact. Backward parity is held on one ViTDet
``Attention`` and one MViTv2 ``MultiScaleAttention``; the whole backbones'
gradients are checked on the port's side alone (finite, and nonzero for
every parameter), as the JAX package's own tests check its.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from spacecraft_pose_estimation_tpu.projects import mvitv2 as JMV
from spacecraft_pose_estimation_tpu.projects import vitdet as JVD
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, module_to_flax
from spacecraft_pose_estimation_tpu_torch.models import layers as tlayers
from spacecraft_pose_estimation_tpu_torch.models.fpn import FPN
from spacecraft_pose_estimation_tpu_torch.projects import mvitv2 as MV
from spacecraft_pose_estimation_tpu_torch.projects import vitdet as VD

from torch_port_util import few_threads, n, random_variables, t, to_jax  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

VIT_HW = 96  # a 6x6 grid: the 4x4 windows pad, the 4x4 position table is resized
MVIT_HW = 64


def _scaled(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-12))


def _port(module, variables):
    module.load_state_dict(flax_to_state_dict(variables), strict=True)
    return module


# zero in exact arithmetic: the key LayerNorm's bias adds q . b to every logit of a query's row, which the softmax
# removes; each package's value is its own rounding noise, held below the bar of the module's largest gradient
NULL_GRADS = ("attn.norm_k.bias",)


def _grads_close(named_params, jgrads, rel=1e-4):
    flat = flax_to_state_dict({"params": jax.tree_util.tree_map(np.array, jgrads)})
    assert set(flat) == set(dict(named_params))
    scale = max(np.abs(n(g)).max() for g in flat.values())
    for name, p in named_params:
        if name.endswith(NULL_GRADS):
            assert max(np.abs(n(p.grad)).max(), np.abs(n(flat[name])).max()) <= rel * scale, name
        else:
            _scaled(n(p.grad), n(flat[name]), rel)


def _grads_reach_every_parameter(module, rel=1e-4):
    """Every gradient finite and nonzero, but the NULL_GRADS leaves, which
    stay below ``rel`` of the module's largest gradient."""
    named = list(module.named_parameters())
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for _, p in named)
    scale = max(p.grad.abs().max().item() for _, p in named)
    for name, p in named:
        if name.endswith(NULL_GRADS):
            assert p.grad.abs().max().item() <= rel * scale, name
        else:
            assert p.grad.any(), name


def _same_tree(back, want):
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_back.keys() == flat_want.keys()
    for key, arr in flat_want.items():
        np.testing.assert_array_equal(flat_back[key], arr)


def _attention_grads(module):
    """jit of (output, d<output, cot>/d(params, x)) of a Flax attention module."""

    def f(params, x, cot):
        out, vjp = jax.vjp(lambda p, xx: module.apply({"params": p}, xx), params, x)
        return out, vjp(cot)

    return jax.jit(f)


# --------------------------------------------------------------------------- shared pieces


@pytest.mark.parametrize("shape", [(2, 8, 12, 5), (1, 7, 10, 3)], ids=["whole", "padded"])
def test_window_round_trip_matches_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jw, jpad = JVD.window_partition(jnp.asarray(x), 4)
    w, pad = VD.window_partition(t(x), 4)
    assert pad == jpad
    np.testing.assert_array_equal(n(w), np.asarray(jw))
    np.testing.assert_array_equal(n(VD.window_unpartition(w, 4, pad, shape[1:3])), x)


@pytest.mark.parametrize("out_hw", [(5, 9), (14, 14), (20, 6), (64, 64)])
def test_interpolate_bicubic_matches_jax(out_hw):
    """The shapes of the JAX package's bicubic oracle test, and the ViTDet-B
    position table's 14 -> 64 resize."""
    side = 14 if out_hw == (64, 64) else 10
    x = np.random.default_rng(2).normal(size=(2, side, side, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: JVD.interpolate_bicubic(a, out_hw))(jnp.asarray(x)))
    np.testing.assert_allclose(n(VD.interpolate_bicubic(t(x), out_hw)), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("q,k", [(4, 4), (16, 16), (4, 8), (8, 4)])
def test_get_rel_pos_matches_jax(q, k):
    """The table resized linearly where its length differs (15 -> 7 and 31),
    and the truncated coordinates of unequal q and k (MViTv2's pools)."""
    table = np.random.default_rng(3).normal(size=(15, 4)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: JVD.get_rel_pos(q, k, a))(jnp.asarray(table)))
    np.testing.assert_allclose(n(VD.get_rel_pos(q, k, t(table))), want, rtol=0, atol=1e-5)


def test_add_decomposed_rel_pos_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 3 * 5, 4)).astype(np.float32)
    rel_h, rel_w = rng.normal(size=(5, 4)).astype(np.float32), rng.normal(size=(9, 4)).astype(np.float32)
    attn = rng.normal(size=(2, 15, 10)).astype(np.float32)
    args = (attn, q, rel_h, rel_w)
    want = np.asarray(jax.jit(lambda *a: JVD.add_decomposed_rel_pos(*a, (3, 5), (2, 5)))(*map(jnp.asarray, args)))
    np.testing.assert_allclose(n(VD.add_decomposed_rel_pos(*map(t, args), (3, 5), (2, 5))), want, rtol=0, atol=1e-5)


def test_layer_norm_and_gelu_match_flax():
    """Flax's epsilon (1e-6), fast variance E[x^2] - E[x]^2 and tanh GELU."""
    x = (np.random.default_rng(5).normal(size=(3, 4, 16)) * 2 + 1).astype(np.float32)
    jm = fnn.LayerNorm()
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=6)
    want = np.asarray(jax.jit(jm.apply)(to_jax(variables), jnp.asarray(x)))
    np.testing.assert_allclose(n(_port(tlayers.LayerNorm(16), variables)(t(x))), want, rtol=0, atol=1e-5)
    y = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(n(tlayers.gelu(t(y))), np.asarray(jax.jit(fnn.gelu)(jnp.asarray(y))), rtol=0,
                               atol=1e-6)


# --------------------------------------------------------------------------- ViTDet


def test_vitdet_attention_and_its_gradients_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 6, 8)).astype(np.float32)
    jm = JVD.Attention(num_heads=2, use_rel_pos=True)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=8)
    cot = rng.normal(size=x.shape).astype(np.float32)
    want, (jgrads, jgx) = _attention_grads(jm)(to_jax(variables)["params"], jnp.asarray(x), jnp.asarray(cot))
    tm = _port(VD.Attention(8, 2, True, (5, 6)), variables)
    tx = t(x).requires_grad_()
    out = tm(tx)
    _scaled(n(out), np.asarray(want))
    torch.sum(out * t(cot)).backward()
    _grads_close(tm.named_parameters(), jgrads)
    _scaled(n(tx.grad), np.asarray(jgx))


@pytest.fixture(scope="module")
def vitdet():
    jm = JVD.ViTDetBackbone(config=JVD.VITDET_TINY)
    x = jnp.zeros((1, VIT_HW, VIT_HW, 3))
    variables = random_variables(lambda: jm.init(jax.random.key(0), x), seed=9)
    tm = _port(VD.ViTDetBackbone(VD.VITDET_TINY, (VIT_HW, VIT_HW), device="cpu"), variables)
    return variables, jax.jit(jm.apply), tm


def test_vitdet_backbone_matches_jax_and_feeds_the_fpn(vitdet):
    variables, apply, tm = vitdet
    x = np.random.default_rng(10).normal(size=(2, VIT_HW, VIT_HW, 3)).astype(np.float32)
    want = apply(to_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x))
    oc = VD.VITDET_TINY.out_channels
    assert {k: tuple(v.shape) for k, v in got.items()} == {f"res{i}": (2, 96 >> i, 96 >> i, oc) for i in (2, 3, 4, 5)}
    for key in got:
        _scaled(n(got[key]), np.asarray(want[key]))
    fpn = FPN({k: oc for k in got}, 16)
    tlayers.init_params(fpn, torch.Generator().manual_seed(0))
    with torch.no_grad():
        pyr = fpn({k: v.permute(0, 3, 1, 2) for k, v in got.items()})
    assert {k: tuple(v.shape[2:]) for k, v in pyr.items()} == {"p2": (24, 24), "p3": (12, 12), "p4": (6, 6),
                                                               "p5": (3, 3), "p6": (2, 2)}


def _cotangent_loss(outputs, seed):
    """<outputs, seeded cotangents>: the sum of squares of a LayerNorm's
    output hardly moves with its input, so its gradient would be rounding
    noise."""
    rng = np.random.default_rng(seed)
    return sum(torch.sum(v * t(rng.normal(size=v.shape).astype(np.float32))) for v in outputs.values())


def test_vitdet_backbone_gradients_are_finite_and_reach_every_parameter(vitdet):
    tm = vitdet[2]
    x = np.random.default_rng(11).normal(size=(1, VIT_HW, VIT_HW, 3)).astype(np.float32)
    tm.zero_grad()
    _cotangent_loss(tm(t(x)), 19).backward()
    _grads_reach_every_parameter(tm)
    assert "block0.attn.rel_pos_h" in dict(tm.named_parameters())  # windowed and global blocks both have tables
    tm.zero_grad()


def test_vitdet_convert_round_trip(vitdet):
    """The transposed convs (``up_res*``) flipped back, ``pos_embed`` and the
    rel-pos tables as they are."""
    _same_tree(module_to_flax(vitdet[2])["params"], vitdet[0]["params"])


# --------------------------------------------------------------------------- MViTv2


def test_multiscale_attention_and_its_gradients_match_jax():
    """q, k and v pooled at stride 2 on an even side (SAME pads (0, 1)), the
    rel-pos tables, residual pooling."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 8, 6, 8)).astype(np.float32)
    jm = JMV.MultiScaleAttention(dim_out=16, num_heads=2, q_stride=2, kv_stride=2, use_rel_pos=True,
                                 residual_pooling=True)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=13)
    cot = rng.normal(size=(2, 4, 3, 16)).astype(np.float32)
    want, (jgrads, jgx) = _attention_grads(jm)(to_jax(variables)["params"], jnp.asarray(x), jnp.asarray(cot))
    tm = _port(MV.MultiScaleAttention(8, 16, 2, 2, 2, True, True, (8, 6)), variables)
    tx = t(x).requires_grad_()
    out = tm(tx)
    _scaled(n(out), np.asarray(want))
    torch.sum(out * t(cot)).backward()
    _grads_close(tm.named_parameters(), jgrads)
    _scaled(n(tx.grad), np.asarray(jgx))


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)], ids=["even", "odd"])
def test_transition_block_matches_jax(hw):
    """The stage transition: q pooled at stride 2 (SAME), the normed input
    projected on the shortcut and max-pooled (3x3, stride 2, padding 1)."""
    x = np.random.default_rng(14).normal(size=(2, *hw, 8)).astype(np.float32)
    jm = JMV.MultiScaleBlock(dim_out=16, num_heads=2, q_stride=2, kv_stride=1, mlp_ratio=2.0, use_rel_pos=True,
                             residual_pooling=True)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=15)
    want = np.asarray(jax.jit(jm.apply)(to_jax(variables), jnp.asarray(x)))
    tm = _port(MV.MultiScaleBlock(8, 16, 2, 2, 1, 2.0, True, True, hw), variables)
    with torch.no_grad():
        got = n(tm(t(x)))
    assert got.shape == (2, -(-hw[0] // 2), -(-hw[1] // 2), 16)
    _scaled(got, want)


@pytest.fixture(scope="module")
def mvit():
    jm = JMV.MViTv2Backbone(config=JMV.MVITV2_TINY)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.zeros((1, MVIT_HW, MVIT_HW, 3))), seed=16)
    tm = _port(MV.MViTv2Backbone(MV.MVITV2_TINY, (MVIT_HW, MVIT_HW), device="cpu"), variables)
    return variables, jax.jit(jm.apply), tm


def test_mvitv2_backbone_matches_jax(mvit):
    variables, apply, tm = mvit
    x = np.random.default_rng(17).normal(size=(2, MVIT_HW, MVIT_HW, 3)).astype(np.float32)
    want = apply(to_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x))
    d = MV.MVITV2_TINY.embed_dim
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        f"res{i + 2}": (2, 16 >> i, 16 >> i, d << i) for i in range(4)}
    for key in got:
        _scaled(n(got[key]), np.asarray(want[key]))


def test_mvitv2_backbone_gradients_are_finite_and_reach_every_parameter(mvit):
    tm = mvit[2]
    x = np.random.default_rng(18).normal(size=(1, MVIT_HW, MVIT_HW, 3)).astype(np.float32)
    tm.zero_grad()
    _cotangent_loss(tm(t(x)), 20).backward()
    _grads_reach_every_parameter(tm)
    tm.zero_grad()


def test_mvitv2_convert_round_trip(mvit):
    """The depthwise pools' (3, 3, 1, C) kernels back from OIHW."""
    _same_tree(module_to_flax(mvit[2])["params"], mvit[0]["params"])
