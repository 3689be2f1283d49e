"""Port parity of ``projects/tridentnet.py``, ``projects/tensormask.py`` and
``projects/rethinking_bn.py``, on the CPU against the JAX package.

The same numpy-seeded inputs, and the JAX variables carried by
``convert.flax_to_state_dict``, go to both packages; each JAX reference is
jitted. Bars (float32): the resample 1e-5 absolute; convs, blocks, stages
and towers 1e-4 of each output's largest magnitude; running statistics
1e-5 relative; gradients (autograd against ``jax.grad``) 1e-4 of each
gradient's largest magnitude; the branch merge's kept boxes, scores,
classes and validity exact, the padded rows included (K4's plain version
on the CPU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu.projects import rethinking_bn as JRB
from spacecraft_pose_estimation_tpu.projects import tensormask as JTM
from spacecraft_pose_estimation_tpu.projects import tridentnet as JTN
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, module_to_flax
from spacecraft_pose_estimation_tpu_torch.projects import rethinking_bn as RB
from spacecraft_pose_estimation_tpu_torch.projects import tensormask as TM
from spacecraft_pose_estimation_tpu_torch.projects import tridentnet as TN

from torch_port_util import few_threads, n, random_variables, t, to_jax  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def _scaled(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-12))


def _port(module, variables):
    module.load_state_dict(flax_to_state_dict(variables), strict=True)
    return module


def _same_tree(back, want):
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_back.keys() == flat_want.keys()
    for key, arr in flat_want.items():
        np.testing.assert_array_equal(flat_back[key], arr)


# --------------------------------------------------------------------------- TridentNet


def test_trident_conv_matches_jax_on_every_branch_and_on_one():
    x = np.random.default_rng(0).normal(size=(2, 9, 9, 4)).astype(np.float32)
    xs = np.broadcast_to(x[None], (3,) + x.shape)
    jm = JTN.TridentConv(features=6, stride=2, use_bias=True)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(xs)), seed=1)
    apply = jax.jit(jm.apply, static_argnums=2)
    tm = _port(TN.TridentConv(4, 6, 3, 2, use_bias=True), variables)
    with torch.no_grad():
        got = n(tm(t(xs)))
        one = n(tm(t(xs[1:2]), branch_idx=1))
    _scaled(got, np.asarray(apply(to_jax(variables), jnp.asarray(xs), None)))
    _scaled(one, np.asarray(apply(to_jax(variables), jnp.asarray(xs[1:2]), 1)))
    np.testing.assert_array_equal(one[0], got[1])


@pytest.mark.parametrize("stride_in_1x1", [False, True])
def test_trident_block_matches_jax(stride_in_1x1):
    xs = np.random.default_rng(2).normal(size=(3, 2, 10, 10, 8)).astype(np.float32)
    jm = JTN.TridentBottleneckBlock(out_channels=16, bottleneck_channels=4, stride=2, stride_in_1x1=stride_in_1x1)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(xs)), seed=3)
    want = np.asarray(jax.jit(jm.apply)(to_jax(variables), jnp.asarray(xs)))
    tm = _port(TN.TridentBottleneckBlock(8, 16, 4, 2, stride_in_1x1=stride_in_1x1), variables)
    with torch.no_grad():
        _scaled(n(tm(t(xs))), want)


@pytest.fixture(scope="module")
def trident_stage():
    x = jnp.zeros((2, 16, 16, 8))
    jm = JTN.TridentStage(num_blocks=3, out_channels=16, bottleneck_channels=8, stride=2)
    variables = random_variables(lambda: jm.init(jax.random.key(0), x), seed=4)
    tm = _port(TN.TridentStage(3, 8, 16, 8, 2, device="cpu"), variables)
    return variables, jax.jit(jm.apply, static_argnums=2), tm


@pytest.mark.parametrize("branch_idx", [None, 1], ids=["all", "branch1"])
def test_trident_stage_matches_jax(trident_stage, branch_idx):
    """Branch-major concatenation onto the batch axis: (3 · 2, 8, 8, 16), or
    (2, 8, 8, 16) with ``branch_idx``."""
    variables, apply, tm = trident_stage
    x = np.random.default_rng(5).normal(size=(2, 16, 16, 8)).astype(np.float32)
    want = np.asarray(apply(to_jax(variables), jnp.asarray(x), branch_idx))
    with torch.no_grad():
        got = n(tm(t(x), branch_idx))
    assert got.shape == ((2 if branch_idx is not None else 6), 8, 8, 16)
    _scaled(got, want)


def test_trident_stage_convert_round_trip(trident_stage):
    """TridentConv's raw ``kernel`` back from OIHW to HWIO, the FrozenBNs."""
    _same_tree(module_to_flax(trident_stage[2])["params"], trident_stage[0]["params"])


def _branch_detections(rng, b, nb, r):
    """Seeded padded detections of nb branches of b images, branch-major:
    jittered copies of a few objects (overlapping across branches), three
    classes, tied scores, a third of the rows padding."""
    centre = rng.uniform(20, 180, (b, 4, 2))
    obj = rng.integers(0, 4, (nb, b, r))
    size = rng.uniform(10, 60, (nb, b, r, 2))
    c = centre[np.arange(b)[None, :, None], obj] + rng.normal(0, 4, (nb, b, r, 2))
    boxes = np.concatenate([c - size / 2, c + size / 2], -1).reshape(nb * b, r, 4).astype(np.float32)
    scores = rng.choice([0.3, 0.5, 0.7, 0.9], (nb * b, r)).astype(np.float32)  # many ties
    classes = rng.integers(0, 3, (nb * b, r)).astype(np.int32)
    valid = (rng.uniform(size=(nb * b, r)) > 0.33).astype(np.float32)
    return boxes, scores, classes, valid


@pytest.mark.parametrize("topk", [5, 40], ids=["topk5", "topk_past_the_kept"])
def test_merge_branch_detections_matches_jax_in_full(topk):
    """Every output row, the padded (-inf) ones included: JAX's ``lax.top_k``
    and the port's stable sort pick the same indices."""
    boxes, scores, classes, valid = _branch_detections(np.random.default_rng(6), 2, 3, 12)
    want = jax.jit(JTN.merge_branch_detections, static_argnums=(4, 5, 6))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), jnp.asarray(valid), 3, 0.5, topk)
    got = TN.merge_branch_detections(t(boxes), t(scores), t(classes), t(valid), 3, 0.5, topk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    kept = n(got[3]).sum(1)
    if topk == 40:  # the NMS removed valid boxes: the rows past the kept ones are padding
        assert (kept < valid.reshape(3, 2, 12).sum((0, 2))).all() and not n(got[1])[:, -1].any()
    else:
        assert (kept == topk).all()


# --------------------------------------------------------------------------- TensorMask


@pytest.fixture(scope="module")
def swap_reference():
    def f(x, cot, lam):
        out, vjp = jax.vjp(lambda a: JTM.swap_align2nat(a, lam), x)
        return out, vjp(cot)[0]

    return jax.jit(f, static_argnums=2)


@pytest.mark.parametrize("lam,shape", [(1, (1, 2, 2, 4, 4)), (2, (1, 2, 2, 4, 4)), (2, (2, 3, 2, 5, 7))],
                         ids=["lam1", "lam2", "lam2_odd"])
def test_swap_align2nat_and_its_gradient_match_jax(swap_reference, lam, shape):
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape).astype(np.float32)
    out_shape = (shape[0], lam * shape[1], lam * shape[2], -(-shape[3] // lam), -(-shape[4] // lam))
    cot = rng.normal(size=out_shape).astype(np.float32)
    want, jgrad = swap_reference(jnp.asarray(x), jnp.asarray(cot), lam)
    tx = t(x).requires_grad_()
    got = TM.swap_align2nat(tx, lam)
    assert tuple(got.shape) == out_shape
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=1e-5)
    torch.sum(got * t(cot)).backward()
    _scaled(n(tx.grad), np.asarray(jgrad))


# --------------------------------------------------------------------------- Rethinking-BN


def test_cycle_batch_norm_running_stats_over_steps_match_jax():
    """Three train steps on each of two domains, interleaved: the outputs,
    each domain's running mean and UNBIASED running variance; then eval
    with each domain's own statistics."""
    rng = np.random.default_rng(8)
    xs = [(rng.normal(size=(4, 3, 3, 5)) * (1 + d) + 3 * d).astype(np.float32) for _ in range(3) for d in (0, 1)]
    jm = JRB.CycleBatchNorm(num_domains=2, features=5)
    state = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(xs[0]), 0, train=True), seed=9)
    step = jax.jit(lambda v, x, d: jm.apply(v, x, d, train=True, mutable=["batch_stats"]), static_argnums=2)
    tm = _port(RB.CycleBatchNorm(2, 5, device="cpu"), state)
    tm.train()
    state = to_jax(state)
    for i, x in enumerate(xs):
        want, upd = step(state, jnp.asarray(x), i % 2)
        state = {"params": state["params"], "batch_stats": upd["batch_stats"]}
        _scaled(n(tm(t(x), i % 2)), np.asarray(want))
    for key in ("mean", "var"):
        np.testing.assert_allclose(n(getattr(tm, key)), np.asarray(state["batch_stats"][key]), rtol=1e-5)
    tm.eval()
    evaluate = jax.jit(lambda v, x, d: jm.apply(v, x, d, train=False), static_argnums=2)
    for d in (0, 1):
        _scaled(n(tm(t(xs[d]), d)), np.asarray(evaluate(state, jnp.asarray(xs[d]), d)))


@pytest.mark.parametrize("variant", ["cycle", "shared"])
def test_bn_conv_tower_train_and_eval_match_jax(variant):
    rng = np.random.default_rng(10)
    feats = [rng.normal(size=(2, 8 >> i, 8 >> i, 4)).astype(np.float32) for i in range(3)]
    jfeats = [jnp.asarray(f) for f in feats]
    jm = JRB.BNConvTower(num_levels=3, features=8, num_convs=2, variant=variant)
    variables = random_variables(lambda: jm.init(jax.random.key(0), jfeats, train=True), seed=11)
    train = jax.jit(lambda v, f: jm.apply(v, f, train=True, mutable=["batch_stats"]))
    want, upd = train(to_jax(variables), jfeats)
    tm = _port(RB.BNConvTower(3, 4, 8, 2, variant, device="cpu"), variables)
    assert not tm.training
    assert tuple(tm.norm0.mean.shape) == ((3 if variant == "cycle" else 1), 8)
    tm.train()
    for g, w in zip(tm([t(f) for f in feats]), want):
        _scaled(n(g), np.asarray(w))
    back = module_to_flax(tm)
    for name in ("norm0", "norm1"):
        for key in ("mean", "var"):
            np.testing.assert_allclose(back["batch_stats"][name][key], np.asarray(upd["batch_stats"][name][key]),
                                       rtol=1e-5)
    tm.eval()
    state = {"params": to_jax(variables)["params"], "batch_stats": upd["batch_stats"]}
    want = jax.jit(lambda v, f: jm.apply(v, f, train=False))(state, jfeats)
    with torch.no_grad():
        for g, w in zip(tm([t(f) for f in feats]), want):
            _scaled(n(g), np.asarray(w))


def test_bn_conv_tower_convert_round_trip():
    """The per-domain (domains, C) ``batch_stats`` and the shared convs."""
    feats = [jnp.zeros((1, 8 >> i, 8 >> i, 4)) for i in range(2)]
    jm = JRB.BNConvTower(num_levels=2, features=8, num_convs=2)
    variables = random_variables(lambda: jm.init(jax.random.key(0), feats, train=True), seed=12)
    back = module_to_flax(_port(RB.BNConvTower(2, 4, 8, 2, device="cpu"), variables))
    _same_tree(back["params"], variables["params"])
    _same_tree(back["batch_stats"], variables["batch_stats"])
