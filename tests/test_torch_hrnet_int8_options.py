"""Port parity of the int8 HRNet's options (``models/hrnet_int8.py``) against JAX.

``HRNET_TINY`` with 5 joints and numpy-seeded weights and BN statistics, as
``test_torch_hrnet_int8.py``.

* ``quantize_hrnet(s2d=True)``: the port's tree on the bridged float model
  against the JAX one: the same keys, the packed twins (``convs_s2d``,
  ``final_s2d``) bit-equal in their int8 weights and within rtol 1e-5 in
  their requant vectors (two float forwards calibrate them); the 'alt'
  scheme's packs of one tree equal JAX's exactly; the s2d site tables equal.
* Each option (``s2d`` in both schemes, ``fused_even3``, ``merge_fuse``,
  ``fold_residual``, ``fold_fuse_up``) of ``HRNetInt8`` on the JAX tree
  (``convert.quantized_to_torch``) against ``hrnet_int8_apply`` with the
  same flags, at ``test_walk_matches_jax``'s bar (atol 2e-2, rtol 1e-3: the
  bf16 stem conv sums in another order).
* On the port's own tree, ``s2d``, ``s2d + fused_even3`` and ``merge_fuse``
  are bit-equal to its per-op walk, as the JAX package asserts for itself;
  the merge fires (fewer K5a calls, one with a clip per family), even3
  reaches K5 on the packed map, and the documented fall-throughs (merge
  under s2d or fold, even3 without s2d) run the routes JAX runs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu import pipeline as jpipe
from spacecraft_pose_estimation_tpu.models import hrnet_int8 as jhi
from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu.models.hrnet import POSE_HRNET_W32 as J_W32
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, quantized_to_torch
from spacecraft_pose_estimation_tpu_torch.models import hrnet_int8 as thi
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, POSE_HRNET_W32, HRNet
from spacecraft_pose_estimation_tpu_torch.ops import int8_blocks, int8_conv

from torch_port_util import few_threads, n, random_variables, t, to_jax  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

J = 5
S2D_KEYS = ("convs_s2d", "final_s2d")


@pytest.fixture(scope="module")
def tiny():
    jmodel = JHRNet(config=J_TINY.with_joints(J))
    variables = random_variables(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False), seed=5,
        overrides={"final_layer": 0.1})
    rng = np.random.default_rng(6)
    calib = rng.normal(0, 1.0, (2, 64, 64, 3)).astype(np.float32)
    jq_s2d = jhi.quantize_hrnet(jmodel, to_jax(variables), jnp.asarray(calib), s2d=True)
    jq = {k: v for k, v in jq_s2d.items() if k not in S2D_KEYS}
    tmodel = HRNet(HRNET_TINY.with_joints(J), device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(variables))
    raw = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    return dict(jmodel=jmodel, calib=calib, jq=jq, jq_s2d=jq_s2d, tmodel=tmodel, raw=raw,
                x=np.asarray(jpipe.normalize_crops(jnp.asarray(raw))),
                q=quantized_to_torch(jax.tree_util.tree_map(np.asarray, jq)),
                q_s2d=quantized_to_torch(jax.tree_util.tree_map(np.asarray, jq_s2d)))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("cfgs", [(HRNET_TINY, J_TINY), (POSE_HRNET_W32, J_W32)], ids=["tiny", "w32"])
def test_s2d_sites_match_jax(cfgs):
    assert thi._s2d_sites(cfgs[0]) == jhi._s2d_sites(cfgs[1])


def test_quantize_s2d_matches_jax(tiny):
    got = dict(_leaves(thi.quantize_hrnet(tiny["tmodel"], t(tiny["calib"]), s2d=True)))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, tiny["jq_s2d"])))
    assert set(got) == set(want) and any(p[0] == "convs_s2d" for p in want) and ("final_s2d", "w8p") in want
    for path, w in want.items():
        if path[0] not in S2D_KEYS:
            continue  # the std tree: test_torch_hrnet_int8.py::test_quantize_matches_jax
        if path[-1] == "w8p":
            np.testing.assert_array_equal(n(got[path]), w, err_msg="/".join(path))
        else:
            np.testing.assert_allclose(n(got[path]), np.asarray(w, np.float32), rtol=1e-5, atol=1e-7,
                                       err_msg="/".join(path))


def test_s2d_pack_alt_matches_jax(tiny):
    """The 2x2 'alt' scheme's packs of one tree: exactly JAX's."""
    want = jax.tree_util.tree_map(np.asarray, jhi.s2d_pack_quantized(tiny["jq"], J_TINY.with_joints(J), "alt"))
    got = thi.s2d_pack_quantized(tiny["q"], HRNET_TINY.with_joints(J), "alt")
    for key in S2D_KEYS:
        g, w = dict(_leaves(got[key])), dict(_leaves(want[key]))
        assert set(g) == set(w)
        for path in w:
            np.testing.assert_array_equal(n(g[path]), w[path], err_msg=f"{key}/{'/'.join(path)}")
    assert {tuple(v["w8p"].shape[:2]) for v in got["convs_s2d"].values()} == {(4, 4), (2, 2)}


OPTIONS = {  # port flags, JAX flags, tree ('s2d' even3 twins, 'alt' 2x2 twins, 'std' none)
    "s2d": ({"s2d": True}, {"s2d": True}, "s2d"),
    "s2d_alt": ({"s2d": True}, {"s2d": True}, "alt"),
    "fused_even3": ({"s2d": True, "fused_even3": True}, {"s2d": True, "fused_even3": True}, "s2d"),
    "merge_fuse": ({"merge_fuse": True}, {"merge_fuse": True}, "std"),
    "fold_residual": ({"fold_residual": True}, {"fold_residual": True}, "std"),
    "fold_fuse_up": ({"fold_residual": True, "fold_fuse_up": True}, {"fold_residual": True, "fold_fuse_up": True},
                     "std"),
    "s2d_fold_fuse_up": ({"s2d": True, "fold_residual": True, "fold_fuse_up": True},
                         {"s2d": True, "fold_residual": True, "fold_fuse_up": True}, "s2d"),
}


def _trees(tiny, kind):
    """(port tree, JAX tree) of kind 's2d', 'alt' or 'std'."""
    if kind == "alt":
        return (thi.s2d_pack_quantized(tiny["q"], HRNET_TINY.with_joints(J), "alt"),
                jhi.s2d_pack_quantized(tiny["jq"], J_TINY.with_joints(J), "alt"))
    return (tiny["q_s2d"], tiny["jq_s2d"]) if kind == "s2d" else (tiny["q"], tiny["jq"])


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_matches_jax(tiny, option):
    port_flags, jax_flags, kind = OPTIONS[option]
    q, jq = _trees(tiny, kind)
    want = np.asarray(jhi.hrnet_int8_apply(J_TINY.with_joints(J), jq, jnp.asarray(tiny["x"]), **jax_flags))
    got = n(thi.HRNetInt8(HRNET_TINY.with_joints(J), q, device="cpu", **port_flags)(t(tiny["x"])))
    assert got.shape == want.shape == (2, 16, 16, J)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-3)


def test_fold_normalize_with_s2d_matches_jax(tiny):
    """The served form: raw crops, stem1's folded weights, branch 0 packed."""
    want = np.asarray(jhi.hrnet_int8_apply(J_TINY.with_joints(J), tiny["jq_s2d"], jnp.asarray(tiny["raw"]),
                                           s2d=True, fold_normalize=True))
    model = thi.HRNetInt8(HRNET_TINY.with_joints(J), tiny["q_s2d"], fold_normalize=True, device="cpu")
    assert model.s2d  # on by default with the packed twins in the tree, as in JAX
    np.testing.assert_allclose(n(model(t(tiny["raw"]))), want, atol=2e-2, rtol=1e-3)


class Calls:
    """Count calls of int8_conv.int8_conv (with and without a clip) and of
    int8_blocks.basic_block_chain (by the channels of its input)."""

    def __init__(self, monkeypatch):
        self.convs, self.clipped, self.chains = 0, 0, []
        conv, chain = int8_conv.int8_conv, int8_blocks.basic_block_chain

        def counting_conv(*args, **kwargs):
            self.convs += 1
            self.clipped += kwargs.get("lo") is not None
            return conv(*args, **kwargs)

        def counting_chain(x, *args, **kwargs):
            self.chains.append(x.shape[-1])
            return chain(x, *args, **kwargs)

        monkeypatch.setattr(int8_conv, "int8_conv", counting_conv)
        monkeypatch.setattr(int8_blocks, "basic_block_chain", counting_chain)


def _run(tiny, q, monkeypatch, **flags):
    calls = Calls(monkeypatch)
    out = thi.HRNetInt8(HRNET_TINY.with_joints(J), q, device="cpu", **flags)(t(tiny["x"]))
    monkeypatch.undo()
    return out, calls


@pytest.mark.parametrize("flags", [{"s2d": True}, {"s2d": True, "fused_even3": True},
                                   {"s2d": False, "merge_fuse": True},
                                   {"s2d": True, "fused_blocks": True, "fused_even3": True, "fuse_exchange": True}],
                         ids=["s2d", "s2d_even3", "merge_fuse", "s2d_even3_fused"])
def test_bit_equal_to_per_op_walk(tiny, flags, monkeypatch):
    """The lane packings change no int8 value: bit-equal to the port's own
    per-op walk on the port's own s2d tree."""
    q = thi.quantize_hrnet(tiny["tmodel"], t(tiny["calib"]), s2d=True)
    walk, per_op = _run(tiny, q, monkeypatch, s2d=False)
    got, calls = _run(tiny, q, monkeypatch, **flags)
    assert torch.equal(got, walk)
    assert per_op.chains == [] and per_op.clipped == 0
    if flags.get("merge_fuse"):
        # HRNET_TINY's families of two: stage3's {up0_2, up1_2} and {down1_0_0, down2_0_0} (stage2 has
        # one of each, the last stage's single output one up per branch), one clipped K5a launch each
        assert calls.clipped == 2 and calls.convs == per_op.convs - 2
    if flags.get("fused_even3"):
        c0 = HRNET_TINY.stage2.num_channels[0]
        # one K5 launch a module on branch 0's packed map (4C channels) in place of its 2 x blocks convs
        assert calls.chains.count(4 * c0) >= 3 and calls.convs < per_op.convs


def test_documented_fall_throughs(tiny, monkeypatch):
    """As the JAX walk: merge_fuse under s2d or fold_residual re-routes
    nothing (the same calls and heatmaps as without it); fused_even3
    without s2d runs no packed chain; s2d on a tree without packed twins
    is refused."""
    for base in ({"s2d": True}, {"s2d": False, "fold_residual": True}):
        want, plain = _run(tiny, tiny["q_s2d"], monkeypatch, **base)
        got, merged = _run(tiny, tiny["q_s2d"], monkeypatch, merge_fuse=True, **base)
        assert torch.equal(got, want) and merged.convs == plain.convs and merged.clipped == 0
    want, _ = _run(tiny, tiny["q"], monkeypatch)
    got, calls = _run(tiny, tiny["q"], monkeypatch, fused_even3=True)
    assert torch.equal(got, want) and calls.chains == []
    with pytest.raises(ValueError, match="packed twins"):
        thi.HRNetInt8(HRNET_TINY.with_joints(J), tiny["q"], device="cpu", s2d=True)


def test_fold_within_the_jax_bars_of_the_walk(tiny):
    """fold_residual (+ fold_fuse_up) skips one rounding: the JAX package's
    bars against the per-op walk (tests/test_hrnet_int8.py:249-253)."""
    ref = n(tiny["tmodel"](t(tiny["x"])))
    scale = np.abs(ref).max() + 1e-9
    walk = n(thi.HRNetInt8(HRNET_TINY.with_joints(J), tiny["q"], device="cpu")(t(tiny["x"])))
    for flags in ({"fold_residual": True}, {"fold_residual": True, "fold_fuse_up": True}):
        fold = n(thi.HRNetInt8(HRNET_TINY.with_joints(J), tiny["q"], device="cpu", **flags)(t(tiny["x"])))
        assert not np.array_equal(fold, walk)
        assert np.abs(fold - walk).max() / scale < 0.1
        assert np.corrcoef(fold.ravel(), walk.ravel())[0, 1] > 0.995
