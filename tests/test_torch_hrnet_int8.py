"""Port parity of the int8 HRNet (``models/hrnet_int8.py``) against JAX.

``HRNET_TINY`` with 5 joints and numpy-seeded weights and BN statistics.

* Quantization: the port's ``quantize_hrnet`` on the bridged float model
  against the JAX one on the same weights and calibration crops. The site
  tables (scale names) and the tree's keys are identical and the int8
  weights bit-equal; the scales, m, b and coeffs come from two float
  forwards that sum in different orders, so they agree to rtol 1e-5.
* The walk: the port's ``HRNetInt8`` on the JAX tree (bridged with
  ``convert.quantized_to_torch``) against ``hrnet_int8_apply``, per-op and
  fused (K5, K6, and K7 through ``_SPE_FUSE_EXCHANGE=1`` on the JAX side),
  with the normalize folded in or not. Every int8 site equals its JAX site;
  only the bf16 stem conv sums in another order, which can move a stem
  output by one int8 step, and the JAX fused kernels may round a tie the
  other way. Bound: heatmaps within 2e-2 + 1e-3 relative, the JAX
  package's own bound for its fused walk against the per-op one
  (``tests/test_pallas_blocks.py:225``); most cases are bit-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacecraft_pose_estimation_tpu import pipeline as jpipe
from spacecraft_pose_estimation_tpu.models import hrnet_int8 as jhi
from spacecraft_pose_estimation_tpu.models.hrnet import HRNET_TINY as J_TINY, HRNet as JHRNet
from spacecraft_pose_estimation_tpu_torch.convert import flax_to_state_dict, quantized_to_torch
from spacecraft_pose_estimation_tpu_torch.models import hrnet_int8 as thi
from spacecraft_pose_estimation_tpu_torch.models.hrnet import HRNET_TINY, HRNet

from torch_port_util import n, random_variables, t, to_jax

J = 5


@pytest.fixture(scope="module")
def tiny():
    jmodel = JHRNet(config=J_TINY.with_joints(J))
    variables = random_variables(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False), seed=5,
        overrides={"final_layer": 0.1})
    rng = np.random.default_rng(6)
    calib = rng.normal(0, 1.0, (2, 64, 64, 3)).astype(np.float32)
    jq = jhi.quantize_hrnet(jmodel, to_jax(variables), jnp.asarray(calib))
    tmodel = HRNet(HRNET_TINY.with_joints(J), device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(variables))
    return dict(jmodel=jmodel, variables=variables, calib=calib, jq=jq,
                jq_np=jax.tree_util.tree_map(np.asarray, jq), tmodel=tmodel, rng=rng)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_scale_sites_match_jax(tiny):
    """Forward hooks name every site as the JAX package's captured intermediates."""
    want = jhi._collect_scales(tiny["jmodel"], to_jax(tiny["variables"]), jnp.asarray(tiny["calib"]))
    got = thi._collect_scales(tiny["tmodel"], t(tiny["calib"]))
    assert set(got) == set(want)
    np.testing.assert_allclose([got[k] for k in sorted(want)], [want[k] for k in sorted(want)], rtol=1e-5)


def test_quantize_matches_jax(tiny):
    got = dict(_leaves(thi.quantize_hrnet(tiny["tmodel"], t(tiny["calib"]))))
    want = dict(_leaves(tiny["jq_np"]))
    assert set(got) == set(want)
    for path, w in want.items():
        g = n(got[path].float()) if got[path].dtype == torch.bfloat16 else n(got[path])
        if path[-1] == "w8":
            np.testing.assert_array_equal(g, w, err_msg="/".join(path))
        elif path[-1] == "w_bf16":  # bf16 of the same f32 weights
            np.testing.assert_array_equal(g, np.asarray(w, np.float32), err_msg="/".join(path))
        else:
            np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=1e-5, atol=1e-7, err_msg="/".join(path))


WALKS = {  # port flags, JAX flags, input size
    "per_op": ({}, {"fused_blocks": False}, 64),
    "fused": ({"fused_blocks": True, "fuse_exchange": True}, {"fused_blocks": True}, 64),
    "min_width": ({"fused_min_width": 8}, {"fused_min_width": 8}, 64),
    # the JAX strips kernel leaves the walk in the image's edge rows
    # (test_torch_int8_blocks.py), so the port's K6s route, which follows
    # the walk, is held to the JAX per-op walk
    "layer1_strips": ({"layer1_strips": True}, {"fused_blocks": False}, 128),
}


@pytest.mark.parametrize("walk,fold", [("per_op", False), ("per_op", True), ("fused", False), ("fused", True),
                                       ("min_width", False), ("layer1_strips", False)])
def test_walk_matches_jax(tiny, walk, fold, monkeypatch):
    port_flags, jax_flags, size = WALKS[walk]
    monkeypatch.setenv("_SPE_FUSE_EXCHANGE", "1")
    raw = tiny["rng"].uniform(0, 255, (2, size, size, 3)).astype(np.float32)
    x = raw if fold else np.asarray(jpipe.normalize_crops(jnp.asarray(raw)))
    want = np.asarray(jhi.hrnet_int8_apply(J_TINY.with_joints(J), tiny["jq"], jnp.asarray(x),
                                           fold_normalize=fold, **jax_flags))
    model = thi.HRNetInt8(HRNET_TINY.with_joints(J), quantized_to_torch(tiny["jq_np"]), fold_normalize=fold,
                          device="cpu", **port_flags)
    assert model.consumes_raw_pixels == fold
    got = n(model(t(x)))
    assert got.shape == want.shape == (2, size // 4, size // 4, J)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-3)


def test_fused_routes_run_their_kernels(tiny):
    """With every fused flag on, the walk hands K5, K6 and K7 their sites:
    the plain versions are reached through the kernel wrappers."""
    from spacecraft_pose_estimation_tpu_torch.ops import int8_blocks

    model = thi.HRNetInt8(HRNET_TINY.with_joints(J), quantized_to_torch(tiny["jq_np"]), fused_blocks=True,
                          layer1_strips=True, fuse_exchange=True, device="cpu")
    calls = {"chain": 0, "bottleneck": 0, "exchange": 0}
    originals = {k: getattr(int8_blocks, f) for k, f in (("chain", "basic_block_chain"),
                                                         ("bottleneck", "bottleneck_chain"),
                                                         ("exchange", "up_exchange"))}

    def counting(key):
        def call(*args, **kwargs):
            calls[key] += 1
            return originals[key](*args, **kwargs)
        return call

    mp = pytest.MonkeyPatch()
    for key, name in (("chain", "basic_block_chain"), ("bottleneck", "bottleneck_chain"), ("exchange", "up_exchange")):
        mp.setattr(int8_blocks, name, counting(key))
    try:
        model(t(tiny["rng"].normal(size=(1, 64, 64, 3)).astype(np.float32)))
    finally:
        mp.undo()
    # HRNET_TINY: 1 + 1 + 1 modules of 2, 3, 4 branches; exchanges 2 + 3 + 1
    assert calls == {"chain": 9, "bottleneck": 1, "exchange": 6}


@pytest.mark.parametrize("flag", ["s2d", "merge_fuse", "fold_residual", "fold_fuse_up", "fused_even3"])
def test_unported_flags_raise(tiny, flag):
    with pytest.raises(NotImplementedError, match=flag):
        thi.HRNetInt8(HRNET_TINY.with_joints(J), {}, device="cpu", **{flag: True})
