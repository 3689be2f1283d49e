"""The K-major weights of the int8 tensor-core kernels (K5a, K5, K6, K7).

The kernels multiply on the int8 tensor cores, which read both operands
K-major, so every int8 site also holds its weights as (Cout, k, k, Cin)
(``w8k`` beside the HWIO ``w8``), packed once when the model is built. The
public functions and the plain versions keep the JAX package's HWIO
layout; on CUDA tensors the wrappers require the packed copy and raise
without it, before any launch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spacecraft_pose_estimation_tpu_torch import pipeline, serving
from spacecraft_pose_estimation_tpu_torch.models import backbone_int8, hrnet, hrnet_int8, rcnn
from spacecraft_pose_estimation_tpu_torch.ops import int8_blocks, int8_conv

J = 5


def hwio_transposed(w8: torch.Tensor) -> torch.Tensor:
    """(..., k, k, cin, cout) -> (..., cout, k, k, cin), written out index by index."""
    return torch.einsum("...hwio->...ohwi", w8)


@pytest.mark.parametrize("shape", [(3, 3, 8, 12), (1, 1, 16, 4), (7, 7, 3, 8), (2, 2, 3, 3, 8, 8),
                                   (4, 3, 3, 64, 64), (4, 1, 1, 64, 256), (1, 1, 256, 32)],
                         ids=["3x3", "1x1", "7x7", "chain", "layer1-conv2", "layer1-conv3", "exchange-up"])
def test_pack_round_trips(shape):
    w = torch.from_numpy(np.random.default_rng(0).integers(-127, 128, shape).astype(np.int8))
    wk = int8_conv.pack_kmajor(w)
    assert wk.is_contiguous() and wk.shape == shape[:-4] + (shape[-1],) + shape[-4:-1]
    torch.testing.assert_close(wk, torch.einsum("...hwio->...ohwi", w), rtol=0, atol=0)
    torch.testing.assert_close(int8_conv.unpack_kmajor(wk), w, rtol=0, atol=0)


def test_with_kmajor_packs_every_site_once():
    w = torch.ones(3, 3, 4, 8, dtype=torch.int8)
    tree = {"convs": {"a": {"w8": w, "m": torch.ones(8)}}, "final": {"w8": w[:1, :1]}, "scale": 0.5}
    packed = int8_conv.with_kmajor(tree)
    assert packed["convs"]["a"]["w8k"].shape == (8, 3, 3, 4) and packed["final"]["w8k"].shape == (8, 1, 1, 4)
    assert packed["convs"]["a"]["w8"] is w and packed["scale"] == 0.5 and "w8k" not in tree["convs"]["a"]
    assert int8_conv.with_kmajor(packed)["convs"]["a"]["w8k"] is packed["convs"]["a"]["w8k"]


def assert_bottleneck_kmajor(wk, w1, w2, w3, wd):
    """K6's K-major copies hold every block's HWIO weights: w1k each
    block's (Cm, Cin) in turn at its own Cin, the others as pack_kmajor."""
    w1k, w2k, w3k, wdk = wk
    nblocks, cm = w2.shape[0], w2.shape[-1]
    cin0, cout = wd.shape
    assert all(t.is_contiguous() for t in wk)
    assert w1k.shape == (cm * (cin0 + (nblocks - 1) * cout),)
    off = 0
    for blk in range(nblocks):
        cin = cin0 if blk == 0 else cout
        part = w1k[off:off + cm * cin].reshape(cm, 1, 1, cin)
        torch.testing.assert_close(int8_conv.unpack_kmajor(part)[0, 0], w1[blk, :cin], rtol=0, atol=0)
        assert not w1[blk, cin:].any()  # only zero padding is left out
        off += cm * cin
    torch.testing.assert_close(w2k, hwio_transposed(w2), rtol=0, atol=0)
    torch.testing.assert_close(int8_conv.unpack_kmajor(w3k)[:, 0, 0], w3, rtol=0, atol=0)
    torch.testing.assert_close(int8_conv.unpack_kmajor(wdk)[0, 0], wd, rtol=0, atol=0)


@pytest.mark.parametrize("nblocks,cin0,cm,cout", [(1, 8, 8, 32), (3, 16, 16, 64), (4, 64, 64, 256)],
                         ids=["tiny", "test", "w32"])
def test_bottleneck_kmajor_round_trips(nblocks, cin0, cm, cout):
    rng = np.random.default_rng(5)
    i8 = lambda *s: torch.from_numpy(rng.integers(-127, 128, s).astype(np.int8))  # noqa: E731
    w1 = torch.zeros(nblocks, max(cin0, cout) if nblocks > 1 else cin0, cm, dtype=torch.int8)
    w1[0, :cin0] = i8(cin0, cm)
    for blk in range(1, nblocks):
        w1[blk, :cout] = i8(cout, cm)
    w2, w3, wd = i8(nblocks, 3, 3, cm, cm), i8(nblocks, cm, cout), i8(cin0, cout)
    assert_bottleneck_kmajor(int8_blocks.pack_bottleneck_kmajor(w1, w2, w3, wd), w1, w2, w3, wd)


@pytest.fixture(scope="module")
def tiny_models():
    det = rcnn.GeneralizedRCNN(rcnn.RCNN_TINY, device="cpu", generator=torch.Generator().manual_seed(0))
    hr = hrnet.HRNet(dataclasses.replace(hrnet.HRNET_TINY, num_joints=J), device="cpu",
                     generator=torch.Generator().manual_seed(1))
    calib = torch.from_numpy(np.random.default_rng(2).integers(0, 255, (2, 64, 64, 3)).astype(np.float32))
    qb = backbone_int8.quantize_backbone(det.config.backbone, det, det.normalize(calib))
    qh = hrnet_int8.quantize_hrnet(hr, pipeline.normalize_crops(calib))
    return det, hr, qb, qh


def test_hrnet_int8_holds_kmajor_copies(tiny_models):
    _, hr, _, qh = tiny_models
    model = hrnet_int8.HRNetInt8(hr.config, qh, fused_blocks=True, device="cpu")
    sites = [site for site in (*model.q["convs"].values(), model.q["final"]) if "w8" in site]
    assert all("w8k" not in site for site in qh["convs"].values())  # the quantizer's tree is the JAX one
    for site in sites:
        torch.testing.assert_close(site["w8k"], hwio_transposed(site["w8"]), rtol=0, atol=0)
    assert len(sites) == len(qh["convs"])  # every conv but the bf16 stem1, and the head


def test_chain_params_hold_kmajor_copies(tiny_models):
    _, hr, _, qh = tiny_models
    nblocks = hr.config.stage2.num_blocks[0]
    w, m, b, coeffs, wk = int8_blocks.chain_params_from_q(qh, "stage2_m0", 0, nblocks)
    assert wk.shape == (nblocks, 2, w.shape[-1], 3, 3, w.shape[-2]) and wk.is_contiguous()
    for blk in range(nblocks):
        for j, part in enumerate(("conv1", "conv2")):
            site = qh["convs"][f"stage2_m0/branch0/block{blk}/{part}"]
            torch.testing.assert_close(wk[blk, j], hwio_transposed(site["w8"]), rtol=0, atol=0)


def test_layer1_pack_and_exchange_operands_hold_kmajor_copies(tiny_models):
    """The layer1 operands that HRNetInt8 packs at its first fused call and
    keeps, and the exchange operands it hands K7, carry the K-major copies."""
    _, hr, _, qh = tiny_models
    model = hrnet_int8.HRNetInt8(hr.config, qh, fused_blocks=True, fuse_exchange=True, device="cpu")
    crops = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 64, 64, 3)).astype(np.float32))
    model(crops)
    p = model._packed[("layer1",)]
    assert model.packed(("layer1",), lambda: None) is p  # packed once, then kept
    assert_bottleneck_kmajor(p["wk"], p["w1"], p["w2"], p["w3"], p["wd"])
    ys = [torch.zeros(1, 16 // 2**j, 16 // 2**j, w, dtype=torch.int8) for j, w in enumerate((4, 8, 16))]
    ups, _, wks = int8_blocks.up_exchange_operands(model.q, "stage3_m0", 0, ys)
    assert len(wks) == len(ups) == 2
    for (_, w, _, _), wk in zip(ups, wks):
        torch.testing.assert_close(wk, hwio_transposed(w[None, None]), rtol=0, atol=0)


def test_int8_backbone_holds_kmajor_copies(tiny_models):
    det, hr, qb, _ = tiny_models
    cfg = pipeline.PipelineConfig(image_size=(64, 64), solver="gn", refine_iters=2, crop_window=(112, 112))
    server = serving.PoseServer(det, hr, np.zeros((J, 3), np.float32), np.eye(3, dtype=np.float32),
                                np.zeros(5, np.float32), cfg, det_size=64, backbone_q=qb)
    convs = server.backbone_q["convs"]
    assert set(convs) == set(qb["convs"]) and server.backbone_q["feature_scales"] == qb["feature_scales"]
    for site in convs.values():
        torch.testing.assert_close(site["w8k"], hwio_transposed(site["w8"]), rtol=0, atol=0)


def test_wrappers_raise_without_the_packed_weights():
    """A call bound for the card without ``wk`` raises before any launch
    (meta tensors stand in for CUDA ones here)."""
    meta = torch.device("meta")
    i8 = lambda *s: torch.zeros(*s, dtype=torch.int8, device=meta)  # noqa: E731
    f32 = lambda *s: torch.zeros(*s, device=meta)  # noqa: E731
    with pytest.raises(ValueError, match="K-major weights wk"):
        int8_conv.int8_conv(i8(1, 4, 4, 16), i8(3, 3, 16, 32), f32(32), f32(32))
    with pytest.raises(ValueError, match="K-major weights wk"):
        int8_blocks.basic_block_chain(i8(1, 4, 4, 16), i8(1, 2, 3, 3, 16, 16), f32(1, 2, 16), f32(1, 2, 16),
                                      f32(1, 2), 1)
    with pytest.raises(ValueError, match="K-major weights wk"):
        int8_blocks.bottleneck_chain(i8(1, 4, 4, 16), i8(1, 16, 16), f32(1, 16), f32(1, 16), i8(1, 3, 3, 16, 16),
                                     f32(1, 16), f32(1, 16), i8(1, 16, 64), f32(1, 64), f32(1, 64), i8(16, 64),
                                     f32(64), f32(64), f32(1, 2), 1, strip=32)
    with pytest.raises(ValueError, match="K-major weights wks"):
        int8_blocks.up_exchange(i8(1, 4, 4, 16), [], [(i8(1, 2, 2, 32), i8(32, 16), f32(16), f32(16))], f32(2))


def test_plain_versions_ignore_the_packed_weights():
    """On CPU tensors the wrappers compute from the HWIO weights, with or
    without ``wk``."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-60, 60, (1, 6, 5, 16)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-60, 60, (3, 3, 16, 8)).astype(np.int8))
    m, b = torch.full((8,), 1e-3), torch.zeros(8)
    want = int8_conv.int8_conv_plain(x, w, m, b, relu=True)
    got = int8_conv.int8_conv(x, w, m, b, relu=True, wk=int8_conv.pack_kmajor(w))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # K6: layer1, one block with its projection 16 -> 32
    w1, w2 = w[:1, 0, :, :8].reshape(1, 16, 8), w[None, :, :, :8, :8].contiguous()
    w3 = torch.from_numpy(rng.integers(-60, 60, (1, 8, 32)).astype(np.int8))
    wd = torch.from_numpy(rng.integers(-60, 60, (16, 32)).astype(np.int8))
    m8, b8, m32, b32 = m[None], b[None], torch.full((1, 32), 1e-3), torch.zeros(1, 32)
    ops = (w1, m8, b8, w2, m8, b8, w3, m32, b32, wd, m32[0], b32[0], torch.ones(1, 2))
    want = int8_blocks.bottleneck_chain_plain(x, *ops, 1)
    got = int8_blocks.bottleneck_chain(x, *ops, 1, wk=int8_blocks.pack_bottleneck_kmajor(w1, w2, w3, wd))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # K7: one output with an up operand at f = 2
    yi = torch.from_numpy(rng.integers(-60, 60, (1, 6, 4, 8)).astype(np.int8))
    u = torch.from_numpy(rng.integers(-60, 60, (1, 3, 2, 16)).astype(np.int8))
    ups, coeffs = [(u, w[0, 0], m, b)], torch.tensor([0.5, 0.7])
    want = int8_blocks.up_exchange_plain(yi, [], ups, coeffs)
    got = int8_blocks.up_exchange(yi, [], ups, coeffs, wks=[int8_conv.pack_kmajor(w[:1, :1])])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
