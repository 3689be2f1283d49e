"""The plain reference against the port's CPU path at tiny widths: the
same weights and inputs through both, stage by stage."""

from __future__ import annotations

import json

import pytest
import torch

from pose_bench import harness
from pose_bench.reference import detector as ref_det
from pose_bench.reference import pose as ref_pose
from pose_bench.reference.nets import Detector, HRNet
from pose_bench.reference.quant import QuantHRNet, QuantTrunk, calibrate_norms
from pose_bench.tests import tiny

port = pytest.importorskip("spacecraft_pose_estimation_tpu_torch")
from spacecraft_pose_estimation_tpu_torch import pipeline, serving  # noqa: E402
from spacecraft_pose_estimation_tpu_torch.models import backbone_int8, hrnet, hrnet_int8, rcnn  # noqa: E402
from spacecraft_pose_estimation_tpu_torch.ops import heatmap, pnp, warp  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def nets():
    cfg = tiny.tiny_config("int8")
    gen = torch.Generator().manual_seed(5)
    images = ref_det.letterbox(torch.randint(0, 256, (2, 72, 96, 3), dtype=torch.uint8, generator=gen), 64)[0]
    crops = torch.randint(0, 256, (4, 64, 64, 3), generator=gen).float()
    det, net = Detector(cfg["detector"]), HRNet(cfg["landmarks"])
    harness.make_weights(det, 11, CPU)
    harness.make_weights(net, 12, CPU)
    calibrate_norms(det.backbone, det.normalize(images).permute(0, 3, 1, 2), det.backbone)
    calibrate_norms(net, ref_pose.normalize(crops), net)
    pdet = rcnn.GeneralizedRCNN(rcnn.RCNN_TINY, dtype=torch.float32, device=CPU)
    pdet.load_state_dict(det.state_dict(), strict=True)
    pnet = hrnet.HRNet(hrnet.HRNET_TINY.with_joints(11), dtype=torch.float32, device=CPU)
    pnet.load_state_dict(net.state_dict(), strict=True)
    return dict(cfg=cfg, det=det, net=net, pdet=pdet, pnet=pnet, images=images, crops=crops)


def test_detector_best_box_matches_port(nets):
    det, pdet, images = nets["det"], nets["pdet"], nets["images"]
    with torch.no_grad():
        want = rcnn.select_best_box(pdet(images), (64, 64))
        feats = det.backbone(det.normalize(images).permute(0, 3, 1, 2))
        got = ref_det.keyframe_readout(det, images, feats)
    torch.testing.assert_close(got["best"], want, atol=1e-4, rtol=0)


def test_grouped_trunk_detector_matches_port():
    """The X101 form's trunk (grouped 3x3 convs, stride on the 3x3) at tiny widths."""
    import dataclasses

    grouped = dict(groups=4, width_per_group=4, stride_in_1x1=False)
    cfg = tiny.tiny_config("bfloat16")
    cfg["detector"]["backbone"].update(grouped)
    pcfg = dataclasses.replace(rcnn.RCNN_TINY, backbone=dataclasses.replace(rcnn.RCNN_TINY.backbone, **grouped))
    gen = torch.Generator().manual_seed(7)
    images = ref_det.letterbox(torch.randint(0, 256, (2, 72, 96, 3), dtype=torch.uint8, generator=gen), 64)[0]
    det = Detector(cfg["detector"])
    harness.make_weights(det, 13, CPU)
    calibrate_norms(det.backbone, det.normalize(images).permute(0, 3, 1, 2), det.backbone)
    pdet = rcnn.GeneralizedRCNN(pcfg, dtype=torch.float32, device=CPU)
    pdet.load_state_dict(det.state_dict(), strict=True)
    with torch.no_grad():
        want = rcnn.select_best_box(pdet(images), (64, 64))
        got = ref_det.keyframe_readout(det, images, det.backbone(det.normalize(images).permute(0, 3, 1, 2)))
    torch.testing.assert_close(got["best"], want, atol=1e-4, rtol=0)


def test_letterbox_matches_port():
    frames = torch.randint(0, 256, (2, 72, 96, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(1))
    got, s1 = ref_det.letterbox(frames, 64)
    want, s2 = serving.letterbox(frames, 64)
    assert s1 == s2
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_int8_trunk_matches_port(nets):
    det, pdet, images = nets["det"], nets["pdet"], nets["images"]
    x = pdet.normalize(images)
    pdet_bf16 = rcnn.GeneralizedRCNN(rcnn.RCNN_TINY, dtype=torch.bfloat16, device=CPU)
    pdet_bf16.load_state_dict(det.state_dict())
    q = backbone_int8.quantize_backbone(rcnn.RCNN_TINY.backbone, pdet_bf16, x)
    want = backbone_int8.backbone_int8_apply(rcnn.RCNN_TINY.backbone, q, x)
    with torch.no_grad():
        got = QuantTrunk(det.backbone, x)(x)
    for k in want:  # the same integers: the features equal up to the program's bfloat16 rounding
        torch.testing.assert_close(got[k].permute(0, 2, 3, 1).to(torch.bfloat16), want[k], atol=0, rtol=0)


def test_hrnet_matches_port(nets):
    x = ref_pose.normalize(nets["crops"])
    with torch.no_grad():
        torch.testing.assert_close(nets["net"](x), nets["pnet"](x), atol=1e-5, rtol=1e-4)


def test_int8_hrnet_matches_port(nets):
    net, crops = nets["net"], nets["crops"]
    pnet_bf16 = hrnet.HRNet(hrnet.HRNET_TINY.with_joints(11), dtype=torch.bfloat16, device=CPU)
    pnet_bf16.load_state_dict(net.state_dict())
    x = pipeline.normalize_crops(crops)
    q = hrnet_int8.quantize_hrnet(pnet_bf16, x)
    want = hrnet_int8.HRNetInt8(pnet_bf16.config, q, fold_normalize=True, device=CPU)(crops)
    with torch.no_grad():
        got = QuantHRNet(net, x, (ref_pose.IMAGENET_MEAN, ref_pose.IMAGENET_STD))(crops)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_crop_decode_and_solve_match_port():
    gen = torch.Generator().manual_seed(3)
    frames = torch.randint(0, 256, (3, 72, 96, 3), dtype=torch.uint8, generator=gen)
    boxes = torch.tensor([[10.0, 8.0, 40.0, 30.0], [0.0, 0.0, 96.0, 72.0], [50.0, 40.0, 60.0, 50.0]])
    cfg = serving.SERVING_PIPELINE
    c1, s1 = ref_pose.center_scale(boxes, cfg.bbox_padding, (64, 64), (96, 96))
    c2, s2 = pipeline.boxes_to_center_scale(boxes, cfg.bbox_padding)
    s2 = warp.clamp_scales_to_window(s2, (64, 64), (96, 96), coverage=(94, 94))
    torch.testing.assert_close(s1, s2, atol=0, rtol=0)
    torch.testing.assert_close(ref_pose.crop(frames, c1, s1, (64, 64)),
                               warp.crop_and_resize(frames, c2, s2, (64, 64)), atol=0, rtol=0)
    maps = torch.randn(3, 16, 16, 11, generator=gen)
    kp1, mv1 = ref_pose.decode(maps, c1, s1)
    kp2, mv2 = heatmap.decode_heatmaps(maps, c2, s2)
    torch.testing.assert_close(kp1, kp2, atol=1e-5, rtol=0)
    torch.testing.assert_close(mv1, mv2, atol=0, rtol=0)
    world = torch.randn(11, 3, generator=gen)
    K = torch.tensor([[120.0, 0.0, 48.0], [0.0, 120.0, 36.0], [0.0, 0.0, 1.0]])
    dist = torch.tensor([0.01, -0.02, 0.001, 0.0, 0.0])
    w = ref_pose.confidence_mask(mv1, min_count=15).float()
    torch.testing.assert_close(w, pnp.adaptive_confidence_mask(mv2, min_count=15).float())
    R1, t1 = ref_pose.solve(world, kp1 * 3 + 5, K, dist, w, 5)
    R2, t2 = pnp.solve_pnp(world, kp2 * 3 + 5, K, dist, w, 5)
    torch.testing.assert_close(R1, R2, atol=1e-5, rtol=0)
    torch.testing.assert_close(t1, t2, atol=1e-4, rtol=1e-5)


def test_configs_state_what_the_port_runs():
    """Each configuration's numbers are the port preset's it names."""
    for entry in json.loads((tiny.BENCH.parent / "BENCHMARK.json").read_text())["configs"]:
        cfg = json.loads((tiny.BENCH.parent / entry["file"]).read_text())
        harness.check_preset(getattr(rcnn, cfg["program"]["detector"]), cfg["detector"], "detector")
        preset = getattr(hrnet, cfg["program"]["landmarks"]).with_joints(cfg["landmarks"]["num_joints"])
        harness.check_preset(preset, cfg["landmarks"], "landmarks")
