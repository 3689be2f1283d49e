"""Models of the port: the landmark nets, the domain discriminator, the detectors (Faster, Mask, Keypoint and Cascade R-CNN, RetinaNet, FCOS), and the int8 forms."""

from __future__ import annotations

import dataclasses

import torch


def build_landmark_model(name: str, num_joints: int, device=None, dtype=torch.float32,
                         generator: torch.Generator | None = None):
    """A landmark model by the reference's name, with ``num_joints``
    heatmaps and weights from ``generator``: ``pose_hrnet`` (HRNet-W32),
    ``hrnet_cms`` / ``hrnet_cms_384`` (W32 with the CMS heads at full / half
    the input's resolution), ``hrnet_tiny``, ``hrnet_golden``,
    ``hrnet_tiny_cms`` and ``pose_resnet`` (SimpleBaseline ResNet-50); see
    ``hrnet.HRNet`` and ``pose_resnet.PoseResNet``."""
    from .hrnet import HRNET_CMS, HRNET_CMS_384, HRNET_GOLDEN, HRNET_TINY, POSE_HRNET_W32, HRNet
    from .pose_resnet import PoseResNet, PoseResNetConfig

    configs = {"pose_hrnet": POSE_HRNET_W32, "hrnet_cms": HRNET_CMS, "hrnet_cms_384": HRNET_CMS_384,
               "hrnet_tiny": HRNET_TINY, "hrnet_golden": HRNET_GOLDEN,
               "hrnet_tiny_cms": dataclasses.replace(HRNET_TINY, head="cms")}
    if name in configs:
        return HRNet(configs[name].with_joints(num_joints), dtype=dtype, device=device, generator=generator)
    if name == "pose_resnet":
        return PoseResNet(PoseResNetConfig(num_joints=num_joints), dtype=dtype, device=device, generator=generator)
    raise ValueError(f"unknown landmark model: {name}")
