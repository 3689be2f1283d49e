"""Models of the port: HRNet and the Faster R-CNN detector (eval mode), and their int8 forms."""

from __future__ import annotations

import torch

_NOT_PORTED = ("hrnet_cms", "hrnet_cms_384", "hrnet_tiny_cms", "hrnet_golden", "pose_resnet")


def build_landmark_model(name: str, num_joints: int, device=None, dtype=torch.float32,
                         generator: torch.Generator | None = None):
    """A landmark model by the reference's name: ``pose_hrnet`` (HRNet-W32)
    or ``hrnet_tiny``, with ``num_joints`` heatmaps, weights from
    ``generator`` (see ``hrnet.HRNet``)."""
    from .hrnet import HRNET_TINY, POSE_HRNET_W32, HRNet

    configs = {"pose_hrnet": POSE_HRNET_W32, "hrnet_tiny": HRNET_TINY}
    if name in configs:
        return HRNet(configs[name].with_joints(num_joints), dtype=dtype, device=device, generator=generator)
    if name in _NOT_PORTED:
        raise NotImplementedError(f"landmark model {name!r} is not ported yet (the CMS heads and the other "
                                  "landmark nets are on ROADMAP.md's queue); have 'pose_hrnet', 'hrnet_tiny'")
    raise ValueError(f"unknown landmark model: {name}")
